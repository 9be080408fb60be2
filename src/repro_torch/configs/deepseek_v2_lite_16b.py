"""deepseek-v2-lite-16b [arXiv:2405.04434; hf]: 27L d_model=2048 16H,
MLA kv_lora=512, MoE 64 routed top-6 + 2 shared, expert d_ff=1408,
vocab=102400 (counterpart of ``repro.configs.deepseek_v2_lite_16b``).

Deviation note (DESIGN.md §4): HF uses a dense FFN on layer 0; we use a
uniform 27-layer MoE stack so the layer scan is homogeneous (<1% param
delta).  "160 routed" in the assignment line refers to full V2; the Lite
config (bracketed values used here) has 64 routed experts.
"""
import dataclasses

from repro_torch.configs.base import ArchDef, lm_shapes
from repro_torch.models.transformer import LMConfig

CONFIG = LMConfig(
    name="deepseek-v2-lite-16b", n_layers=27, d_model=2048, n_heads=16,
    n_kv_heads=16, d_ff=10944, vocab=102400,
    moe=True, n_experts=64, top_k=6, n_shared=2, moe_d_ff=1408,
    moe_group_size=128,   # keeps dispatch-mask overhead ~8% (see moe.py)
    mla=True, kv_lora_rank=512, qk_nope_dim=128, qk_rope_dim=64,
    v_head_dim=128, rope_theta=1e4)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
    vocab=256, n_experts=8, top_k=2, n_shared=1, moe_d_ff=32,
    moe_group_size=64, kv_lora_rank=32, qk_nope_dim=16, qk_rope_dim=8,
    v_head_dim=16, q_chunk=16, kv_chunk=16)

ARCH = ArchDef(name="deepseek-v2-lite-16b", family="lm", config=CONFIG,
               smoke_config=SMOKE, shapes=lm_shapes())

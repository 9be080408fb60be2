"""dbrx-132b [hf:databricks/dbrx-base]: 40L d_model=6144 48H (GQA kv=8),
16 experts top-4, expert d_ff=10752, vocab=100352 (counterpart of
``repro.configs.dbrx_132b``)."""
import dataclasses

from repro_torch.configs.base import ArchDef, lm_shapes
from repro_torch.models.transformer import LMConfig

CONFIG = LMConfig(
    name="dbrx-132b", n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=10752, vocab=100352,
    moe=True, n_experts=16, top_k=4, n_shared=0, moe_d_ff=10752,
    moe_group_size=512, rope_theta=5e5)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=96, n_heads=6, n_kv_heads=2, d_ff=128,
    vocab=256, n_experts=4, top_k=2, moe_d_ff=64, moe_group_size=64,
    q_chunk=16, kv_chunk=16)

ARCH = ArchDef(name="dbrx-132b", family="lm", config=CONFIG,
               smoke_config=SMOKE, shapes=lm_shapes())

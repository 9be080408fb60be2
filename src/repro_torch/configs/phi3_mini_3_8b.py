"""phi3-mini-3.8b [arXiv:2404.14219]: 32L d_model=3072 32H (MHA kv=32),
d_ff=8192, vocab=32064, RoPE SwiGLU (counterpart of
``repro.configs.phi3_mini_3_8b``)."""
import dataclasses

from repro_torch.configs.base import ArchDef, lm_shapes
from repro_torch.models.transformer import LMConfig

CONFIG = LMConfig(
    name="phi3-mini-3.8b", n_layers=32, d_model=3072, n_heads=32,
    n_kv_heads=32, d_ff=8192, vocab=32064, rope_theta=1e4)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
    vocab=256, q_chunk=16, kv_chunk=16)

ARCH = ArchDef(name="phi3-mini-3.8b", family="lm", config=CONFIG,
               smoke_config=SMOKE, shapes=lm_shapes())

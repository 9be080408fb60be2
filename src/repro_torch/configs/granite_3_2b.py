"""granite-3-2b [hf:ibm-granite]: 40L d_model=2048 32H (GQA kv=8),
d_ff=8192, vocab=49155 (counterpart of ``repro.configs.granite_3_2b``)."""
import dataclasses

from repro_torch.configs.base import ArchDef, lm_shapes
from repro_torch.models.transformer import LMConfig

CONFIG = LMConfig(
    name="granite-3-2b", n_layers=40, d_model=2048, n_heads=32,
    n_kv_heads=8, d_ff=8192, vocab=49155, rope_theta=1e4)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab=256, q_chunk=16, kv_chunk=16)

ARCH = ArchDef(name="granite-3-2b", family="lm", config=CONFIG,
               smoke_config=SMOKE, shapes=lm_shapes())

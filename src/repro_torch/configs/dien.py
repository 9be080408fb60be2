"""dien [arXiv:1809.03672]: GRU + AUGRU interest evolution — embed 18,
seq 100, GRU 108, MLP 200-80 (counterpart of ``repro.configs.dien``)."""
import dataclasses

from repro_torch.configs.base import ArchDef, recsys_shapes
from repro_torch.models.recsys import DIENConfig

CONFIG = DIENConfig(name="dien", embed_dim=18, seq_len=100, gru_dim=108,
                    mlp=(200, 80), vocab=2_000_000)

SMOKE = dataclasses.replace(CONFIG, vocab=1000, seq_len=10)

ARCH = ArchDef(name="dien", family="recsys", config=CONFIG,
               smoke_config=SMOKE, shapes=recsys_shapes())

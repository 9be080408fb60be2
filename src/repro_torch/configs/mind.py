"""mind [arXiv:1904.08030]: multi-interest capsule network — embed 64,
4 interests, 3 routing iterations (counterpart of
``repro.configs.mind``)."""
import dataclasses

from repro_torch.configs.base import ArchDef, recsys_shapes
from repro_torch.models.recsys import MINDConfig

CONFIG = MINDConfig(name="mind", embed_dim=64, seq_len=50, n_interests=4,
                    capsule_iters=3, vocab=2_000_000)

SMOKE = dataclasses.replace(CONFIG, vocab=1000, seq_len=12)

ARCH = ArchDef(name="mind", family="recsys", config=CONFIG,
               smoke_config=SMOKE, shapes=recsys_shapes())

"""bst [arXiv:1905.06874]: Behavior Sequence Transformer — embed 32,
seq 20, 1 block, 8 heads, MLP 1024-512-256 (counterpart of
``repro.configs.bst``)."""
import dataclasses

from repro_torch.configs.base import ArchDef, recsys_shapes
from repro_torch.models.recsys import BSTConfig

CONFIG = BSTConfig(name="bst", embed_dim=32, seq_len=20, n_heads=8,
                   n_blocks=1, mlp=(1024, 512, 256), vocab=2_000_000)

SMOKE = dataclasses.replace(CONFIG, vocab=1000, mlp=(64, 32))

ARCH = ArchDef(name="bst", family="recsys", config=CONFIG,
               smoke_config=SMOKE, shapes=recsys_shapes())

"""dlrm-rm2 [arXiv:1906.00091]: 13 dense + 26 sparse fields, embed 64,
bottom MLP 13-512-256-64, top MLP 512-512-256-1, dot interaction
(counterpart of ``repro.configs.dlrm_rm2``)."""
import dataclasses

from repro_torch.configs.base import ArchDef, recsys_shapes
from repro_torch.models.recsys import DLRMConfig

CONFIG = DLRMConfig(name="dlrm-rm2", n_dense=13, n_sparse=26, embed_dim=64,
                    vocab=1_000_000, bot_mlp=(13, 512, 256, 64),
                    top_mlp=(512, 512, 256, 1))

SMOKE = dataclasses.replace(CONFIG, vocab=1000)

ARCH = ArchDef(name="dlrm-rm2", family="recsys", config=CONFIG,
               smoke_config=SMOKE, shapes=recsys_shapes())

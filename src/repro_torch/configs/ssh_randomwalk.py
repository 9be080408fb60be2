"""SSH on Random Walk (paper §5.1): W=30, δ=5, n=15, K=40, L=20
(counterpart of ``repro.configs.ssh_randomwalk``)."""
from repro_torch.configs.base import ShapeCell
from repro_torch.configs.registry import SSHArch
from repro_torch.db.config import SearchConfig
from repro_torch.encoders import IndexSpec

CONFIG = IndexSpec(encoder="ssh", params=dict(
    window=30, step=5, ngram=15, num_filters=1, num_hashes=40,
    num_tables=20), seed=11)

SMOKE = CONFIG.with_params(window=16, step=5, ngram=8, num_hashes=20,
                           num_tables=20)

SEARCH = SearchConfig(topk=10, top_c=512, band=6, multiprobe_offsets=5)

SHAPES = {
    "build_2048": ShapeCell("build", {"batch": 65536, "length": 2048}),
    "query_2048": ShapeCell("query", {"length": 2048,
                                      "n_database": 20_971_520,
                                      "top_c": 1024, "band": 102}),
}

ARCH = SSHArch(name="ssh-randomwalk", config=CONFIG, smoke_config=SMOKE,
               search_defaults=SEARCH, shapes=SHAPES)

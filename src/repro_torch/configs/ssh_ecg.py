"""SSH on ECG (paper §5.1): W=80, δ=3, n=15, K=40, L=20 (counterpart of
``repro.configs.ssh_ecg``).

The shape cells exercise the index at the paper's 20M-series scale:
``build`` hashes a batch of series; ``query`` probes the database's
signatures and re-ranks the candidates by banded DTW."""
from repro_torch.configs.base import ShapeCell
from repro_torch.configs.registry import SSHArch
from repro_torch.db.config import SearchConfig
from repro_torch.encoders import IndexSpec

CONFIG = IndexSpec(encoder="ssh", params=dict(
    window=80, step=3, ngram=15, num_filters=1, num_hashes=40,
    num_tables=20), seed=7)

SMOKE = CONFIG.with_params(window=24, step=3, ngram=8, num_hashes=20,
                           num_tables=20)

# search-time defaults (paper §5.3): band=6 is the 5% convention at the
# serving length 128; search_config(length=L) rescales it
SEARCH = SearchConfig(topk=10, top_c=512, band=6, multiprobe_offsets=3)

# the paper's database: 20,971,520 ECG subsequences
PAPER_N_SERIES = 20_971_520

SHAPES = {
    "build_2048": ShapeCell("build", {"batch": 65536, "length": 2048}),
    "query_128": ShapeCell("query", {"length": 128,
                                     "n_database": PAPER_N_SERIES,
                                     "top_c": 1024, "band": 6}),
    "query_2048": ShapeCell("query", {"length": 2048,
                                      "n_database": PAPER_N_SERIES,
                                      "top_c": 1024, "band": 102}),
}

ARCH = SSHArch(name="ssh-ecg", config=CONFIG, smoke_config=SMOKE,
               search_defaults=SEARCH, shapes=SHAPES)

#: ``SEARCH`` at a series length with per-call overrides
search_config = ARCH.search_config

"""SSH on ECG (paper §5.1): W=80, δ=3, n=15, K=40, L=20 (counterpart of
``repro.configs.ssh_ecg``)."""
import dataclasses
from typing import Optional

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


def search_config(length: Optional[int] = None, **overrides
                  ) -> SearchConfig:
    """``SEARCH`` at a series length (UCR 5% band: max(4, length // 20))
    with per-call overrides."""
    cfg = SEARCH
    if length is not None:
        cfg = dataclasses.replace(cfg, band=max(4, length // 20))
    return cfg.replace(**overrides) if overrides else cfg.validate()

"""PyTorch/CUDA port of the SSH time-series index (``repro``).

The module layout mirrors the JAX package one for one
(``repro_torch.core.dtw`` <-> ``repro.core.dtw``).  Entry points run on
CUDA unless the caller passes ``device="cpu"``; the kernels of the SSH
search and ingest paths and the LM prefill's flash attention are
hand-written CUDA C++ for sm_90a under ``csrc/``, each beside its plain
PyTorch version in ``kernels/ref.py``.
"""
from repro_torch.db import SearchConfig, TimeSeriesDB
from repro_torch.encoders import IndexSpec

__all__ = ["IndexSpec", "SearchConfig", "TimeSeriesDB"]

"""Synthetic recsys batches (Criteo/Amazon-like statistics), counterpart
of ``repro.data.recsys_data`` (numpy only, the same draws from
``np.random.default_rng(seed)``)."""
from __future__ import annotations

from typing import Dict

import numpy as np


def dlrm_batch(batch: int, n_dense: int = 13, n_sparse: int = 26,
               vocab: int = 1_000_000, seed: int = 0
               ) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    # log-normal dense features, zipfian sparse ids (realistic skew)
    dense = rng.lognormal(0, 1, (batch, n_dense)).astype(np.float32)
    sparse = (rng.zipf(1.2, (batch, n_sparse)) % vocab).astype(np.int32)
    labels = (rng.uniform(size=batch) < 0.25).astype(np.float32)
    return {"dense": dense, "sparse": sparse, "labels": labels}


def seq_batch(batch: int, seq_len: int, vocab: int = 2_000_000,
              n_profile: int = 8, seed: int = 0) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    return {
        "history": (rng.zipf(1.2, (batch, seq_len)) % vocab
                    ).astype(np.int32),
        "target": (rng.zipf(1.2, batch) % vocab).astype(np.int32),
        "profile": rng.integers(0, 1000, (batch, n_profile)
                                ).astype(np.int32),
        "labels": (rng.uniform(size=batch) < 0.3).astype(np.float32),
    }


def retrieval_batch(n_candidates: int, seq_len: int, vocab: int = 2_000_000,
                    n_dense: int = 13, n_sparse: int = 26, seed: int = 0
                    ) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    return {
        "dense": rng.lognormal(0, 1, (1, n_dense)).astype(np.float32),
        "sparse": rng.integers(0, vocab, (1, n_sparse)).astype(np.int32),
        "history": rng.integers(0, vocab, (1, seq_len)).astype(np.int32),
        "cand_ids": rng.integers(0, vocab, n_candidates).astype(np.int32),
    }

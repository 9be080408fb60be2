"""Step 3 of SSH — 0-bit Consistent Weighted Sampling (§4.3), counterpart
of ``repro.core.minhash``.

Ioffe's CWS, 0-bit variant: hash k of a weighted set w is the index i of
the active element (w_i > 0) minimising

    ln a_i = ln c_i - r_i (t_i - β_i) - r_i,   t_i = floor(ln w_i / r_i + β_i)

with r, c ~ Gamma(2, 1) and β ~ U(0, 1) drawn once per (k, i).  Ties go
to the lowest index, as ``argmin`` breaks them.

``ln w`` of the integer counts comes from a table of correctly rounded
logarithms (float64 ``log`` rounded once to float32), so every device
computes the same ``ln a`` bit for bit; the reference's XLA ``log`` is
off by one ulp on a few integers (7, 47, 49, ...), which moves
``floor`` only when ``ln w / r + β`` lies within that ulp of an integer —
hence the agreement rate, not identity, in the tests.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch


class CWSParams(NamedTuple):
    """Random fields for K independent CWS hashes over a D-dim space."""
    log_r: torch.Tensor   # (K, D) log of r (kept for the reference layout)
    r: torch.Tensor       # (K, D) Gamma(2,1)
    log_c: torch.Tensor   # (K, D) log of Gamma(2,1)
    beta: torch.Tensor    # (K, D) U(0,1)

    @property
    def num_hashes(self) -> int:
        return self.r.shape[0]

    @property
    def dim(self) -> int:
        return self.r.shape[1]


def make_cws(num_hashes: int, dim: int,
             generator: torch.Generator) -> CWSParams:
    """Sample the CWS fields on the CPU (the distributions of
    ``repro/core/minhash.py:40-51``).  Gamma(2,1) = -log(u1) - log(u2)."""
    shape = (num_hashes, dim)

    def uniform(lo):
        u = torch.rand(shape, generator=generator, dtype=torch.float32)
        return lo + (1.0 - lo) * u

    r = -torch.log(uniform(1e-12)) - torch.log(uniform(1e-12))
    c = -torch.log(uniform(1e-12)) - torch.log(uniform(1e-12))
    beta = uniform(0.0)
    return CWSParams(log_r=torch.log(r), r=r, log_c=torch.log(c), beta=beta)


_LOG_TABLES: Dict[Tuple[torch.device, int], torch.Tensor] = {}


def _log_counts(counts: torch.Tensor, max_count: int) -> torch.Tensor:
    """ln of integer counts >= 1 via the correctly rounded table
    (counts of 0 map to 0, like the reference's masked log).  The table is
    made once per device and size."""
    key = (counts.device, max_count)
    table = _LOG_TABLES.get(key)
    if table is None:
        logs = np.log(np.arange(1, max_count + 1, dtype=np.float64))
        table = torch.from_numpy(np.concatenate([[0.0], logs]).astype(
            np.float32)).to(counts.device)
        _LOG_TABLES[key] = table
    return table[counts.to(torch.int64)]


def _ln_a(logw, r, log_c, beta):
    """The CWS score, op for op as ``repro/core/minhash.py:65-66``."""
    t = torch.floor(logw / r + beta)
    return log_c - r * (t - beta) - r


def cws_hash(weights: torch.Tensor, params: CWSParams) -> torch.Tensor:
    """Dense 0-bit CWS: integer counts (..., D) -> (..., K) int32.

    Evaluates all K·D scores; the encoder uses :func:`cws_hash_active`,
    which gives the same hashes from the active elements alone.
    """
    w = weights.to(torch.int64)
    logw = _log_counts(w, max(int(w.max()) if w.numel() else 0, 1))
    ln_a = _ln_a(logw[..., None, :], params.r, params.log_c, params.beta)
    ln_a = torch.where(w[..., None, :] > 0, ln_a, torch.inf)
    return torch.argmin(ln_a, dim=-1).to(torch.int32)


def cws_hash_dense_batch(weights: torch.Tensor, params: CWSParams
                         ) -> torch.Tensor:
    """Dense 0-bit CWS of a batch of integer count vectors, (B, D) ->
    (B, K) int32, a hash at a time so the largest temporary is one (B, D)
    score tile (``repro/core/minhash.py:72-96``); equal to
    :func:`cws_hash` of the batch."""
    w = weights.to(torch.int64)
    logw = _log_counts(w, max(int(w.max()) if w.numel() else 0, 1))
    active = w > 0
    sigs = [torch.argmin(torch.where(
        active, _ln_a(logw, params.r[k], params.log_c[k], params.beta[k]),
        torch.inf), dim=1) for k in range(params.num_hashes)]
    return torch.stack(sigs, 1).to(torch.int32)


def cws_hash_batch(weights: torch.Tensor, params: CWSParams,
                   chunk: int = 64) -> torch.Tensor:
    """(B, D) integer counts -> (B, K) int32, :func:`cws_hash` over
    blocks of ``chunk`` rows, which bound the (chunk, K, D) score
    temporary (``repro/core/minhash.py:99-111``)."""
    if weights.shape[0] == 0:
        return torch.zeros((0, params.num_hashes), dtype=torch.int32,
                           device=weights.device)
    return torch.cat([cws_hash(weights[lo:lo + chunk], params)
                      for lo in range(0, weights.shape[0], chunk)])


def cws_hash_active(ids: torch.Tensor, params: CWSParams) -> torch.Tensor:
    """0-bit CWS of the histogram of shingle ids, from its active elements
    only: ``ids`` (B, S), ids >= D masked -> (B, K) int32.

    Sorted ascending, each distinct id is an active element and its run
    length is its count.  Visited in that order with repeats dropped, the
    active elements come in the dense argmin's order, and each score is
    computed by the same operations, so the result equals ``cws_hash`` of
    the histogram while touching S instead of D elements per hash (at
    D = 2^15 and S = 131, about 250x less work) and never forming the
    (B, D) histogram.
    """
    srt = torch.sort(ids, dim=1).values
    runs = (torch.searchsorted(srt, srt, right=True)
            - torch.searchsorted(srt, srt))                     # (B, S)
    return _cws_sorted(srt, runs, srt < params.dim, params)


def cws_hash_sparse(dims: torch.Tensor, counts: torch.Tensor,
                    params: CWSParams) -> torch.Tensor:
    """0-bit CWS of a weighted set given as (dimension, integer weight)
    entries: ``dims`` (B, S) with dims >= D masked, ``counts`` (B, S)
    the weight of each entry's dimension (an entry may repeat, always
    with its dimension's weight; weights <= 0 are inactive, and none
    exceeds S) -> (B, K) int32, equal to ``cws_hash`` of the dense
    weights."""
    srt, order = torch.sort(dims, dim=1)
    counts = counts.gather(1, order)
    return _cws_sorted(srt, counts, (srt < params.dim) & (counts > 0),
                       params)


def _cws_sorted(srt: torch.Tensor, counts: torch.Tensor,
                valid: torch.Tensor, params: CWSParams) -> torch.Tensor:
    """The argmin over the first entry of each run of ``srt`` (ascending
    dims) that is ``valid``, with ``counts`` the integer weights, at most
    S each (a weight counts entries of one row)."""
    b, s = srt.shape
    d = params.dim
    first = torch.ones_like(srt, dtype=torch.bool)
    first[:, 1:] = srt[:, 1:] != srt[:, :-1]
    active = first & valid
    idx = srt.clamp(0, d - 1)
    logw = _log_counts(counts.clamp(min=0), max(s, 1))          # (B, S)
    flat = idx.reshape(-1)
    fields = [f[:, flat].reshape(-1, b, s)
              for f in (params.r, params.log_c, params.beta)]  # (K, B, S)
    ln_a = _ln_a(logw[None], *fields)
    ln_a = torch.where(active[None], ln_a, torch.inf)
    pick = torch.argmin(ln_a, dim=-1)                           # (K, B)
    sig = srt.gather(1, pick.t())                               # (B, K)
    # a row with no active element hashes to 0, like the dense argmin
    sig = torch.where(active.any(1, keepdim=True), sig, 0)
    return sig.to(torch.int32)


def collision_probability_estimate(sig_a: torch.Tensor,
                                   sig_b: torch.Tensor) -> torch.Tensor:
    """Fraction of agreeing hashes over the last axis, f32: the unbiased
    estimator of the weighted Jaccard similarity (paper eq. 3)."""
    agree = (sig_a == sig_b).to(torch.float32)
    # jnp.mean's arithmetic: the sum times the float32 reciprocal of n
    return agree.sum(-1) * torch.tensor(1.0 / agree.shape[-1],
                                        dtype=torch.float32)


_MASK32 = 0xFFFFFFFF


def _mul32(a: torch.Tensor, mult: int) -> torch.Tensor:
    """(a * mult) mod 2^32 for 0 <= a < 2^32 in int64 without overflow:
    the multiplier is split into 16-bit halves."""
    lo = a * (mult & 0xFFFF)
    hi = ((a * (mult >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def combine_bands(signatures: torch.Tensor, num_tables: int
                  ) -> torch.Tensor:
    """Group K hashes into L bands and mix each band into one bucket key.

    signatures (..., K) -> (..., L) int32 holding the 32-bit pattern of the
    reference's uint32 keys (``repro/core/minhash.py:114-131``), emulated in
    int64 masked to 32 bits.
    """
    k = signatures.shape[-1]
    if k % num_tables:
        raise ValueError(f"K={k} not divisible by L={num_tables}")
    rows = k // num_tables
    bands = signatures.to(torch.int64).reshape(
        signatures.shape[:-1] + (num_tables, rows)) & _MASK32
    acc = torch.zeros(bands.shape[:-1], dtype=torch.int64,
                      device=signatures.device)
    for i in range(rows):
        acc = _mul32(acc, 0x9E3779B1) ^ ((bands[..., i] + 0x85EBCA6B)
                                         & _MASK32)
        acc = acc ^ (acc >> 15)
    return torch.where(acc >= 2 ** 31, acc - 2 ** 32, acc).to(torch.int32)


# b-bit signature packing (Li & König, the paper's ref [30];
# ``repro/core/minhash.py:141-174``): keep the low b bits of each hash,
# 32/b hashes a 32-bit word.  Integer arithmetic, so exact.

def pack_signatures(signatures: torch.Tensor, bits: int = 8) -> torch.Tensor:
    """(..., K) int32 -> (..., K·bits/32) int32 packed b-bit sketches;
    hash j of a word sits at bit (j mod 32/b)·b."""
    if 32 % bits:
        raise ValueError("bits must divide 32")
    per_word = 32 // bits
    k = signatures.shape[-1]
    if k % per_word:
        raise ValueError(f"K={k} not divisible by {per_word} hashes/word")
    s = (signatures.to(torch.int64) & ((1 << bits) - 1)).reshape(
        signatures.shape[:-1] + (k // per_word, per_word))
    shifts = torch.arange(per_word, device=signatures.device) * bits
    word = (s << shifts).sum(-1)                  # disjoint fields, < 2^32
    return torch.where(word >= 2 ** 31, word - 2 ** 32, word).to(
        torch.int32)


def packed_collisions(query_packed: torch.Tensor, db_packed: torch.Tensor,
                      bits: int = 8) -> torch.Tensor:
    """Agreement counts over b-bit lanes: query (W,), db (N, W) -> (N,)
    int32."""
    per_word = 32 // bits
    mask = (1 << bits) - 1
    x = db_packed ^ query_packed[None, :]                       # (N, W)
    total = torch.zeros(db_packed.shape[:-1], dtype=torch.int32,
                        device=db_packed.device)
    for i in range(per_word):
        lane = (x >> (i * bits)) & mask
        total += (lane == 0).sum(-1, dtype=torch.int32)
    return total

"""SSH search in plain PyTorch, written from the paper (arXiv:1610.07328
§4) and the configuration's guarantees, for the check that decides
``correct``.  It imports nothing of the program.

* **State.** The encoder's random state is drawn again from the spec
  seed: one CPU ``torch.Generator`` seeded by it draws the (W, F) filter
  bank ~ N(0, 1), then CWS fields over the 2^n shingle space, each (K, D):
  r = -ln u1 - ln u2 and c = -ln u3 - ln u4 (Gamma(2, 1)) and beta = u5
  (U(0, 1)), with u = 1e-12 + (1 - 1e-12)·U(0, 1) for the Gamma draws.
* **Sketch.** Bit t of a series is [<f, x[tδ : tδ + W]> >= 0].  The
  configuration states float32 arithmetic, in which a projection within
  rounding of 0 may come out either way.  The reference takes each
  projection in float64, with a bound on what any float32 evaluation of
  the W products can be off by, (W + 2)·2^-24·Σ|f_w x_w|: a bit whose
  projection lies inside it is *free* (either value is a valid float32
  answer); every other bit is fixed.
* **Shingles and hash.** Shingle i of the bits is Σ_j b[i+j]·2^j; the
  weighted set is their histogram.  The 0-bit CWS hash k is the active
  id minimising ln a = ln c - r·(floor(ln w / r + beta) - beta) - r,
  ties to the lowest id, in float32, with ln w the float64 logarithm of
  the count rounded once to float32.
* **Probe.** A query's offset o hashes q[o:]; its count against a row is
  the most hashes agreeing at any offset; the top-C rows by count, ties to
  the lowest id, are the candidates, those of count 0 left out.
* **Re-rank.** Squared DTW in the Sakoe-Chiba band |i - j| <= r, in
  float64; the answer is the top-k candidates by it.

A signature of the program is *valid* when it is the hash of some value
of the free bits.  Where the program's signature of a row is valid, the
reference's probe uses it; elsewhere the reference's own.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

#: unit roundoff of float32
U32 = 2.0 ** -24
#: a row with more free bits than this is not enumerated (2^12 variants)
MAX_FREE = 12


@dataclasses.dataclass
class State:
    filters: torch.Tensor     # (W,) float32 (one filter)
    r: torch.Tensor           # (K, D) float32
    log_c: torch.Tensor       # (K, D) float32
    beta: torch.Tensor        # (K, D) float32
    window: int
    step: int
    ngram: int

    @property
    def num_hashes(self) -> int:
        return int(self.r.shape[0])

    @property
    def dim(self) -> int:
        return int(self.r.shape[1])


def encoder_state(params: Dict, seed: int, device) -> State:
    """The encoder's state drawn from the spec seed (module docstring)."""
    w, f = int(params["window"]), int(params["num_filters"])
    if f != 1:
        raise ValueError("the reference covers one filter")
    k, n = int(params["num_hashes"]), int(params["ngram"])
    d = 1 << n
    gen = torch.Generator().manual_seed(int(seed))
    filters = torch.randn((w, f), generator=gen, dtype=torch.float32)

    def uniform(lo):
        u = torch.rand((k, d), generator=gen, dtype=torch.float32)
        return lo + (1.0 - lo) * u

    r = -torch.log(uniform(1e-12)) - torch.log(uniform(1e-12))
    c = -torch.log(uniform(1e-12)) - torch.log(uniform(1e-12))
    beta = uniform(0.0)
    return State(filters=filters[:, 0].to(device), r=r.to(device),
                 log_c=torch.log(c).to(device), beta=beta.to(device),
                 window=w, step=int(params["step"]), ngram=n)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10-bit significand, to nearest even."""
    i = x.contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


# -- sketch --------------------------------------------------------------

def projections(x: torch.Tensor, st: State, precision: str = "exact"
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(R, L) series -> (projections (R, T), free (R, T) bool).

    ``"exact"``: float64 projections and the free bits of the module
    docstring.  ``"tf32"``: inputs rounded to TF32 and summed in float32
    (the control), no bit free."""
    win = x.unfold(1, st.window, st.step)                  # (R, T, W)
    if precision == "exact":
        f = st.filters.to(torch.float64)
        w64 = win.to(torch.float64)
        proj = w64 @ f
        bound = (st.window + 2) * U32 * (w64.abs() @ f.abs()) * 1.0001
        return proj, proj.abs() <= bound
    if precision == "tf32":
        proj = tf32(win.contiguous()) @ tf32(st.filters)
        return proj, torch.zeros_like(proj, dtype=torch.bool)
    raise ValueError(precision)


# -- shingles and the hash -------------------------------------------------

def shingle_ids(bits: torch.Tensor, n: int) -> torch.Tensor:
    """(R, T) {0, 1} -> (R, T - n + 1) int64 ids sum_j b[i+j] << j."""
    s = bits.shape[1] - n + 1
    ids = torch.zeros((bits.shape[0], s), dtype=torch.int64,
                      device=bits.device)
    for j in range(n):
        ids += bits[:, j:j + s].to(torch.int64) << j
    return ids


def cws(ids: torch.Tensor, st: State, rows_a_block: int = 8192
        ) -> torch.Tensor:
    """0-bit CWS of each row's shingle histogram: (R, S) ids -> (R, K)
    int32, from the active ids alone."""
    out = []
    for lo in range(0, ids.shape[0], rows_a_block):
        out.append(_cws_block(ids[lo:lo + rows_a_block], st))
    if not out:
        return torch.zeros((0, st.num_hashes), dtype=torch.int32,
                           device=ids.device)
    return torch.cat(out)


def _cws_block(ids: torch.Tensor, st: State) -> torch.Tensor:
    srt = torch.sort(ids, dim=1).values
    b, s = srt.shape
    count = (torch.searchsorted(srt, srt, right=True)
             - torch.searchsorted(srt, srt))                 # run lengths
    first = torch.ones_like(srt, dtype=torch.bool)
    first[:, 1:] = srt[:, 1:] != srt[:, :-1]
    table = torch.from_numpy(
        np.log(np.arange(1, s + 1, dtype=np.float64)).astype(np.float32)
    ).to(ids.device)
    logw = table[count - 1]                                  # (B, S)
    flat = srt.reshape(-1)
    r = st.r[:, flat].reshape(-1, b, s)
    log_c = st.log_c[:, flat].reshape(-1, b, s)
    beta = st.beta[:, flat].reshape(-1, b, s)
    t = torch.floor(logw[None] / r + beta)
    ln_a = log_c - r * (t - beta) - r
    ln_a = torch.where(first[None], ln_a, torch.inf)
    pick = torch.argmin(ln_a, dim=-1)                        # (K, B)
    return srt.gather(1, pick.t()).to(torch.int32)


def signatures(bits: torch.Tensor, st: State) -> torch.Tensor:
    return cws(shingle_ids(bits, st.ngram), st)


# -- judging signatures ------------------------------------------------------

@dataclasses.dataclass
class SigJudgement:
    accepted: torch.Tensor    # (R, K) the signature the probe uses
    off: int                  # rows whose signature is no valid hash
    free_rows: int            # rows with a free bit
    unsettled: int            # rows with more than MAX_FREE free bits


def judge_signatures(x: torch.Tensor, program: Optional[torch.Tensor],
                     st: State, precision: str = "exact",
                     rows_a_block: int = 16384) -> SigJudgement:
    """Judge the program's signatures (R, K) of the series ``x`` (R, L);
    with ``program`` None the reference's own come back as accepted.
    ``precision`` is the reference's (``"tf32"`` only for the control's
    own signatures, judged elsewhere)."""
    acc, off, free_rows, unsettled = [], 0, 0, 0
    for lo in range(0, x.shape[0], rows_a_block):
        xb = x[lo:lo + rows_a_block]
        proj, free = projections(xb, st, precision)
        bits = (proj >= 0).to(torch.uint8)
        base = signatures(bits, st)
        if program is None:
            acc.append(base)
            continue
        prog = program[lo:lo + rows_a_block].to(base.device, torch.int32)
        same = (prog == base).all(1)
        nfree = free.sum(1)
        free_rows += int((nfree > 0).sum())
        take = base.clone()
        take[same] = prog[same]
        differ = (~same).nonzero().flatten()
        if differ.numel():
            ok, unset = _variants_match(bits[differ], free[differ],
                                        prog[differ], st)
            unsettled += unset
            take[differ[ok]] = prog[differ[ok]]
            off += int((~ok).sum())
        acc.append(take)
    return SigJudgement(accepted=torch.cat(acc), off=off,
                        free_rows=free_rows, unsettled=unsettled)


def _variants_match(bits: torch.Tensor, free: torch.Tensor,
                    prog: torch.Tensor, st: State
                    ) -> Tuple[torch.Tensor, int]:
    """For rows whose program signature differs from the base one: is it
    the hash of some value of the row's free bits?  A row with more than
    :data:`MAX_FREE` free bits is not enumerated and counts as matched
    (``unsettled``)."""
    nfree = free.sum(1)
    ok = torch.zeros(bits.shape[0], dtype=torch.bool, device=bits.device)
    unsettled = 0
    for f in sorted(set(nfree.tolist())):
        rows = (nfree == f).nonzero().flatten()
        if f == 0:
            continue
        if f > MAX_FREE:
            ok[rows] = True
            unsettled += int(rows.numel())
            continue
        v = 1 << f
        pos = free[rows].nonzero()[:, 1].reshape(len(rows), f)  # (R_f, f)
        var = bits[rows].unsqueeze(1).repeat(1, v, 1)            # (R_f, V, T)
        pattern = ((torch.arange(v, device=bits.device)[:, None]
                    >> torch.arange(f, device=bits.device)[None, :]) & 1)
        idx = pos.unsqueeze(1).expand(-1, v, -1)
        var.scatter_(2, idx, pattern.to(torch.uint8)[None].expand(
            len(rows), -1, -1))
        sigs = signatures(var.reshape(len(rows) * v, -1), st).reshape(
            len(rows), v, -1)
        ok[rows] = (sigs == prog[rows][:, None, :]).all(2).any(1)
    return ok, unsettled


def query_rows(q: torch.Tensor, offsets: int) -> List[torch.Tensor]:
    """The series each multiprobe offset hashes: q[:, o:] for o < O."""
    return [q[:, o:] for o in range(offsets)]


def judge_queries(q: torch.Tensor, program: Optional[torch.Tensor],
                  st: State, offsets: int) -> SigJudgement:
    """Judge the program's query signatures (S, O, K) of queries (S, m);
    accepted comes back (S, O, K)."""
    parts = []
    for o, xo in enumerate(query_rows(q, offsets)):
        prog = None if program is None else program[:, o]
        parts.append(judge_signatures(xo, prog, st))
    return SigJudgement(
        accepted=torch.stack([p.accepted for p in parts], 1),
        off=sum(p.off for p in parts),
        free_rows=sum(p.free_rows for p in parts),
        unsettled=sum(p.unsettled for p in parts))


# -- probe -------------------------------------------------------------------

def counts(qsig: torch.Tensor, db_t: torch.Tensor) -> torch.Tensor:
    """(G, O, K) query signatures x the database's (K, N) transposed ->
    (G, N) int32: the most hashes a row agrees on at any offset."""
    g, o, k = qsig.shape
    flat = qsig.reshape(g * o, k).to(db_t.device)
    c = torch.zeros((g * o, db_t.shape[1]), dtype=torch.int32,
                    device=db_t.device)
    for j in range(k):
        c += db_t[j][None, :] == flat[:, j][:, None]
    return c.reshape(g, o, -1).amax(1)


def top_c(cnt: torch.Tensor, c: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each row's ``c`` columns of highest count, ties to the lowest id,
    and their counts: a stable sort of the negated counts.  (G, N) ->
    (G, c) ids int64, (G, c) counts."""
    order = torch.sort(-cnt.to(torch.int64), dim=1, stable=True
                       ).indices[:, :c]
    return order, cnt.gather(1, order)


# -- re-rank -------------------------------------------------------------

def dtw(q: torch.Tensor, x: torch.Tensor, radius: int,
        dtype=torch.float64) -> torch.Tensor:
    """Squared DTW of row-aligned pairs (P, m) x (P, m) -> (P,) in the band
    |i - j| <= radius, row by row.  A row's cells are
    D(i, j) = c(i, j) + min(D(i-1, j-1), D(i-1, j), D(i, j-1)); with
    A(j) = c(i, j) + min(D(i-1, j-1), D(i-1, j)) and C the running sum of
    the row's costs, D(i, j) = C(j) + min over l <= j of (A(l) - C(l))."""
    q = q.to(dtype)
    x = x.to(dtype)
    p, m = q.shape
    r = min(int(radius), m - 1)
    w = 2 * r + 1
    u = torch.arange(w, device=q.device)
    inf = torch.tensor(float("inf"), dtype=dtype, device=q.device)
    prev = torch.full((p, w + 1), float("inf"), dtype=dtype, device=q.device)
    prev[:, r] = 0.0                   # D(-1, -1): the path's start
    for i in range(m):
        j = i - r + u                              # (w,) columns of row i
        valid = (j >= 0) & (j < m)
        cost = (q[:, i:i + 1] - x[:, j.clamp(0, m - 1)]) ** 2
        cost = torch.where(valid, cost, torch.zeros((), dtype=dtype,
                                                    device=q.device))
        a = cost + torch.minimum(prev[:, :w], prev[:, 1:])
        a = torch.where(valid, a, inf)
        csum = torch.cumsum(cost, 1)
        d = csum + torch.cummin(a - csum, 1).values
        prev[:, :w] = torch.where(valid, d, inf)
    return prev[:, r]

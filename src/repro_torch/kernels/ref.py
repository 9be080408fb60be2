"""Plain PyTorch versions of the CUDA kernels (counterpart of
``repro.kernels.ref``).

Each ``<name>_ref`` is the oracle its kernel is held against on the card
and the path ``kernels.ops`` takes for a tensor that lies on the CPU.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from repro_torch.core import dtw as _dtw
from repro_torch.core.sketch import sketch_projections
from repro_torch.kernels import collision_count as _cc
from repro_torch.kernels.dtw_wavefront import ROWS_TILE
from repro_torch.kernels.flash_attention import REORDER


def sketch_conv_ref(x: torch.Tensor, filters: torch.Tensor, step: int
                    ) -> torch.Tensor:
    """Sliding-window projections. x (B, m), filters (W, F) -> (B, N_B, F).

    ``x.unfold(-1, W, step) @ filters``: a matrix product, which sums the
    taps in another order than the kernel's tap loop — compare within
    float32 tolerance.
    """
    return sketch_projections(x, filters, step)


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor
            ) -> torch.Tensor:
    """fl32(a * b + c) rounded once, as ``__fmaf_rn`` computes it, for
    float32 tensors (broadcast) on any device.

    The product is exact in float64 (two 24-bit significands), TwoSum
    gives the sum s and its exact residual e (a*b + c = s + e), and s
    rounds to float32.  Every float32 midpoint is a float64, so that
    rounding is the correct one unless s lies on a midpoint itself; then
    the sign of e says on which side the exact sum lies.
    """
    prod = a.double() * b.double()
    c64 = c.double()
    s = prod + c64
    bp = s - c64
    e = (c64 - (s - bp)) + (prod - bp)
    r = s.float()
    r64 = r.double()
    nxt = torch.nextafter(r, torch.where(s > r64, math.inf, -math.inf))
    tie = (r64 != s) & (s == (r64 + nxt.double()) * 0.5)
    return torch.where(tie & (e != 0) & ((e > 0) == (s > r64)), nxt, r)


def sketch_conv_fma_ref(x: torch.Tensor, filters: torch.Tensor, step: int
                        ) -> torch.Tensor:
    """The sketch kernel's arithmetic, exactly: x (B, m), filters (W, F)
    float32 -> (B, N_B, F), each output one fused multiply-add chain
    acc = fma(x[t*step + w], filters[w, f], acc) over w = 0 .. W-1 from
    0.0 (:func:`fma_f32`).  The kernel is held to it bit for bit."""
    w_, f_ = filters.shape
    win = x.unfold(-1, w_, step)                       # (B, N_B, W) view
    acc = torch.zeros((*win.shape[:-1], f_), dtype=torch.float32,
                      device=x.device)
    for w in range(w_):
        acc = fma_f32(win[..., w, None], filters[w], acc)
    return acc


def collision_count_batch_ref(query_keys: torch.Tensor,
                              db_keys: torch.Tensor) -> torch.Tensor:
    """queries (B, K), db (N, K) int32 -> (B, N) int32 match counts,
    accumulated key by key as a (B, N) broadcast compare."""
    b, n = query_keys.shape[0], db_keys.shape[0]
    acc = torch.zeros((b, n), dtype=torch.int32, device=db_keys.device)
    db_t = db_keys.t()
    for k in range(db_keys.shape[1]):
        acc += db_t[k][None, :] == query_keys[:, k][:, None]
    return acc


def collision_count_ref(query_keys: torch.Tensor, db_keys: torch.Tensor
                        ) -> torch.Tensor:
    """query (K,), db (N, K) int32 -> (N,) int32 per-row match counts."""
    return (db_keys == query_keys[None, :]).sum(1, dtype=torch.int32)


def collision_count_padded_ref(query_keys: torch.Tensor,
                               db_keys: torch.Tensor) -> torch.Tensor:
    """The kernels' padding rule: queries (B, K) padded to ``k_pad(K)``
    slots with ``Q_PAD``, the database (N, K) with ``DB_PAD``, and every
    slot compared -> (B, N) int32.  A padded slot compares the two
    sentinels and never matches, so this equals
    :func:`collision_count_batch_ref` for any keys, the sentinels
    themselves included."""
    (b, k), n = query_keys.shape, db_keys.shape[0]
    extra = _cc.k_pad(k) - k
    qp = torch.cat([query_keys, torch.full((b, extra), _cc.Q_PAD,
                                           dtype=torch.int32,
                                           device=query_keys.device)], 1)
    dp = torch.cat([db_keys, torch.full((n, extra), _cc.DB_PAD,
                                        dtype=torch.int32,
                                        device=db_keys.device)], 1)
    return collision_count_batch_ref(qp, dp)


def collision_count_stream_ref(query_keys: torch.Tensor,
                               db_keys: torch.Tensor, lead: int = 0
                               ) -> torch.Tensor:
    """The single-query kernel's walk over memory, in plain PyTorch:
    query (K,), db (N, K) int32 -> (N,) int32, equal to
    :func:`collision_count_ref`.

    The matrix lies ``lead`` (0-3) words after a 16-byte boundary, in a
    buffer whose other words hold ``Q_PAD`` (so a pad slot read from
    memory instead of set to ``DB_PAD`` would match).  Tile t of
    ``ONE_TILE`` rows is the span of words [w0, w1) widened to [s0, s1)
    on 16-byte boundaries and copied into a stage of
    ``one_stage_words(K)`` words; its rows are read at offset w0 - s0,
    slots past K as ``DB_PAD``, against the query padded with ``Q_PAD``.
    Asserts that no span reaches past the 16-byte chunks holding real
    keys and that every read stays inside its stage."""
    n, k = db_keys.shape
    kp, tile, words = _cc.k_pad(k), _cc.ONE_TILE, _cc.one_stage_words(k)
    end = (lead + n * k + 3) & ~3         # end of the last real chunk
    flat = torch.full((end,), _cc.Q_PAD, dtype=torch.int32)
    flat[lead:lead + n * k] = db_keys.reshape(-1).cpu()
    qp = torch.cat([query_keys.cpu(),
                    torch.full((kp - k,), _cc.Q_PAD, dtype=torch.int32)])
    out = torch.empty(n, dtype=torch.int32)
    for t in range(-(-n // tile)):
        rows = min(tile, n - t * tile)
        w0 = t * tile * k + lead
        w1 = w0 + rows * k
        s0, s1 = w0 & ~3, (w1 + 3) & ~3
        assert 0 <= s0 and s1 <= end and s1 - s0 <= words
        stage = torch.full((words,), _cc.Q_PAD, dtype=torch.int32)
        stage[:s1 - s0] = flat[s0:s1]
        idx = (w0 - s0 + k * torch.arange(rows)[:, None]
               + torch.arange(kp)[None, :])
        assert int(idx.max()) < words
        vals = stage[idx]
        vals[:, k:] = _cc.DB_PAD
        out[t * tile:t * tile + rows] = (vals == qp).sum(1)
    return out.to(db_keys.device)


def dtw_pairs_ref(queries: torch.Tensor, candidates: torch.Tensor,
                  band: Optional[int] = None,
                  threshold: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Row-aligned banded squared DTW: (P, m) x (P, m) -> (P,).

    The reference routes narrow bands to its O(m·band) window DP and the
    rest to the full DP (``repro/kernels/ref.py:30-73``); both compute the
    same function, which the wavefront of ``core.dtw`` computes at radius
    ``min(band, m - 1)`` (``None`` -> m - 1), with the same threshold
    contract: exact where <= threshold, else BIG.
    """
    return _dtw.dtw_banded_pairs(queries, candidates, band,
                                 threshold=threshold)


def dtw_wavefront_ref(query: torch.Tensor, candidates: torch.Tensor,
                      band: Optional[int] = None,
                      threshold=None) -> torch.Tensor:
    """Banded squared DTW of one query against a block: query (m,),
    candidates (C, m) -> (C,), with the threshold contract of
    :func:`dtw_pairs_ref` (``threshold`` a scalar or (C,)).  The query
    row is broadcast to every pair, so the values are those of the pair
    wavefront, bit for bit."""
    return _dtw.dtw_banded_pairs(query[None, :].expand_as(candidates),
                                 candidates, band, threshold=threshold)


def dtw_band_rows_ref(queries: torch.Tensor, candidates: torch.Tensor,
                      band: Optional[int] = None,
                      threshold=None) -> torch.Tensor:
    """The row schedule of ``csrc/dtw_wavefront.cu`` in plain torch:
    (P, m) x (P, m) -> (P,), the contract of :func:`dtw_pairs_ref`
    (``threshold`` a scalar or (P,)).

    Each pair sweeps the candidate's rows j, keeping the row's 2r + 1
    band costs (u = i - j + r) and updating them in place from left to
    right: cell (j, u) reads the old u (diagonal), the old u + 1 (top)
    and the new u - 1 (left), as the kernel computes it:
    min(c + left, min(c + min(diagonal, top), BIG)) with c = (q - x)^2,
    which equals the plain min(c + min(diagonal, top, left), BIG) bit for
    bit (x -> fl(c + x) is monotone, so it commutes with min).  The
    query is padded with +inf, so a cell off the matrix costs inf and
    clamps to BIG.  Row -1 holds 0 at u = r, the diagonal of cell
    (0, 0).  With a threshold, the row minimum is tested after every
    ``ROWS_TILE`` rows and at the end, as the kernel does, and the sweep
    stops once every pair is past it.  Loops over rows and u in Python:
    for tests at small sizes.
    """
    q = queries.to(torch.float32)
    x = candidates.to(torch.float32)
    p, m = q.shape
    r = _dtw.radius(band, m)
    big = torch.tensor(_dtw.BIG, dtype=torch.float32)
    pad = torch.full((p, r), float("inf"), dtype=torch.float32)
    qp = torch.cat([pad, q, pad], 1)                 # qp[:, t] = q[:, t - r]
    row = torch.full((p, 2 * r + 1), _dtw.BIG, dtype=torch.float32)
    row[:, r] = 0.0
    thr = None
    if threshold is not None:
        thr = torch.as_tensor(threshold, dtype=torch.float32).expand(p)
    dead = torch.zeros(p, dtype=torch.bool)
    for j in range(m):
        left = big.expand(p)
        for u in range(2 * r + 1):
            top = row[:, u + 1] if u < 2 * r else big.expand(p)
            d = qp[:, j + u] - x[:, j]
            c = d * d
            y = torch.minimum(c + torch.minimum(row[:, u], top), big)
            left = torch.minimum(c + left, y)
            row[:, u] = left
        if thr is not None and (j % ROWS_TILE == ROWS_TILE - 1
                                or j == m - 1):
            dead |= row.min(1).values > thr
            if bool(dead.all()):
                break
    out = row[:, r].clone()
    if thr is not None:
        out = torch.where(dead | (out > thr), big, out)
    return out


def cs_tables_ref(bucket: torch.Tensor, sign: torch.Tensor, width: int
                  ) -> torch.Tensor:
    """Signed count-sketch tables: bucket (B, R, S) int32 (-1 invalid),
    sign (B, R, S) f32 -> (B, R, width) f32.

    A scatter-add into ``width + 1`` bins whose last bin collects every
    bucket outside [0, width) and is sliced off
    (``repro/kernels/ref.py:106-122``).  Sums of +-1 are exact integers,
    so every order of the adds gives the same bits.
    """
    b, r, s = bucket.shape
    tgt = torch.where((bucket >= 0) & (bucket < width), bucket, width)
    tables = torch.zeros((b * r, width + 1), dtype=torch.float32,
                         device=bucket.device)
    tables.scatter_add_(1, tgt.reshape(b * r, s).to(torch.int64),
                        sign.to(torch.float32).reshape(b * r, s))
    return tables[:, :width].reshape(b, r, width)


def key_lengths(kv_valid: Optional[torch.Tensor], b: int, t: int,
                device) -> Optional[torch.Tensor]:
    """kv_len[b] = min(T, max(0, kv_valid[b])) as int64 on ``device``, or
    None without ``kv_valid`` (every row's keys run to T)."""
    if kv_valid is None:
        return None
    if kv_valid.shape != (b,):
        raise ValueError(f"kv_valid must be (B,) = ({b},), got "
                         f"{tuple(kv_valid.shape)}")
    return kv_valid.to(device=device, dtype=torch.int64).clamp(0, t)


def attention_hidden(s: int, t: int, causal: bool, q_offset: int = 0,
                     kv_valid: Optional[torch.Tensor] = None, rows=None,
                     device=None, batch: Optional[int] = None
                     ) -> Optional[torch.Tensor]:
    """The keys a query row does not see, as a bool mask (B or 1, 1, R, T)
    over query rows ``rows`` (default 0..S-1) and keys 0..T-1, or None
    where every row sees every key.  ``batch``, where given, is the B
    that ``kv_valid`` must have.

    Row i of batch b sees key j iff j < kv_len[b] (:func:`key_lengths`)
    and, under ``causal``, j <= i + q_offset: the reference's
    ``chunked_attention`` mask with q_offset = T - S
    (``repro/models/layers.py:126-132``); q_offset = 0 is the TPU
    kernel's."""
    b = batch if batch is not None else (
        1 if kv_valid is None else kv_valid.shape[0])
    kv_len = key_lengths(kv_valid, b, t, device)
    if not causal and kv_len is None:
        return None
    rows = torch.arange(s, device=device) if rows is None else rows
    cols = torch.arange(t, device=device)
    hidden = torch.zeros((1, 1, rows.numel(), t), dtype=torch.bool,
                         device=device)
    if causal:
        hidden = hidden | (cols[None, :] > rows[:, None] + q_offset)
    if kv_len is not None:
        hidden = hidden | (cols[None, None, None, :]
                           >= kv_len[:, None, None, None])
    return hidden


def may_hide_rows(causal: bool, q_offset: int,
                  kv_valid: Optional[torch.Tensor]) -> bool:
    """Whether some query row can see no key: a key bound (which may be
    0), or a causal offset below 0 (rows before the first key)."""
    return kv_valid is not None or (causal and q_offset < 0)


def _masked_softmax(logits: torch.Tensor, hidden: Optional[torch.Tensor],
                    empty_rows: bool) -> torch.Tensor:
    """softmax over the last axis, in place, with the ``hidden`` keys at
    weight 0; with ``empty_rows`` a row that sees no key gets weight 0
    everywhere (the kernels write 0 for it), where softmax alone gives
    NaN."""
    if hidden is not None:
        logits.masked_fill_(hidden, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    if not empty_rows:
        return probs
    return probs.masked_fill_(hidden.all(-1, keepdim=True), 0.0)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = False, scale: Optional[float] = None,
                        q_offset: int = 0,
                        kv_valid: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Plain softmax attention: q (B, H, S, D), k (B, Hk, T, D), v (B, Hk,
    T, Dv) with H % Hk == 0 -> (B, H, S, Dv) in q's type.

    The reference's oracle (``repro/kernels/ref.py:126-136``) with the
    KV heads repeated (head h reads KV head h // (H / Hk)), computed in
    float32 throughout (float64 for float64 inputs, which gradient checks
    take) and rounded to q's type once, as the kernel does: the (B, H, S,
    T) logits are materialised.  Row i sees the keys of
    :func:`attention_hidden`: under ``causal`` keys 0..i + ``q_offset``
    (0: as the TPU kernel has it; T - S: the reference's
    ``chunked_attention``), and only keys below ``kv_valid[b]`` where it
    is given.  A row that sees no key is 0 (the reference's chunked
    computation gives sum(V) / T padded to its chunk there, a fault that
    depends on its tiling).
    """
    b, h, s, d = q.shape
    hk, t = k.shape[1], k.shape[2]
    acc = torch.promote_types(q.dtype, torch.float32)
    qf, kf, vf = q.to(acc), k.to(acc), v.to(acc)
    if h != hk:
        kf = kf.repeat_interleave(h // hk, dim=1)
        vf = vf.repeat_interleave(h // hk, dim=1)
    logits = torch.einsum("bhsd,bhtd->bhst", qf, kf)
    logits.mul_(d ** -0.5 if scale is None else scale)
    probs = _masked_softmax(logits, attention_hidden(
        s, t, causal, q_offset, kv_valid, device=q.device, batch=b),
        may_hide_rows(causal, q_offset, kv_valid))
    del logits
    return torch.einsum("bhst,bhtd->bhsd", probs, vf).to(q.dtype)


#: elements of one (B, H, rows, keys) block of the chunked backward: four
#: such float32 tensors (logits, weights, dP, dS) live at once, 2 GB
BWD_BLOCK_ELEMS = 1 << 27


def bwd_block_rows(b: int, h: int, s: int, t: int) -> int:
    """Query rows a block of :func:`flash_attention_bwd_ref`: the most
    that keep B * H * rows * T within ``BWD_BLOCK_ELEMS``, a multiple of
    64 when more than 64 fit, at least 1, at most S."""
    rows = max(1, BWD_BLOCK_ELEMS // max(1, b * h * t))
    if rows > 64:
        rows -= rows % 64
    return min(rows, s)


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, o: torch.Tensor,
                            do: torch.Tensor, causal: bool = False,
                            scale: Optional[float] = None, q_offset: int = 0,
                            kv_valid: Optional[torch.Tensor] = None):
    """Gradients (dq, dk, dv) of :func:`flash_attention_ref` at output
    ``o`` and output gradient ``do``, chunked over blocks of query rows.

    q (B, H, S, D), k (B, Hk, T, D), v (B, Hk, T, Dv), o and do (B, H, S,
    Dv) -> dq, dk, dv in the inputs' types.  Each block recomputes its
    logits S = q kᵀ · scale under the mask of :func:`attention_hidden`
    (a causal block reads only the keys up to its last row's diagonal,
    its last row + ``q_offset``), the weights P = softmax(S) in
    float32 (float64 for float64 inputs), then dV += Pᵀ dO, dP = dO Vᵀ,
    dS = P ∘ (dP − rowsum(dO ∘ O)), dQ = dS K · scale, dK += dSᵀ Q ·
    scale.  The query heads of a KV head (h // (H / Hk)) are summed into
    its dK and dV.  A row that sees no key has P = 0 and so no gradient,
    as its output is 0.  ``o`` is the forward's output as it was returned
    (from the tensor-core kernel, computed with P rounded to bf16), so in
    bf16 rowsum(dO ∘ O) carries that rounding beside the float32 P.

    This is the gradient ``jax.grad`` takes of the reference's chunked
    ``chunked_attention`` (the reference has no backward kernel), without
    the (B, H, S, T) logits that autograd through
    :func:`flash_attention_ref` would keep: a block holds B * H * rows *
    T elements (:func:`bwd_block_rows`).
    """
    b, h, s, d = q.shape
    hk, t, dv_dim = k.shape[1], k.shape[2], v.shape[-1]
    g = h // hk
    acc = torch.promote_types(q.dtype, torch.float32)
    scale = d ** -0.5 if scale is None else scale
    rows = bwd_block_rows(b, h, s, t)
    # (B, Hk, g, ., .): query head h = kv * g + j reads KV head kv
    qf = q.to(acc).reshape(b, hk, g, s, d)
    dof = do.to(acc).reshape(b, hk, g, s, dv_dim)
    delta = (dof * o.to(acc).reshape(b, hk, g, s, dv_dim)).sum(-1)
    kf, vf = k.to(acc), v.to(acc)
    empty_rows = may_hide_rows(causal, q_offset, kv_valid)
    dq = torch.zeros_like(qf)
    dk = torch.zeros((b, hk, t, d), dtype=acc, device=q.device)
    dv = torch.zeros((b, hk, t, dv_dim), dtype=acc, device=q.device)
    for r0 in range(0, s, rows):
        r1 = min(s, r0 + rows)
        # keys any row here sees
        tk = max(0, min(t, r1 + q_offset)) if causal else t
        if tk == 0:
            continue
        q_b, do_b = qf[:, :, :, r0:r1], dof[:, :, :, r0:r1]
        k_b, v_b = kf[:, :, :tk], vf[:, :, :tk]
        logits = torch.einsum("bkgsd,bktd->bkgst", q_b, k_b).mul_(scale)
        hidden = attention_hidden(
            r1 - r0, tk, causal, q_offset, kv_valid,
            rows=torch.arange(r0, r1, device=q.device), device=q.device,
            batch=b)
        p = _masked_softmax(logits, None if hidden is None
                            else hidden[:, :, None], empty_rows)
        del logits
        dv[:, :, :tk] += torch.einsum("bkgst,bkgsd->bktd", p, do_b)
        dp = torch.einsum("bkgsd,bktd->bkgst", do_b, v_b)
        ds = dp.sub_(delta[:, :, :, r0:r1, None]).mul_(p)
        del p
        dq[:, :, :, r0:r1] = torch.einsum("bkgst,bktd->bkgsd", ds,
                                          k_b).mul_(scale)
        dk[:, :, :tk] += torch.einsum("bkgst,bkgsd->bktd", ds,
                                      q_b).mul_(scale)
        del ds
    return (dq.reshape(b, h, s, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def simt_tiling(d: int):
    """(DQ, MR, WR) of the CUDA-core flash kernel at head dim ``d``, the
    larger of the Q/K and the V head dims (at most 192): the width of its
    Q and K tiles, ``d`` rounded up to a multiple of 32, and the query rows
    a thread and a warp (``simt::Cfg<DQ, DV>`` in
    ``csrc/flash_attention.cu``; its V tile is min(DQ, 128) wide)."""
    if not 1 <= d <= 192:
        raise ValueError(f"the CUDA-core flash kernel takes head dims up to "
                         f"192, got {d}")
    dp = 32 * max(1, -(-d // 32))
    return dp, 4, 16


def flash_attention_simt_ref(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, causal: bool = False,
                             scale: Optional[float] = None, q_offset: int = 0,
                             kv_valid: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """The CUDA-core kernel's schedule, step for step, in plain torch
    (same arguments as :func:`flash_attention_ref`), in float32.

    Blocks of 64 query rows, warps of WR = 16 rows, 64-key tiles in 8
    groups of 8; Q scaled by scale * log2(e) once; per warp and tile the same
    choices as the kernel: tiles past the warp's keys not visited, on the
    tile that crosses its causal diagonal the WR-key sub-blocks past it
    skipped and, on the diagonal sub-block, only the (row group i, key
    group jj) pairs with 8 jj <= 4 i + 3 computed (``active``); the P.V
    product reads P only from row group ``2 jj`` on.  The warp's diagonal
    is key wq0 + ``q_offset`` and its keys end at kv_len[b]; the sub-block
    skips apply only where ``q_offset`` is a multiple of WR (any other
    offset computes every visited tile whole).  The weights of the
    pairs the logits skipped are NaN here (the kernel's are 0, masked by
    causality), so a P.V product that read one, or a skip that dropped a
    key some row sees, shows in the output.  Each lane (key mod 8) keeps
    its own partial row sum; they add at the end.  A row that sees no key
    sums to 0 and comes out 0.
    """
    if kv_valid is not None:        # a block's key bound: one batch a call
        kv_len = key_lengths(kv_valid, q.shape[0], k.shape[2], "cpu")
        return torch.cat([_simt_ref(q[i:i + 1], k[i:i + 1], v[i:i + 1],
                                    causal, scale, q_offset, int(kv_len[i]))
                          for i in range(q.shape[0])])
    return _simt_ref(q, k, v, causal, scale, q_offset, k.shape[2])


def _simt_ref(q, k, v, causal, scale, off, kv_len):
    b, h, s, d = q.shape
    hk, t, dv = k.shape[1], k.shape[2], v.shape[3]
    g = h // hk
    _, mr, wr = simt_tiling(max(d, dv))
    gps, bm, bn = wr // 8, 64, 64
    c = (d ** -0.5 if scale is None else scale) * math.log2(math.e)
    qf = q.float() * c
    kf = k.float().repeat_interleave(g, 1)
    vf = v.float().repeat_interleave(g, 1)
    dev = q.device
    out = torch.zeros((b, h, s, dv), device=dev)

    def active(tri, i, j):          # (rows of i, keys of j) broadcast
        if tri < 0:
            return torch.ones(torch.broadcast_shapes(i.shape, j.shape),
                              dtype=torch.bool, device=dev)
        sb, jj = j // gps, j - tri * gps
        return (sb < tri) | ((sb == tri) & (8 * jj <= 4 * i + 3))

    aligned = off % wr == 0
    for q0 in range(0, s, bm):
        kv_end = max(0, min(kv_len, q0 + bm + off)) if causal else kv_len
        ntiles = -(-kv_end // bn)
        for wq0 in range(q0, q0 + bm, wr):
            dq = wq0 + off
            w_end = (0 if wq0 >= s else max(0, min(kv_len, dq + wr))
                     if causal else kv_len)
            rows = torch.arange(wq0, wq0 + wr, device=dev)
            qw = torch.zeros((b, h, wr, d), device=dev)
            qw[:, :, :max(0, min(wr, s - wq0))] = qf[:, :, wq0:wq0 + wr]
            m = torch.full((b, h, wr), -1e30, device=dev)
            lanes = torch.zeros((b, h, wr, 8), device=dev)
            acc = torch.zeros((b, h, wr, dv), device=dev)
            i_of = (torch.arange(wr, device=dev) // 4)[:, None]
            for k0 in range(0, ntiles * bn, bn):
                if k0 >= w_end:
                    continue
                tri = ((dq - k0) // wr
                       if causal and aligned and k0 + bn - 1 > dq else -1)
                jn = 8 if tri < 0 else (tri + 1) * gps
                keys = torch.arange(k0, k0 + 8 * jn, device=dev)
                j_of = (torch.arange(8 * jn, device=dev) // 8)[None, :]
                kt = torch.zeros((b, h, 8 * jn, d), device=dev)
                vt = torch.zeros((b, h, 8 * jn, dv), device=dev)
                n_in = max(0, min(8 * jn, t - k0))
                kt[:, :, :n_in] = kf[:, :, k0:k0 + n_in]
                vt[:, :, :n_in] = vf[:, :, k0:k0 + n_in]
                act = active(tri, i_of, j_of)
                ok = act & (keys < kv_len)[None, :]
                if causal:
                    ok &= keys[None, :] <= rows[:, None] + off
                x = torch.einsum("bhrd,bhkd->bhrk", qw, kt)
                x = torch.where(ok, x, -math.inf)
                mx = torch.maximum(m, x.amax(-1).clamp_min(-1e30))
                corr = torch.exp2(m - mx)
                p = torch.exp2(x - mx[..., None])
                m = mx
                lanes = lanes * corr[..., None] + p.reshape(
                    b, h, wr, jn, 8).sum(3)
                p_smem = torch.where(act, p, math.nan)
                imin = torch.where(
                    (j_of < tri * gps) | (tri < 0), 0, 2 * (j_of - tri * gps))
                p_read = torch.where(i_of >= imin, p_smem, 0.0)
                acc = acc * corr[..., None] + p_read @ vt
            n_out = max(0, min(wr, s - wq0))
            denom = lanes.sum(-1).clamp_min(1e-30)[..., None]
            out[:, :, wq0:wq0 + n_out] = (acc / denom)[:, :, :n_out]
    return out


class TcRef(NamedTuple):
    """What :func:`flash_attention_tc_ref` returns."""
    out: torch.Tensor      # (B, H, S, Dv) in q's type
    abs_out: torch.Tensor  # sum_j w_j |v_j| under the softmax weights w
    spread: torch.Tensor   # how far the kernel's rounded weights may move


def flash_attention_tc_ref(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, causal: bool = False,
                           scale: Optional[float] = None, q_offset: int = 0,
                           kv_valid: Optional[torch.Tensor] = None) -> TcRef:
    """The tensor-core kernel's arithmetic, step for step, in plain torch
    (same arguments as :func:`flash_attention_ref`).

    Key tiles as wide as the kernel's (128 keys where both head dims are
    at most 64, else 64: ``Cfg<DQ, DV>::BN`` in
    ``csrc/flash_attention.cu``), a running max in
    log2 units, p = exp2(x - m) rounded to v's type before P.V (bf16, as
    the reference rounds its weights, ``repro/kernels/ref.py:136``),
    float32 accumulation, l summed from the unrounded p and 1/l applied
    once at the end; the keys each row sees are :func:`attention_hidden`'s
    (tiles past a block's last key are not visited in the kernel; here
    they are, fully masked, which adds exact zeros), and a row that sees
    no key comes out 0.  Float32 inputs give the unrounded recurrence.

    Besides the output it returns, per output element and in float32,
    what :func:`flash_attention.error_bound` holds the kernel to against
    it: ``abs_out``, the same weights applied to |v|; and ``spread``.
    The kernel computes its p in another order, within ``REORDER`` of
    these (relative), so where a p lies that near a rounding boundary its
    bf16 value may be the next one.  Rounding is monotone, so it lies
    between the roundings of p (1 - REORDER) and p (1 + REORDER);
    ``spread`` sums that width times |v_j| / l.
    """
    b, h, s, d = q.shape
    t, dv, dev = k.shape[2], v.shape[3], q.device
    bn = 128 if max(d, dv) <= 64 else 64
    g = h // k.shape[1]
    qf = q.float()
    kf = k.float().repeat_interleave(g, 1)
    vf = v.float().repeat_interleave(g, 1)
    va = vf.abs()
    c = (d ** -0.5 if scale is None else scale) * math.log2(math.e)
    m = torch.full((b, h, s, 1), -math.inf, device=dev)
    l = torch.zeros((b, h, s, 1), device=dev)
    acc, mag, spread = (torch.zeros((b, h, s, dv), device=dev)
                        for _ in range(3))
    rows = torch.arange(s, device=dev)[:, None]
    kv_len = key_lengths(kv_valid, b, t, dev)
    for k0 in range(0, t, bn):
        x = torch.einsum("bhsd,bhtd->bhst", qf, kf[:, :, k0:k0 + bn]) * c
        cols = torch.arange(k0, min(k0 + bn, t), device=dev)[None, :]
        if causal:
            x.masked_fill_(cols > rows + q_offset, -math.inf)
        if kv_len is not None:
            x.masked_fill_(cols[None, None] >= kv_len[:, None, None, None],
                           -math.inf)
        mx = torch.maximum(m, x.amax(-1, keepdim=True))
        mu = torch.where(mx == -math.inf, 0.0, mx)
        corr = torch.exp2(m - mu)
        p = torch.exp2(x - mu)
        l = l * corr + p.sum(-1, keepdim=True)
        vt, at = vf[:, :, k0:k0 + bn], va[:, :, k0:k0 + bn]
        acc = acc * corr + p.to(v.dtype).float() @ vt
        mag = mag * corr + p @ at
        width = ((p * (1 + REORDER)).to(v.dtype).float()
                 - (p * (1 - REORDER)).to(v.dtype).float())
        spread = spread * corr + width @ at
        m = mx
    l = l.clamp_min(1e-30)
    return TcRef((acc / l).to(q.dtype), mag / l, spread / l)

"""Rolling sketch and window signatures of one long stream (counterpart
of ``repro.subseq.rolling``; DESIGN.md §10).

A subsequence index encodes every sliding window (length L, hop h) of a
stream.  Encoding each window on its own repeats work that overlapping
windows share; the rolling encode shares it:

* **sketch** — the projection at stream position p, <x[p:p+W], f>, does
  not depend on the window that reads it: window j's i-th tap reads
  position j·h + i·δ.  Every tap lies on the stride-g grid, g =
  gcd(h, δ), so one ``sketch_conv`` launch over the stream at stride g
  (``ops.sketch_bits_stream``) holds every window's bits, and window j's
  bit-profile is a strided view of that grid.  Each projection contracts
  the same operand values in the same order as the per-window call, so
  the bits are the per-window bits.
* **shingle ids** — when h % δ == 0 every window lies on one stride-δ
  bit grid: n-gram packing runs once over the stream's bits
  (:func:`global_shingle_ids`) and window j's ids are the columns
  [j·h/δ, j·h/δ + S).  Neighbours share all but h/δ of them, the
  delta-histogram invariant that :func:`delta_histograms` (a plain loop
  of scatter-adds, the tests' reference) checks.  At other hops each
  window's bits are packed on their own.
* **CWS** — over each window's S = N_B − n + 1 active shingles only
  (``core.minhash.cws_hash_active``, equal to the dense ``cws_hash``),
  never over the 2^n-bin histogram.

Windows go through the hash stage a chunk at a time, so no (windows,
N_B) index grid or gathered bit block of the whole stream is ever made
(at the paper's 20,971,520 windows and N_B = 145 they would be 24.3 and
3.0 GB).  The result is the same for every chunk size.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import shingle
from repro_torch.encoders.pipeline import (GaussianFilterSketcher,
                                           PipelineEncoder, SSHEncoder)
from repro_torch.kernels import ops

#: windows a chunk on the plain ``"ssh"`` path: bounds the (K, chunk, S)
#: CWS temporaries (about 2.7 GB at K = 40, S = 131)
SPARSE_CHUNK = 16384
#: windows a chunk for the other encoders (``encode_chunked``'s batch)
DENSE_CHUNK = 4096


def num_windows(stream_len: int, length: int, hop: int) -> int:
    """Sliding-window count: 0 when the stream is shorter than one
    window, else (n − L)//h + 1."""
    if length < 1 or hop < 1:
        raise ValueError(f"length and hop must be >= 1, got length="
                         f"{length}, hop={hop}")
    if stream_len < length:
        return 0
    return (stream_len - length) // hop + 1


def _check_stream(stream: torch.Tensor, length: int, hop: int,
                  w: int) -> int:
    """The window count of a valid 1-D stream, else ValueError."""
    if stream.dim() != 1:
        raise ValueError(f"stream must be 1-D, got shape "
                         f"{tuple(stream.shape)}")
    if length < w:
        raise ValueError(f"window length {length} < filter width {w}")
    nw = num_windows(int(stream.shape[0]), length, hop)
    if nw == 0:
        raise ValueError(
            f"stream of {int(stream.shape[0])} points holds no window of "
            f"length {length}")
    return nw


def _window_bits(stream: torch.Tensor, filters: torch.Tensor, step: int,
                 length: int, hop: int, nw: int) -> torch.Tensor:
    """(nw, N_B, F) bit-profiles of every window as a strided view of
    the one stride-gcd(h, δ) sketch of the stream (no copy)."""
    w, f = filters.shape
    n_b = (length - w) // step + 1
    g = math.gcd(hop, step)
    gbits = ops.sketch_bits_stream(stream, filters, g)      # (P, F)
    # window j's tap i sits at grid column (j·h + i·δ)/g; the last
    # window's last tap is at most n − W, inside the grid
    return gbits.as_strided((nw, n_b, f), ((hop // g) * f, (step // g) * f,
                                           1))


def rolling_sketch_bits(stream: torch.Tensor, filters: torch.Tensor,
                        step: int, length: int, hop: int) -> torch.Tensor:
    """Bit-profiles of every sliding window from one shared projection:
    stream (n,), filters (W, F) -> (num_windows, N_B, F) uint8, N_B =
    (L − W)//δ + 1, equal to ``ops.sketch_bits`` of the materialised
    windows.  The result is a strided view of the shared grid."""
    nw = _check_stream(stream, length, hop, int(filters.shape[0]))
    return _window_bits(stream, filters, step, length, hop, nw)


def global_shingle_ids(gbits: torch.Tensor, ngram: int) -> torch.Tensor:
    """Offset n-gram ids of the stream's bit string: gbits (P, F) ->
    (F, P − n + 1) int64; filter f's id at column i is
    ``pack(bits[i:i+n, f]) + (f << n)``, the flat bin that
    ``shingle_histogram`` counts.  Aligned windows (h % δ == 0) are
    column slices of it."""
    ids = shingle.pack_ngrams(gbits.t(), ngram).to(torch.int64)
    offs = torch.arange(gbits.shape[1], device=gbits.device) << ngram
    return ids + offs[:, None]


def delta_histograms(global_ids: torch.Tensor, s: int, shift: int,
                     nw: int, dim: int) -> torch.Tensor:
    """Histograms of aligned windows, computed incrementally: window j
    covers columns [j·shift, j·shift + s) of ``global_ids`` (F, P'), and
    its histogram is window j−1's minus the ``shift`` columns that leave
    plus the ``shift`` that enter.  (nw, dim) int32.  The tests' check of
    the invariant the aligned path rests on; no encode builds dense
    histograms (use a small ``dim``)."""
    def add(hist, cols, sign):
        flat = cols.reshape(-1)
        hist.index_add_(0, flat, torch.full_like(flat, sign,
                                                 dtype=torch.int32))

    hist = torch.zeros(dim, dtype=torch.int32, device=global_ids.device)
    add(hist, global_ids[:, :s], 1)
    out = [hist.clone()]
    for j in range(1, nw):
        lo = (j - 1) * shift
        add(hist, global_ids[:, lo:lo + shift], -1)
        add(hist, global_ids[:, lo + s:lo + s + shift], 1)
        out.append(hist.clone())
    return torch.stack(out)


def _check_encoder(encoder) -> None:
    """``repro/subseq/rolling.py:213-221``: the sketch must be a strided
    filter bank (the ``"ssh"`` family); ``"srp"`` is refused."""
    if not isinstance(encoder, PipelineEncoder) \
            or not isinstance(encoder.sketcher, GaussianFilterSketcher):
        raise ValueError(
            "subsequence indexing requires a strided-filter sketch "
            "encoder (PipelineEncoder with a GaussianFilterSketcher); "
            f"got {type(encoder).__name__}")
    if not encoder.materialized:
        raise ValueError("encoder is not materialized")


def rolling_signatures(stream, encoder, length: int, hop: int, *,
                       backend: str = "auto",
                       chunk: int = SPARSE_CHUNK) -> torch.Tensor:
    """Signatures of every sliding window of ``stream``, (num_windows, K)
    int32 on the encoder's device, equal to ``encoder.encode_batch`` of
    the materialised windows.

    Routes: the plain ``"ssh"`` encoder at an aligned hop (h % δ == 0)
    slices the stream's global shingle ids; at other hops, and for the
    other encoders (``"ssh-multires"``, ``"ssh-cs"``), each chunk of
    windows takes its bits from the shared sketch grid and hashes them
    through the encoder's own shingle and hash stages
    (``PipelineEncoder.encode_bits``).  ``backend`` is checked against
    the encoder's device (``Encoder.check_backend``), which picks the
    route.
    """
    _check_encoder(encoder)
    encoder.check_backend(backend)
    state = encoder.state()
    filters = state["filters"]
    stream = torch.as_tensor(stream, dtype=torch.float32).to(filters.device)
    step, w = encoder.step, encoder.window
    nw = _check_stream(stream, length, hop, w)
    n_b = (length - w) // step + 1
    if n_b < encoder.min_bits:
        raise ValueError(
            f"window length {length} yields only {n_b} sketch bits — "
            f"fewer than the shingle length {encoder.min_bits}")
    out = torch.empty((nw, encoder.num_hashes), dtype=torch.int32,
                      device=stream.device)
    if type(encoder) is SSHEncoder and hop % step == 0:
        # aligned: sketch and n-gram packing once over the stream; window
        # j is the column slice [j·h/δ, j·h/δ + S) of the global ids
        ngram = encoder.ngram
        s = n_b - ngram + 1
        gids = global_shingle_ids(
            ops.sketch_bits_stream(stream, filters, step), ngram)
        f, p = gids.shape
        wins = gids.as_strided((nw, f, s), ((hop // step), p, 1))
        for lo in range(0, nw, chunk):
            ids = wins[lo:lo + chunk].reshape(-1, f * s)
            out[lo:lo + chunk] = encoder.hasher.hash_ids(ids, state)
        return out
    if type(encoder) is not SSHEncoder:
        chunk = min(chunk, DENSE_CHUNK)
    bits = _window_bits(stream, filters, step, length, hop, nw)
    for lo in range(0, nw, chunk):
        out[lo:lo + chunk] = encoder.encode_bits(bits[lo:lo + chunk])
    return out

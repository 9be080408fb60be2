"""The database and the queries of a cell, made from ``--seed``.

The paper's database (arXiv:1610.07328 §5.1) is every z-normalised
subsequence of one long stream at stride 1.  The real ECG and
random-walk series are not in the repository, so the stream is
generated with their statistics (copied from
``repro_torch.data.timeseries``, which the benchmark does not import):
``synthetic_ecg``, a PQRST template with beat-rate and amplitude jitter,
baseline wander and sensor noise, and ``random_walk``.

The stream holds the database's ``N + m - 1`` points and, after them, a
held-out stretch that no database row covers.  The windows are made on
the card from the uploaded stream; the same tensor goes to the program
and to the reference.  A query pool holds distinct rows: half warped
copies of database rows (shift, stretch, noise), half windows of the
held-out stretch, shuffled; every row is z-normalised.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

#: float64 elements a chunk of the windowing pass (256 MB)
_CHUNK_ELEMS = 1 << 25


def random_walk(n_points: int, seed: int, scale: float = 1.0
                ) -> np.ndarray:
    """x_t = x_{t-1} + N(0, scale^2), float32."""
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.normal(0.0, scale, n_points)).astype(np.float32)


def _pqrst_beat(t: np.ndarray) -> np.ndarray:
    """One heartbeat on t in [0, 1): P, Q, R, S, T Gaussian bumps, widths
    of physiological durations at 250 Hz."""
    centers = np.array([0.18, 0.36, 0.40, 0.44, 0.70])
    widths = np.array([0.060, 0.022, 0.030, 0.022, 0.080])
    amps = np.array([0.15, -0.18, 1.20, -0.25, 0.30])
    out = np.zeros_like(t)
    for c, w, a in zip(centers, widths, amps):
        out += a * np.exp(-0.5 * ((t - c) / w) ** 2)
    return out


def synthetic_ecg(n_points: int, seed: int, hz: int = 250,
                  bpm: float = 72.0, noise: float = 0.03) -> np.ndarray:
    """ECG-like stream: jittered beats, baseline wander (respiration at
    0.25 Hz) and white sensor noise, float32."""
    rng = np.random.default_rng(seed)
    out = np.zeros(n_points, np.float32)
    samples_per_beat = int(hz * 60.0 / bpm)
    beats: Dict[int, np.ndarray] = {}
    pos = 0
    while pos < n_points:
        jitter = rng.normal(1.0, 0.05)
        amp = rng.normal(1.0, 0.08)
        nb = max(16, int(samples_per_beat * jitter))
        if nb not in beats:
            beats[nb] = _pqrst_beat(np.arange(nb) / nb)
        end = min(pos + nb, n_points)
        out[pos:end] += (amp * beats[nb][: end - pos]).astype(np.float32)
        pos += nb
    tt = np.arange(n_points) / hz
    out += 0.08 * np.sin(2 * np.pi * 0.25 * tt).astype(np.float32)
    out += rng.normal(0.0, noise, n_points).astype(np.float32)
    return out


def make_stream(config: Dict, n_points: int, seed: int) -> np.ndarray:
    s = config["stream"]
    if s["kind"] == "ecg":
        return synthetic_ecg(n_points, seed, hz=int(s["hz"]),
                             bpm=float(s["bpm"]), noise=float(s["noise"]))
    if s["kind"] == "randomwalk":
        return random_walk(n_points, seed, scale=float(s["scale"]))
    raise ValueError(f"unknown stream kind {s['kind']!r}")


def znorm_rows(x: torch.Tensor) -> torch.Tensor:
    """(R, m) -> (R, m) float32: (x - mean) / (population std + 1e-8),
    the moments taken in float64."""
    x64 = x.to(torch.float64)
    mu = x64.mean(1, keepdim=True)
    sd = x64.std(1, correction=0, keepdim=True)
    return ((x64 - mu) / (sd + 1e-8)).to(torch.float32)


def windows(stream: torch.Tensor, m: int, n: int, start: int = 0,
            stride: int = 1, out: Optional[torch.Tensor] = None
            ) -> torch.Tensor:
    """The ``n`` z-normalised windows of length ``m`` of a 1-D stream
    starting at ``start`` and ``stride`` apart, (n, m) float32 on the
    stream's device, made in chunks."""
    view = stream[start:].unfold(0, m, stride)
    if view.shape[0] < n:
        raise ValueError(f"the stream holds {view.shape[0]} windows, "
                         f"not {n}")
    if out is None:
        out = torch.empty((n, m), dtype=torch.float32, device=stream.device)
    chunk = max(1, _CHUNK_ELEMS // m)
    for lo in range(0, n, chunk):
        hi = min(n, lo + chunk)
        out[lo:hi] = znorm_rows(view[lo:hi])
    return out


def warped(rows: torch.Tensor, shifts: torch.Tensor, stretch: float,
           noise: float, generator: torch.Generator) -> torch.Tensor:
    """Warped copies: each row read at ``arange(m) * stretch + shift``
    (linear interpolation, clamped to the row), plus Gaussian noise of
    standard deviation ``noise``, then z-normalised.  rows (R, m),
    shifts (R,) -> (R, m) float32."""
    r, m = rows.shape
    src = (torch.arange(m, device=rows.device, dtype=torch.float64)[None, :]
           * stretch + shifts.to(torch.float64)[:, None]).clamp(0, m - 1)
    lo = src.floor().long()
    hi = (lo + 1).clamp(max=m - 1)
    frac = src - lo
    x = rows.to(torch.float64)
    out = x.gather(1, lo) * (1 - frac) + x.gather(1, hi) * frac
    out = out + noise * torch.randn((r, m), generator=generator,
                                    dtype=torch.float64, device=rows.device)
    return znorm_rows(out)


@dataclasses.dataclass
class Pool:
    """Host query rows in the order they are sent, warm-up rows apart,
    and the map from a row's leading bytes to its position."""
    rows: np.ndarray          # (P, m) float32, sent in order
    warm: np.ndarray          # (W, m) float32, set-up only
    prefix: Dict[bytes, int]  # leading PREFIX bytes of a row -> its index

    PREFIX = 32

    def key(self, row_bytes: bytes) -> Optional[int]:
        return self.prefix.get(row_bytes[:self.PREFIX])


def query_pool(db_windows: torch.Tensor, heldout: torch.Tensor,
               traffic: Dict, n_rows: int, n_warm: int, seed: int) -> Pool:
    """``n_rows + n_warm`` distinct queries: half warped copies of
    database rows drawn without replacement, half windows of the held-out
    stretch ``heldout_stride`` apart; shuffled, then the last ``n_warm``
    set apart for warm-up."""
    p = traffic["pool"]
    total = n_rows + n_warm
    n_warp = total // 2
    n_held = total - n_warp
    m = db_windows.shape[1]
    rng = np.random.default_rng([seed, 1])
    src = rng.choice(db_windows.shape[0], size=n_warp, replace=False)
    lo_s, hi_s = p["warp_shift"]
    shifts = torch.from_numpy(rng.integers(lo_s, hi_s + 1, size=n_warp))
    gen = torch.Generator(device=db_windows.device).manual_seed(
        int(rng.integers(0, 2 ** 62)))
    dev = db_windows.device
    parts = []
    chunk = max(1, _CHUNK_ELEMS // m)
    for lo in range(0, n_warp, chunk):
        idx = torch.from_numpy(src[lo:lo + chunk]).to(dev)
        parts.append(warped(db_windows[idx], shifts[lo:lo + chunk].to(dev),
                            float(p["warp_stretch"]), float(p["warp_noise"]),
                            gen))
    parts.append(windows(heldout, m, n_held,
                         stride=int(p["heldout_stride"])))
    qs = torch.cat(parts).cpu().numpy()
    qs = qs[rng.permutation(total)]
    qs = np.ascontiguousarray(qs)
    prefix = {}
    for i, row in enumerate(qs[:n_rows]):
        prefix[row.tobytes()[:Pool.PREFIX]] = i
    if len(prefix) != n_rows:
        raise RuntimeError("two query rows share their leading bytes; the "
                           "recorder could not tell them apart")
    return Pool(rows=qs[:n_rows], warm=qs[n_rows:], prefix=prefix)


def heldout_points(traffic: Dict, n_rows: int, n_warm: int, m: int) -> int:
    """Points of the held-out stretch that :func:`query_pool` reads."""
    n_held = (n_rows + n_warm) - (n_rows + n_warm) // 2
    return (n_held - 1) * int(traffic["pool"]["heldout_stride"]) + m

"""Time-series data pipeline (paper §5.1), counterpart of
``repro.data.timeseries`` (numpy only, same values).

The paper evaluates on two public series — 22h of ECG (20.14M points) and
a random-walk benchmark — sliced into overlapping subsequences
S_i = (s_i, ..., s_{i+t-1}).  The originals are not redistributable here,
so we generate series with matching statistics:

* random_walk  — x_t = x_{t-1} + N(0,1): the standard benchmark generator
  (identical in distribution to the published one).
* synthetic_ecg — sum-of-Gaussians PQRST template with beat-rate and
  amplitude jitter + baseline wander (McSharry-style dynamical ECG,
  simplified), which reproduces the quasi-periodic motif structure that
  makes SSH's alignment property matter.

Subsequence extraction is stride-able so a 20M-point stream becomes the
paper's ~20M-subsequence database (stride 1) or a deduplicated database
(stride t) for container-scale tests.
"""
from __future__ import annotations

from typing import Optional

import numpy as np


def random_walk(n_points: int, seed: int = 0, scale: float = 1.0
                ) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.normal(0.0, scale, n_points)).astype(np.float32)


def _pqrst_beat(t: np.ndarray) -> np.ndarray:
    """One heartbeat on t ∈ [0,1): P, Q, R, S, T Gaussian bumps."""
    # widths follow physiological durations at 250 Hz (QRS ≈ 0.1 s ≈ 10
    # samples) — narrower spikes alias under the stride-δ sketch grid.
    centers = np.array([0.18, 0.36, 0.40, 0.44, 0.70])
    widths = np.array([0.060, 0.022, 0.030, 0.022, 0.080])
    amps = np.array([0.15, -0.18, 1.20, -0.25, 0.30])
    out = np.zeros_like(t)
    for c, w, a in zip(centers, widths, amps):
        out += a * np.exp(-0.5 * ((t - c) / w) ** 2)
    return out


def synthetic_ecg(n_points: int, seed: int = 0, hz: int = 250,
                  bpm: float = 72.0, noise: float = 0.03) -> np.ndarray:
    """ECG-like stream: jittered beats + baseline wander + sensor noise."""
    rng = np.random.default_rng(seed)
    out = np.zeros(n_points, np.float32)
    samples_per_beat = int(hz * 60.0 / bpm)
    pos = 0
    while pos < n_points:
        jitter = rng.normal(1.0, 0.05)
        amp = rng.normal(1.0, 0.08)
        nb = max(16, int(samples_per_beat * jitter))
        t = np.arange(nb) / nb
        seg = amp * _pqrst_beat(t)
        end = min(pos + nb, n_points)
        out[pos:end] += seg[: end - pos].astype(np.float32)
        pos += nb
    # baseline wander (respiration ~0.25 Hz) + white noise
    tt = np.arange(n_points) / hz
    out += 0.08 * np.sin(2 * np.pi * 0.25 * tt).astype(np.float32)
    out += rng.normal(0.0, noise, n_points).astype(np.float32)
    return out


def extract_subsequences(stream: np.ndarray, length: int,
                         stride: int = 1, max_count: Optional[int] = None,
                         znorm: bool = False) -> np.ndarray:
    """D = {S_i} sliding windows (paper §5.1). -> (N, length) float32."""
    n = (len(stream) - length) // stride + 1
    if max_count is not None:
        n = min(n, max_count)
    # a strided view instead of an (n, length) index array: the same
    # values without the index array's memory at millions of series
    windows = np.lib.stride_tricks.sliding_window_view(stream, length)
    out = windows[::stride][:n].astype(np.float32)
    if znorm:
        mu = out.mean(axis=1, keepdims=True)
        sd = out.std(axis=1, keepdims=True) + 1e-8
        out = (out - mu) / sd
    return out


def warp_series(x: np.ndarray, shift: int = 0, stretch: float = 1.0,
                seed: int = 0, noise: float = 0.0) -> np.ndarray:
    """Apply the misalignments SSH must be invariant to (shift/warp/noise)."""
    rng = np.random.default_rng(seed)
    m = len(x)
    src = np.clip(np.arange(m) * stretch + shift, 0, m - 1)
    lo = np.floor(src).astype(int)
    hi = np.minimum(lo + 1, m - 1)
    frac = src - lo
    out = x[lo] * (1 - frac) + x[hi] * frac
    if noise > 0:
        out = out + rng.normal(0, noise, m)
    return out.astype(np.float32)


def make_benchmark_db(kind: str, n_series: int, length: int, seed: int = 0,
                      stride: Optional[int] = None) -> np.ndarray:
    """Container-scale stand-in for the paper's 20M-subsequence databases."""
    stride = stride if stride is not None else max(1, length // 8)
    n_points = n_series * stride + length
    if kind == "ecg":
        stream = synthetic_ecg(n_points, seed=seed)
    elif kind == "randomwalk":
        stream = random_walk(n_points, seed=seed)
    else:
        raise ValueError(f"unknown dataset kind: {kind}")
    return extract_subsequences(stream, length, stride=stride,
                                max_count=n_series)

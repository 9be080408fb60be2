"""Synthetic arrival processes for the load harness (counterpart of
``repro.loadgen.arrivals``; DESIGN.md §12).

Every generator maps ``(rate_qps, n, seed)`` to a sorted float64 array
of *absolute* arrival offsets in seconds from the start of the run —
fully determined by the seed, so a trace replays bit-identically across
engines, policies, and processes.  All processes are normalized to the
same mean rate: over a long trace, ``n / arrivals[-1] ≈ rate_qps``, so
an offered-load sweep compares like against like regardless of shape.

  poisson   — memoryless baseline: i.i.d. exponential inter-arrivals.
  mmpp      — bursty 2-state Markov-modulated Poisson process: dwell in
              a quiet state at rate r, jump to a burst state at
              ``burst_factor * r``, exponential dwell times; the state
              rates are chosen so the long-run mean is ``rate_qps``.
  diurnal   — slow sinusoidal ramp (a compressed day): nonhomogeneous
              Poisson via Lewis-Shedler thinning against the peak rate.
"""
from __future__ import annotations

import numpy as np


def _validate(rate_qps: float, n: int) -> None:
    if rate_qps <= 0:
        raise ValueError(f"rate_qps must be > 0, got {rate_qps}")
    if n < 1:
        raise ValueError(f"n must be >= 1, got {n}")


def poisson_arrivals(rate_qps: float, n: int, seed: int = 0) -> np.ndarray:
    """Homogeneous Poisson: exponential inter-arrivals at ``rate_qps``."""
    _validate(rate_qps, n)
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate_qps, size=n)
    return np.cumsum(gaps)


def mmpp_arrivals(rate_qps: float, n: int, seed: int = 0,
                  burst_factor: float = 4.0,
                  dwell_s: float = 0.25) -> np.ndarray:
    """2-state MMPP with equal expected dwell in quiet and burst states.

    With dwell times symmetric, each state carries probability 1/2, so
    the quiet rate solves ``(r + burst_factor * r) / 2 = rate_qps``.
    """
    _validate(rate_qps, n)
    if burst_factor < 1.0:
        raise ValueError(f"burst_factor must be >= 1, got {burst_factor}")
    rng = np.random.default_rng(seed)
    r_quiet = 2.0 * rate_qps / (1.0 + burst_factor)
    rates = (r_quiet, burst_factor * r_quiet)
    out = np.empty(n)
    t, state = 0.0, 0
    t_switch = rng.exponential(dwell_s)
    for k in range(n):
        gap = rng.exponential(1.0 / rates[state])
        # state switches between arrivals restart the residual gap —
        # exact for exponentials (memorylessness)
        while t + gap > t_switch:
            frac = (t_switch - t) / gap        # survive to the switch
            t = t_switch
            state = 1 - state
            t_switch = t + rng.exponential(dwell_s)
            gap = (1.0 - frac) * gap * rates[1 - state] / rates[state]
        t += gap
        out[k] = t
    return out


def diurnal_arrivals(rate_qps: float, n: int, seed: int = 0,
                     period_s: float = 20.0,
                     depth: float = 0.8) -> np.ndarray:
    """Sinusoidal ramp: rate(t) = rate_qps * (1 + depth·sin(2πt/T)).

    Lewis–Shedler thinning against the peak rate keeps the process an
    exact nonhomogeneous Poisson (mean rate ``rate_qps`` by symmetry).
    """
    _validate(rate_qps, n)
    if not 0.0 <= depth < 1.0:
        raise ValueError(f"depth must be in [0, 1), got {depth}")
    rng = np.random.default_rng(seed)
    peak = rate_qps * (1.0 + depth)
    out = np.empty(n)
    t, k = 0.0, 0
    while k < n:
        t += rng.exponential(1.0 / peak)
        rate_t = rate_qps * (1.0 + depth * np.sin(2 * np.pi * t / period_s))
        if rng.uniform() * peak <= rate_t:
            out[k] = t
            k += 1
    return out


ARRIVAL_PROCESSES = {
    "poisson": poisson_arrivals,
    "mmpp": mmpp_arrivals,
    "diurnal": diurnal_arrivals,
}


def make_arrivals(process: str, rate_qps: float, n: int, seed: int = 0,
                  **kwargs) -> np.ndarray:
    """Dispatch by process name (``ARRIVAL_PROCESSES`` keys)."""
    try:
        fn = ARRIVAL_PROCESSES[process]
    except KeyError:
        raise ValueError(
            f"unknown arrival process {process!r}; "
            f"choose from {sorted(ARRIVAL_PROCESSES)}") from None
    return fn(rate_qps, n, seed, **kwargs)

"""Device time of a call on the card, apart from its call time.

CUDA events around back-to-back Python calls (:func:`call_ms`) measure
the device only while it stays busy: when a call's host work (argument
checks, allocation, the ctypes launch) takes longer than its kernels,
the device idles between launches and the events read host dispatch.
:func:`device_ms` reads what the kernels themselves took, from
``torch.profiler``'s CUDA kernel, memcpy and memset records
(``self_device_time_total``), summed over a window of calls and divided
by their number; :func:`timed` gives both.  Where the profiler keeps no
device record at all (it has done so late in a process that profiled
many windows), :func:`spun_ms` reads the same device time from CUDA
events, with the stream held busy while the host dispatches.  All need
a CUDA GPU.
"""
from __future__ import annotations

import time
from typing import Callable, Dict

import numpy as np
import torch


def call_ms(fn: Callable, min_iters: int = 5, budget_ms: float = 300.0
            ) -> float:
    """Mean ms per call by CUDA events around back-to-back calls, after a
    warm-up, over enough calls to fill ``budget_ms``."""
    fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(True), torch.cuda.Event(True)
    t0.record()
    fn()
    t1.record()
    torch.cuda.synchronize()
    once = max(t0.elapsed_time(t1), 1e-3)
    iters = max(min_iters, min(200, int(budget_ms / once)))
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


#: profiled windows tried before reading a call's device time by events
WINDOWS = 3

#: spin cycles a millisecond (the H100's 1.98 GHz boost clock; a lower
#: clock only lengthens the spin, and :func:`spun_ms` measures it anyway)
SPIN_CYCLES_PER_MS = 1_980_000


def spun_ms(fn: Callable, calls: int = 20, doublings: int = 6) -> float:
    """Median device ms a call of ``fn`` by CUDA events, over ``calls``
    calls after a warm-up.

    Before each call a spin kernel (``torch.cuda._sleep``) holds the
    stream for longer than the call's host work, so every launch of the
    call is queued before the start event runs and the two events span
    only the call's device work and the gaps between its launches on
    the card.  A call whose host work outlasted its spin (read by an
    event before the spin) is run again with the spin doubled, at most
    ``doublings`` times; a call that still outlasts it (one that
    synchronises with the card) raises."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    host_ms = (time.perf_counter() - t) * 1e3
    torch.cuda.synchronize()
    spin = max(0.2, 4.0 * host_ms)
    ev = [torch.cuda.Event(True) for _ in range(3)]
    out = []
    while len(out) < calls:
        for _ in range(doublings + 1):
            torch.cuda.synchronize()
            ev[0].record()
            torch.cuda._sleep(int(spin * SPIN_CYCLES_PER_MS))
            ev[1].record()
            t = time.perf_counter()
            fn()
            ev[2].record()
            host_ms = (time.perf_counter() - t) * 1e3
            torch.cuda.synchronize()
            if host_ms < 0.8 * ev[0].elapsed_time(ev[1]):
                out.append(ev[1].elapsed_time(ev[2]))
                break
            spin *= 2.0
        else:
            raise RuntimeError(f"a call's host work ({host_ms:.3f} ms) "
                               f"outlasted a {spin / 2:.3f} ms spin: it "
                               f"synchronises with the card, and its "
                               f"device time cannot be read by events")
    return float(np.median(out))


def device_ms(fn: Callable, calls: int = 20) -> Dict[str, object]:
    """Device time a call of ``fn``: the kernels, copies and fills it ran
    on the card, as ``torch.profiler`` records them, over ``calls`` calls
    after a warm-up.

    Each kernel name's records are averaged, and the mean is counted
    ``round(records / calls)`` times a call (at least once): a window
    that lost records (``torch.profiler`` has dropped some of a few long
    launches late in a process that profiled many times) still gives
    each kernel's time a launch.  A window that kept no device record at
    all (seen late in ``chip_smoke.py``: at the 1 x 32,768 flash call,
    and at a DTW call after the engine phase) is profiled again, up to
    :data:`WINDOWS` windows; when every one came back empty, ``ms`` is
    :func:`spun_ms` over ``calls`` calls.  Returns ``ms`` (per call),
    ``source`` (``"profiler"`` or ``"events"``), ``launches`` (device
    operations a call; None by events), ``complete`` (every kernel
    recorded a whole number of times a call; None by events),
    ``windows`` (windows profiled, the last the one read: more than 1
    when an earlier one came back empty) and ``kernels`` ({name: ms a
    launch}; empty by events)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for windows in range(1, WINDOWS + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        dev = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
        if dev:
            break
    else:
        return dict(ms=spun_ms(fn, calls), source="events", launches=None,
                    complete=None, windows=WINDOWS, kernels={})
    each = {e.key[:80]: e.self_device_time_total / e.count / 1e3
            for e in dev}
    per_call = {e.key[:80]: max(1, round(e.count / calls)) for e in dev}
    return dict(ms=sum(each[k] * per_call[k] for k in each),
                source="profiler", launches=sum(per_call.values()),
                complete=all(e.count == per_call[e.key[:80]] * calls
                             for e in dev),
                windows=windows, kernels=each)


def timed(fn: Callable, min_iters: int = 5) -> Dict[str, float]:
    """``device_ms`` (profiler) and ``call_ms`` (events) of ``fn``; the
    profiled window holds about 100 ms of calls, 3 to 50 of them."""
    call = call_ms(fn, min_iters)
    dev = device_ms(fn, calls=max(3, min(50, int(100.0 / max(call, 1e-3)))))
    return dict(device_ms=dev["ms"], call_ms=call,
                device_launches=dev["launches"],
                device_complete=dev["complete"],
                device_windows=dev["windows"],
                device_source=dev["source"])

"""Device time of a call on the card, apart from its call time.

CUDA events around back-to-back Python calls (:func:`call_ms`) measure
the device only while it stays busy: when a call's host work (argument
checks, allocation, the ctypes launch) takes longer than its kernels,
the device idles between launches and the events read host dispatch.
:func:`device_ms` reads what the kernels themselves took, from
``torch.profiler``'s CUDA kernel, memcpy and memset records
(``self_device_time_total``), summed over a window of calls and divided
by their number; :func:`timed` gives both.  Both need a CUDA GPU.
"""
from __future__ import annotations

from typing import Callable, Dict

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


def device_ms(fn: Callable, calls: int = 20) -> Dict[str, object]:
    """Device time a call of ``fn``: the kernels, copies and fills it ran
    on the card, as ``torch.profiler`` records them, over ``calls`` calls
    after a warm-up.

    Each kernel name's records are averaged, and the mean is counted
    ``round(records / calls)`` times a call (at least once): a window
    that lost records (``torch.profiler`` has dropped some of a few long
    launches late in a process that profiled many times) still gives
    each kernel's time a launch.  Returns ``ms`` (per call),
    ``launches`` (device operations a call), ``complete`` (every kernel
    recorded a whole number of times a call) and ``kernels`` ({name: ms
    a launch}).  Raises if the profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA
           and e.self_device_time_total > 0]
    if not dev:
        raise RuntimeError("torch.profiler recorded no device time: the "
                           "device time of a call cannot be read")
    each = {e.key[:80]: e.self_device_time_total / e.count / 1e3
            for e in dev}
    per_call = {e.key[:80]: max(1, round(e.count / calls)) for e in dev}
    return dict(ms=sum(each[k] * per_call[k] for k in each),
                launches=sum(per_call.values()),
                complete=all(e.count == per_call[e.key[:80]] * calls
                             for e in dev),
                kernels=each)


def timed(fn: Callable, min_iters: int = 5) -> Dict[str, float]:
    """``device_ms`` (profiler) and ``call_ms`` (events) of ``fn``; the
    profiled window holds about 100 ms of calls, 3 to 50 of them."""
    call = call_ms(fn, min_iters)
    dev = device_ms(fn, calls=max(3, min(50, int(100.0 / max(call, 1e-3)))))
    return dict(device_ms=dev["ms"], call_ms=call,
                device_launches=dev["launches"],
                device_complete=dev["complete"])

"""Device time of a call on the card, apart from its call time.

CUDA events around back-to-back Python calls (:func:`call_ms`) measure
the device only while it stays busy: when a call's host work (argument
checks, allocation, the ctypes launch) takes longer than its kernels,
the device idles between launches and the events read host dispatch.
:func:`device_ms` reads what the kernels themselves took, from
``torch.profiler``'s CUDA kernel, memcpy and memset records
(``self_device_time_total``), summed over a window of calls and divided
by their number; :func:`timed` gives both.  Where the profiler keeps no
device record at all, :func:`spun_ms` reads the same device time from
CUDA events, with the stream held busy while the host dispatches.  All
need a CUDA GPU.

Every profiled window (:class:`Window`) leaves one entry in
:data:`CENSUS` (:func:`census_window`): the device records it kept of
each of the port's kernels against the launches their counters saw in
the same window.  The census showed what the profiler loses: the device
records of the first kernels launched in a window, more of them the
longer the process has run (none at first, 33 late in a run of
``chip_smoke.py``), whatever the kernels and however long the window; a
window of fewer launches kept nothing.  So every window opens with
:data:`LEAD_KERNELS` spin kernels (``torch.cuda._sleep``), whose records
take that loss and are left out of every sum (:attr:`Window.events`);
``lead_lost`` in the census counts how many of them went unrecorded.
The lead-in does not cover every window: one has still lost every
record, its lead-in's and its calls' alike, so :func:`device_ms`
profiles a window that kept nothing again and, after :data:`WINDOWS`
empty ones, reads the call by :func:`spun_ms`.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.bench import records
from repro_torch.kernels import ops

#: one dict a profiled window, in order (:func:`census_window`)
CENSUS: List[Dict[str, object]] = []
#: spin kernels each profiled window launches before its calls, more
#: than the profiler has been seen to drop at a window's start in all
#: but a few windows (33)
LEAD_KERNELS = 128
#: the device name of the lead-in's kernels
LEAD_NAME = "spin_kernel"
#: runtime calls that launch a kernel, as the profiler names them
_LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                 "cuLaunchKernelEx")


def _group_launches(counts: Dict[str, int]) -> Dict[str, int]:
    return {g: sum(counts.get(c, 0) for c in names)
            for g, names in records.PORT_COUNTERS.items()}


def lost_launch_positions(raw_events) -> List[int]:
    """Positions, in host order among a window's kernel-launch calls, of
    the calls whose kernel the profiler did not record (a launch call and
    its kernel share a correlation id).  ``raw_events``:
    ``prof.profiler.kineto_results.events()``."""
    cuda = torch.autograd.DeviceType.CUDA
    launches = sorted((e for e in raw_events if e.name() in _LAUNCH_CALLS),
                      key=lambda e: e.start_ns())
    kept = {e.correlation_id() for e in raw_events
            if e.device_type() == cuda}
    return [i for i, e in enumerate(launches)
            if e.correlation_id() not in kept]


def without_lead(events) -> list:
    """Profiler events without the lead-in's device records."""
    return [e for e in events
            if not (e.device_type == torch.autograd.DeviceType.CUDA
                    and LEAD_NAME in e.key)]


def census_window(label: str, events, launches_before: Dict[str, int],
                  launches_after: Dict[str, int], raw_events=None,
                  lead: int = 0) -> Dict[str, object]:
    """Record one profiled window in :data:`CENSUS`: ``kept``, the device
    records of each of the port's kernels (``records.
    kernel_records``); ``launched``, what their launch counters
    (``ops.launch_counts()`` read before and after the window) saw;
    ``gap`` = launched - kept where it is not 0; ``device_records``, all
    device records but the lead-in's; ``other``, those of other kernels,
    copies and fills; ``lead_lost``, how many of the window's ``lead``
    lead-in kernels went unrecorded; where ``raw_events`` are given,
    ``lost_calls``, the launch calls whose kernel went unrecorded, and
    ``lost_at``, their positions among the window's launch calls
    (:func:`lost_launch_positions`; the first and last 4)."""
    events = list(events)
    lead_kept = sum(int(getattr(e, "count", 1)) for e in events
                    if e.device_type == torch.autograd.DeviceType.CUDA
                    and LEAD_NAME in e.key)
    events = without_lead(events)
    kept = records.kernel_records(events)
    before = _group_launches(launches_before)
    after = _group_launches(launches_after)
    launched = {g: after[g] - before[g] for g in after}
    total = sum(records.op_census(events).values())
    entry = {
        "window": len(CENSUS) + 1, "label": label,
        "kept": {g: n for g, n in kept.items() if n or launched[g]},
        "launched": {g: n for g, n in launched.items() if n or kept[g]},
        "gap": {g: launched[g] - kept[g] for g in kept
                if launched[g] != kept[g]},
        "device_records": total, "other": total - sum(kept.values()),
        "lead_lost": lead - lead_kept,
    }
    if raw_events is not None:
        lost = lost_launch_positions(raw_events)
        entry["lost_calls"] = len(lost)
        entry["lost_at"] = lost if len(lost) <= 8 else lost[:4] + lost[-4:]
    CENSUS.append(entry)
    return entry


class Window:
    """A ``torch.profiler`` window over the card and the host that opens
    with :data:`LEAD_KERNELS` spin kernels and leaves its entry in
    :data:`CENSUS` under ``label``.  The body synchronises before it
    ends; after it, :attr:`events` holds ``key_averages()`` without the
    lead-in's records."""

    def __init__(self, label: str):
        self.label, self.events = label, None

    def __enter__(self) -> "Window":
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        self._before = ops.launch_counts()
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.__enter__()
        for _ in range(LEAD_KERNELS):
            torch.cuda._sleep(1)
        return self

    def __exit__(self, *exc) -> None:
        torch.cuda.synchronize()
        self._prof.__exit__(*exc)
        if exc[0] is not None:
            return
        events = self._prof.key_averages()
        census_window(self.label, events, self._before, ops.launch_counts(),
                      self._prof.profiler.kineto_results.events(),
                      LEAD_KERNELS)
        self.events = without_lead(events)


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


def device_ms(fn: Callable, calls: int = 20, label: Optional[str] = None
              ) -> Dict[str, object]:
    """Device time a call of ``fn``: the kernels, copies and fills it ran
    on the card, as ``torch.profiler`` records them, over ``calls`` calls
    after a warm-up.

    Each kernel name's records are averaged, and the mean is counted
    ``round(records / calls)`` times a call (at least once), so a window
    that lost records past its lead-in (:class:`Window`) still gives each
    kernel's time a launch.  A window that kept no device record at all
    is profiled again, up to :data:`WINDOWS` windows; when every one came
    back empty, ``ms`` is :func:`spun_ms` over ``calls`` calls.
    Returns ``ms`` (per call),
    ``source`` (``"profiler"`` or ``"events"``), ``launches`` (device
    operations a call; None by events), ``complete`` (every kernel
    recorded a whole number of times a call; None by events),
    ``windows`` (windows profiled, the last the one read: more than 1
    when an earlier one came back empty) and ``kernels`` ({name: ms a
    launch}; empty by events).  Each window is recorded in
    :data:`CENSUS` under ``label`` (default: ``fn``'s name)."""
    label = label or getattr(fn, "__name__", "call")
    fn()
    torch.cuda.synchronize()
    for windows in range(1, WINDOWS + 1):
        with Window(label) as win:
            for _ in range(calls):
                fn()
        dev = records.device_events(win.events)
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


def timed(fn: Callable, min_iters: int = 5, label: Optional[str] = None
          ) -> Dict[str, float]:
    """``device_ms`` (profiler) and ``call_ms`` (events) of ``fn``; the
    profiled window holds about 100 ms of calls, 3 to 50 of them."""
    call = call_ms(fn, min_iters)
    dev = device_ms(fn, calls=max(3, min(50, int(100.0 / max(call, 1e-3)))),
                    label=label)
    return dict(device_ms=dev["ms"], call_ms=call,
                device_launches=dev["launches"],
                device_complete=dev["complete"],
                device_windows=dev["windows"],
                device_source=dev["source"])

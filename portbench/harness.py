"""One run of one cell: set-up, the driver's window, then the check.

:class:`Harness` is what a driver (``portbench/drivers/<kind>.py``) is
handed.  It makes the cell's data from the seed, builds the program's
database through its facade (``repro_torch.db.TimeSeriesDB``), makes the
query pool, and installs the recorder (``portbench.recorder``).  After
the driver's window it reads the peak memory, frees the program's state
but the database's signatures, and holds a sample of the window's
answers to the plain reference (``portbench.reference.judge``), then
puts the result line together.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from portbench import spec
from portbench.data import series
from portbench.recorder import Recorder
from portbench.reference import judge
from portbench.trace import TraceObs, Tracer

#: what the program's checkout holds beside the benchmark
PROGRAM = spec.ROOT / "src"
#: top-level module names that no run may load
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def use_program() -> None:
    """Put the program's package (``src/repro_torch``) on the path; its
    absence fails the run."""
    if not (PROGRAM / "repro_torch").is_dir():
        raise SystemExit(f"the program is missing: no {PROGRAM / 'repro_torch'}")
    if str(PROGRAM) not in sys.path:
        sys.path.insert(0, str(PROGRAM))


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name (before the first dot) is one
    of :data:`FORBIDDEN`, compared whole."""
    return sorted({name for name in list(sys.modules)
                   if name.split(".")[0] in FORBIDDEN
                   and sys.modules[name] is not None})


@dataclasses.dataclass
class Outcome:
    """What a driver's window gave."""
    end_to_end: Dict[str, float]          # metric -> value
    attempted: int
    failed: int
    answers: Dict[int, Any]               # query -> (ids, dists)
    obs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    notes: Dict[str, Any] = dataclasses.field(default_factory=dict)


class Harness:
    def __init__(self, cell: spec.Cell, seed: int, seconds: float,
                 trace: bool, device: torch.device, t_start: float):
        self.cell, self.seed, self.seconds = cell, int(seed), float(seconds)
        self.trace, self.device, self.t_start = trace, device, t_start
        self.setup_s: Optional[float] = None
        self.recorder: Optional[Recorder] = None
        self.tracer: Optional[Tracer] = None
        self.windows: Optional[torch.Tensor] = None
        self.pool: Optional[series.Pool] = None
        self.db = None
        self.sampled: Optional[np.ndarray] = None
        self.log: Dict[str, Any] = {}

    # -- set-up -----------------------------------------------------------
    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def pool_rows(self) -> int:
        """Distinct queries the window may send: four times the rate in
        the traffic file over the window, and a block over."""
        t = self.cell.traffic
        return int(math.ceil(4 * float(t["pool"]["pool_qps"]) * self.seconds)
                   ) + int(t.get("block", 64))

    def make_data(self, n_warm: int) -> None:
        """The stream (database and held-out stretch) from the seed, the
        windows on the device, and the query pool."""
        cfg, t = self.cell.config, self.cell.traffic
        m, n = self.cell.length, self.cell.n_rows
        n_pool = self.pool_rows()
        held = series.heldout_points(t, n_pool, n_warm, m)
        t0 = time.perf_counter()
        host = series.make_stream(cfg, n + m - 1 + held, self.seed)
        stream = torch.from_numpy(host).to(self.device)
        self.windows = series.windows(stream, m, n)
        heldout = stream[n + m - 1:]
        self.pool = series.query_pool(self.windows, heldout, t, n_pool,
                                      n_warm, self.seed)
        del stream, heldout
        self.sync()
        self.log["data_s"] = time.perf_counter() - t0

    def index_spec(self):
        from repro_torch.encoders import IndexSpec
        cfg = self.cell.config
        return IndexSpec(encoder=cfg["encoder"], params=dict(cfg["params"]),
                         seed=int(cfg["spec_seed"]))

    def search_config(self, **changes):
        from repro_torch.db import SearchConfig
        cfg = self.cell.config
        return SearchConfig(topk=int(cfg["topk"]), top_c=int(cfg["top_c"]),
                            band=self.cell.band,
                            multiprobe_offsets=self.cell.offsets,
                            stage_timings=self.trace, **changes)

    def build(self, **changes):
        """The program's database over the windows, through the facade,
        with the recorder installed on it."""
        from repro_torch.db import TimeSeriesDB
        t0 = time.perf_counter()
        self.db = TimeSeriesDB.build(self.windows, spec=self.index_spec(),
                                     config=self.search_config(**changes),
                                     device=self.device)
        self.sync()
        self.log["build_s"] = time.perf_counter() - t0
        self.recorder = Recorder(self.db.index, self.pool.key).install()
        return self.db

    def mark_setup(self) -> None:
        """Set-up ends here: the next query is the first timed one."""
        if self.trace and self.device.type == "cuda":
            t = self.cell.traffic["trace"]
            self.tracer = Tracer(float(t["start_frac"]) * self.seconds,
                                 float(t["seconds"]))
            self.tracer.begin()
        # the run's own bookkeeping (every request's future and answer)
        # would make the collector's full passes part of the tail: set-up's
        # objects leave its scans, and it pauses until the window closes
        gc.collect()
        gc.freeze()
        gc.disable()
        self.sync()
        self.setup_s = time.perf_counter() - self.t_start

    def poll(self, t: float) -> None:
        if self.tracer is not None:
            self.tracer.poll(t)

    def end_window(self) -> None:
        if self.tracer is not None:
            self.tracer.finish()
        gc.enable()
        gc.unfreeze()

    # -- after the window ---------------------------------------------------
    def conclude(self, out: Outcome) -> Dict[str, Any]:
        """Peak memory, the check, and the result line's fields."""
        peak = (torch.cuda.max_memory_allocated(self.device)
                if self.device.type == "cuda" else 0)
        cfgj = judge.Cfg.of(self.cell.config, self.cell.band)
        rng = np.random.default_rng([self.seed, 2])
        done = np.asarray(sorted(out.answers), dtype=np.int64)
        size = min(int(self.cell.traffic["sample"]), len(done))
        chosen = np.sort(rng.choice(done, size=size, replace=False)) \
            if size else done
        q_sigs, t_ids, t_vals, missing = self.recorder.outputs(chosen)
        keep = np.asarray([q for q in chosen.tolist() if q not in
                           set(missing)], dtype=np.int64)
        self.sampled = keep
        db_sigs = self.db.index.signatures
        self.recorder.uninstall()
        self.recorder = None
        self.db.close()
        self.db = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        checks: Dict[str, float] = {}
        if len(keep):
            queries = torch.from_numpy(self.pool.rows[keep]).to(self.device)
            prog = judge.Outputs(
                db_sigs=db_sigs, q_sigs=q_sigs, topc_ids=t_ids,
                topc_vals=t_vals,
                ids=[out.answers[q][0] for q in keep.tolist()],
                dists=[out.answers[q][1] for q in keep.tolist()])
            got = judge.judge(self.windows, queries, prog, cfgj)
            checks.update(got["checks"])
            self.log.update(got["info"])
        checks["unrecorded"] = len(missing) + (0 if len(keep) else 1)
        limits = dict(self.cell.traffic["limits"])
        limits["unrecorded"] = 0
        correct = (out.failed == 0
                   and all(c in checks and checks[c] <= limits[c]
                           for c in limits))
        return dict(correct=bool(correct), peak=int(peak), checks=checks,
                    limits=limits)


def device_info(device: torch.device, peak: int,
                trace: Optional[TraceObs]) -> Dict[str, Any]:
    if device.type == "cuda":
        info = {"platform": "gpu",
                "kind": torch.cuda.get_device_name(device),
                "count": 1, "memory_peak_bytes": peak}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": peak}
    if trace is not None:
        info["busy_s"] = trace.busy_s
        info["window_s"] = trace.window_s
    return info


def result_line(cell: spec.Cell, h: Harness, out: Outcome,
                verdict: Dict[str, Any], root: Path) -> Dict[str, Any]:
    """The last line of a run, ``checks`` last."""
    metrics: Dict[str, Dict[str, Any]] = {}
    trace = h.tracer.obs if h.tracer is not None else None
    if not h.trace:
        values = dict(out.end_to_end, setup_s=h.setup_s)
        for m in cell.end_to_end:
            if values.get(m["name"]) is not None:
                metrics[m["name"]] = {"value": float(values[m["name"]]),
                                      "unit": m["unit"]}
    else:
        obs = Observations(cell=cell, trace=trace, out=out, harness=h)
        for m in cell.per_layer:
            reader = spec.load_module(spec.metric_path(root, m["name"]),
                                      m["name"])
            value = reader.read(obs)
            if value is not None:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": m["unit"]}
    line: Dict[str, Any] = {
        "correct": verdict["correct"], "attempted": int(out.attempted),
        "failed": int(out.failed), "metrics": metrics,
        "device": device_info(h.device, verdict["peak"], trace)}
    if trace is not None:
        line["breakdown"] = {"device_ops": trace.top(trace.device_ops),
                             "idle_gaps": trace.top(trace.gaps)}
    line["checks"] = {k: {"value": verdict["checks"].get(k),
                          "limit": verdict["limits"][k]}
                      for k in verdict["limits"]}
    return line


@dataclasses.dataclass
class Observations:
    """What a per-layer reader reads: the cell, the trace window (None
    without one), the driver's outcome (its ``obs``: the recorder's
    per-block stats, the engine's counters) and the harness."""
    cell: spec.Cell
    trace: Optional[TraceObs]
    out: Outcome
    harness: Harness

    def block_stats(self) -> List[object]:
        """``SearchStats`` of every block served in the window."""
        return self.out.obs.get("block_stats", [])


def dumps(line: Dict[str, Any]) -> str:
    return json.dumps(line, separators=(", ", ": "))

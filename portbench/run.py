"""Run one cell of the benchmark once on one card and print its result.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``,
``portbench/`` and the program (``src/repro_torch``).  ``--trace 0``
gives the cell's end-to-end metrics, ``--trace 1`` its per-layer
metrics, read in a profiler window.  The last line of standard output
is one JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with a trace ``breakdown``, and ``checks`` last: each number
the correctness check compared, beside its limit); the last lines of
standard error repeat the checks.  The run exits non-zero, printing no
result, without a CUDA device, without the program, or with JAX or the
JAX package loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def _args(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _caches() -> None:
    """Kernel caches of the run inside the checkout, at fixed paths (the
    program's own nvcc build lives in ``build/repro_torch``)."""
    base = ROOT / "build" / "portbench"
    os.environ.setdefault("TRITON_CACHE_DIR", str(base / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(base / "torch_ext"))


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", root: Path = ROOT,
             t_start: float = T_START) -> dict:
    """One run; returns the result line as a dict.  The CLI gives
    ``device="cuda"``; the tests drive the same path on the CPU."""
    import torch
    from portbench import harness, spec
    bench = spec.load(root)
    cell = spec.cell(workload, root, bench)
    harness.use_program()
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(0)
    h = harness.Harness(cell, seed, seconds, trace, dev, t_start)
    driver = spec.load_module(spec.driver_path(root, cell.driver),
                              cell.driver)
    out = driver.run(h)
    verdict = h.conclude(out)
    line = harness.result_line(cell, h, out, verdict, root)
    line["_log"] = dict(h.log, setup_s=h.setup_s, **out.notes)
    if h.tracer is not None and h.tracer.obs is not None:
        obs = h.tracer.obs
        line["_log"].update(trace_window_s=obs.window_s,
                            trace_batches=obs.batches,
                            launch_lag_us=obs.launch_lag_us)
    return line


def main(argv=None) -> int:
    args = _args(argv)
    import torch
    from portbench import harness, spec
    try:
        cell = spec.cell(args.workload)
    except (KeyError, FileNotFoundError) as exc:
        print(f"portbench: {exc}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA "
              "device(s); none or too few are visible", file=sys.stderr)
        return 2
    _caches()
    line = run_cell(args.workload, args.seed, args.seconds,
                    bool(args.trace))
    found = harness.forbidden_modules()
    if found:
        print("portbench: forbidden modules loaded: " + ", ".join(found),
              file=sys.stderr)
        return 3
    log = line.pop("_log")
    print("portbench: " + harness.dumps(log), file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name} = {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(f"correct = {line['correct']}", file=sys.stderr)
    sys.stderr.flush()
    print(harness.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

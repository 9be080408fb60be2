"""Readings that the limits of the correctness check are set from.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,... \
        --control 3 --seconds 3 --out calib_<cell>.jsonl

In one process, for each seed: one run of the cell as ``run.py`` makes
it (set-up, a window of ``--seconds``, the check), whose compared
numbers are the program's readings; then, for the first ``--control``
seeds, the control (``reference.judge.control_outputs``: the reference
at TF32 in the program's place) over the same sampled queries, judged
the same way.  One JSON line a reading goes to ``--out`` and to standard
output.  The benchmark's own runs never run the control.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def readings(workload: str, seeds, n_control: int, seconds: float,
             device: str = "cuda", root: Path = ROOT):
    """Yield one dict a reading: the program's for every seed, the
    control's for the first ``n_control``."""
    import torch
    from portbench import harness, spec
    from portbench.reference import judge
    bench = spec.load(root)
    cell = spec.cell(workload, root, bench)
    harness.use_program()
    dev = torch.device(device)
    driver = spec.load_module(spec.driver_path(root, cell.driver),
                              cell.driver)
    cfg = judge.Cfg.of(cell.config, cell.band)
    t_start = T_START
    for i, seed in enumerate(seeds):
        h = harness.Harness(cell, seed, seconds, False, dev, t_start)
        out = driver.run(h)
        verdict = h.conclude(out)
        yield dict(workload=workload, seed=seed, kind="program",
                   correct=verdict["correct"], checks=verdict["checks"],
                   e2e=out.end_to_end, setup_s=h.setup_s, log=h.log,
                   peak=verdict["peak"])
        if i < n_control and h.sampled is not None and len(h.sampled):
            t0 = time.perf_counter()
            queries = torch.from_numpy(h.pool.rows[h.sampled]).to(dev)
            ctrl = judge.control_outputs(h.windows, queries, cfg)
            got = judge.judge(h.windows, queries, ctrl, cfg)
            yield dict(workload=workload, seed=seed, kind="control",
                       checks=got["checks"], info=got["info"],
                       seconds=time.perf_counter() - t0)
            del ctrl, queries
        del h, out
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        t_start = time.perf_counter()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True,
                   help="comma-separated seeds")
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    with open(args.out, "a") as f:
        for r in readings(args.workload, seeds, args.control, args.seconds):
            text = json.dumps(r, default=float)
            print(text, flush=True)
            f.write(text + "\n")
            f.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The highest rate a serving cell sustains, found once by a sweep.

    python3 portbench/sweep.py --workload ecg-serve-m512 --seed <n> \
        --rates 400,600,800 --seconds 5 --out sweep.jsonl

One process builds the cell's database once and offers each rate in
turn for ``--seconds`` of Poisson arrivals, every request a distinct
pool row.  A rate is sustained when the requests completed over the
window's time reach 0.9 of the offered rate (the rule of
``repro_torch.loadgen.harness.sweep``) and the queue does not grow: the
median latency of the last third of the arrivals stays within twice that
of the first third.  The cell then offers 0.8 of the highest sustained
rate, written into its traffic file by hand.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

SUSTAINED_FRAC = 0.9
GROWTH = 2.0


def sustained(offered: float, completed: float, lat_ms) -> bool:
    from portbench.loadgen import openloop
    third = max(1, len(lat_ms) // 3)
    head = openloop.percentile(lat_ms[:third], 50)
    tail = openloop.percentile(lat_ms[-third:], 50)
    return completed >= SUSTAINED_FRAC * offered and tail <= GROWTH * head


def sweep(workload: str, seed: int, rates, seconds: float,
          device: str = "cuda", root: Path = ROOT):
    import torch
    from portbench import harness, spec
    from portbench.loadgen import openloop
    bench = spec.load(root)
    cell = spec.cell(workload, root, bench)
    harness.use_program()
    serve = spec.load_module(spec.driver_path(root, cell.driver),
                             cell.driver)
    cell.traffic["pool"]["pool_qps"] = max(rates)
    span = seconds * len(rates) * 1.25 / 4
    h = harness.Harness(cell, seed, span, False, torch.device(device),
                        T_START)
    db = serve.setup(h, rates[0])
    h.mark_setup()
    first = 0
    for i, rate in enumerate(rates):
        arrivals = openloop.poisson_arrivals(rate, seconds, [seed, 20 + i])
        res, delta = serve.window(h, db, first, arrivals)
        first += len(arrivals)
        lat = res.latency_ms
        yield dict(rate_qps=rate, completed_qps=res.rate_qps,
                   requests=res.n, failed=res.failed,
                   p50_ms=openloop.percentile(lat, 50),
                   p95_ms=openloop.percentile(lat, 95),
                   p99_ms=openloop.percentile(lat, 99),
                   late_max_ms=res.late_max_ms,
                   batch_size_mean=delta["requests"] / max(delta["batches"],
                                                           1),
                   sustained=sustained(rate, res.rate_qps, lat))
    h.end_window()
    db.close()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--rates", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    rates = [float(r) for r in args.rates.split(",")]
    best = 0.0
    with open(args.out, "a") as f:
        for r in sweep(args.workload, args.seed, rates, args.seconds):
            best = max(best, r["rate_qps"]) if r["sustained"] else best
            text = json.dumps(r)
            print(text, flush=True)
            f.write(text + "\n")
        summary = json.dumps({"max_sustained_qps": best,
                              "cell_rate_qps": 0.8 * best})
        print(summary, flush=True)
        f.write(summary + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Host wall time of the batched and sequential SSH paths at ssh-ecg's
full width, for timing two checkouts of the port in turns.

    PYTHONPATH=<checkout>/src python3 src/repro_torch/bench/search_paths.py \\
        --label NAME [--batches 32] [--sequential 48] [--out FILE]

``repro_torch`` is imported from the path it is given, so one copy of
this script times any checkout whose port has ``TimeSeriesDB.build``,
``serving.batched.ssh_search_batch`` and ``configs.ssh_ecg``:
run it once a checkout, in turns (parent, change, change, parent).  It
builds ``chip_smoke.py``'s database (2^20 z-normalised synthetic-ECG
series of length 512, the ``ssh-ecg`` CONFIG, band 25, top_c 512,
multiprobe 3) and then times, after one warm-up each:

* ``batched``: ``--batches`` batches of 64 queries, no row drawn twice
  (half database rows, half warped copies, as ``chip_smoke.py``'s), µs
  per query and the stage µs of each batch;
* ``repeat``: each batch once more right after it, its rows all
  repeated (a signature LRU hit where the checkout has one);
* ``sequential``: ``--sequential`` further queries through the
  ``local`` searcher, none seen before.

The database rows must find themselves at rank 1.  Prints the card's
name and power limit, then one JSON line of every time and its median.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

BATCH = 64


def queries(series: np.ndarray, rows: np.ndarray, rng, warp_series):
    """(rows, block): the rows' series, the second half warped."""
    qs = series[rows].copy()
    for i in range(len(rows) // 2, len(rows)):
        qs[i] = warp_series(series[rows[i]], shift=int(rng.integers(1, 4)),
                            stretch=1.02, seed=int(rows[i]), noise=0.02)
    return rows, qs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--label", required=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n-series", type=int, default=1 << 20)
    ap.add_argument("--length", type=int, default=512)
    ap.add_argument("--batches", type=int, default=32)
    ap.add_argument("--sequential", type=int, default=48)
    ap.add_argument("--out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("search_paths: needs a CUDA GPU")
    from repro_torch.configs import ssh_ecg
    from repro_torch.data.timeseries import (extract_subsequences,
                                             synthetic_ecg, warp_series)
    from repro_torch.db import TimeSeriesDB
    from repro_torch.serving.batched import ssh_search_batch

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    n, m = args.n_series, args.length
    stride = max(1, m // 8)
    series = extract_subsequences(synthetic_ecg(n * stride + m,
                                                seed=args.seed),
                                  m, stride=stride, max_count=n, znorm=True)
    rng = np.random.default_rng(args.seed + 1)
    # no row is drawn twice: only the repeats may hit a signature LRU
    picks = rng.choice(n, size=(args.batches + 1) * BATCH
                       + args.sequential + 1, replace=False)
    blocks = [queries(series, picks[i * BATCH:(i + 1) * BATCH], rng,
                      warp_series) for i in range(args.batches + 1)]
    seq_rows, seq_qs = queries(series, picks[(args.batches + 1) * BATCH:],
                               rng, warp_series)
    cfg = ssh_ecg.search_config(length=m)
    db = TimeSeriesDB.build(series, ssh_ecg.CONFIG, cfg)
    torch.cuda.synchronize()

    def batch(rows, qs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = ssh_search_batch(qs, db.index, config=db.config)
        wall = time.perf_counter() - t
        for i in range(BATCH // 2):
            if int(res.ids[i, 0]) != int(rows[i]):
                raise AssertionError(f"{args.label}: row {rows[i]} did not "
                                     "find itself at rank 1")
        return dict(us_per_query=wall / BATCH * 1e6,
                    stage_us={k: round(v, 1)
                              for k, v in res.stats.stage_us.items()},
                    sig_cache_hit=getattr(res.stats, "sig_cache_hit", None))

    batch(*blocks[0])                                   # warm-up
    # each batch, then the same batch again
    turns = [(batch(*b), batch(*b)) for b in blocks[1:]]
    out = dict(label=args.label, card=card,
               batched=[t[0] for t in turns], repeat=[t[1] for t in turns])
    local = TimeSeriesDB(db.index, cfg.replace(searcher="local"))
    seq = []
    for i, q in enumerate(seq_qs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = local.search(q)
        wall = time.perf_counter() - t
        if i < len(seq_qs) // 2 and int(res.ids[0]) != int(seq_rows[i]):
            raise AssertionError(f"{args.label}: sequential row "
                                 f"{seq_rows[i]} did not find itself")
        if i:                                           # 0 is the warm-up
            seq.append(dict(us=wall * 1e6, encode_us=round(
                res.stats.stage_us["encode"], 1)))
    out["sequential"] = seq
    out["median"] = {
        "batched_us_per_query": float(np.median(
            [b["us_per_query"] for b in out["batched"]])),
        "batched_encode_us": float(np.median(
            [b["stage_us"]["encode"] for b in out["batched"]])),
        "repeat_us_per_query": float(np.median(
            [b["us_per_query"] for b in out["repeat"]])),
        "repeat_encode_us": float(np.median(
            [b["stage_us"]["encode"] for b in out["repeat"]])),
        "sequential_us": float(np.median([s["us"] for s in seq])),
        "sequential_encode_us": float(np.median(
            [s["encode_us"] for s in seq]))}
    text = json.dumps(out)
    print(text, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""End-to-end example of the PyTorch/CUDA port: index an ECG stream,
persist the database, run a few queries and report the paper's Table 3/4
metrics (time, pruning, precision and NDCG against exact DTW) beside the
UCR suite's.

    PYTHONPATH=src python examples/torch_index_and_search.py \\
        [--points 20000] [--length 256] [--db-dir DIR] [--device cpu]

Persistence replaces rebuild-on-restart: a run that finds a database of
the same size in ``--db-dir`` loads it and answers without paying the
O(N) signature build again; otherwise it builds the index (paper Alg. 1),
saves it and loads it back, and the loaded database must equal the built
one bit for bit (signatures, band keys, series and every answer).
Without ``--db-dir`` the database lives in a temporary directory that is
removed at the end.  ``--smoke`` takes the arch's smoke spec, whose
window fits short series (``--length 64``).  Runs on CUDA unless
``--device cpu``.
"""
import argparse
import tempfile
import time

import numpy as np
import torch

from repro_torch.configs.registry import get_arch
from repro_torch.core.search import (brute_force_topk, ndcg_at_k,
                                     precision_at_k, ucr_search)
from repro_torch.data.timeseries import extract_subsequences, synthetic_ecg
from repro_torch.db import TimeSeriesDB, is_database_dir


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--points", type=int, default=20000)
    ap.add_argument("--length", type=int, default=256)
    ap.add_argument("--queries", type=int, default=3)
    ap.add_argument("--db-dir", default=None,
                    help="database directory (default: a temporary one)")
    ap.add_argument("--rebuild", action="store_true",
                    help="ignore a saved database and rebuild")
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's smoke spec (window 24)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap.parse_args(argv)


def same_database(a: TimeSeriesDB, b: TimeSeriesDB) -> bool:
    """Signatures, band keys and stored series equal bit for bit."""
    return all(torch.equal(getattr(a.index, f), getattr(b.index, f))
               for f in ("signatures", "keys", "series"))


def run(args: argparse.Namespace) -> dict:
    """Build or load, then query; returns what a caller checks:
    ``loaded_equal`` (None when the database was loaded, not built) and
    one dict of metrics a query."""
    stream = synthetic_ecg(args.points, seed=7)
    series = extract_subsequences(stream, args.length, stride=1, znorm=True)
    arch = get_arch("ssh-ecg")
    config = arch.search_config(length=args.length)
    spec = arch.index_spec(smoke=args.smoke)

    with tempfile.TemporaryDirectory() as tmp:
        db_dir = args.db_dir or tmp
        # -- build once, load forever ------------------------------------
        t0 = time.perf_counter()
        db, loaded_equal = None, None
        if is_database_dir(db_dir) and not args.rebuild:
            db = TimeSeriesDB.load(db_dir, device=args.device)
            if len(db) != series.shape[0]:      # a stale save
                db = None
            else:
                print(f"loaded database from {db_dir} in "
                      f"{time.perf_counter() - t0:.2f}s")
        if db is None:
            built = TimeSeriesDB.build(series, spec=spec, config=config,
                                       device=args.device)
            built.save(db_dir)
            print(f"built + saved database ({len(built)} series) in "
                  f"{time.perf_counter() - t0:.2f}s")
            db = TimeSeriesDB.load(db_dir, device=args.device)
            queries = series[:4]
            loaded_equal = same_database(built, db) and all(
                np.array_equal(a.ids, b.ids)
                and np.array_equal(a.dists, b.dists)
                for a, b in zip(built.search_batch(queries),
                                db.search_batch(queries)))
            print(f"loaded database equals the built one: {loaded_equal}")
            del built

        # -- queries --------------------------------------------------------
        band, data = db.config.band, db.index.series
        rng = np.random.default_rng(0)
        out = []
        for qi in rng.integers(0, series.shape[0], args.queries):
            q = data[int(qi)]
            t0 = time.perf_counter()
            res = db.search(q)
            t_ssh = time.perf_counter() - t0
            t0 = time.perf_counter()
            ucr = ucr_search(q, data, topk=10, band=band)
            t_ucr = time.perf_counter() - t0
            gold, _ = brute_force_topk(q, data, 10, band=band)
            m = dict(query=int(qi), ssh_s=t_ssh, ucr_s=t_ucr,
                     ssh_pruned=res.pruned_total_frac,
                     ssh_pruned_by_hash=res.pruned_by_hash_frac,
                     ucr_pruned=ucr.pruned_total_frac,
                     precision=precision_at_k(res.ids, gold, 10),
                     ndcg=ndcg_at_k(res.ids, gold, 10),
                     ucr_exact=bool(np.array_equal(ucr.ids, gold)),
                     dtw_evals=res.dtw_evals, ucr_dtw_evals=ucr.dtw_evals)
            out.append(m)
            print(f"q={qi}: ssh {t_ssh:.3f}s (pruned "
                  f"{m['ssh_pruned']:.1%}, prec {m['precision']:.2f}, ndcg "
                  f"{m['ndcg']:.2f}, {m['dtw_evals']} DTWs) | ucr "
                  f"{t_ucr:.3f}s (pruned {m['ucr_pruned']:.1%}, "
                  f"{m['ucr_dtw_evals']} DTWs, exact "
                  f"{m['ucr_exact']}) | speedup {t_ucr / t_ssh:.1f}x")
    return {"n_series": int(series.shape[0]), "loaded_equal": loaded_equal,
            "queries": out}


def main(argv=None) -> int:
    res = run(parse_args(argv))
    return 0 if res["loaded_equal"] in (None, True) else 1


if __name__ == "__main__":
    raise SystemExit(main())

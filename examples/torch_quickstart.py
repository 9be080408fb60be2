"""Quickstart of the PyTorch/CUDA port: build an SSH database over an ECG
stream, search it, save it, load it back and search again.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

Runs on CUDA unless ``--device cpu``.  The saved directory is the JAX
package's format too: ``repro.db.TimeSeriesDB.load`` opens it.
"""
import argparse
import tempfile

import numpy as np

from repro_torch.configs.registry import get_arch
from repro_torch.core.search import brute_force_topk, precision_at_k
from repro_torch.data.timeseries import extract_subsequences, synthetic_ecg
from repro_torch.db import TimeSeriesDB


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    # 1. a long ECG stream, sliced into overlapping subsequences (§5.1)
    series = extract_subsequences(synthetic_ecg(4000, seed=42), 128,
                                  stride=4, znorm=True)
    print(f"database: {series.shape[0]} subsequences of length "
          f"{series.shape[1]}")

    # 2. what the index is (IndexSpec) and what a query does
    #    (SearchConfig), both from the arch registry
    arch = get_arch("ssh-ecg")
    db = TimeSeriesDB.build(series, arch.index_spec(smoke=True),
                            arch.search_config(length=128),
                            device=args.device)
    print(db)

    # 3. search: database rows find themselves first
    queries = series[[3, 141, 400]]
    before = db.search_batch(queries)
    for q, res in zip(queries, before):
        gold, _ = brute_force_topk(q, db.index.series, 10, db.config.band)
        print(f"top-3 {res.ids[:3].tolist()} precision@10 against exact "
              f"DTW {precision_at_k(res.ids, gold, 10):.2f}")

    # 4. save and load: the loaded database answers bit for bit the same
    with tempfile.TemporaryDirectory() as tmp:
        db.save(tmp)
        loaded = TimeSeriesDB.load(tmp, device=args.device)
        after = loaded.search_batch(queries)
    same = all(np.array_equal(a.ids, b.ids)
               and np.array_equal(a.dists, b.dists)
               for a, b in zip(before, after))
    print(f"saved and loaded {len(loaded)} series: answers "
          f"{'identical' if same else 'DIFFER'}")
    return 0 if same else 1


if __name__ == "__main__":
    raise SystemExit(main())

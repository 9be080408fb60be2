"""Distributed SSH index of the PyTorch/CUDA port: row-sharded fan-out over
a mesh of devices.

    PYTHONPATH=src python examples/torch_distributed_search.py \\
        [--shards 8] [--device cpu]

A mesh is a list of devices.  Every visible card takes one shard when
there are ``--shards`` of them; otherwise the shards share the first
device (on one card, several row shards on that card).  The signatures
are built shard by shard through the reference's legacy call form
``build_sharded(series, filters, cws, params, mesh)``; one query then
probes every shard, re-ranks each shard's candidates by banded DTW and
merges the shards' lists into the global top-k.  The same answer must
come back through the facade (``SearchConfig(searcher="distributed")``
over the same mesh), and the query row must be its own top-1 there and
in the single-device facade.  Runs on CUDA unless ``--device cpu``.
"""
import argparse

import numpy as np
import torch

from repro_torch.configs.registry import get_arch
from repro_torch.core.index import SSHFunctions, SSHParams
from repro_torch.data.timeseries import extract_subsequences, synthetic_ecg
from repro_torch.db import TimeSeriesDB
from repro_torch.distributed.dist_index import (build_sharded,
                                                index_shardings,
                                                make_query_fn, place_rows)
from repro_torch.kernels import ops


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--points", type=int, default=6000)
    ap.add_argument("--length", type=int, default=128)
    ap.add_argument("--shards", type=int, default=8)
    ap.add_argument("--query", type=int, default=4321,
                    help="database row to query (modulo the rows)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap.parse_args(argv)


def make_mesh(device: torch.device, shards: int):
    """One shard a visible card when there are enough, else every shard
    on ``device``."""
    if device.type == "cuda" and torch.cuda.device_count() >= shards:
        return [torch.device("cuda", i) for i in range(shards)]
    return [device] * shards


def run(args: argparse.Namespace) -> dict:
    """Returns the fan-out's, the distributed facade's and the
    single-device facade's (ids, dists) of the query, and its row."""
    dev = ops.resolve_device(args.device)
    mesh = make_mesh(dev, args.shards)
    print(f"mesh: {len(mesh)} shards on {sorted({str(d) for d in mesh})}")

    stream = synthetic_ecg(args.points, seed=1)
    series = extract_subsequences(stream, args.length, stride=1, znorm=True)
    n = (series.shape[0] // len(mesh)) * len(mesh)
    series = torch.from_numpy(series[:n]).to(dev)
    row = args.query % n

    params = SSHParams(window=32, step=3, ngram=10, num_hashes=40,
                       num_tables=20)
    fns = SSHFunctions.create(params, dev)
    # one config drives the fan-out and the facade; the shard probe is
    # single-probe by construction
    config = get_arch("ssh-ecg").search_config(length=args.length, topk=5,
                                               multiprobe_offsets=1)

    # shard the database, build signatures on every shard
    shards = index_shardings(mesh, n)
    series_sh = place_rows(series, shards)
    cws = fns.cws._asdict()
    sigs_sh = build_sharded(series, fns.filters, cws, params, mesh)
    print(f"sharded signatures: {len(sigs_sh)} shards of "
          f"{tuple(sigs_sh[0].shape)}")

    # one query: local probe -> local DTW re-rank -> global top-k
    qfn = make_query_fn(params, mesh, length=args.length, config=config)
    ids, dists = qfn(series_sh, sigs_sh, fns.filters, cws, series[row])
    ids, dists = ids.cpu().numpy(), dists.cpu().numpy()
    print(f"global top-{config.topk} ids: {ids} (dists {np.round(dists, 4)})")

    # the same answer through the facade over the same mesh, and the
    # single-device facade
    spec = params.to_spec()
    facade = TimeSeriesDB.build(series, spec=spec,
                                config=config.replace(searcher="distributed"),
                                mesh=mesh, device=dev).search(series[row])
    single = TimeSeriesDB.build(series, spec=spec, config=config,
                                device=dev).search(series[row])
    print(f"facade (searcher='distributed') top-{config.topk}: {facade.ids}")
    print(f"single-device facade top-{config.topk}: {single.ids}")
    return {"row": row, "fanout": (ids, dists),
            "facade": (facade.ids, facade.dists),
            "single": (single.ids, single.dists)}


def agree(res: dict) -> bool:
    """The fan-out equals the distributed facade bit for bit, and the
    query row is the top-1 of all three."""
    (ids, d), (f_ids, f_d) = res["fanout"], res["facade"]
    same = np.array_equal(ids, f_ids) and np.array_equal(d, f_d)
    return same and all(int(res[k][0][0]) == res["row"]
                        for k in ("fanout", "facade", "single"))


def main(argv=None) -> int:
    ok = agree(run(parse_args(argv)))
    print("distributed search OK" if ok else "distributed search DIFFERS")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())

"""Index-build launcher, the paper's preprocessing stage (Alg. 1;
counterpart of ``repro.launch.build_index``)::

    PYTHONPATH=src python -m repro_torch.launch.build_index \\
        --dataset ecg --points 50000 --length 256 --out DIR [--device cpu]

The stream's windows are hashed in fixed batches; after each batch the
signatures so far go to ``<out>.build_ckpt`` through the port's
``Checkpointer`` (atomic), so a build that dies resumes at the last
finished batch.  The index is published as a database directory that
``TimeSeriesDB.load(out)`` (of either package) and ``serve --db-dir
out`` read without paying the build again; the scratch checkpoint is
then removed.  ``--encoder`` names any registered encoder (default: the
arch's ``"ssh"`` spec).  Runs on CUDA unless ``--device cpu``;
``--backend`` is the reference's knob, checked against the device
(``jnp`` only with ``--device cpu``).
"""
from __future__ import annotations

import argparse
import shutil
import time

import numpy as np
import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs.registry import get_arch
from repro_torch.core.index import SSHIndex
from repro_torch.data.timeseries import (extract_subsequences, random_walk,
                                         synthetic_ecg)
from repro_torch.db import TimeSeriesDB
from repro_torch.encoders import IndexSpec, make_encoder
from repro_torch.kernels import ops

_GENERATORS = {"ecg": synthetic_ecg, "randomwalk": random_walk}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dataset", choices=sorted(_GENERATORS), default="ecg")
    ap.add_argument("--points", type=int, default=50_000)
    ap.add_argument("--length", type=int, default=256)
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--out", required=True,
                    help="database directory to publish")
    ap.add_argument("--encoder", default=None,
                    help="registered encoder name (default: the arch's "
                         "'ssh' spec; 'srp'/'ssh-multires' take their "
                         "defaults)")
    ap.add_argument("--backend", choices=list(ops.BACKENDS), default="auto",
                    help="the reference's kernel knob: 'auto' and "
                         "'pallas' run the kernels on CUDA and their plain "
                         "versions on the CPU; 'jnp' (the plain versions) "
                         "only with --device cpu")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap.parse_args(argv)


def build(args: argparse.Namespace) -> TimeSeriesDB:
    """Hash, checkpointing every batch, then publish ``args.out``."""
    dev = ops.resolve_device(args.device)
    ops.check_backend(args.backend, dev)
    stream = _GENERATORS[args.dataset](args.points, seed=3)
    series = extract_subsequences(stream, args.length, stride=1, znorm=True)
    n = series.shape[0]

    arch = get_arch(f"ssh-{args.dataset}")
    spec = (arch.index_spec() if args.encoder in (None, "ssh")
            else IndexSpec(encoder=args.encoder))
    enc = make_encoder(spec, dev, length=args.length)

    ck = Checkpointer(f"{args.out}.build_ckpt", keep=2)
    latest, restored = ck.restore_latest(
        {"sigs": np.zeros((n, enc.num_hashes), np.int32),
         "done": np.zeros((), np.int32)})
    sigs = np.array(restored["sigs"], np.int32)
    done = int(restored["done"]) if latest is not None else 0
    if done:
        print(f"resuming at series {done}/{n}", flush=True)

    t0 = time.time()
    for lo in range(done, n, args.batch):
        hi = min(lo + args.batch, n)
        out = enc.encode_batch(torch.from_numpy(series[lo:hi]).to(dev))
        sigs[lo:hi] = out.cpu().numpy()
        ck.save(hi, {"sigs": sigs, "done": np.asarray(hi, np.int32)})
        rate = (hi - done) / max(time.time() - t0, 1e-9)
        print(f"hashed {hi}/{n} ({rate:.0f} series/s)", flush=True)

    sig_t = torch.from_numpy(sigs).to(dev)
    index = SSHIndex(encoder=enc, signatures=sig_t,
                     keys=enc.band_keys(sig_t),
                     series=torch.from_numpy(series).to(dev),
                     build_backend=dev.type)
    # TimeSeriesDB caches the envelopes (saved with the index) and folds
    # knobs the encoder cannot honour (multiprobe for "srp")
    db = TimeSeriesDB(index, arch.search_config(length=args.length))
    db.save(args.out)
    # the database is published; the scratch copies of the signatures
    # are waste now
    shutil.rmtree(f"{args.out}.build_ckpt", ignore_errors=True)
    print(f"index built: {n} series, encoder {spec.encoder!r}, "
          f"{enc.num_hashes} hashes, {enc.num_tables} tables on {dev} in "
          f"{time.time() - t0:.1f}s; database saved to {args.out} "
          f"(TimeSeriesDB.load / serve --db-dir)", flush=True)
    return db


def main(argv=None) -> int:
    build(parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""End-to-end check of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0] [--n-series 1048576] [--length 512]

1. Set-up: the card's name and power limit, the torch and CUDA versions,
   and the build of the three CUDA kernels from ``src/repro_torch/csrc``.
2. Main path: ``TimeSeriesDB.build`` at the full ``ssh-ecg`` config
   (W=80, δ=3, n=15, K=40, L=20) over ``--n-series`` synthetic-ECG series
   of length ``--length`` made from ``--seed`` (the windows of
   ``make_benchmark_db``, each z-normalised as in the UCR suite: raw,
   the baseline-dominated windows collapse onto a few signatures shared
   by thousands of series, and a query's top-512 ties by lowest id can
   then leave the query itself out), then ``search_batch`` on
   4 batches of 64 queries (half database rows, whose top-1 must be
   themselves, half warped copies) with ``SEARCH`` at the 5 % band,
   topk 10, top_c 512, multiprobe 3.  Every kernel's launch count is set
   to 0 just before and read just after; each must have grown.
3. Kernels: each kernel against its plain PyTorch version on the card, on
   the very tensors the main path handed it (recorded on one more batch):
   integers exact, DTW bit-identical, the sketch within the float32 bound
   of reordering an 80-term sum.  Times by CUDA events: the kernel, the
   plain version, and one PyTorch call computing the same function where
   there is one; the bound is the larger of bytes over 3.35 TB/s and
   operations over the peak rate of their type (H100 SXM: f32 outside the
   tensor cores 67 TFLOP/s, int32 33.5 Tops/s).  The sketch is checked
   and timed at both of its shapes: a 4096-row build chunk (the ``ms``
   of its entry) and the query encode, where a call is mostly host
   dispatch.
4. Cross-check: 8 queries through the plain CPU path on a CPU copy of the
   index; ids equal, distances within rtol 1e-5.

Prints a ``kernels`` JSON line and, last, ``{"ok": true, "device": ...}``.
Any failure raises and exits non-zero.  Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet
F32_OPS_PER_S = 67e12           # H100 SXM f32 outside the tensor cores
# 32-bit integer compare/add: at most one per FP32 lane per clock (INT32
# ALU plus IMAD on the FMA pipe), half the f32 rate, which counts an FMA
# as two operations
INT32_OPS_PER_S = 33.5e12
BATCHES, BATCH_SIZE = 4, 64     # the main path: 4 batches of 64 queries


def log(*a):
    print(*a, flush=True)


def cuda_time_ms(fn, min_iters=5, budget_ms=300.0):
    """Mean ms per call by CUDA events, after a warm-up, over enough
    calls to fill ``budget_ms``."""
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


def bound_ms(n_bytes, n_ops, ops_per_s=F32_OPS_PER_S):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


class Recorder:
    """Pass-through around the ``kernels.ops`` entry points that keeps
    the arguments of every call (the main path's own kernel inputs)."""

    def __init__(self, ops, names):
        self.ops, self.names, self.calls = ops, names, {n: [] for n in names}
        self.saved = {}

    def __enter__(self):
        for n in self.names:
            fn = getattr(self.ops, n)
            self.saved[n] = fn

            def spy(*args, _fn=fn, _n=n, **kw):
                self.calls[_n].append((args, kw))
                return _fn(*args, **kw)
            setattr(self.ops, n, spy)
        return self

    def __exit__(self, *exc):
        for n, fn in self.saved.items():
            setattr(self.ops, n, fn)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n-series", type=int, default=1 << 20)
    ap.add_argument("--length", type=int, default=512)
    args = ap.parse_args()

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script runs only on a CUDA GPU")
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.configs import ssh_ecg
    from repro_torch.core import dtw as core_dtw
    from repro_torch.core.index import SSHIndex
    from repro_torch.data.timeseries import (extract_subsequences,
                                             synthetic_ecg, warp_series)
    from repro_torch.db import TimeSeriesDB
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.serving.batched import ssh_search_batch

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    log(f"card: {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}; tf32 off for matmul and cuDNN")
    t = time.perf_counter()
    _build.build_all()
    for name in _build.SIGNATURES:
        _build.load(name)
    log(f"kernels built and loaded in {time.perf_counter() - t:.1f} s "
        f"({', '.join(_build.SIGNATURES)})")

    # -- data ---------------------------------------------------------------
    n, m = args.n_series, args.length
    t = time.perf_counter()
    stride = max(1, m // 8)                 # make_benchmark_db's stride
    series = extract_subsequences(
        synthetic_ecg(n * stride + m, seed=args.seed), m, stride=stride,
        max_count=n, znorm=True)
    log(f"database: {n} z-normalised synthetic-ECG series of length {m} "
        f"({series.nbytes / 1e9:.2f} GB), made in "
        f"{time.perf_counter() - t:.1f} s; the paper's scale is "
        f"{ssh_ecg.PAPER_N_SERIES} series, cut "
        f"{ssh_ecg.PAPER_N_SERIES / n:.1f}x")
    rng = np.random.default_rng(args.seed + 1)
    bs, half = BATCH_SIZE, BATCH_SIZE // 2
    batches = []
    for _ in range(BATCHES):
        rows = rng.choice(n, size=bs, replace=False)
        qs = series[rows].copy()
        for i in range(half, bs):
            qs[i] = warp_series(series[rows[i]], shift=int(rng.integers(1, 4)),
                                stretch=1.02, seed=int(rows[i]), noise=0.02)
        batches.append((rows, qs))

    # -- main path (counted) ------------------------------------------------
    spec = ssh_ecg.CONFIG
    cfg = ssh_ecg.search_config(length=m)
    log(f"spec {spec.to_dict()}; search {cfg.to_dict()}")
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t = time.perf_counter()
    db = TimeSeriesDB.build(series, spec, cfg)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t
    log(f"build: {build_s:.2f} s ({n / build_s:.0f} series/s), index "
        f"{db.index.nbytes() / 1e9:.2f} GB on {dev}, launches "
        f"{ops.launch_counts()}")
    per_batch = []
    results = []
    for bi, (rows, qs) in enumerate(batches):
        before = ops.launch_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = db.search_batch(qs)
        wall = time.perf_counter() - t
        after = ops.launch_counts()
        st = res[0].stats
        per_batch.append({k: after[k] - before[k] for k in after})
        results.append(res)
        selfs = [int(r.ids[0]) == int(rows[i])
                 for i, r in enumerate(res[:half])]
        if not all(selfs):
            raise AssertionError(
                f"batch {bi}: self-match failed for rows "
                f"{[int(rows[i]) for i, ok in enumerate(selfs) if not ok]}")
        for r in res:
            if not (len(r.ids) == cfg.topk and np.all(np.isfinite(r.dists))
                    and np.all(np.diff(r.dists) >= 0)
                    and np.all((r.ids >= 0) & (r.ids < n))):
                raise AssertionError(f"batch {bi}: malformed result {r}")
        log(f"batch {bi}: us_per_query {wall / bs * 1e6:.1f} stage_us "
            f"{ {k: round(v, 1) for k, v in st.stage_us.items()} } "
            f"(whole batch) n_in {st.n_in} lb_pruned {st.lb_pruned} n_dtw "
            f"{st.n_dtw} abandoned {st.dtw_abandoned} launches "
            f"{per_batch[-1]}")
    counts = ops.launch_counts()
    log(f"main path launches: {counts}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    if min(counts.values()) < 1:
        raise AssertionError(f"a kernel never launched on the main path: "
                             f"{counts}")

    # -- kernel phase (inputs recorded from one more main-path batch) -------
    names = ("sketch_conv", "collision_count_batch", "dtw_rerank_pairs")
    with Recorder(ops, names) as rec:
        db.search_batch(batches[0][1])
    entries = []

    # sketch_conv: a build chunk (the rows encode_chunked hands it) and the
    # query encode (B·O rows of the multiprobe slices)
    (xq, filt, step), _ = rec.calls["sketch_conv"][0]
    xb = db.index.series[:4096]
    w, f_ = filt.shape

    def conv_at(x):
        wconv = filt.t().contiguous()[:, None, :]
        return lambda: torch.nn.functional.conv1d(
            x[:, None, :], wconv, stride=step).transpose(1, 2)

    sk = {}
    for tag, x in (("build", xb), ("query", xq)):
        kern = ops.sketch_conv(x, filt, step)
        plain = ref.sketch_conv_ref(x, filt, step)
        scale = ref.sketch_conv_ref(x.abs(), filt.abs(), step)
        err = (kern - plain).abs()
        if not bool((err <= 2 * w * 2.0 ** -24 * scale).all()):
            raise AssertionError(
                f"sketch_conv ({tag} shape) disagrees with its plain version "
                f"beyond the reordering bound: max err {float(err.max())}")
        bms, bkind = bound_ms(4 * (x.numel() + filt.numel() + kern.numel()),
                              2 * x.shape[0] * kern.shape[1] * f_ * w)
        sk[tag] = dict(
            max_abs_err=float(err.max()),
            ms=cuda_time_ms(lambda: ops.sketch_conv(x, filt, step)),
            plain_ms=cuda_time_ms(lambda: ref.sketch_conv_ref(x, filt, step)),
            bound_ms=bms, bound_by=bkind, library_ms=cuda_time_ms(conv_at(x)),
            library_max_abs_err=float((conv_at(x)() - plain).abs().max()),
            sign_flips=int(((kern >= 0) != (plain >= 0)).sum()),
            shape=f"x {tuple(x.shape)} filters {tuple(filt.shape)} "
                  f"step {step}")
    entries.append(dict(
        name="sketch_conv", route="cuda",
        source="src/repro_torch/csrc/sketch_conv.cu",
        replaces="src/repro/kernels/sketch_conv.py:48",
        launches=counts["sketch_conv"], **sk["build"],
        query_shape={k: sk["query"][k] for k in
                     ("shape", "ms", "plain_ms", "bound_ms", "library_ms",
                      "max_abs_err", "sign_flips")},
        tolerance="|err| <= 2*W*2^-24*sum|x*f|",
        library="F.conv1d(stride=step), cudnn.allow_tf32=False"))

    # collision_count_batch: the probe of B·O signature rows
    (qk, dbk), _ = rec.calls["collision_count_batch"][0]
    kern = ops.collision_count_batch(qk, dbk)
    plain = ref.collision_count_batch_ref(qk, dbk)
    if not torch.equal(kern, plain):
        raise AssertionError("collision_count_batch is not exact: "
                             f"{int((kern != plain).sum())} counts differ")
    k_ = qk.shape[1]
    if int(max(qk.max(), dbk.max())) >= 1 << 24 or int(qk.min()) < 0:
        raise AssertionError("hash values outside [0, 2^24): the float "
                             "yardstick would not be exact")

    def cdist_counts():
        return k_ - torch.cdist(qk.float(), dbk.float(), p=0)
    if not torch.equal(cdist_counts().to(torch.int32), plain):
        raise AssertionError("cdist yardstick disagrees with the counts")
    bms, bkind = bound_ms(4 * (qk.numel() + dbk.numel() + kern.numel()),
                          2 * qk.shape[0] * dbk.shape[0] * k_,
                          INT32_OPS_PER_S)
    entries.append(dict(
        name="collision_count_batch", route="cuda",
        source="src/repro_torch/csrc/collision_count.cu",
        replaces="src/repro/kernels/collision_count.py:68",
        launches=counts["collision_count"], max_abs_err=0.0,
        ms=cuda_time_ms(lambda: ops.collision_count_batch(qk, dbk)),
        plain_ms=cuda_time_ms(
            lambda: ref.collision_count_batch_ref(qk, dbk)),
        bound_ms=bms, bound_by=bkind, library_ms=cuda_time_ms(cdist_counts),
        shape=f"queries {tuple(qk.shape)} db {tuple(dbk.shape)}",
        tolerance="exact", library="K - torch.cdist(q, db, p=0)"))

    # dtw_wavefront_pairs: every call of the batch (seed DTW, survivors)
    dtw_calls = rec.calls["dtw_rerank_pairs"]
    for (q, c, band, *rest), kw in dtw_calls:
        thr = rest[0] if rest else kw.get("threshold")
        kern = ops.dtw_rerank_pairs(q, c, band, thr)
        plain = ref.dtw_pairs_ref(q, c, band, thr)
        if not torch.equal(kern, plain):
            diff = (kern != plain)
            raise AssertionError(
                f"dtw_wavefront_pairs is not bit-identical on "
                f"{int(diff.sum())} of {kern.numel()} pairs")
    (q, c, band, *rest), kw = dtw_calls[-1]      # survivor DTW, threshold
    thr = rest[0] if rest else kw.get("threshold")
    _, cells = core_dtw.dtw_pairs_work(q, c, band, thr)
    p_, m_ = q.shape
    abandoned = int((ops.dtw_rerank_pairs(q, c, band, thr)
                     >= core_dtw.BIG * 0.5).sum())
    bms, bkind = bound_ms(4 * (2 * q.numel() + 2 * p_),
                          6 * int(cells.sum()))
    entries.append(dict(
        name="dtw_wavefront_pairs", route="cuda",
        source="src/repro_torch/csrc/dtw_wavefront.cu",
        replaces="src/repro/kernels/dtw_wavefront.py:201",
        launches=counts["dtw_wavefront"], max_abs_err=0.0,
        ms=cuda_time_ms(lambda: ops.dtw_rerank_pairs(q, c, band, thr)),
        plain_ms=cuda_time_ms(lambda: ref.dtw_pairs_ref(q, c, band, thr),
                              min_iters=2),
        bound_ms=bms, bound_by=bkind, library_ms=None,
        shape=f"pairs {tuple(q.shape)} radius {band} threshold "
              f"{thr is not None}; {abandoned} abandoned; "
              f"{int(cells.sum())} cells run",
        tolerance="bit-identical", calls_checked=len(dtw_calls)))
    for e in entries:
        log(f"kernel {e['name']}: kernel_ms {e['ms']:.4f} plain_ms "
            f"{e['plain_ms']:.4f} library_ms {e['library_ms']} bound_ms "
            f"{e['bound_ms']:.4f} ({e['bound_by']}) max_err "
            f"{e['max_abs_err']} [{e['shape']}]")
        if "query_shape" in e:
            log(f"kernel {e['name']} at the query shape: "
                f"{e['query_shape']}")

    # -- cross-check on the CPU plain path ---------------------------------
    cpu = torch.device("cpu")
    enc_cpu = type(db.index.encoder)(spec).load_state(
        {k: v.cpu() for k, v in db.index.encoder._require_state().items()})
    idx_cpu = SSHIndex(encoder=enc_cpu, signatures=db.index.signatures.cpu(),
                       keys=db.index.keys.cpu(), series=db.index.series.cpu(),
                       env_radius=db.index.env_radius,
                       env_upper=db.index.env_upper.cpu(),
                       env_lower=db.index.env_lower.cpu(),
                       build_backend=db.index.build_backend)
    pick = list(range(4)) + list(range(half, half + 4))
    qs8 = batches[0][1][pick]
    t = time.perf_counter()
    res_cpu = ssh_search_batch(qs8, idx_cpu, cfg)
    cpu_s = time.perf_counter() - t
    for j, i in enumerate(pick):
        g = results[0][i]
        cids, cd = res_cpu.ids[j], res_cpu.dists[j]
        if not np.array_equal(g.ids, cids[cids >= 0]):
            raise AssertionError(f"cross-check query {i}: cuda ids {g.ids} "
                                 f"!= cpu ids {cids}")
        np.testing.assert_allclose(g.dists, cd[cids >= 0], rtol=1e-5,
                                   atol=1e-6)
    log(f"cross-check: 8 queries on the plain CPU path ({cpu_s:.1f} s on "
        f"{cpu}) match the CUDA path: ids equal, distances within rtol 1e-5")

    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(f"{smi}")
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

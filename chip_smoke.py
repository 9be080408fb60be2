"""End-to-end check of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0] [--n-series 1048576] [--length 512]
                          [--lm-prompt 32768]

1. Set-up: the card's name and power limit, the torch and CUDA versions,
   and the build of the CUDA kernels from ``src/repro_torch/csrc`` (one
   ``nvcc`` per source, all at once).
2. Data: ``--n-series`` synthetic-ECG series of length ``--length`` made
   from ``--seed`` (the windows of ``make_benchmark_db``, each
   z-normalised as in the UCR suite: raw, the baseline-dominated windows
   collapse onto a few signatures shared by thousands of series, and a
   query's top-512 ties by lowest id can then leave the query itself
   out).  Queries: 4 batches of 64, half database rows (whose top-1 must
   be themselves), half warped copies.
3. Paths, each driven with every kernel's launch count set to 0 just
   before and read just after; each kernel of the path must have grown:
   a. batched: ``TimeSeriesDB.build`` at the full ``ssh-ecg`` config
      (W=80, δ=3, n=15, K=40, L=20), then ``SEARCH`` at the 5 % band,
      topk 10, top_c 512, multiprobe 3 on the 4 batches through
      ``serving.batched.ssh_search_batch`` (the facade's call; its
      ``BatchSearchResult`` carries the batch's counters and stage
      times);
   b. sequential: ``searcher="local"`` on the same index for 16 queries
      of batch 0 (8 database rows, 8 warped copies): self-match at rank 1
      for the rows, ids equal to the batched answers, distances within
      rtol 1e-5 of them;
   c. UCR baseline: ``ucr_search`` for 4 of those queries over the whole
      database at the same band and topk, 2 of them held to
      ``brute_force_topk`` (both exact); SSH precision@10 and NDCG@10
      against the UCR answer and the UCR/SSH time ratio are logged;
   d. streaming: an ``"ssh-cs"`` database (the same sketch and hash
      settings, rows 4, width 4096, base_bits 4) built from the first
      half of the series, the second half ingested through two
      ``StreamIngestor`` shards with out-of-order ``seq``, merged and
      folded in: the merged aggregate must equal the sum of the shards'
      exactly, a 4096-row chunk re-encoded directly must give the stored
      signatures, and 8 streamed rows must find themselves through both
      searchers;
   e. persist (phases ``persist_*``; saved directories live under
      ``build/`` and are removed once read, after a check that the disk
      there holds two saved databases): the batched index saved with
      ``TimeSeriesDB.save`` and loaded onto the card answers the 4
      batches with bit-identical ids and distances (save, load and build
      seconds, bytes and GB/s logged); the streaming database saved and
      loaded, then one more 4096-row chunk ingested into it and into the
      never-saved one: signatures, keys and ``cs/agg`` equal; host
      buckets (``searcher="local", use_host_buckets=True``) on the loaded
      index, their build at 2^20 x 20 and 16 queries timed, the database
      rows self-matched; ``"srp"`` and ``"ssh-multires"`` each built from
      all the series at their defaults, batch 0 through the batched
      searcher with the database rows self-matched, bit-identical after
      one save and load, precision@10 against UCR beside SSH's logged;
      ``launch.build_index --points 70000`` and ``launch.serve --arch
      ssh-ecg --sequential --db-dir`` on its output as subprocesses (exit
      0, ``loaded database``); batch 0 twice on the loaded index from an
      empty signature LRU: 64 hits the second time, the same ids, no
      sketch launch.  The LRU is emptied before the sequential path and
      before the recording run of step 4, which must encode.
4. Kernels: each of the six against its plain PyTorch version on the
   card, on the very tensors its path handed it (recorded on one more
   run of the path): integers and count-sketch tables exact, DTW
   bit-identical, the sketch within the float32 bound of reordering an
   80-term sum and bit for bit against ``ref.sketch_conv_fma_ref``, the
   exact emulation of its fused multiply-add chain.  Times: ``ms`` is
   the device time a launch (``torch.profiler``'s kernel records,
   ``repro_torch.bench.device_time``), ``call_ms`` the time between
   back-to-back calls by CUDA events, which reads host dispatch when a
   call's host work outlasts its kernel; the same two for one PyTorch
   call computing the same function where there is one
   (``library_ms``, ``library_call_ms``); the plain version's call time.
   The bound is the larger of bytes over 3.35 TB/s and operations over
   the peak rate of their type (H100 SXM: f32 outside the tensor cores
   67 TFLOP/s, int32 33.5 Tops/s; the DTW cell's 6 operations, none of
   which fuses, 33.5e12 a second).  The sketch is timed at a 4096-row
   build chunk and at the query encode, with ptxas's registers and
   spills of each sketch kernel (a spill, a stack frame or local memory
   fails the run) and its SASS instructions a tap
   (``repro_torch.bench.sketch_flash.tap_costs``).  The collision-count
   kernels:
   ptxas's registers and spills of each (a spill, or local memory in the
   SASS, fails the run), the batch kernel's SASS instructions a key
   compared (``repro_torch.bench.collision_count.key_costs``), every
   recorded single-query call checked, and the batched probe stage
   split into its three parts, each timed by CUDA events on batch 0's
   recorded input: the kernel, the max over the multiprobe offsets and
   ``top_c_by_count``.  The DTW kernels: ptxas's
   registers and spills of every DTW kernel (a spill fails the run) and
   the SASS instructions a DP cell of each schedule
   (``repro_torch.bench.dtw_schedules.cell_costs``); every recorded call
   through the schedule rule (``kernels.dtw_wavefront.dtw_schedule``, its
   choice printed per call) and through each schedule that takes its
   radius ("rows", "diagonals"), bit-identical to the plain version;
   both schedules timed in turns, with cells run, Gcells/s and the share
   of the bound, at the batched survivors, the UCR scan and a sequential
   re-rank; launches per schedule per path.
5. Cross-check: 8 queries through the plain CPU path on a CPU copy of the
   index; ids equal, distances within rtol 1e-5.
6. Serving engine (phases ``engine*``, last of the SSH paths because
   its insert grows the index): ``TimeSeriesDB(searcher="engine")`` on
   the batched index at ``SEARCH`` with ``BatchPolicy(max_batch=8,
   max_wait_ms=2.0)``, the signature LRU cut to one entry so that every
   batch encodes.  Every bucket (1, 2, 4, 8) warmed through
   ``engine.searcher``; a full batch's service time ``s8`` (median of
   15) sets the capacity ``8 / s8`` qps and the SLO p99 <= max(100 ms,
   4 s8).  Open-loop Poisson traces from ``repro_torch.loadgen`` (from
   ``--seed``, length 512, topk 10) over batch 0's 64 queries, each
   holding about 3 s of arrivals at its own load (at most 4096
   requests): fixed 2 ms at 0.25, 0.5, 0.75 and 1.1 x capacity through
   ``sweep``, adaptive at 0.5 x over the same trace as fixed's.
   Logged: latency from arrival (p50, p95, p99), achieved against
   offered qps and the trace's own rate (arrivals over its span), queue
   depth p95, batch histogram, mean batch wait and occupancy, padded-row
   share, stage us a batch and ``max_sustainable_qps`` for each policy.
   The three kernels of the path are held to their plain versions as in
   step 4 on the inputs of the engine's own batches, one of 8 and one of
   1 through ``engine.searcher`` (every call checked, one of each
   timed; the kernel entries' ``engine_shapes``).  Gates: fixed and
   adaptive answer the trace alike (``LoadResult.same_answers``); every
   answer's
   ids and distances equal to ``ssh_search_batch`` on the 64 queries as
   one block; database rows their own top-1; 64 requests submitted then
   ``stop()``: every future resolved, answers equal; ``launch.serve
   --arch ssh-ecg --requests 16`` as a subprocess in its default engine
   mode, exit 0, every request its own top-1; one novel series inserted
   through the running engine at 2^20 (insert ms and peak memory
   logged) found at rank 1 as row N of N + 1.
7. LM serving (the SSH state freed first, so its peak memory is its own):
   granite-3-2b CONFIG at full width in bf16, random weights from a
   ``torch.Generator`` seeded by ``--seed``.  First the flash library's
   build report: ptxas's registers, stack and spills of every flash
   kernel (a spill, a stack frame or local memory in the SASS fails the
   run), and the count of tensor-core instructions (HGMMA, HMMA) in the
   tensor-core kernel's SASS (``cuobjdump -sass``), which must not be 0.
   Then three more counted paths, each with 40 launches of the
   tensor-core kernel ``flash_attention`` (one a layer) and none of the
   CUDA-core ``flash_attention_simt``:
   e1. ``lm``: one prefill of 1 x ``--lm-prompt`` tokens (the
       prefill_32k cell's 32,768 tokens, its batch cut from 32 to 1),
       timed once: tokens/s, seconds, peak memory;
   e2. ``lm_batch``: one prefill of 8 x 2048;
   e3. ``lm_serve``: ``serve_lm`` at batch 8, prompts of 128 tokens
       stepped through ``decode_step``, 32 greedy tokens, one prefill of
       the prompts; gate: the prefill's last-position logits equal the
       decode logits after token 128 within 10 % of max |logit| in bf16
       and, on a float32 copy of the weights (``lm_serve_f32``: 40
       launches of ``flash_attention_simt``, none of the other), within
       1e-4; the argmax equal where the top-2 margin exceeds the
       tolerance.
   Then the tensor-core kernel (its launch counted) on layer 0's own q,
   k, v (all heads at 8 x 2048, heads 0-1 at the long prefill), per
   element with a = sum_j w_j |v_j| (``flash_attention.error_bound``):
   against its plain version within one bf16 ulp, 2^-13 a for float32
   reordering and 2^-8 a for its bf16 weights; against the emulation of
   its own rounding (``ref.flash_attention_tc_ref``) within one ulp,
   2^-13 a and the emulation's spread; the median |o| is printed beside
   each median bound.  At both shapes, in turns
   in one call, its time, the CUDA-core kernel's on the same bf16 inputs
   (through its own entry point, off the path) and
   ``scaled_dot_product_attention``'s (KV heads expanded), the library
   yardstick; the plain version's time at 8 x 2048.  The bound is 4·D
   flops per unmasked (query, key) pair at 989 TFLOP/s (bf16 tensor
   cores) or the q, k, v and o bytes at 3.35 TB/s, the larger.  The
   CUDA-core kernel gets its own entry, held to its plain version and
   timed on the float32 gate's layer-0 inputs (device and call time,
   ``scaled_dot_product_attention`` in float32 beside it), its bound at
   the 67 TFLOP/s of float32 outside the tensor cores.

Prints a ``kernels`` JSON line and, last, ``{"ok": true, "device": ...}``.
Any failure raises and exits non-zero.  Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
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
# float32 operations that do not fuse (the DTW cell's subtract, multiply,
# add and mins): one per FP32 lane per clock, 132 SMs x 128 lanes x 1.98
# GHz; F32_OPS_PER_S counts an FMA as two
F32_NONFUSED_OPS_PER_S = 33.5e12
BATCHES, BATCH_SIZE = 4, 64     # the batched path: 4 batches of 64 queries
SEQ_ROWS, SEQ_WARPED = 8, 8     # the sequential path: queries of batch 0
UCR_QUERIES, UCR_GOLD = 4, 2    # UCR scans, and how many brute force holds
# the launchers' build: synthetic-ECG points (their windows of --length at
# stride 1 are the database, 69,489 series at length 512)
LAUNCH_POINTS = 70_000
STREAM_SHARDS, STREAM_BLOCKS = 2, 8
# the engine phase: the reference's BatchPolicy defaults (max_batch 8,
# 2 ms), offered loads as fractions of the measured full-batch capacity
# (benchmarks/loadgen_bench.py:45-54), a Poisson trace a load holding
# about ENGINE_TRACE_S seconds of arrivals at that load (at most
# ENGINE_MAX_REQUESTS requests), and the SLO p99 <= max(100 ms, 4 x one
# full batch's service time)
ENGINE_MAX_BATCH, ENGINE_WAIT_MS = 8, 2.0
ENGINE_LOAD_FRACS = (0.25, 0.5, 0.75, 1.1)
ENGINE_ADAPTIVE_FRAC = 0.5
ENGINE_TRACE_S, ENGINE_MAX_REQUESTS = 3.0, 4096
ENGINE_S8_BATCHES = 15
ENGINE_SLO_FLOOR_MS, ENGINE_SLO_MULT = 100.0, 4.0
ENGINE_LAUNCHER_REQUESTS = 16
BF16_TC_OPS_PER_S = 989e12      # H100 SXM bf16 tensor cores, dense
PREFILL_32K_BATCH = 32          # the prefill_32k cell's batch (cut to 1)
LM_BATCH, LM_BATCH_LEN = 8, 2048                   # the batch prefill
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 8, 128, 32  # the serve loop
# prefill against stepped decode, as max |diff| / max |logit|.  In
# float32 the two paths differ by reordering only: 1e-4.  In bf16 each
# path lands about 4 % of max |logit| off the float32 result (the run
# logs both), because the two round to bf16 at other places (batched
# against one-row products, float32 against bf16 softmax weights) and 40
# residual layers of random weights carry the differences on: twice
# that, 10 %.  A wrong mask moves the logits by their own size.
GATE_REL_TOL = {"bfloat16": 0.10, "float32": 1e-4}


def log(*a):
    print(*a, flush=True)


def cuda_time_ms(fn, min_iters=5, budget_ms=300.0):
    """Mean ms per call by CUDA events around back-to-back calls, after a
    warm-up (``repro_torch.bench.device_time.call_ms``)."""
    from repro_torch.bench.device_time import call_ms
    return call_ms(fn, min_iters, budget_ms)


def kernel_times(kernel_fn, library_fn=None):
    """Device ms a call (``torch.profiler``'s kernel time,
    ``repro_torch.bench.device_time``) as ``ms`` and the call time (CUDA
    events around back-to-back calls) as ``call_ms``, of a kernel and of
    its library yardstick when there is one; whether the profiled window
    kept every record, how many windows were profiled to get one that
    kept any (``device_windows``; 1 unless a window came back empty), and
    where the device time came from (``device_source``: ``"profiler"``,
    or ``"events"`` when every window came back empty).  ``events_ms``
    is the kernel's device time read by events alone
    (``device_time.spun_ms``), the clock that stands in when the profiler
    keeps nothing, held beside the profiler's in every run."""
    from repro_torch.bench.device_time import spun_ms, timed
    k = timed(kernel_fn)
    out = dict(ms=k["device_ms"], call_ms=k["call_ms"],
               events_ms=spun_ms(kernel_fn),
               device_window_complete=k["device_complete"],
               device_windows=k["device_windows"],
               device_source=k["device_source"])
    if library_fn is not None:
        lib = timed(library_fn)
        out.update(library_ms=lib["device_ms"],
                   library_call_ms=lib["call_ms"],
                   library_window_complete=lib["device_complete"],
                   library_windows=lib["device_windows"],
                   library_source=lib["device_source"])
    return out


def bound_ms(n_bytes, n_ops, ops_per_s=F32_OPS_PER_S):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


class _Enough(Exception):
    """Raised by a Recorder once it holds ``stop_after`` calls."""


class Recorder:
    """Pass-through around the ``kernels.ops`` entry points that keeps
    the arguments of every call (a path's own kernel inputs).  With
    ``stop_after=n`` the n-th call is recorded and the run stopped there
    instead of computed (the context swallows the stop)."""

    def __init__(self, ops, names, stop_after=None):
        self.ops, self.names, self.calls = ops, names, {n: [] for n in names}
        self.saved, self.stop_after = {}, stop_after

    def __enter__(self):
        for n in self.names:
            fn = getattr(self.ops, n)
            self.saved[n] = fn

            def spy(*args, _fn=fn, _n=n, **kw):
                self.calls[_n].append((args, kw))
                if len(self.calls[_n]) == self.stop_after:
                    raise _Enough
                return _fn(*args, **kw)
            setattr(self.ops, n, spy)
        return self

    def __exit__(self, exc_type, *exc):
        for n, fn in self.saved.items():
            setattr(self.ops, n, fn)
        return exc_type is _Enough


def arg(call, i, name):
    """Positional argument ``i`` or keyword ``name`` of a recorded call."""
    args, kw = call
    return args[i] if len(args) > i else kw.get(name)


def dir_bytes(path: Path) -> int:
    return sum(f.stat().st_size for f in path.rglob("*") if f.is_file())


def persist_paths(args, counted, ctx) -> None:
    """Path e: save/load of the batched index and of the streaming
    ``"ssh-cs"`` database, the host-bucket probe, the ``"srp"`` and
    ``"ssh-multires"`` encoders at full scale, the two launchers as
    subprocesses and the signature LRU (step 3e of the docstring).  Every
    saved directory lives under ``build/`` and is removed when read."""
    import shutil
    import tempfile
    from repro_torch.core import search
    from repro_torch.db import TimeSeriesDB
    from repro_torch.encoders import IndexSpec
    from repro_torch.kernels import ops

    series, batches, cfg = ctx["series"], ctx["batches"], ctx["cfg"]
    db, results = ctx["db"], ctx["results"]
    n, m = series.shape
    half = BATCH_SIZE // 2
    root = Path(__file__).resolve().parent / "build"
    root.mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="persist_", dir=root))
    free = shutil.disk_usage(tmp).free
    # series and two envelopes a database; one is on disk at a time
    need = 2 * (series.nbytes * 3)
    log(f"persist: saving under {tmp}, {free / 1e9:.1f} GB free there; "
        f"one saved {n} x {m} database holds about "
        f"{3 * series.nbytes / 1e9:.1f} GB")
    if free < need:
        raise AssertionError(f"persist: {free / 1e9:.1f} GB free under "
                             f"{tmp}, fewer than the {need / 1e9:.1f} GB the "
                             f"phase needs at {n} series")

    def same_answers(got, want, what):
        for bi, (g_b, w_b) in enumerate(zip(got, want)):
            for i, (g, w) in enumerate(zip(g_b, w_b)):
                if not (np.array_equal(g.ids, w.ids)
                        and np.array_equal(g.dists, w.dists)):
                    raise AssertionError(
                        f"{what}: batch {bi} query {i} ids {g.ids} dists "
                        f"{g.dists} != {w.ids} {w.dists}")

    def self_matched(res, rows, what):
        bad = [int(rows[i]) for i, r in enumerate(res[:half])
               if int(r.ids[0]) != int(rows[i])]
        if bad:
            raise AssertionError(f"{what}: database rows {bad} are not "
                                 f"their own top-1")

    # 1. the batched index: save, load, the same answers bit for bit
    d1 = tmp / "ssh_ecg"
    t = time.perf_counter()
    db.save(d1)
    save_s = time.perf_counter() - t
    nbytes = dir_bytes(d1)
    torch.cuda.synchronize()
    t = time.perf_counter()
    db2 = TimeSeriesDB.load(d1)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t
    shutil.rmtree(d1)

    def loaded_path():
        return [db2.search_batch(qs) for _, qs in batches]

    got = counted("persist_load", ("sketch_conv", "collision_count_batch",
                                   "dtw_wavefront_pairs"), loaded_path)
    same_answers(got, results, "loaded index")
    log(f"persist: saved {len(db)} series in {save_s:.2f} s, "
        f"{nbytes / 1e9:.3f} GB ({nbytes / save_s / 1e9:.2f} GB/s); loaded "
        f"onto the card in {load_s:.2f} s ({nbytes / load_s / 1e9:.2f} "
        f"GB/s); the build of the same index took {ctx['build_s']:.2f} s; "
        f"{BATCHES} x {BATCH_SIZE} queries answer bit-identically")

    # 2. the streaming database: save, load, one more chunk into both
    db_cs = ctx["db_cs"]
    d2 = tmp / "ssh_cs"
    t = time.perf_counter()
    db_cs.save(d2)
    cs_save_s = time.perf_counter() - t
    t = time.perf_counter()
    db_cs2 = TimeSeriesDB.load(d2)
    torch.cuda.synchronize()
    cs_load_s = time.perf_counter() - t
    shutil.rmtree(d2)
    chunk = series[:4096] + np.float32(0.01)

    def ingest_both():
        for d in (db_cs, db_cs2):
            d.add_stream(chunk)
            d.flush()

    counted("persist_cs", ("sketch_conv", "cs_tables"), ingest_both)
    for name in ("signatures", "keys", "series"):
        if not torch.equal(getattr(db_cs.index, name),
                           getattr(db_cs2.index, name)):
            raise AssertionError(f"ssh-cs after load and ingest: {name} "
                                 f"differ from the never-saved database")
    if not torch.equal(db_cs.index.encoder.aggregate_sketch(),
                       db_cs2.index.encoder.aggregate_sketch()):
        raise AssertionError("ssh-cs after load and ingest: cs/agg differs")
    log(f"persist: ssh-cs database of {len(db_cs2) - 4096} series saved in "
        f"{cs_save_s:.2f} s, loaded in {cs_load_s:.2f} s; after one more "
        f"4096-row chunk into both, signatures, keys and cs/agg are equal")
    del db_cs2

    # 3. host buckets on the loaded index, through the local searcher
    t = time.perf_counter()
    db_hb = TimeSeriesDB(db2.index, cfg.replace(searcher="local",
                                                use_host_buckets=True))
    hb_s = time.perf_counter() - t
    rows0, qs0 = batches[0]
    hb_pick = ctx["seq_pick"]

    def host_bucket_path():
        out, walls = [], []
        for i in hb_pick:
            torch.cuda.synchronize()
            t = time.perf_counter()
            out.append(db_hb.search(qs0[i]))
            walls.append(time.perf_counter() - t)
        return out, walls

    hb_res, hb_walls = counted("persist_host_buckets", ("dtw_wavefront",),
                               host_bucket_path)
    bad = [int(rows0[i]) for i, r in zip(hb_pick, hb_res)
           if i < half and int(r.ids[0]) != int(rows0[i])]
    if bad:
        raise AssertionError(f"host buckets: database rows {bad} are not "
                             f"their own top-1")
    log(f"persist: host buckets of {len(db2)} x {db2.index.num_tables} keys "
        f"built in {hb_s:.2f} s; {len(hb_pick)} queries, the "
        f"{sum(i < half for i in hb_pick)} database rows self-matched; "
        f"candidates a query {[r.n_candidates for r in hb_res]}; "
        f"us_per_query {np.mean(hb_walls[1:]) * 1e6:.1f} (mean of queries "
        f"2-{len(hb_walls)}; the first {hb_walls[0] * 1e6:.1f}) probe_us "
        f"{np.mean([r.stats.stage_us['probe'] for r in hb_res[1:]]):.1f}")
    db2.index.host_buckets = None

    # 4. the srp and ssh-multires encoders at full scale
    ucr_ids = [u.ids for u in ctx["ucr_res"]]
    precision = {"ssh": ctx["precs"]}
    for name, spec, kernels in (
            ("srp", IndexSpec(encoder="srp"),
             ("collision_count_batch", "dtw_wavefront_pairs")),
            ("ssh-multires", IndexSpec(encoder="ssh-multires"),
             ("sketch_conv", "collision_count_batch",
              "dtw_wavefront_pairs"))):
        rows, qs = batches[0]

        def encoder_path():
            t = time.perf_counter()
            d = TimeSeriesDB.build(series, spec, cfg)
            torch.cuda.synchronize()
            return d, time.perf_counter() - t, d.search_batch(qs)

        d, b_s, res = counted(f"persist_{name}", kernels, encoder_path)
        self_matched(res, rows, name)
        dd = tmp / name
        d.save(dd)
        res2 = TimeSeriesDB.load(dd).search_batch(qs)
        shutil.rmtree(dd)
        same_answers([res2], [res], f"{name} after save and load")
        precision[name] = [search.precision_at_k(res[i].ids, u, cfg.topk)
                           for i, u in zip(ctx["ucr_pick"], ucr_ids)]
        log(f"persist: {name} {d} built in {b_s:.2f} s; batch 0 "
            f"self-matched, answers bit-identical after save and load; "
            f"precision@{cfg.topk} against UCR on the {len(ucr_ids)} UCR "
            f"queries {precision[name]} (ssh {precision['ssh']})")
        del d, res, res2
        gc.collect()
        torch.cuda.empty_cache()

    # 5. the launchers, as a user runs them
    src = Path(__file__).resolve().parent / "src"
    env = dict(os.environ, PYTHONPATH=str(src))
    out = tmp / "built"
    cmds = [[sys.executable, "-m", "repro_torch.launch.build_index",
             "--points", str(LAUNCH_POINTS), "--length", str(m),
             "--out", str(out)],
            [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
             "ssh-ecg", "--sequential", "--db-dir", str(out)]]

    def launchers():
        outs = []
        for cmd in cmds:
            t = time.perf_counter()
            p = subprocess.run(cmd, capture_output=True, text=True,
                               timeout=600, cwd=src.parent, env=env)
            outs.append((p, time.perf_counter() - t))
            if p.returncode != 0:
                raise AssertionError(f"{' '.join(cmd[1:4])} exit "
                                     f"{p.returncode}: {p.stderr[-3000:]}")
        return outs

    (b, b_t), (srv, s_t) = counted("persist_launchers", (), launchers)
    shutil.rmtree(out)
    if "loaded database" not in srv.stdout:
        raise AssertionError(f"serve --db-dir did not load the database: "
                             f"{srv.stdout[-2000:]}")
    log(f"persist: build_index --points {LAUNCH_POINTS} --length {m} "
        f"{b_t:.1f} s: {b.stdout.strip().splitlines()[-1]}")
    log(f"persist: serve --sequential --db-dir {s_t:.1f} s: "
        f"{' | '.join(srv.stdout.strip().splitlines()[-3:])}")

    # 6. the signature LRU: batch 0 twice on the loaded index, from an
    # empty LRU (the loaded path above filled it), so the first encodes
    db2.index.sig_cache = None
    first = ops_batch_stats(db2, batches[0][1])
    again = counted("persist_sig_cache", ("collision_count_batch",
                                          "dtw_wavefront_pairs"),
                    lambda: ops_batch_stats(db2, batches[0][1]))
    if ops.launch_counts()["sketch_conv"]:
        raise AssertionError("signature LRU: the repeated batch launched "
                             "sketch_conv")
    if again[1].sig_cache_hit != BATCH_SIZE:
        raise AssertionError(f"signature LRU: {again[1].sig_cache_hit} "
                             f"hits for the repeated batch, expected "
                             f"{BATCH_SIZE}")
    if not np.array_equal(again[0], first[0]):
        raise AssertionError("signature LRU: a cached batch answers "
                             "other ids")
    log(f"persist: repeated batch 0 on the loaded index: sig_cache_hit "
        f"{first[1].sig_cache_hit} then {again[1].sig_cache_hit}, the same "
        f"ids, no sketch_conv launch on the hit; encode stage "
        f"{first[1].stage_us['encode']:.1f} us encoding, "
        f"{again[1].stage_us['encode']:.1f} us on the hit")
    shutil.rmtree(tmp, ignore_errors=True)


def padded_share(hist, buckets) -> float:
    """Share of the rows the engine searched that were bucket padding,
    from its histogram of real batch sizes."""
    real = sum(b * c for b, c in hist.items())
    padded = sum(next(s for s in buckets if s >= b) * c
                 for b, c in hist.items())
    return (padded - real) / padded if padded else 0.0


def engine_paths(args, counted, ctx) -> None:
    """The dynamic-batching ``ServingEngine`` behind
    ``TimeSeriesDB(searcher="engine")`` on the 2^20 index (step 6 of the
    docstring).  Raises on any gate; a batch's exception reaches its
    futures and ``run_trace`` re-raises it.  Returns the kernels' calls
    recorded on one batch of 8 and one of 1, {size: {name: [(args,
    kwargs)]}}."""
    from repro_torch.data.timeseries import extract_subsequences, \
        synthetic_ecg
    from repro_torch.db import BatchPolicy, TimeSeriesDB
    from repro_torch.encoders.sigcache import SignatureCache
    from repro_torch.kernels import ops
    from repro_torch.loadgen import (Mixture, WorkloadSpec, generate_trace,
                                     run_trace, sweep)
    from repro_torch.loadgen.harness import SUSTAINED_FRAC
    from repro_torch.serving import ssh_search_batch

    rows, pool = ctx["batches"][0]
    cfg, index = ctx["cfg"], ctx["db"].index
    n, m = ctx["series"].shape
    half = len(rows) // 2
    policy = BatchPolicy(max_batch=ENGINE_MAX_BATCH,
                         max_wait_ms=ENGINE_WAIT_MS)
    cfg_e = cfg.replace(searcher="engine", batch_policy=policy)
    buckets = cfg_e.buckets()
    # a one-entry signature LRU: the pool's 64 queries repeat within a
    # trace, and a batch whose rows were all cached would skip the sketch;
    # with one entry every batch of two or more rows encodes, as new
    # traffic does (hits are counted and logged)
    index.sig_cache = SignatureCache(capacity=1)
    engines = []

    def make(mode="fixed"):
        tsdb = TimeSeriesDB(index, cfg_e.replace(
            batch_policy=policy.replace(mode=mode)))
        engines.append(tsdb.engine)
        return engines[-1]

    pools, sizes = {m: pool}, {m: len(pool)}
    want = ssh_search_batch(pool, index, config=cfg_e)   # one block of 64
    want = [want.per_query(i) for i in range(len(pool))]

    def check_answers(res, trace, what):
        for k, (ids, dists) in enumerate(zip(res.ids, res.dists)):
            pid, topk = int(trace.pool_ids[k]), int(trace.topks[k])
            w = want[pid]
            if not (np.array_equal(ids, w.ids[:topk])
                    and np.array_equal(dists, w.dists[:topk])):
                raise AssertionError(
                    f"engine {what}: request {k} (pool row {pid}) ids {ids} "
                    f"dists {dists} != the block's {w.ids} {w.dists}")
            if pid < half and int(ids[0]) != int(rows[pid]):
                raise AssertionError(f"engine {what}: database row "
                                     f"{rows[pid]} is not its own top-1")

    def traffic():
        # every bucket warmed through engine.searcher, outside the metrics
        warm = make()
        for size in buckets:
            warm.searcher.search_batch(pool[:size])
        service = {}                # bucket -> seconds a batch, each run
        for size in buckets:
            service[size] = []
            for r in range(ENGINE_S8_BATCHES):
                block = pool[(np.arange(size) + size * r) % len(pool)]
                t = time.perf_counter()
                warm.searcher.search_batch(block)  # ends with host arrays
                service[size].append(time.perf_counter() - t)
        s8s = service[ENGINE_MAX_BATCH]
        s8 = float(np.median(s8s))
        capacity = ENGINE_MAX_BATCH / s8
        slo_ms = max(ENGINE_SLO_FLOOR_MS, ENGINE_SLO_MULT * s8 * 1e3)
        log(f"engine: full batch of {ENGINE_MAX_BATCH} s8 median "
            f"{s8 * 1e3:.3f} ms over {ENGINE_S8_BATCHES} (min "
            f"{min(s8s) * 1e3:.3f}, max {max(s8s) * 1e3:.3f}); capacity "
            f"{capacity:.1f} qps; SLO p99 <= {slo_ms:.1f} ms; median ms "
            f"a batch by bucket { {b: round(float(np.median(v)) * 1e3, 3)
                                   for b, v in service.items()} }")
        base = WorkloadSpec(
            process="poisson", rate_qps=capacity, seed=args.seed,
            n_requests=32, lengths=Mixture((m,)), topks=Mixture((cfg.topk,)))
        with warm:                  # first live replay's one-time costs
            run_trace(warm, generate_trace(base.replace(
                rate_qps=ENGINE_LOAD_FRACS[0] * capacity), sizes), pools)
        points = []
        for mode, fracs in (("fixed", ENGINE_LOAD_FRACS),
                            ("adaptive", (ENGINE_ADAPTIVE_FRAC,))):
            best = 0.0
            for f in fracs:
                # ~ENGINE_TRACE_S of arrivals at this load, so the drain
                # after the last arrival is a small share of the window
                load = f * capacity
                spec = base.replace(n_requests=int(min(
                    ENGINE_MAX_REQUESTS, max(16, round(
                        load * ENGINE_TRACE_S)))))
                (res,), b = sweep(lambda mode=mode: make(mode), spec, [load],
                                  pools, slo_ms)
                best = max(best, b)
                points.append((mode, f, load, spec, res, engines[-1]))
            log(f"engine {mode}: max_sustainable_qps {best:.1f} of offered "
                f"{[round(f * capacity, 1) for f in fracs]} (SLO p99 <= "
                f"{slo_ms:.1f} ms, achieved >= {SUSTAINED_FRAC} x offered)")
        return points

    points = counted("engine", ("sketch_conv", "collision_count_batch",
                                "dtw_wavefront_pairs"), traffic)
    by = {(mode, f): r for mode, f, _, _, r, _ in points}
    if not by[("fixed", ENGINE_ADAPTIVE_FRAC)].same_answers(
            by[("adaptive", ENGINE_ADAPTIVE_FRAC)]):
        raise AssertionError("engine: fixed and adaptive batching answer the "
                             "same trace differently")
    for mode, frac, load, spec, res, eng in points:
        # the trace sweep() replayed at this load
        trace = generate_trace(spec.replace(rate_qps=float(load)), sizes)
        check_answers(res, trace, f"{mode} {frac}")
        snap = eng.metrics.snapshot()
        log(f"engine {mode} {frac} x capacity: offered "
            f"{res.offered_qps:.1f} (the trace's own rate "
            f"{len(trace) / trace.duration_s:.1f}: {len(trace)} arrivals in "
            f"{trace.duration_s:.3f} s) achieved {res.achieved_qps:.1f} qps, "
            f"{res.n_requests} requests in {res.wall_s:.3f} s; latency from "
            f"arrival p50 {res.latency_p50_ms:.3f} p95 "
            f"{res.latency_p95_ms:.3f} p99 {res.latency_p99_ms:.3f} ms; "
            f"queue depth p95 {res.queue_depth_p95:.0f} max "
            f"{res.queue_depth_max:.0f}; batches "
            f"{dict(sorted(res.batch_histogram.items()))} mean "
            f"{res.batch_size_mean:.2f}, wait {res.batch_wait_ms_mean:.3f} "
            f"ms, occupancy {res.batch_occupancy_mean:.3f}; padded rows "
            f"{padded_share(res.batch_histogram, buckets):.3f}; stage_us a "
            f"batch { {k: round(v, 1) for k, v in res.stage_us.items()} }; "
            f"service EWMA {eng.service_ewma_s * 1e3:.3f} ms; sig-cache hits "
            f"{snap['sig_cache_hits_total']}; answers equal to the block's")
    log("engine: fixed and adaptive answers bit-identical over one trace")

    # the kernels' inputs at the engine's own shapes: a full batch (4
    # database rows, 4 warped copies) and a batch of one warped copy
    # through the engine's searcher, each from an empty LRU so it encodes
    # (held to the plain versions in ssh_paths)
    recorded, searcher = {}, make().searcher
    blocks = {ENGINE_MAX_BATCH: list(range(ENGINE_MAX_BATCH // 2))
              + list(range(half, half + ENGINE_MAX_BATCH // 2)), 1: [half]}
    for size, picks in blocks.items():
        index.sig_cache = SignatureCache(capacity=1)
        with Recorder(ops, ("sketch_conv", "collision_count_batch",
                            "dtw_rerank_pairs")) as rec:
            searcher.search_batch(pool[picks])
        missing = [k for k, v in rec.calls.items() if not v]
        if missing:
            raise AssertionError(f"engine: a batch of {size} through the "
                                 f"engine's searcher called no {missing}")
        recorded[size] = rec.calls
    index.sig_cache = SignatureCache(capacity=1)

    # stop() with requests queued: every future resolves, answers right
    def burst():
        eng = make()
        eng.start()
        futs = [eng.submit(q) for q in pool]
        eng.stop()
        return eng, futs

    eng, futs = counted("engine_stop", ("collision_count_batch",), burst)
    if not all(f.done() for f in futs):
        raise AssertionError(f"engine: {sum(not f.done() for f in futs)} "
                             f"futures unresolved after stop()")
    for i, f in enumerate(futs):
        if not np.array_equal(f.result().ids, want[i].ids):
            raise AssertionError(f"engine: pool row {i} answered "
                                 f"{f.result().ids} around stop(), the "
                                 f"block {want[i].ids}")
    log(f"engine: {len(futs)} requests submitted then stop(): all resolved "
        f"({eng.metrics.snapshot()['batches_total']} batches, histogram "
        f"{dict(sorted(eng.metrics.batch_histogram().items()))})")

    # the launcher as a user runs it, in its default engine mode
    src = Path(__file__).resolve().parent / "src"
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
           "ssh-ecg", "--requests", str(ENGINE_LAUNCHER_REQUESTS)]

    def launcher():
        t = time.perf_counter()
        p = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                           cwd=src.parent,
                           env=dict(os.environ, PYTHONPATH=str(src)))
        return p, time.perf_counter() - t

    srv, srv_s = counted("engine_launcher", (), launcher)
    reqs = [line for line in srv.stdout.splitlines()
            if line.startswith("req ")]
    bad = [line for line in reqs
           if line.split(":")[0].split()[1] !=
           line.split("top1=")[1].split()[0]]
    if srv.returncode != 0 or len(reqs) != ENGINE_LAUNCHER_REQUESTS or bad \
            or "engine: req=" not in srv.stdout:
        raise AssertionError(f"serve --arch ssh-ecg exit {srv.returncode}, "
                             f"{len(reqs)} request lines, not self-matched "
                             f"{bad}: {srv.stdout[-2000:]} "
                             f"{srv.stderr[-2000:]}")
    log(f"engine: serve --arch ssh-ecg --requests "
        f"{ENGINE_LAUNCHER_REQUESTS} {srv_s:.1f} s, every request its own "
        f"top-1: {' | '.join(srv.stdout.strip().splitlines()[-2:])}")

    # a novel series inserted through the running engine at 2^20
    novel = extract_subsequences(synthetic_ecg(8 * m, seed=args.seed + 7),
                                 m, stride=m, max_count=1, znorm=True)

    def insert_path():
        tsdb = TimeSeriesDB(index, cfg_e)
        with tsdb:
            tsdb.search(pool[0])
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
            t = time.perf_counter()
            tsdb.add(novel)
            tsdb.engine.flush_inserts()
            torch.cuda.synchronize()
            insert_s = time.perf_counter() - t
            peak = torch.cuda.max_memory_allocated() - before
            got = tsdb.search(novel[0])
        return got, insert_s, peak, before

    got, insert_s, peak, before = counted(
        "engine_insert", ("sketch_conv", "collision_count_batch",
                          "dtw_wavefront_pairs"), insert_path)
    if int(got.ids[0]) != n or got.n_database != n + 1:
        raise AssertionError(f"engine insert: the novel series is not found "
                             f"at rank 1 as row {n} of {n + 1}: ids "
                             f"{got.ids}, n_database {got.n_database}")
    log(f"engine: one novel series inserted through the running engine at "
        f"{n} series in {insert_s * 1e3:.1f} ms, peak {peak / 1e9:.2f} GB "
        f"above the {before / 1e9:.2f} GB allocated; found at rank 1 as row "
        f"{n} of {got.n_database}")
    index.sig_cache = None
    return recorded


def ops_batch_stats(d, qs):
    """(ids, stats) of one batched search through the library call."""
    from repro_torch.serving.batched import ssh_search_batch
    res = ssh_search_batch(qs, d.index, config=d.config)
    return res.ids, res.stats


def ssh_paths(args, counted, phases) -> list:
    """Paths a-d and the six SSH kernels (steps 2-5 of the docstring);
    returns their kernel entries.  Every tensor of the SSH state is freed
    when this returns."""
    from repro_torch.configs import ssh_ecg
    from repro_torch.core import dtw as core_dtw
    from repro_torch.core import search
    from repro_torch.core.index import SSHIndex
    from repro_torch.data.timeseries import (extract_subsequences,
                                             synthetic_ecg, warp_series)
    from repro_torch.db import TimeSeriesDB
    from repro_torch.encoders import IndexSpec
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import dtw_wavefront as kd
    from repro_torch.serving.batched import ssh_search_batch
    from repro_torch.streaming import StreamIngestor

    dev = torch.device("cuda")
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

    spec = ssh_ecg.CONFIG
    cfg = ssh_ecg.search_config(length=m)
    log(f"spec {spec.to_dict()}; search {cfg.to_dict()}")

    # -- a. batched path ------------------------------------------------------
    def batched_path():
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        db = TimeSeriesDB.build(series, spec, cfg)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t
        log(f"build: {build_s:.2f} s ({n / build_s:.0f} series/s), index "
            f"{db.index.nbytes() / 1e9:.2f} GB on {dev}, launches "
            f"{ops.launch_counts()}")
        results, walls = [], []
        for bi, (rows, qs) in enumerate(batches):
            before = ops.launch_counts()
            torch.cuda.synchronize()
            t = time.perf_counter()
            res = ssh_search_batch(qs, db.index, config=db.config)
            wall = time.perf_counter() - t
            after = ops.launch_counts()
            st = res.stats
            per_q = [res.per_query(i) for i in range(res.n_queries)]
            results.append(per_q)
            walls.append(wall)
            selfs = [int(r.ids[0]) == int(rows[i])
                     for i, r in enumerate(per_q[:half])]
            if not all(selfs):
                raise AssertionError(
                    f"batch {bi}: self-match failed for rows "
                    f"{[int(rows[i]) for i, ok in enumerate(selfs) if not ok]}")
            for r in per_q:
                if not (len(r.ids) == cfg.topk and r.stats is None
                        and np.all(np.isfinite(r.dists))
                        and np.all(np.diff(r.dists) >= 0)
                        and np.all((r.ids >= 0) & (r.ids < n))):
                    raise AssertionError(f"batch {bi}: malformed result {r}")
            log(f"batch {bi}: us_per_query {wall / bs * 1e6:.1f} stage_us "
                f"{ {k: round(v, 1) for k, v in st.stage_us.items()} } "
                f"(whole batch) n_in {st.n_in} lb_pruned {st.lb_pruned} "
                f"n_dtw {st.n_dtw} abandoned {st.dtw_abandoned} launches "
                f"{ {k: after[k] - before[k] for k in after} }")
        log(f"batched path: peak memory "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
        return db, results, build_s

    db, results, build_s = counted(
        "batched", ("sketch_conv", "collision_count_batch",
                    "dtw_wavefront_pairs"), batched_path)

    # -- b. sequential path ---------------------------------------------------
    rows0, qs0 = batches[0]
    seq_pick = list(range(SEQ_ROWS)) + list(range(half, half + SEQ_WARPED))
    db_local = TimeSeriesDB(db.index, cfg.replace(searcher="local"))
    # the batched path left batch 0's multiprobe signatures in the index's
    # LRU under the key the sequential encode reads: emptied, so this path
    # encodes (and launches sketch_conv) as a cold query does
    db.index.sig_cache = None

    def sequential_path():
        out, walls = [], []
        for i in seq_pick:
            torch.cuda.synchronize()
            t = time.perf_counter()
            out.append(db_local.search(qs0[i]))
            walls.append(time.perf_counter() - t)
        return out, walls

    seq_res, seq_walls = counted(
        "sequential", ("sketch_conv", "collision_count", "dtw_wavefront"),
        sequential_path)
    max_rel = 0.0
    for j, i in enumerate(seq_pick):
        got, want = seq_res[j], results[0][i]
        if i < half and int(got.ids[0]) != int(rows0[i]):
            raise AssertionError(f"sequential query {i}: top-1 {got.ids[0]} "
                                 f"is not the database row {rows0[i]}")
        if not np.array_equal(got.ids, want.ids):
            raise AssertionError(f"sequential query {i}: ids {got.ids} != "
                                 f"batched ids {want.ids}")
        np.testing.assert_allclose(got.dists, want.dists, rtol=1e-5,
                                   atol=1e-6)
        max_rel = max(max_rel, float(np.max(
            np.abs(got.dists - want.dists) / np.maximum(want.dists, 1e-30))))
        if got.stats.n_dtw != got.n_candidates:
            raise AssertionError(f"sequential query {i}: stats.n_dtw "
                                 f"{got.stats.n_dtw} != n_candidates")
    seq_us = float(np.mean(seq_walls[1:]) * 1e6)
    stage_keys = seq_res[0].stats.stage_us.keys()
    seq_stage = {k: round(float(np.mean([r.stats.stage_us[k]
                                         for r in seq_res[1:]])), 1)
                 for k in stage_keys}
    log(f"sequential: {len(seq_pick)} queries ({SEQ_ROWS} database rows "
        f"self-matched, {SEQ_WARPED} warped), ids equal to the batched "
        f"answers, largest relative distance difference {max_rel:.3g}; "
        f"us_per_query {seq_us:.1f} (mean of queries 2-{len(seq_pick)}; "
        f"the first {seq_walls[0] * 1e6:.1f}) stage_us {seq_stage}; "
        f"n_dtw per query {[r.stats.n_dtw for r in seq_res]}")

    # -- c. UCR baseline ------------------------------------------------------
    # positions in batch 0: database rows first, then warped copies
    ucr_pick = (list(range(UCR_QUERIES // 2))
                + list(range(half, half + UCR_QUERIES // 2)))
    db_series = db.index.series

    def ucr_path():
        out, walls = [], []
        for i in ucr_pick:
            torch.cuda.synchronize()
            t = time.perf_counter()
            out.append(search.ucr_search(qs0[i], db_series, topk=cfg.topk,
                                         band=cfg.band))
            walls.append(time.perf_counter() - t)
        return out, walls

    ucr_res, ucr_walls = counted("ucr", ("dtw_wavefront",), ucr_path)
    precs, ndcgs = [], []
    for j, i in enumerate(ucr_pick):
        u = ucr_res[j]
        if i < half and int(u.ids[0]) != int(rows0[i]):
            raise AssertionError(f"ucr query {i}: top-1 {u.ids[0]} is not "
                                 f"the database row {rows0[i]}")
        ssh_ids = seq_res[seq_pick.index(i)].ids
        precs.append(search.precision_at_k(ssh_ids, u.ids, cfg.topk))
        ndcgs.append(search.ndcg_at_k(ssh_ids, u.ids, cfg.topk))
    t = time.perf_counter()
    for i in (ucr_pick[0], ucr_pick[-1])[:UCR_GOLD]:
        gold_ids, _ = search.brute_force_topk(qs0[i], db_series, cfg.topk,
                                              cfg.band)
        got = ucr_res[ucr_pick.index(i)].ids
        if not np.array_equal(got, gold_ids):
            raise AssertionError(f"ucr query {i}: ids {got} != brute force "
                                 f"{gold_ids}")
    gold_s = time.perf_counter() - t
    ucr_us = float(np.mean(ucr_walls) * 1e6)
    log(f"ucr: {len(ucr_pick)} queries over {n} series, survivors "
        f"{[u.n_candidates for u in ucr_res]}, us_per_query {ucr_us:.1f} "
        f"({[round(w * 1e6, 1) for w in ucr_walls]}); {UCR_GOLD} equal to "
        f"brute force ({gold_s:.1f} s of plain DTW over the database); SSH "
        f"precision@{cfg.topk} {precs} NDCG@{cfg.topk} "
        f"{[round(x, 4) for x in ndcgs]} against UCR; UCR / sequential SSH "
        f"time per query {ucr_us / seq_us:.1f}")

    # -- d. streaming ingest --------------------------------------------------
    spec_cs = IndexSpec(encoder="ssh-cs", params=dict(
        spec.params, rows=4, width=4096, base_bits=4), seed=spec.seed)
    n_base = n // 2
    block = (n - n_base) // STREAM_BLOCKS

    def streaming_path():
        t = time.perf_counter()
        db_cs = TimeSeriesDB.build(series[:n_base], spec_cs, cfg)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t
        enc = db_cs.index.encoder
        agg0 = enc.aggregate_sketch().clone()
        shards = [StreamIngestor(enc, shard=f"edge{s}")
                  for s in range(STREAM_SHARDS)]
        t = time.perf_counter()
        # shard s takes blocks s, s + 2, ... and appends them last first
        for s, sh in enumerate(shards):
            for seq in reversed(range(s, STREAM_BLOCKS, STREAM_SHARDS)):
                lo = n_base + seq * block
                sh.append(series[lo:lo + block], seq=seq)
        torch.cuda.synchronize()
        ingest_s = time.perf_counter() - t
        merged = StreamIngestor.merge_all(shards[::-1])
        shard_sum = shards[0].sketch + shards[1].sketch
        if not torch.equal(merged.sketch, shard_sum):
            raise AssertionError("merged cs/agg is not the exact sum of the "
                                 "shard aggregates")
        t = time.perf_counter()
        db_cs.apply_stream(merged)
        torch.cuda.synchronize()
        fold_s = time.perf_counter() - t
        if not torch.equal(enc.aggregate_sketch(), agg0 + shard_sum):
            raise AssertionError("folded cs/agg is not the exact sum")
        n_cs = n_base + STREAM_BLOCKS * block
        if len(db_cs) != n_cs:
            raise AssertionError(f"folded database holds {len(db_cs)} rows, "
                                 f"expected {n_cs}")
        lo = n_base + 3 * block
        again = enc.encode_batch(db_cs.index.series[lo:lo + 4096])
        if not torch.equal(again, db_cs.index.signatures[lo:lo + 4096]):
            raise AssertionError("a re-encoded chunk disagrees with the "
                                 "signatures the ingestor stored")
        if not torch.equal(db_cs.index.series[lo:lo + 4096].cpu(),
                           torch.from_numpy(series[lo:lo + 4096])):
            raise AssertionError("streamed rows are not in seq order")
        picks = np.random.default_rng(args.seed + 2).choice(
            np.arange(n_base, n_cs), size=8, replace=False)
        db_cs_batched = TimeSeriesDB(db_cs.index, cfg)
        db_cs_local = TimeSeriesDB(db_cs.index,
                                   cfg.replace(searcher="local"))
        for name, d in (("batched", db_cs_batched), ("local", db_cs_local)):
            res = d.search_batch(series[picks])
            bad = [int(p) for p, r in zip(picks, res)
                   if int(r.ids[0]) != int(p)]
            if bad:
                raise AssertionError(f"streaming, {name} searcher: streamed "
                                     f"rows {bad} do not find themselves")
        log(f"streaming: ssh-cs build of {n_base} series {build_s:.2f} s, "
            f"ingest of {n_cs - n_base} series through {STREAM_SHARDS} "
            f"shards {ingest_s:.2f} s ({(n_cs - n_base) / ingest_s:.0f} "
            f"series/s), fold {fold_s:.2f} s; cs/agg "
            f"{tuple(enc.sketch_shape)} holds "
            f"{int(enc.aggregate_sketch()[0].abs().sum())} |updates| at "
            f"level 0; merged aggregate exact; re-encoded chunk equal; 8 "
            f"streamed rows self-match through both searchers")
        return db_cs

    db_cs = counted("streaming", ("sketch_conv", "cs_tables",
                                  "collision_count_batch",
                                  "dtw_wavefront_pairs", "collision_count",
                                  "dtw_wavefront"), streaming_path)

    # -- e. persistence, host buckets, the srp and ssh-multires encoders,
    #    the launchers and the signature LRU ---------------------------------
    persist_paths(args, counted, dict(
        series=series, batches=batches, spec=spec, cfg=cfg, db=db,
        results=results, build_s=build_s, db_cs=db_cs, seq_pick=seq_pick,
        ucr_pick=ucr_pick, ucr_res=ucr_res, precs=precs))
    gc.collect()
    torch.cuda.empty_cache()

    # -- 4. kernels, on inputs recorded from one more run of each path ------
    # batch 0 is in the LRU again: emptied, so the recorded run encodes
    db.index.sig_cache = None
    with Recorder(ops, ("sketch_conv", "collision_count_batch",
                        "dtw_rerank_pairs")) as rec_b:
        ssh_search_batch(batches[0][1], db.index, config=db.config)
    with Recorder(ops, ("collision_count", "dtw_rerank")) as rec_s:
        db_local.search(qs0[half])
    with Recorder(ops, ("dtw_rerank",)) as rec_u:
        search.ucr_search(qs0[half], db_series, topk=cfg.topk, band=cfg.band)
    with Recorder(ops, ("cs_tables",)) as rec_c:
        db_cs.index.encoder.encode_batch(db_cs.index.series[:4096])
    entries = []

    # sketch_conv: a build chunk (the rows encode_chunked hands it) and the
    # query encode (B·O rows of the multiprobe slices)
    xq, filt, step = rec_b.calls["sketch_conv"][0][0]
    xb = db.index.series[:4096]

    def conv_at(x, filt, step):
        wconv = filt.t().contiguous()[:, None, :]
        return lambda: torch.nn.functional.conv1d(
            x[:, None, :], wconv, stride=step).transpose(1, 2)

    def sketch_check(x, filt, step, tag):
        """(kernel, plain, |err|) of one call, after holding it bit for
        bit to the emulation and within the bound of the plain version."""
        kern = ops.sketch_conv(x, filt, step)
        emu = ref.sketch_conv_fma_ref(x, filt, step)
        if not torch.equal(kern, emu):
            raise AssertionError(
                f"sketch_conv ({tag} shape) is not bit-identical to "
                f"sketch_conv_fma_ref: {int((kern != emu).sum())} outputs "
                f"differ")
        plain = ref.sketch_conv_ref(x, filt, step)
        scale = ref.sketch_conv_ref(x.abs(), filt.abs(), step)
        err = (kern - plain).abs()
        if not bool((err <= 2 * filt.shape[0] * 2.0 ** -24 * scale).all()):
            raise AssertionError(
                f"sketch_conv ({tag} shape) disagrees with its plain version "
                f"beyond the reordering bound: max err {float(err.max())}")
        return kern, plain, err

    def sketch_at(x, filt, step, tag):
        """Check and time one call."""
        kern, plain, err = sketch_check(x, filt, step, tag)
        w, f_ = filt.shape
        bms, bkind = bound_ms(4 * (x.numel() + filt.numel() + kern.numel()),
                              2 * x.shape[0] * kern.shape[1] * f_ * w)
        out = dict(
            max_abs_err=float(err.max()),
            **kernel_times(lambda: ops.sketch_conv(x, filt, step),
                           conv_at(x, filt, step)),
            plain_ms=cuda_time_ms(lambda: ref.sketch_conv_ref(x, filt, step)),
            bound_ms=bms, bound_by=bkind,
            library_max_abs_err=float(
                (conv_at(x, filt, step)() - plain).abs().max()),
            sign_flips=int(((kern >= 0) != (plain >= 0)).sum()),
            shape=f"x {tuple(x.shape)} filters {tuple(filt.shape)} "
                  f"step {step}")
        out["share_of_bound"] = bms / out["ms"]
        return out

    sk_report = sketch_build_report(_build)
    sk = {tag: sketch_at(x, filt, step, tag)
          for tag, x in (("build", xb), ("query", xq))}
    entries.append(dict(
        name="sketch_conv", route="cuda",
        source="src/repro_torch/csrc/sketch_conv.cu",
        replaces="src/repro/kernels/sketch_conv.py:48",
        launches=phases["batched"]["sketch_conv"], **sk["build"],
        launches_by_phase={p: c["sketch_conv"] for p, c in phases.items()},
        query_shape={k: sk["query"][k] for k in
                     ("shape", "ms", "call_ms", "plain_ms", "bound_ms",
                      "share_of_bound", "library_ms", "library_call_ms",
                      "max_abs_err", "sign_flips")},
        tolerance="bit-identical to ref.sketch_conv_fma_ref; |err| <= "
                  "2*W*2^-24*sum|x*f| against the plain version",
        sass=sk_report["sass"], registers=sk_report["registers"],
        library="F.conv1d(stride=step), cudnn.allow_tf32=False"))

    def check_hash_range(qk, dbk):
        if int(max(qk.max(), dbk.max())) >= 1 << 24 or int(qk.min()) < 0:
            raise AssertionError("hash values outside [0, 2^24): the float "
                                 "yardstick would not be exact")

    # collision_count_batch: the probe of B·O signature rows
    cc_report = collision_build_report(_build)

    def counts_check(qk, dbk):
        """The kernel's counts, after holding them exact."""
        kern = ops.collision_count_batch(qk, dbk)
        plain = ref.collision_count_batch_ref(qk, dbk)
        if not torch.equal(kern, plain):
            raise AssertionError(
                f"collision_count_batch is not exact at {tuple(qk.shape)}: "
                f"{int((kern != plain).sum())} counts differ")
        return kern, plain

    def counts_at(qk, dbk):
        """Check and time one call, with its cdist yardstick."""
        kern, plain = counts_check(qk, dbk)
        check_hash_range(qk, dbk)
        k_ = qk.shape[1]

        def cdist_counts():
            return k_ - torch.cdist(qk.float(), dbk.float(), p=0)
        if not torch.equal(cdist_counts().to(torch.int32), plain):
            raise AssertionError("cdist yardstick disagrees with the counts")
        bms, bkind = bound_ms(4 * (qk.numel() + dbk.numel() + kern.numel()),
                              2 * qk.shape[0] * dbk.shape[0] * k_,
                              INT32_OPS_PER_S)
        return dict(
            max_abs_err=0.0,
            **kernel_times(lambda: ops.collision_count_batch(qk, dbk),
                           cdist_counts),
            plain_ms=cuda_time_ms(
                lambda: ref.collision_count_batch_ref(qk, dbk)),
            bound_ms=bms, bound_by=bkind,
            shape=f"queries {tuple(qk.shape)} db {tuple(dbk.shape)}")

    qk, dbk = rec_b.calls["collision_count_batch"][0][0]
    probe_split = probe_split_ms(qk, dbk, cfg)
    entries.append(dict(
        name="collision_count_batch", route="cuda",
        source="src/repro_torch/csrc/collision_count.cu",
        replaces="src/repro/kernels/collision_count.py:68",
        launches=phases["batched"]["collision_count_batch"],
        **counts_at(qk, dbk),
        tolerance="exact", library="K - torch.cdist(q, db, p=0)",
        probe_split=probe_split, sass=cc_report["sass"],
        registers=cc_report["registers"]))

    # collision_count: one probe row of a sequential query
    cc_calls = rec_s.calls["collision_count"]
    for (q1, dbk1), _ in cc_calls:
        if not torch.equal(ops.collision_count(q1, dbk1),
                           ref.collision_count_ref(q1, dbk1)):
            raise AssertionError("collision_count is not exact")
    q1, dbk1 = cc_calls[0][0]
    check_hash_range(q1, dbk1)
    k1 = q1.shape[0]

    def cdist_one():
        return k1 - torch.cdist(q1[None].float(), dbk1.float(), p=0)[0]
    if not torch.equal(cdist_one().to(torch.int32),
                       ref.collision_count_ref(q1, dbk1)):
        raise AssertionError("cdist yardstick disagrees with the counts")
    bms, bkind = bound_ms(4 * (q1.numel() + dbk1.numel() + dbk1.shape[0]),
                          2 * dbk1.shape[0] * k1, INT32_OPS_PER_S)
    entries.append(dict(
        name="collision_count", route="cuda",
        source="src/repro_torch/csrc/collision_count.cu",
        replaces="src/repro/kernels/collision_count.py:42",
        launches=phases["sequential"]["collision_count"],
        launches_by_phase={p: c["collision_count"]
                           for p, c in phases.items()},
        max_abs_err=0.0,
        **kernel_times(lambda: ops.collision_count(q1, dbk1), cdist_one),
        plain_ms=cuda_time_ms(lambda: ref.collision_count_ref(q1, dbk1)),
        bound_ms=bms, bound_by=bkind,
        shape=f"query {tuple(q1.shape)} db {tuple(dbk1.shape)}; "
              f"{len(cc_calls)} calls (one per probe row) checked",
        tolerance="exact", library="K - torch.cdist(q[None], db, p=0)"))

    # DTW: every recorded call through the rule and through each schedule
    # that takes its radius, bit for bit against the plain version; timed
    # (both schedules in turns) at the batched survivors, the UCR scan and
    # a sequential re-rank
    dtw_report = dtw_build_report(_build)

    def dtw_call(kernel, call):
        """(q, c, r, thr, plain) of a recorded call, after checking it
        through the rule and each schedule; the rule's schedule too."""
        q, c, band = call[0][:3]
        thr = arg(call, 3, "threshold")
        n_, m_ = c.shape
        r = core_dtw.radius(band, m_)
        pairs = kernel == "dtw_wavefront_pairs"
        plain = (ref.dtw_pairs_ref(q, c, band, thr) if pairs
                 else ref.dtw_wavefront_ref(q, c, band, thr))
        fn = kd.dtw_wavefront_pairs if pairs else kd.dtw_wavefront
        for sched in (None, *dtw_schedules_for(r)):
            got = fn(q, c, r, thr, schedule=sched)
            if not torch.equal(got, plain):
                raise AssertionError(
                    f"{kernel} ({sched or 'rule'}) is not bit-identical on "
                    f"{int((got != plain).sum())} of {n_} pairs "
                    f"({n_}, {m_}) radius {r}")
        return q, c, r, thr, plain, kd.dtw_schedule(n_, m_, r)

    def dtw_shape(kernel, call, min_plain_iters):
        """Times, bound, rate and schedules of one recorded call."""
        q, c, r, thr, plain, rule = dtw_call(kernel, call)
        pairs = kernel == "dtw_wavefront_pairs"
        fn = kd.dtw_wavefront_pairs if pairs else kd.dtw_wavefront
        cells = int(core_dtw.dtw_pairs_work(
            q if pairs else q.expand_as(c), c, r, thr)[1].sum())
        bms, bkind = bound_ms(4 * (q.numel() + c.numel() + 2 * c.shape[0]),
                              6 * cells, F32_NONFUSED_OPS_PER_S)
        per_sched = {s: float(np.mean(v)) for s, v in in_turns(
            {s: (lambda s=s: fn(q, c, r, thr, schedule=s))
             for s in dtw_schedules_for(r)}).items()}
        times = kernel_times(lambda: fn(q, c, r, thr, schedule=rule))
        ms = times["ms"]
        plain_fn = ((lambda: ref.dtw_pairs_ref(q, c, r, thr)) if pairs
                    else (lambda: ref.dtw_wavefront_ref(q, c, r, thr)))
        return dict(
            **times,
            plain_ms=cuda_time_ms(plain_fn, min_iters=min_plain_iters),
            bound_ms=bms, bound_by=bkind, schedule=rule,
            schedule_call_ms=per_sched, cells=cells,
            gcells_per_s=cells / ms / 1e6, share_of_bound=bms / ms,
            shape=f"{'pairs' if pairs else 'query'} {tuple(q.shape)} "
                  f"candidates {tuple(c.shape)} radius {r} threshold "
                  f"{thr is not None}; "
                  f"{int((plain >= core_dtw.BIG * 0.5).sum())} abandoned; "
                  f"{cells} cells run")

    def dtw_calls_log(kernel, calls):
        """The rule's schedule of every recorded call, in order."""
        return [f"({c[0][1].shape[0]}, {c[0][1].shape[1]}) r "
                f"{core_dtw.radius(c[0][2], c[0][1].shape[1])} thr "
                f"{arg(c, 3, 'threshold') is not None}: "
                f"{dtw_call(kernel, c)[5]}" for c in calls]

    bound_note = ("6 operations a DP cell (a subtract, a multiply, an add "
                  "and three mins; none fuses) at 33.5e12 non-fused f32 "
                  "operations a second (132 SMs x 128 lanes x 1.98 GHz); "
                  "cells as the plain wavefront counts them "
                  "(core.dtw.dtw_pairs_work)")
    dtw_calls = rec_b.calls["dtw_rerank_pairs"]
    pairs_calls = dtw_calls_log("dtw_wavefront_pairs", dtw_calls)
    survivors = dtw_shape("dtw_wavefront_pairs", dtw_calls[-1], 2)
    entries.append(dict(
        name="dtw_wavefront_pairs", route="cuda",
        source="src/repro_torch/csrc/dtw_wavefront.cu",
        replaces="src/repro/kernels/dtw_wavefront.py:201",
        launches=phases["batched"]["dtw_wavefront_pairs"], max_abs_err=0.0,
        library_ms=None, **survivors,
        launches_by_schedule={s: phases["batched"][
            f"dtw_wavefront_pairs:{s}"] for s in kd.SCHEDULES},
        calls_checked=pairs_calls, tolerance="bit-identical",
        bound_note=bound_note, sass=dtw_report["sass"]))

    one_calls = rec_s.calls["dtw_rerank"] + rec_u.calls["dtw_rerank"]
    one_log = dtw_calls_log("dtw_wavefront", one_calls)
    ucr_big = dtw_shape("dtw_wavefront", max(
        rec_u.calls["dtw_rerank"], key=lambda cl: cl[0][1].shape[0]), 1)
    seq_surv = dtw_shape("dtw_wavefront", rec_s.calls["dtw_rerank"][-1], 2)
    entries.append(dict(
        name="dtw_wavefront", route="cuda",
        source="src/repro_torch/csrc/dtw_wavefront.cu",
        replaces="src/repro/kernels/dtw_wavefront.py:151",
        launches=phases["sequential"]["dtw_wavefront"]
        + phases["ucr"]["dtw_wavefront"],
        launches_by_phase={p: c["dtw_wavefront"] for p, c in phases.items()},
        launches_by_schedule={p: {s: phases[p][f"dtw_wavefront:{s}"]
                                  for s in kd.SCHEDULES}
                              for p in ("sequential", "ucr")},
        max_abs_err=0.0, **ucr_big, library_ms=None,
        sequential_shape=seq_surv, tolerance="bit-identical",
        calls_checked=one_log, bound_note=bound_note))
    for e in entries[-2:]:
        log(f"dtw {e['name']}: schedules of the recorded calls "
            f"{e['calls_checked']}; launches by schedule "
            f"{e['launches_by_schedule']}")
        for shape in (e, e.get("sequential_shape")):
            if shape:
                log(f"dtw {e['name']} [{shape['shape']}]: {shape['schedule']}"
                    f" {shape['ms']:.4f} ms, {shape['gcells_per_s']:.1f} "
                    f"Gcells/s, {shape['share_of_bound']:.3f} of the "
                    f"{shape['bound_ms']:.4f} ms bound (device time; call "
                    f"time {shape['call_ms']:.4f}); both schedules' call "
                    f"times in turns {shape['schedule_call_ms']}")

    # cs_tables: the level-0 tables of one 4096-row build chunk
    (bkt, sgn, width), _ = rec_c.calls["cs_tables"][0]
    kern = ops.cs_tables(bkt, sgn, width)
    plain = ref.cs_tables_ref(bkt, sgn, width)
    if not torch.equal(kern, plain):
        raise AssertionError(f"cs_tables is not bit-identical: "
                             f"{int((kern != plain).sum())} bins differ")
    b_, r_, s_ = bkt.shape
    tgt = torch.where(bkt >= 0, bkt, width).to(torch.int64).reshape(
        b_ * r_, s_)
    sg2 = sgn.reshape(b_ * r_, s_)

    def scatter_lib():
        return torch.zeros((b_ * r_, width + 1), dtype=torch.float32,
                           device=bkt.device).scatter_add_(1, tgt, sg2)
    if not torch.equal(scatter_lib()[:, :width].reshape(b_, r_, width),
                       plain):
        raise AssertionError("scatter_add_ yardstick disagrees")
    bms, bkind = bound_ms(4 * (2 * bkt.numel() + kern.numel()),
                          int((bkt >= 0).sum()))
    entries.append(dict(
        name="cs_tables", route="cuda",
        source="src/repro_torch/csrc/count_sketch.cu",
        replaces="src/repro/kernels/count_sketch.py:51",
        launches=phases["streaming"]["cs_tables"], max_abs_err=0.0,
        **kernel_times(lambda: ops.cs_tables(bkt, sgn, width), scatter_lib),
        plain_ms=cuda_time_ms(lambda: ref.cs_tables_ref(bkt, sgn, width)),
        bound_ms=bms, bound_by=bkind,
        shape=f"bucket {tuple(bkt.shape)} width {width}; "
              f"{float((kern == 0).float().mean()):.4f} of the bins zero",
        tolerance="bit-identical",
        library="zeros(B*R, width + 1).scatter_add_(1, bucket, sign)"))

    # -- 5. cross-check on the CPU plain path -------------------------------
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

    # -- 6. the serving engine (last: its insert grows the index) -----------
    recorded = engine_paths(args, counted, dict(series=series,
                                                batches=batches, cfg=cfg,
                                                db=db))
    # its three kernels on the inputs of its own batches of 8 and 1: every
    # call held as above, the first of each kernel (the last DTW call,
    # the survivors) timed
    by_name = {e["name"]: e for e in entries}
    for size, calls in recorded.items():
        tag = f"engine batch {size}"
        sk_calls = calls["sketch_conv"]
        for (x, filt_e, step_e), _ in sk_calls[1:]:
            sketch_check(x, filt_e, step_e, tag)
        x, filt_e, step_e = sk_calls[0][0]
        sk_e = sketch_at(x, filt_e, step_e, tag)
        cc_calls = calls["collision_count_batch"]
        for (qk_e, dbk_e), _ in cc_calls[1:]:
            counts_check(qk_e, dbk_e)
        cc_e = counts_at(*cc_calls[0][0])
        dtw_e = dtw_shape("dtw_wavefront_pairs",
                          calls["dtw_rerank_pairs"][-1], 2)
        dtw_e.update(max_abs_err=0.0, calls_checked=dtw_calls_log(
            "dtw_wavefront_pairs", calls["dtw_rerank_pairs"]))
        for name, got, n_calls in (
                ("sketch_conv", sk_e, len(sk_calls)),
                ("collision_count_batch", cc_e, len(cc_calls)),
                ("dtw_wavefront_pairs", dtw_e,
                 len(calls["dtw_rerank_pairs"]))):
            by_name[name].setdefault("engine_shapes", {})[
                f"batch {size}"] = dict(got, calls_held=n_calls)
            log(f"kernel {name} at the {tag} shape, {n_calls} calls held "
                f"to the plain version: [{got['shape']}] device ms "
                f"{got['ms']:.4f} call ms {got['call_ms']:.4f} plain_ms "
                f"{got['plain_ms']:.4f} bound_ms {got['bound_ms']:.5f} "
                f"max_err {got['max_abs_err']}")
    return entries


def causal_pairs(s, t):
    """Unmasked (query i, key j) pairs under the causal mask j <= i, for
    S queries over T keys: the work the kernel must do."""
    m = min(s, t)
    return m * (m + 1) // 2 + (s - m) * t


def device_profile(fn):
    """Run ``fn`` once under ``torch.profiler``; returns the device time
    of every kernel, memcpy and memset it ran (ms), how many there were,
    and the ms of the two flash kernels among them.  The profiler
    slows the host, so a busy share divides this device time by an
    unprofiled wall time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    return dict(
        device_ms=sum(e.self_device_time_total for e in dev) / 1e3,
        device_ops=sum(e.count for e in dev),
        flash_ms=sum(e.self_device_time_total for e in dev
                     if "flash_attention_tc_kernel" in e.key
                     or "flash_attention_simt_kernel" in e.key) / 1e3)


def flash_bound(q, k, ops_per_s=BF16_TC_OPS_PER_S, causal=True):
    """(bound_ms, bound_by) of one flash launch: 4·D flops per unmasked
    (query, key) pair of every head at ``ops_per_s`` (the bf16 tensor
    cores by default), and q, k, v, o read or written once."""
    b, h, s, d = q.shape
    t = k.shape[2]
    pairs = causal_pairs(s, t) if causal else s * t
    n_bytes = q.element_size() * (2 * q.numel() + 2 * k.numel())
    return bound_ms(n_bytes, 4 * b * h * d * pairs, ops_per_s)


def in_turns(fns, rounds=2):
    """CUDA-event ms of each callable of ``fns`` (a dict), timed in turns
    (a b c, c b a, ...) so that a drift of the card's clock falls on all
    of them alike; returns {name: [ms of each turn]}."""
    names = list(fns)
    out = {n: [] for n in names}
    for r in range(rounds):
        for n in (names if r % 2 == 0 else names[::-1]):
            out[n].append(cuda_time_ms(fns[n]))
    return out


def ptxas_report(_build, name, label):
    """{kernel label: [ptxas's registers, stack and spill lines]} of the
    library ``name``; ``label`` maps a mangled name to a short one."""
    import re
    kernels, cur = {}, None
    for line in _build.build_log(name).splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = label(m.group(1))
            kernels[cur] = []
        elif cur and ("registers" in line or "stack frame" in line
                      or "spill" in line):
            kernels[cur].append(line.replace("ptxas info    :", "").strip())
    for kname, info in kernels.items():
        log(f"ptxas {kname}: {'; '.join(info)}")
    return kernels


def dtw_schedules_for(r):
    """The DTW schedules that take radius ``r``."""
    from repro_torch.kernels import dtw_wavefront as kd
    return tuple(s for s in kd.SCHEDULES
                 if s != "rows" or r <= kd.ROWS_MAX_RADIUS)


def dtw_build_report(_build):
    """Print what ptxas said of every DTW kernel (a spill fails the run)
    and the SASS instructions a DP cell at r = 25 of each schedule
    (``bench.dtw_schedules.cell_costs``, from ``cuobjdump -sass``)."""
    import re
    from repro_torch.bench.dtw_schedules import cell_costs, kernel_of

    def label(mangled):
        k = kernel_of(mangled)
        if not k:
            return mangled
        return k[0] + (f"<{k[1]}>" if k[2] is None
                       else f"<{k[1]},thr={k[2]},one={k[3]}>")
    kernels = ptxas_report(_build, "dtw_wavefront", label)
    spills = {k: i for k, i in kernels.items()
              if any(re.search(r"[1-9]\d* bytes spill", x) for x in i)}
    if spills:
        raise AssertionError(f"DTW kernels spill: {spills}")
    costs = cell_costs(str(_build.library_path("dtw_wavefront")))
    sass = {k: {a: round(v[a], 2) for a in ("per_slot", "row_overhead",
                                            "per_cell") if a in v}
            for k, v in costs.items() if "per_cell" in v}
    log(f"SASS of the DTW kernels, instructions a DP cell at r = 25: "
        f"{sass}")
    regs = {k: next((x for x in i if "registers" in x), "")
            for k, i in kernels.items()}
    return dict(sass=sass, ptxas_kernels=len(kernels), registers=regs)


def collision_build_report(_build):
    """Print what ptxas said of every collision-count kernel (a spill
    fails the run, as does local memory in the SASS) and the batch
    kernel's SASS instructions a key compared
    (``bench.collision_count.key_costs``, from ``cuobjdump -sass``)."""
    import re
    from repro_torch.bench.collision_count import key_costs

    def label(mangled):
        m = re.search(r"(collision_count(?:_batch)?_kernel)ILi(\d+)E"
                      r"(?:Lb([01])E)?", mangled)
        if not m:
            return mangled
        return (f"{m.group(1)}<{m.group(2)}"
                f"{'' if m.group(3) is None else ',vec=' + m.group(3)}>")
    kernels = ptxas_report(_build, "collision_count", label)
    spills = {k: i for k, i in kernels.items()
              if any(re.search(r"[1-9]\d* bytes spill", x) for x in i)}
    if spills:
        raise AssertionError(f"collision-count kernels spill: {spills}")
    costs = key_costs(str(_build.library_path("collision_count")))
    if costs["local_memory"]:
        raise AssertionError(f"collision-count kernels use local memory: "
                             f"{costs['local_memory']}")
    sass = {k: {a: (round(v[a], 3) if isinstance(v[a], float) else v[a])
                for a in ("per_key", "lds_per_key", "instructions",
                          "compares", "ops")}
            for k, v in costs["batch"].items()}
    log(f"SASS of collision_count_batch_kernel, the hot loop: {sass}")
    regs = {k: next((x for x in i if "registers" in x), "")
            for k, i in kernels.items()}
    return dict(sass=sass, ptxas_kernels=len(kernels), registers=regs)


def no_spill(kernels, what):
    """Fail on a ptxas report of spilled bytes or a stack frame."""
    import re
    bad = {k: i for k, i in kernels.items()
           if any(re.search(r"[1-9]\d* bytes (spill|stack)", x) for x in i)}
    if bad:
        raise AssertionError(f"{what} spill or use a stack frame: {bad}")


def sketch_build_report(_build):
    """Print what ptxas said of every sketch kernel (a spill, or local
    memory in the SASS, fails the run) and the SASS instructions a filter
    tap of each (``bench.sketch_flash.tap_costs``)."""
    import re
    from repro_torch.bench.sketch_flash import tap_costs

    def label(mangled):
        m = re.search(r"sketch_conv_kernelILi(\d+)ELi(\d+)E", mangled)
        if not m:
            return mangled
        return ("sketch_conv_kernel<runtime>" if m.group(1) == "0" else
                f"sketch_conv_kernel<{m.group(1)},{m.group(2)}>")
    kernels = ptxas_report(_build, "sketch_conv", label)
    no_spill(kernels, "sketch kernels")
    costs = tap_costs(str(_build.library_path("sketch_conv")))
    if costs["local_memory"]:
        raise AssertionError(f"sketch kernels use local memory: "
                             f"{costs['local_memory']}")
    sass = {k: {a: (round(v[a], 3) if isinstance(v[a], float) else v[a])
                for a in ("per_tap", "scope", "instructions", "ffma", "ops")}
            for k, v in costs["kernels"].items()}
    log(f"SASS of the sketch kernels, the FFMA loop: {sass}")
    regs = {k: next((x for x in i if "registers" in x), "")
            for k, i in kernels.items()}
    return dict(sass=sass, registers=regs)


def probe_split_ms(qk, dbk, cfg):
    """CUDA-event ms of the batched probe stage's three parts on one
    recorded input (``serving.batched.batch_probe``): the kernel, the max
    over the multiprobe offsets and ``top_c_by_count``."""
    from repro_torch.core.search import top_c_by_count
    from repro_torch.kernels import ops
    o = cfg.multiprobe_offsets
    b = qk.shape[0] // o
    top_c = min(cfg.top_c, dbk.shape[0])
    counts = ops.collision_count_batch(qk, dbk)
    best = counts.reshape(b, o, -1).amax(1)
    split = dict(
        kernel=cuda_time_ms(lambda: ops.collision_count_batch(qk, dbk)),
        offsets_max=cuda_time_ms(lambda: counts.reshape(b, o, -1).amax(1)),
        top_c=cuda_time_ms(lambda: top_c_by_count(best, top_c)))
    split["sum"] = sum(split.values())
    log(f"probe split, ms (batch 0's probe: counts {tuple(counts.shape)}, "
        f"{o} offsets, top {top_c}): "
        f"{ {k: round(v, 4) for k, v in split.items()} }")
    return split


def flash_build_report(_build, lib):
    """Print what ptxas said of every flash kernel (registers, stack and
    spills) and count the tensor-core instructions in the tensor-core
    kernel's SASS; a count of 0 fails the run."""
    import re
    import shutil

    def label(name):
        kind = re.search(r"flash_attention_(tc|simt)_kernel", name)
        args = ("bf16," if "nv_bfloat16" in name else
                "float," if "_kernelIf" in name else "")
        dp = re.search(r"Li(\d+)E", name)
        copy = ",cp.async" if "Lb1E" in name else ""
        return (f"{kind.group(0) if kind else name}<{args}"
                f"{dp.group(1) if dp else '?'}{copy}>")
    no_spill(ptxas_report(_build, "flash_attention", label),
             "flash kernels")
    log(f"flash_attention_tc_kernel dynamic shared memory: "
        f"{lib.flash_attention_tc_smem_bytes(64)} bytes at D <= 64, "
        f"{lib.flash_attention_tc_smem_bytes(128)} at D <= 128")
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        raise RuntimeError("cuobjdump not found on PATH or in "
                           "/usr/local/cuda/bin: the tensor-core "
                           "instructions cannot be counted")
    sass = subprocess.run([tool, "-sass",
                           str(_build.library_path("flash_attention"))],
                          capture_output=True, text=True, check=True).stdout
    counts, cur, local = {}, None, set()
    for line in sass.splitlines():
        if "Function :" in line:
            cur = line.split("Function :")[1].strip()
        elif cur and re.search(r"\b(LDL|STL)\b", line):
            local.add(label(cur))
        elif cur and "flash_attention_tc_kernel" in cur:
            for op in ("HGMMA", "HMMA"):
                if re.search(rf"\b{op}\.", line):
                    counts[op] = counts.get(op, 0) + 1
    if local:
        raise AssertionError(f"flash kernels use local memory: {local}")
    log(f"SASS of flash_attention_tc_kernel (both head-dim variants): "
        f"{counts}")
    if not counts.get("HGMMA", 0) + counts.get("HMMA", 0):
        raise AssertionError("flash_attention_tc_kernel has no tensor-core "
                             "instruction (HGMMA or HMMA) in its SASS")
    return counts


def lm_path(args, counted, phases) -> dict:
    """Path e: granite-3-2b LM serving at full width (step 6 of the
    docstring); returns the entries of the two flash kernels."""
    from repro_torch.configs import granite_3_2b
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels.flash_attention import (error_bound,
                                                     flash_attention_simt)
    from repro_torch.launch.serve import (check_prefill_against_decode,
                                          serve_lm)
    from repro_torch.models import transformer as T

    dev = torch.device("cuda")
    cfg = granite_3_2b.CONFIG
    sass_counts = flash_build_report(_build, _build.load("flash_attention"))
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    params = T.init_params(
        cfg, torch.Generator(device=dev).manual_seed(args.seed), dev)
    torch.cuda.synchronize()
    n_params = cfg.param_count()
    log(f"lm: {cfg.name} CONFIG at full width ({cfg.n_layers} layers, "
        f"d_model {cfg.d_model}, {cfg.n_heads} heads, {cfg.n_kv_heads} KV "
        f"heads, head_dim {cfg.hd}, d_ff {cfg.d_ff}, vocab {cfg.vocab}; "
        f"{n_params} parameters, {torch.cuda.memory_allocated() / 1e9:.2f} "
        f"GB in {cfg.dtype}), random weights from seed {args.seed} drawn "
        f"on the card in {time.perf_counter() - t:.1f} s")
    rng = np.random.default_rng(args.seed + 3)

    def tokens(b, s):
        return torch.as_tensor(rng.integers(0, cfg.vocab, (b, s)),
                               device=dev)

    def timed_prefill(toks):
        """One prefill, timed once; (last logits, s, peak GB)."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        out = T.prefill(params, toks, cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        if out.shape != (toks.shape[0], 1, cfg.vocab) or not bool(
                torch.isfinite(out).all()):
            raise AssertionError(f"prefill logits {tuple(out.shape)} are "
                                 f"malformed or not finite")
        return out, wall, torch.cuda.max_memory_allocated() / 1e9

    def expect_launches(phase, n, kernel="flash_attention"):
        """n launches of ``kernel`` (one a layer) and none of the other
        flash kernel."""
        other = ({"flash_attention", "flash_attention_simt"}
                 - {kernel}).pop()
        got = phases[phase][kernel]
        if got != n or phases[phase][other]:
            raise AssertionError(f"phase {phase}: {got} {kernel} launches "
                                 f"and {phases[phase][other]} {other}, "
                                 f"expected {n} and 0 (one a layer)")

    T.prefill(params, tokens(1, 64), cfg)        # first-use set-up
    # -- e1. long prefill --------------------------------------------------
    long_len = args.lm_prompt
    log(f"lm: long prefill of 1 x {long_len} tokens: the prefill_32k "
        f"cell's shape with its batch cut from {PREFILL_32K_BATCH} to 1"
        + ("" if long_len == 32768 else f" and its length cut from 32768 "
           f"to {long_len}") + " to fit one run's time; timed once")
    toks_long = tokens(1, long_len)
    _, long_s, long_peak = counted("lm", ("flash_attention",),
                                   lambda: timed_prefill(toks_long))
    expect_launches("lm", cfg.n_layers)
    log(f"lm prefill 1 x {long_len}: {long_s:.3f} s, "
        f"{long_len / long_s:.1f} tokens/s, peak memory {long_peak:.2f} GB")

    # -- e2. batch prefill -------------------------------------------------
    toks_batch = tokens(LM_BATCH, LM_BATCH_LEN)
    _, batch_s, batch_peak = counted("lm_batch", ("flash_attention",),
                                     lambda: timed_prefill(toks_batch))
    expect_launches("lm_batch", cfg.n_layers)
    log(f"lm prefill {LM_BATCH} x {LM_BATCH_LEN}: {batch_s:.3f} s, "
        f"{LM_BATCH * LM_BATCH_LEN / batch_s:.1f} tokens/s, peak memory "
        f"{batch_peak:.2f} GB")

    # -- e3. serve: stepped decode, greedy generation, one prefill ---------
    prompts = rng.integers(0, cfg.vocab, (SERVE_BATCH, SERVE_PROMPT))
    torch.cuda.reset_peak_memory_stats()
    res = counted("lm_serve", ("flash_attention",),
                  lambda: serve_lm(cfg, params, prompts, gen_len=SERVE_GEN,
                                   device=dev))
    expect_launches("lm_serve", cfg.n_layers)
    serve_peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"lm serve {SERVE_BATCH} prompts of {SERVE_PROMPT} tokens, "
        f"{SERVE_GEN} generated: {res.decode_ms_per_step:.3f} ms per "
        f"generating decode step, {res.generated_tokens_per_s:.1f} "
        f"generated tokens/s; prompt stepping {res.prompt_s:.3f} s "
        f"({res.prompt_s * 1e3 / SERVE_PROMPT:.3f} ms a step, the first "
        f"included); prefill of the same prompts {res.prefill_s:.4f} s; "
        f"peak memory {serve_peak:.2f} GB; sample "
        f"{res.generated[0, :8].tolist()}")
    gate = check_prefill_against_decode(res, GATE_REL_TOL[cfg.dtype])
    # the same prompts through a float32 copy of the weights (the f32
    # kernel): there the two masks must agree to reordering
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params32 = {k: (v.float() if k != "layers" else
                    {n: w.float() for n, w in v.items()})
                for k, v in params.items()}
    with Recorder(ops, ("flash_attention",)) as rec32:
        res32 = counted("lm_serve_f32", ("flash_attention_simt",),
                        lambda: serve_lm(cfg32, params32, prompts,
                                         gen_len=0, device=dev))
    expect_launches("lm_serve_f32", cfg.n_layers, "flash_attention_simt")
    q32, k32, v32 = rec32.calls["flash_attention"][0][0][:3]
    del params32, rec32
    gate32 = check_prefill_against_decode(res32, GATE_REL_TOL["float32"])
    log(f"lm_serve_f32: prefill of {SERVE_BATCH} x {SERVE_PROMPT} in "
        f"float32 {res32.prefill_s:.4f} s ({cfg.n_layers} "
        f"flash_attention_simt launches); prompt stepping "
        f"{res32.prompt_s:.3f} s")
    off = {name: float((a.float() - b).abs().max())
               / gate32["max_abs_logit"]
           for name, a, b in (
               ("prefill", res.prefill_logits, res32.prefill_logits),
               ("decode", res.prompt_logits, res32.prompt_logits))}
    log(f"lm gate: prefill against stepped decode after token "
        f"{SERVE_PROMPT}, bf16: {gate}; float32 copy of the weights: "
        f"{gate32}; max |bf16 - float32| / max |logit| of each path: "
        f"{ {k: round(v, 4) for k, v in off.items()} }")

    # -- device busy share: a batch prefill and 8 decode steps -------------
    prof_prefill = device_profile(lambda: T.prefill(params, toks_batch, cfg))
    cache = T.init_cache(cfg, SERVE_BATCH, SERVE_PROMPT + 8, dev)
    step_toks = torch.as_tensor(prompts, device=dev)

    def decode_8():
        nonlocal cache
        for i in range(8):
            _, cache = T.decode_step(params, cache, step_toks[:, i:i + 1],
                                     cfg)
    decode_8()                                    # steady state first
    cache["length"].zero_()
    prof_decode = device_profile(decode_8)
    if not (prof_prefill["device_ops"] and prof_decode["device_ops"]):
        log(f"lm device time: not measured, the profiler kept no device "
            f"record (prefill {prof_prefill['device_ops']}, decode "
            f"{prof_decode['device_ops']} operations)")
    else:
        log(f"lm device time: prefill {LM_BATCH} x {LM_BATCH_LEN} "
            f"{prof_prefill['device_ms']:.1f} ms on the device in "
            f"{prof_prefill['device_ops']} operations, flash_attention "
            f"{prof_prefill['flash_ms']:.1f} ms of it, busy "
            f"{prof_prefill['device_ms'] / (batch_s * 1e3):.3f} of the "
            f"unprofiled {batch_s * 1e3:.1f} ms; decode at batch "
            f"{SERVE_BATCH} "
            f"{prof_decode['device_ms'] / 8:.3f} ms on the device a step in "
            f"{prof_decode['device_ops'] / 8:.0f} operations, busy "
            f"{prof_decode['device_ms'] / 8 / res.decode_ms_per_step:.3f} of "
            f"the unprofiled {res.decode_ms_per_step:.3f} ms a step")

    # -- kernel against its plain version, on layer 0's own inputs ---------
    with Recorder(ops, ("flash_attention",), stop_after=1) as rec:
        T.prefill(params, toks_batch, cfg)
    with Recorder(ops, ("flash_attention",), stop_after=1) as rec_long:
        T.prefill(params, toks_long, cfg)
    qb, kb, vb = rec.calls["flash_attention"][0][0][:3]
    ql, kl, vl = rec_long.calls["flash_attention"][0][0][:3]
    checks = {}
    # all heads at 8 x 2048; heads 0-1 (both read KV head 0) of the long
    # prefill: all 32 at 32,768 would need 137 GB of float32 logits.  Two
    # bounds, per element: against the plain version, with the bf16
    # weights allowed for (2^-8 sum_j w_j |v_j|); and against the
    # emulation of the kernel's own rounding, the tight one, which sees
    # a wrong key tile where a row averages thousands of keys
    for tag, (q, k, v) in (("batch", (qb, kb, vb)),
                           ("long_2_heads", (ql[:, :2], kl[:, :1],
                                             vl[:, :1]))):
        ops.reset_launch_counts()
        kern = ops.flash_attention(q, k, v, causal=True)
        torch.cuda.synchronize()
        if ops.launch_counts()["flash_attention"] != 1:
            raise AssertionError(f"flash check ({tag}) did not run the "
                                 f"tensor-core kernel: "
                                 f"{ops.launch_counts()}")
        plain = ref.flash_attention_ref(q, k, v, causal=True)
        emu = ref.flash_attention_tc_ref(q, k, v, causal=True)
        res = {}
        for against, want, bound in (
                ("plain", plain, error_bound(kern, plain, v, emu.abs_out)),
                ("emulation", emu.out, error_bound(kern, emu.out, v,
                                                   emu.abs_out,
                                                   emu.spread))):
            err = (kern.float() - want.float()).abs()
            ratio = float((err / bound).max())
            res[against] = dict(max_abs_err=float(err.max()),
                                worst_err_over_bound=ratio,
                                median_bound=float(bound.median()))
            if not ratio <= 1.0:
                raise AssertionError(
                    f"flash_attention ({tag}) disagrees with its {against} "
                    f"version beyond its bound: max err {float(err.max())},"
                    f" worst err/bound {ratio}")
        checks[tag] = dict(
            res, median_abs_out=float(plain.float().abs().median()),
            shape=f"q {tuple(q.shape)} k/v {tuple(k.shape)} "
                  f"{str(q.dtype)[6:]} causal")
        del kern, plain, emu
    log(f"lm kernel checks against the plain version and the emulation of "
        f"its rounding (median |o| beside each median bound): {checks}")

    def sdpa_at(q, k, v):
        g = q.shape[1] // k.shape[1]
        ke, ve = k.repeat_interleave(g, 1), v.repeat_interleave(g, 1)
        return lambda: torch.nn.functional.scaled_dot_product_attention(
            q, ke, ve, is_causal=True)

    lib_b = sdpa_at(qb, kb, vb)
    lib_err = float((lib_b().float() - ref.flash_attention_ref(
        qb, kb, vb, causal=True).float()).abs().max())
    bms, bkind = flash_bound(qb, kb)
    lbms, lbkind = flash_bound(ql, kl)
    # the tensor-core kernel, the CUDA-core kernel on the same bf16 inputs
    # (its own entry point, off the path) and the library call, in turns
    turns = {tag: in_turns({
        "tensor_core": lambda q=q, k=k, v=v: ops.flash_attention(q, k, v),
        "cuda_core": lambda q=q, k=k, v=v: flash_attention_simt(q, k, v),
        "library": sdpa_at(q, k, v)})
        for tag, (q, k, v) in (("batch", (qb, kb, vb)),
                               ("long", (ql, kl, vl)))}
    mean = {tag: {n: sum(ms) / len(ms) for n, ms in t.items()}
            for tag, t in turns.items()}
    log(f"lm flash in turns (call ms of each turn): {turns}")
    dev_t = {tag: kernel_times(lambda q=q, k=k, v=v: ops.flash_attention(
        q, k, v), sdpa_at(q, k, v))
        for tag, (q, k, v) in (("batch", (qb, kb, vb)),
                               ("long", (ql, kl, vl)))}
    log(f"lm flash device and call ms: {dev_t}")
    long_entry = dict(
        **dev_t["long"],
        bound_ms=lbms, bound_by=lbkind,
        cuda_core_call_ms=mean["long"]["cuda_core"],
        share_of_bound=lbms / dev_t["long"]["ms"],
        plain_ms=None,
        plain_note=f"not timed at all {ql.shape[1]} heads: "
                   f"{ql.shape[1] * ql.shape[2] ** 2 * 4 / 1e9:.0f} GB of "
                   f"float32 logits",
        shape=f"q {tuple(ql.shape)} k/v {tuple(kl.shape)} bf16 causal "
              f"(layer 0 of the 1 x {long_len} prefill)",
        check_2_heads=checks["long_2_heads"])

    # the CUDA-core kernel on the float32 gate's layer-0 inputs
    kern32 = ops.flash_attention(q32, k32, v32, causal=True)
    plain32 = ref.flash_attention_ref(q32, k32, v32, causal=True)
    err32 = (kern32 - plain32).abs()
    if not bool((err32 <= error_bound(kern32, plain32, v32)).all()):
        raise AssertionError(f"flash_attention_simt disagrees with its plain "
                             f"version beyond float32 reordering: max err "
                             f"{float(err32.max())}")
    sbms, sbkind = flash_bound(q32, k32, F32_OPS_PER_S)
    simt_times = kernel_times(lambda: ops.flash_attention(q32, k32, v32),
                              sdpa_at(q32, k32, v32))
    simt_entry = dict(
        name="flash_attention_simt", route="cuda",
        source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:67",
        launches=phases["lm_serve_f32"]["flash_attention_simt"],
        max_abs_err=float(err32.max()),
        **simt_times,
        plain_ms=cuda_time_ms(lambda: ref.flash_attention_ref(
            q32, k32, v32, causal=True)),
        bound_ms=sbms, bound_by=sbkind,
        share_of_bound=sbms / simt_times["ms"],
        shape=f"q {tuple(q32.shape)} k/v {tuple(k32.shape)} float32 causal "
              f"(layer 0 of the float32 gate's prefill of {SERVE_BATCH} x "
              f"{SERVE_PROMPT})",
        tolerance="|err| <= 2^-13 * max|v| (float32 reordering)",
        bound_note="operations at the 67 TFLOP/s of float32 outside the "
                   "tensor cores: the float32 route keeps full float32 "
                   "products",
        library="F.scaled_dot_product_attention(is_causal=True), float32, "
                "KV heads expanded by repeat_interleave outside the timing")
    del kern32, plain32, err32
    return [dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:67",
        launches=phases["lm"]["flash_attention"],
        launches_by_phase={p: c["flash_attention"]
                           for p, c in phases.items()},
        max_abs_err=max(c["plain"]["max_abs_err"] for c in checks.values()),
        **dev_t["batch"],
        plain_ms=cuda_time_ms(lambda: ref.flash_attention_ref(
            qb, kb, vb, causal=True), min_iters=2),
        bound_ms=bms, bound_by=bkind,
        cuda_core_call_ms=mean["batch"]["cuda_core"],
        turns_call_ms=turns,
        share_of_bound=bms / dev_t["batch"]["ms"],
        sass=sass_counts,
        library_max_abs_err=lib_err,
        shape=f"q {tuple(qb.shape)} k/v {tuple(kb.shape)} bf16 causal "
              f"(layer 0 of the {LM_BATCH} x {LM_BATCH_LEN} prefill)",
        long_shape=long_entry,
        tolerance="per element, a = sum_j w_j |v_j|: against the plain "
                  "version one bf16 ulp at max(|kernel|, |plain|) + "
                  "(2^-13 + 2^-8) a (float32 reordering, P in bf16); "
                  "against ref.flash_attention_tc_ref one ulp + 2^-13 a + "
                  "its spread",
        library="F.scaled_dot_product_attention(is_causal=True), KV heads "
                "expanded by repeat_interleave outside the timing"),
        simt_entry]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n-series", type=int, default=1 << 20)
    ap.add_argument("--length", type=int, default=512)
    ap.add_argument("--lm-prompt", type=int, default=32768,
                    help="tokens of the long LM prefill")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script runs only on a CUDA GPU")
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch").is_dir():
        raise SystemExit(f"chip_smoke: {src / 'repro_torch'} is missing; "
                         "run this script from a checkout of the repo")
    sys.path.insert(0, str(src))
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import dtw_wavefront as kd

    t_start = time.perf_counter()
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
    log(f"kernel libraries built and loaded in {time.perf_counter() - t:.1f}"
        f" s ({', '.join(_build.SIGNATURES)}): kernels "
        f"{', '.join(_build.KERNELS)}")

    phases = {}

    def counted(phase, kernels, fn):
        """Run ``fn`` with every launch count at 0 before; require each
        of ``kernels`` to have launched; keep the counts."""
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        phases[phase] = dict(counts, **kd.schedule_counts())
        missing = [k for k in kernels if counts[k] < 1]
        log(f"phase {phase}: launches {counts}")
        if missing:
            raise AssertionError(f"phase {phase}: kernels {missing} never "
                                 f"launched: {counts}")
        return out

    entries = ssh_paths(args, counted, phases)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"SSH state freed: {torch.cuda.memory_allocated() / 1e9:.2f} GB "
        f"still allocated")
    entries.extend(lm_path(args, counted, phases))

    for e in entries:
        log(f"kernel {e['name']}: device ms {e['ms']:.4f} call ms "
            f"{e['call_ms']:.4f} plain_ms {e['plain_ms']:.4f} library "
            f"device ms {e['library_ms']} bound_ms {e['bound_ms']:.4f} "
            f"({e['bound_by']}, {e['bound_ms'] / e['ms']:.3f} of it) "
            f"launches {e['launches']} max_err {e['max_abs_err']} "
            f"[{e['shape']}]")
        log(f"kernel {e['name']}: profiled windows {e.get('device_windows')}"
            f" (library {e.get('library_windows')}), every record kept "
            f"{e.get('device_window_complete')}, device time from "
            f"{e.get('device_source')} (library {e.get('library_source')}),"
            f" by events alone {e.get('events_ms')} ms")
        for extra in ("query_shape", "sequential_shape", "long_shape",
                      "engine_shapes"):
            if extra in e:
                log(f"kernel {e['name']} at the {extra.split('_')[0]} shape: "
                    f"{e[extra]}")

    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(f"{smi}")
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

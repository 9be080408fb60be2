"""Serving launcher (counterpart of ``repro.launch.serve``): SSH query
serving (paper Alg. 2) through the dynamic-batching ``engine`` searcher
(the default) or the sequential ``local`` one, or LM KV-cache decode
over a batch of prompts with one prefill of the same prompts.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch ssh-ecg \\
        [--requests 16] [--batch-size 8] [--wait-ms 2] \\
        [--batch-mode fixed|adaptive] [--db-dir DIR] [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.serve --arch ssh-ecg \\
        --sequential [--db-dir DIR] [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-2b \\
        --smoke --device cpu

SSH: ``--db-dir`` serves a database saved by either package (its search
knobs kept, the serving ones overlaid) instead of building the smoke
index over a synthetic ECG stream; queries are windows of that stream
at the database's length.  The fleet options (``--replication``,
``--fleet-workers``, ``--hedge-ms``) are accepted at their defaults
only: the fleet tier is queued (ROADMAP.md §1, item 6).  LM weights are
random from ``--seed`` (no checkpoint is read).  Without ``--device
cpu`` it runs on CUDA and raises where there is none.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.bench.timing import StageTimer
from repro_torch.configs import granite_3_2b
from repro_torch.kernels import ops
from repro_torch.models import transformer as T

LM_ARCHS = {"granite-3-2b": granite_3_2b}


@dataclasses.dataclass
class ServeResult:
    """What one :func:`serve_lm` call produced and how long it took
    (host clock, synchronised at the end of each stage)."""
    generated: torch.Tensor       # (B, gen_len) greedy tokens
    prompt_logits: torch.Tensor   # (B, 1, V) decode logits after the prompt
    prefill_logits: torch.Tensor  # (B, 1, V) prefill of the same prompts
    prompt_s: float               # stepping decode_step over the prompts
    generate_s: float             # the gen_len greedy steps
    prefill_s: float

    @property
    def decode_ms_per_step(self) -> float:
        """Mean ms per generating decode step."""
        return self.generate_s * 1e3 / max(1, self.generated.shape[1])

    @property
    def generated_tokens_per_s(self) -> float:
        return self.generated.numel() / max(self.generate_s, 1e-12)


def check_prefill_against_decode(res: ServeResult, rel_tol: float) -> dict:
    """Hold the prefill's last-position logits (the flash path's causal
    mask) to the decode logits after the last prompt token
    (``decode_attention``'s ``kv_valid`` mask).

    Raises unless max |prefill - decode| <= ``rel_tol`` x max |prefill|,
    and unless the argmax is equal in every row whose top-2 margin
    exceeds that tolerance (elsewhere the two paths' rounding may
    legitimately swap the top two).  Returns the measured numbers.
    """
    pre = res.prefill_logits.float()
    dec = res.prompt_logits.float()
    scale = float(pre.abs().max())
    diff = float((pre - dec).abs().max())
    top2 = pre.topk(2, dim=-1).values
    decided = (top2[..., 0] - top2[..., 1]) > rel_tol * scale
    same = pre.argmax(dim=-1) == dec.argmax(dim=-1)
    out = dict(max_abs_diff=diff, max_abs_logit=scale,
               rel_diff=diff / max(scale, 1e-30), rel_tol=rel_tol,
               rows=int(decided.numel()), rows_decided=int(decided.sum()),
               argmax_equal=int(same.sum()))
    if diff > rel_tol * scale:
        raise RuntimeError(f"prefill and stepped decode disagree: {out}")
    if bool((decided & ~same).any()):
        raise RuntimeError(f"prefill and stepped decode pick another token "
                           f"where the margin exceeds the tolerance: {out}")
    return out


def serve_lm(cfg: T.LMConfig, params: Optional[T.Params] = None,
             prompts: Optional[np.ndarray] = None, *, batch: int = 2,
             prompt_len: int = 16, gen_len: int = 8, seed: int = 0,
             device=None) -> ServeResult:
    """The reference's ``serve_lm`` loop (``launch/serve.py:147-170``):
    step ``decode_step`` over the prompts, then ``gen_len`` greedy steps
    (argmax, first index on ties); then one ``prefill`` of the prompts.

    ``params`` default to random ones from ``seed`` on ``device`` (CUDA
    unless the caller asks for the CPU); ``prompts`` (B, P) default to
    ``np.random.default_rng(seed).integers(0, vocab, (batch, prompt_len))``.
    """
    dev = ops.resolve_device(device)
    if params is None:
        params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(
            seed), dev)
    if prompts is None:
        prompts = np.random.default_rng(seed).integers(
            0, cfg.vocab, (batch, prompt_len))
    toks = torch.as_tensor(np.asarray(prompts), dtype=torch.long, device=dev)
    b, p = toks.shape
    cache = T.init_cache(cfg, b, p + gen_len, dev)
    timer = StageTimer(device=dev)
    with timer.stage("prompt") as sync:
        for i in range(p):
            logits, cache = T.decode_step(params, cache, toks[:, i:i + 1],
                                          cfg)
        prompt_logits = sync(logits)
    with timer.stage("generate") as sync:
        out = []
        for _ in range(gen_len):
            nxt = logits[:, -1, :].argmax(dim=-1, keepdim=True)
            out.append(nxt)
            logits, cache = T.decode_step(params, cache, nxt, cfg)
        generated = sync(torch.cat(out, dim=1) if out else toks[:, :0])
    with timer.stage("prefill") as sync:
        prefill_logits = sync(T.prefill(params, toks, cfg))
    return ServeResult(generated=generated, prompt_logits=prompt_logits,
                       prefill_logits=prefill_logits,
                       prompt_s=timer.timings["prompt"],
                       generate_s=timer.timings["generate"],
                       prefill_s=timer.timings["prefill"])


SERVE_LENGTH = 128


def _ssh_db(arch, config, db_dir, device):
    """(query pool, TimeSeriesDB): loaded from ``db_dir`` with the saved
    search knobs and ``config``'s searcher and backend overlaid, else
    built from the smoke spec over windows of a synthetic ECG stream
    (``repro/launch/serve.py:27-67``)."""
    from repro_torch.data.timeseries import (extract_subsequences,
                                             synthetic_ecg)
    from repro_torch.db import TimeSeriesDB, is_database_dir
    from repro_torch.db.persistence import saved_config
    tsdb = None
    length = SERVE_LENGTH
    if db_dir:
        if not is_database_dir(db_dir):
            raise FileNotFoundError(
                f"--db-dir {db_dir}: no saved TimeSeriesDB there (build one "
                "with repro_torch.launch.build_index)")
        saved = saved_config(db_dir) or config
        tsdb = TimeSeriesDB.load(db_dir, saved.replace(
            searcher=config.searcher, backend=config.backend,
            batch_policy=config.batch_policy), device=device)
        length = tsdb.length
        print(f"loaded database ({len(tsdb)} series of length {length}) "
              f"from {db_dir}", flush=True)
    stream = synthetic_ecg(8000, seed=5)
    pool = extract_subsequences(stream, length, stride=1, znorm=True)
    if tsdb is None:
        tsdb = TimeSeriesDB.build(pool, arch.index_spec(smoke=True), config,
                                  device=device)
    return pool, tsdb


def serve_ssh(arch, requests: int, batch_size: int = 8,
              wait_ms: float = 2.0, backend: str = "auto", db_dir=None,
              batch_mode: str = "fixed", device=None) -> list:
    """Engine serving (``repro/launch/serve.py:70-124``): every padded
    bucket warmed through ``engine.searcher`` (outside the metrics), then
    the requests submitted one at a time through ``TimeSeriesDB.submit``
    and batched by the ``BatchPolicy``; prints each top-1 and the
    engine's metrics line; returns the results in request order."""
    from repro_torch.db import BatchPolicy
    dev = ops.resolve_device(device)
    policy = BatchPolicy(mode=batch_mode, max_batch=batch_size,
                         max_wait_ms=wait_ms)
    cfg = arch.search_config(length=SERVE_LENGTH, searcher="engine",
                             backend=backend, batch_policy=policy)
    pool, tsdb = _ssh_db(arch, cfg, db_dir, dev)
    engine = tsdb.engine
    qids = np.random.default_rng(0).integers(0, pool.shape[0], requests)
    for size in cfg.buckets():
        engine.searcher.search_batch(pool[np.resize(qids, size)])
    out = []
    t0 = time.perf_counter()
    with tsdb:
        futs = [(int(i), tsdb.submit(pool[int(i)])) for i in qids]
        for i, fut in futs:
            res = fut.result(timeout=600)
            out.append(res)
            print(f"req {i}: top1={res.ids[0]} pruned="
                  f"{res.pruned_total_frac:.1%}", flush=True)
        wall = time.perf_counter() - t0
        snap = engine.metrics.snapshot()
    print(f"engine: {engine.metrics.format()}", flush=True)
    print(f"served {requests} requests in {wall:.2f}s "
          f"({requests / wall:.1f} qps end-to-end, avg batch "
          f"{snap['batch_size_mean']:.1f}) on {dev}", flush=True)
    return out


#: the fleet options and their defaults, the only values accepted
FLEET_DEFAULTS = {"replication": 1, "fleet_workers": None, "hedge_ms": 30.0}


def serve_ssh_sequential(arch, requests: int, backend: str = "auto",
                         db_dir=None, device=None) -> list:
    """One ``ssh_search`` a request through the ``local`` searcher;
    prints each top-1 and the latency percentiles; returns the
    results."""
    dev = ops.resolve_device(device)
    cfg = arch.search_config(length=SERVE_LENGTH, searcher="local",
                             backend=backend)
    pool, tsdb = _ssh_db(arch, cfg, db_dir, dev)
    rng = np.random.default_rng(0)
    lat, out = [], []
    for i in rng.integers(0, pool.shape[0], requests):
        t0 = time.perf_counter()
        res = tsdb.search(pool[int(i)])
        lat.append(time.perf_counter() - t0)
        out.append(res)
        print(f"req {i}: top1={res.ids[0]} pruned="
              f"{res.pruned_total_frac:.1%} {lat[-1] * 1e3:.0f}ms",
              flush=True)
    lat = sorted(lat)
    print(f"p50={lat[len(lat) // 2] * 1e3:.0f}ms p99={lat[-1] * 1e3:.0f}ms "
          f"over {requests} requests ({requests / sum(lat):.1f} qps) on "
          f"{dev}", flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's SMOKE config instead of full width")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen-len", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sequential", action="store_true",
                    help="ssh: one ssh_search per request (local searcher) "
                         "instead of the engine")
    ap.add_argument("--requests", type=int, default=4, help="ssh requests")
    ap.add_argument("--batch-size", type=int, default=8,
                    help="ssh: the dynamic batcher's max batch")
    ap.add_argument("--wait-ms", type=float, default=2.0,
                    help="ssh: the dynamic batcher's max wait")
    ap.add_argument("--batch-mode", default="fixed",
                    choices=("fixed", "adaptive"),
                    help="ssh: fixed deadline, or the wait from queue depth "
                         "and the service-time EWMA")
    ap.add_argument("--replication", type=int, default=1,
                    help="ssh: fleet replicas (1 only; the fleet is queued)")
    ap.add_argument("--fleet-workers", type=int, default=None,
                    help="ssh: fleet size (unset only; the fleet is queued)")
    ap.add_argument("--hedge-ms", type=float, default=30.0,
                    help="ssh: hedging deadline (30 only; the fleet is "
                         "queued)")
    ap.add_argument("--db-dir", default=None,
                    help="ssh: serve the TimeSeriesDB saved here")
    ap.add_argument("--backend", default="auto",
                    choices=("auto", "pallas", "jnp"),
                    help="ssh: kernel backend knob of the query path")
    args = ap.parse_args(argv)
    if args.arch.startswith("ssh"):
        from repro_torch.configs.registry import get_arch
        fleet = [f"--{k.replace('_', '-')} {getattr(args, k)}"
                 for k, v in FLEET_DEFAULTS.items() if getattr(args, k) != v]
        if fleet:
            ap.error(f"{', '.join(fleet)}: the fleet tier is not ported yet "
                     "(queued in ROADMAP.md §1, item 6); leave the fleet "
                     "options at their defaults")
        arch = get_arch(args.arch)
        if args.sequential:
            serve_ssh_sequential(arch, args.requests, backend=args.backend,
                                 db_dir=args.db_dir, device=args.device)
        else:
            serve_ssh(arch, args.requests, args.batch_size, args.wait_ms,
                      backend=args.backend, db_dir=args.db_dir,
                      batch_mode=args.batch_mode, device=args.device)
        return 0
    if args.arch not in LM_ARCHS:
        ap.error(f"--arch {args.arch}: the port serves {sorted(LM_ARCHS)}")
    mod = LM_ARCHS[args.arch]
    cfg = mod.SMOKE if args.smoke else mod.CONFIG
    dev = ops.resolve_device(args.device)
    res = serve_lm(cfg, batch=args.batch, prompt_len=args.prompt_len,
                   gen_len=args.gen_len, seed=args.seed, device=dev)
    diff = (res.prefill_logits.float() - res.prompt_logits.float()).abs()
    print(f"{cfg.name}{' (smoke)' if args.smoke else ''} on {dev}: "
          f"{args.batch} prompts of {args.prompt_len} tokens, "
          f"{args.gen_len} generated")
    print(f"decode: prompt {res.prompt_s:.3f} s; {res.decode_ms_per_step:.2f}"
          f" ms per generating step, {res.generated_tokens_per_s:.1f} "
          f"generated tok/s")
    print(f"prefill of the same prompts {res.prefill_s:.3f} s; max |prefill "
          f"- decode| of the last-position logits {float(diff.max()):.3g}")
    print(f"sample: {res.generated[0].tolist()}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

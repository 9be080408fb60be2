"""Training launcher (counterpart of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b \\
        --shape train_4k --steps 10 --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b \\
        --steps 5 --batch 4 --ckpt-dir build/ckpt --ckpt-every 2

AdamW with float32 master weights, per-layer remat, checkpoint and
restart through ``repro_torch.checkpoint`` (the reference's on-disk
format: ``{"params", "opt"}``, resumed from the latest step), and a
deterministic per-step synthetic batch (seed = step), so a restart sees
the batches it would have seen.  Without ``--device cpu`` it runs on
CUDA and raises where there is none.  ``--batch`` cuts the cell's batch
(256 sequences for ``train_4k``) and ``--layers`` the model's depth to
fit one card, and each says so.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs.base import ShapeCell
from repro_torch.configs.registry import get_arch
from repro_torch.kernels import ops
from repro_torch.launch import steps as steps_mod
from repro_torch.train.optimizer import AdamWState


def synthetic_batch(arch, shape, smoke: bool, step_idx: int, device=None
                    ) -> Dict[str, Any]:
    """Deterministic per-step batch (seed = step): every input of the
    cell drawn from ``np.random.default_rng(step_idx)`` in sorted key
    order, as the reference maps over its spec dict (so ``labels`` is
    drawn before ``tokens``), integers uniform in [0, vocab), floats
    standard normal; ``smoke`` cuts the leading axis to 64 and the others
    to 128, as the reference."""
    rng = np.random.default_rng(step_idx)
    kind, spec = arch.input_specs(shape)
    cfg = arch.smoke_config if smoke else arch.cell_config(shape)
    dev = ops.resolve_device(device)

    def reduced(s):
        shp = (tuple(min(d, 64) if i == 0 else min(d, 128)
                     for i, d in enumerate(s.shape)) if smoke else s.shape)
        if not s.dtype.is_floating_point:
            hi = getattr(cfg, "vocab", 100)
            return torch.as_tensor(rng.integers(0, hi, shp), dtype=s.dtype,
                                   device=dev)
        return torch.as_tensor(rng.normal(size=shp), dtype=s.dtype,
                               device=dev)

    def walk(tree):
        if isinstance(tree, dict):
            return {k: walk(tree[k]) for k in sorted(tree)}
        return reduced(tree)
    return walk(spec)


def cut_batch(arch, shape: str, batch: int):
    """``arch`` with the cell ``shape``'s batch cut to ``batch``."""
    cell = arch.shapes[shape]
    cut = ShapeCell(cell.kind, dict(cell.meta, batch=batch))
    return dataclasses.replace(arch, shapes=dict(arch.shapes, **{shape: cut}))


def cut_layers(arch, layers: int, smoke: bool = False):
    """``arch`` with its config (the smoke one with ``smoke``) cut to
    ``layers`` layers."""
    field = "smoke_config" if smoke else "config"
    cfg = dataclasses.replace(getattr(arch, field), n_layers=layers)
    return dataclasses.replace(arch, **{field: cfg})


def _load_into(live, restored) -> None:
    """Copy a restored tree (numpy arrays, bf16 CPU tensors) into the
    live tensors of the same structure, in place."""
    if isinstance(live, dict):
        for k in live:
            _load_into(live[k], restored[k])
    elif isinstance(live, AdamWState):
        for f in live._fields:
            _load_into(getattr(live, f), getattr(restored, f))
    else:
        with torch.no_grad():
            live.copy_(torch.as_tensor(restored))


@dataclasses.dataclass
class TrainRun:
    """What :func:`main` leaves: the final state, the step it started
    from and one record a step (``step``, ``loss``, ``ce``, ``aux``,
    ``grad_norm``, ``lr``, ``seconds``: host clock around the step,
    which ends reading the loss)."""
    params: Dict[str, Any]
    opt_state: AdamWState
    start: int
    history: List[Dict[str, float]]


def main(argv: Optional[List[str]] = None) -> TrainRun:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="cpu, or a CUDA device (the default)")
    ap.add_argument("--batch", type=int, default=None,
                    help="cut the cell's batch to this many sequences")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the model's depth to this many layers")
    args = ap.parse_args(argv)

    dev = ops.resolve_device(args.device)
    arch = get_arch(args.arch)
    if arch.family != "lm":
        ap.error(f"--arch {args.arch}: the port trains the lm family")
    shape = args.shape or next(s for s, c in arch.shapes.items()
                               if c.kind == "train")
    full_batch = arch.shapes[shape].meta["batch"]
    if args.batch is not None and args.batch < full_batch:
        arch = cut_batch(arch, shape, args.batch)
        print(f"{shape}: batch CUT from {full_batch} to {args.batch} "
              f"sequences", flush=True)
    full_layers = (arch.smoke_config if args.smoke
                   else arch.config).n_layers
    if args.layers is not None and args.layers < full_layers:
        arch = cut_layers(arch, args.layers, args.smoke)
        print(f"{arch.name}: depth CUT from {full_layers} to {args.layers} "
              f"layers", flush=True)
    params = steps_mod.init_fn(arch, shape, smoke=args.smoke, device=dev)()
    opt = steps_mod.make_optimizer(arch.family)
    opt_state = opt.init(params)
    train_step = steps_mod.make_step(arch, shape, "train", smoke=args.smoke)

    ck = None
    start = 0
    if args.ckpt_dir:
        ck = Checkpointer(args.ckpt_dir, keep=3, async_save=True)
        latest, restored = ck.restore_latest(
            {"params": params, "opt": opt_state})
        if latest is not None:
            _load_into({"params": params, "opt": opt_state}, restored)
            del restored
            start = latest
            print(f"resumed from checkpoint step {start}", flush=True)

    history = []
    saved = start
    for i in range(start, args.steps):
        batch = synthetic_batch(arch, shape, args.smoke, i, dev)
        t0 = time.perf_counter()
        params, opt_state, metrics = train_step(params, opt_state, batch)
        loss = float(metrics["loss"])
        rec = {"step": i, "loss": loss,
               **{k: float(metrics[k]) for k in ("ce", "aux", "grad_norm",
                                                 "lr")},
               "seconds": time.perf_counter() - t0}
        history.append(rec)
        if i % args.log_every == 0:
            print(f"step {i}: loss={loss:.4f} ({rec['seconds']:.2f}s)",
                  flush=True)
        if ck and (i + 1) % args.ckpt_every == 0:
            ck.save(i + 1, {"params": params, "opt": opt_state})
            saved = i + 1
    if ck:
        if saved != args.steps:      # the last step's state is not saved yet
            ck.save(args.steps, {"params": params, "opt": opt_state})
        ck.wait()
    print("training done", flush=True)
    return TrainRun(params, opt_state, start, history)


if __name__ == "__main__":
    main()

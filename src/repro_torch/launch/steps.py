"""Step-function builders, one per (family x kind) (counterpart of
``repro.launch.steps``, the ``lm`` family).

``init_fn`` returns the parameter initialiser of a cell and ``make_step``
its step: ``train`` (loss, ``backward()``, AdamW), ``prefill`` and
``decode``.  The reference's gnn and recsys steps wait for their models
(ROADMAP.md §1 item 7.5); its ``abstract_*`` helpers and the ssh build
and query steps exist for the XLA dry run (item 7.8).  Those raise
``NotImplementedError`` here.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.configs.base import ArchDef
from repro_torch.train.optimizer import AdamW, tree_leaves, tree_map

_ITEM_7_5 = "ROADMAP.md §1 item 7.5 (recsys and gnn)"
_ITEM_7_8 = "ROADMAP.md §1 item 7.8 (the XLA dry run)"


def make_optimizer(family: str) -> AdamW:
    if family == "lm":
        return AdamW(lr=3e-4, weight_decay=0.1)
    return AdamW(lr=1e-3, weight_decay=1e-4)


def _config(arch: ArchDef, shape: str, smoke: bool):
    return arch.smoke_config if smoke else arch.cell_config(shape)


def _lm_only(arch: ArchDef) -> None:
    if arch.family == "ssh":
        raise NotImplementedError(f"the ssh build and query steps serve the "
                                  f"dry run: {_ITEM_7_8}")
    if arch.family != "lm":
        raise NotImplementedError(f"family {arch.family!r}: {_ITEM_7_5}")


def init_fn(arch: ArchDef, shape: str, smoke: bool = False,
            device=None) -> Callable[..., Dict[str, Any]]:
    """A ``(generator=None) -> params`` initialiser for the cell's config
    on ``device`` (CUDA unless the caller asks for the CPU); the default
    generator is seeded with 0, as the reference's ``PRNGKey(0)``."""
    _lm_only(arch)
    from repro_torch.models.transformer import init_params
    cfg = _config(arch, shape, smoke)
    return lambda generator=None: init_params(cfg, generator, device)


def abstract_params(*_args, **_kwargs):
    raise NotImplementedError(f"abstract_params: {_ITEM_7_8}")


def abstract_opt_state(*_args, **_kwargs):
    raise NotImplementedError(f"abstract_opt_state: {_ITEM_7_8}")


def abstract_state(*_args, **_kwargs):
    raise NotImplementedError(f"abstract_state: {_ITEM_7_8}")


def _loss_for(arch: ArchDef, shape: str, smoke: bool) -> Callable:
    _lm_only(arch)
    from repro_torch.models.transformer import loss_fn
    cfg = _config(arch, shape, smoke)
    return lambda p, b: loss_fn(p, b, cfg)


def make_step(arch: ArchDef, shape: str, kind: str, smoke: bool = False,
              optimizer: Optional[AdamW] = None) -> Callable:
    """The cell's step.  ``train``: ``(params, opt_state, batch) ->
    (params, opt_state, metrics)`` with metrics ``loss``, ``ce``,
    ``aux``, ``grad_norm`` (0-d tensors) and ``lr``; the parameters are
    made to require grad, their gradients are freed after the update.
    ``prefill``: ``(params, batch) -> last-position logits``;
    ``decode``: ``(params, cache, tokens) -> (logits, cache)``, both
    without grad.  ``optimizer`` defaults to :func:`make_optimizer`."""
    _lm_only(arch)
    cfg = _config(arch, shape, smoke)
    from repro_torch.models import transformer as T

    if kind == "train":
        loss = _loss_for(arch, shape, smoke)
        opt = optimizer or make_optimizer(arch.family)

        def train_step(params, opt_state, batch):
            leaves = tree_leaves(params)
            for p in leaves:
                p.requires_grad_(True)
                p.grad = None
            l, metrics = loss(params, batch)
            l.backward()
            grads = tree_map(lambda p: p.grad, params)
            params, opt_state, opt_metrics = opt.update(params, opt_state,
                                                        grads)
            del grads
            for p in leaves:
                p.grad = None
            metrics = {k: v.detach() for k, v in metrics.items()}
            metrics = dict(metrics, loss=l.detach(), **opt_metrics)
            return params, opt_state, metrics
        return train_step

    if kind == "prefill":
        @torch.no_grad()
        def prefill_step(params, batch):
            return T.prefill(params, batch["tokens"], cfg)
        return prefill_step
    if kind == "decode":
        @torch.no_grad()
        def decode(params, cache, tokens):
            return T.decode_step(params, cache, tokens, cfg)
        return decode
    raise ValueError(f"no step for {arch.family}/{kind}")

"""Step-function builders, one per (family x kind) (counterpart of
``repro.launch.steps``).

``init_fn`` returns the parameter initialiser of a cell and ``make_step``
its step: ``train`` for every family (loss, ``backward()``, AdamW),
``prefill`` and ``decode`` for the lm family, ``serve`` and
``retrieval`` for recsys.  The recsys models are picked by the config's
name up to its first ``-``, as the reference picks them.  The
reference's ``abstract_*`` helpers and the ssh build and query steps
exist for the XLA dry run (ROADMAP.md §1 item 7.8); those raise
``NotImplementedError`` here.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.configs.base import ArchDef
from repro_torch.train.optimizer import AdamW, tree_leaves, tree_map

_ITEM_7_8 = "ROADMAP.md §1 item 7.8 (the XLA dry run)"


def make_optimizer(family: str) -> AdamW:
    if family == "lm":
        return AdamW(lr=3e-4, weight_decay=0.1)
    return AdamW(lr=1e-3, weight_decay=1e-4)


def _config(arch: ArchDef, shape: str, smoke: bool):
    return arch.smoke_config if smoke else arch.cell_config(shape)


def _refuse_ssh(arch: ArchDef) -> None:
    if arch.family == "ssh":
        raise NotImplementedError(f"the ssh build and query steps serve the "
                                  f"dry run: {_ITEM_7_8}")


def _recsys_model(cfg):
    """(init, forward, retrieval) of a recsys config's model."""
    from repro_torch.models.recsys import MODELS
    return MODELS[cfg.name.split("-")[0]]


def init_fn(arch: ArchDef, shape: str, smoke: bool = False,
            device=None) -> Callable[..., Dict[str, Any]]:
    """A ``(generator=None) -> params`` initialiser for the cell's config
    on ``device`` (CUDA unless the caller asks for the CPU); the default
    generator is seeded with 0, as the reference's ``PRNGKey(0)``."""
    _refuse_ssh(arch)
    cfg = _config(arch, shape, smoke)
    if arch.family == "lm":
        from repro_torch.models.transformer import init_params
    elif arch.family == "gnn":
        from repro_torch.models.nequip import init_params
    elif arch.family == "recsys":
        init_params = _recsys_model(cfg)[0]
    else:
        raise ValueError(arch.family)
    return lambda generator=None: init_params(cfg, generator, device)


def abstract_params(*_args, **_kwargs):
    raise NotImplementedError(f"abstract_params: {_ITEM_7_8}")


def abstract_opt_state(*_args, **_kwargs):
    raise NotImplementedError(f"abstract_opt_state: {_ITEM_7_8}")


def abstract_state(*_args, **_kwargs):
    raise NotImplementedError(f"abstract_state: {_ITEM_7_8}")


def _loss_for(arch: ArchDef, shape: str, smoke: bool) -> Callable:
    _refuse_ssh(arch)
    cfg = _config(arch, shape, smoke)
    if arch.family == "lm":
        from repro_torch.models.transformer import loss_fn
        return lambda p, b: loss_fn(p, b, cfg)
    if arch.family == "gnn":
        from repro_torch.models.nequip import loss_fn
        n_graphs = arch.shapes[shape].meta.get("n_graphs")
        return lambda p, b: loss_fn(p, b, cfg, n_graphs=n_graphs)
    if arch.family == "recsys":
        from repro_torch.models import recsys as R
        fwd = _recsys_forward(cfg)

        def loss(p, b):
            feats = {k: v for k, v in b.items() if k != "labels"}
            l = R.bce_loss(fwd(p, feats), b["labels"])
            return l, {"bce": l}
        return loss
    raise ValueError(arch.family)


def _recsys_forward(cfg) -> Callable:
    return functools.partial(_recsys_model(cfg)[1], cfg=cfg)


def _recsys_retrieval(cfg) -> Callable:
    return functools.partial(_recsys_model(cfg)[2], cfg=cfg)


def make_step(arch: ArchDef, shape: str, kind: str, smoke: bool = False,
              optimizer: Optional[AdamW] = None) -> Callable:
    """The cell's step.  ``train``: ``(params, opt_state, batch) ->
    (params, opt_state, metrics)`` with the loss's metrics (lm ``ce``,
    ``aux``; gnn ``mse``; recsys ``bce``: 0-d tensors), ``loss``,
    ``grad_norm`` and ``lr``; the parameters are made to require grad,
    their gradients are freed after the update.  lm ``prefill``:
    ``(params, batch) -> last-position logits``; lm ``decode``:
    ``(params, cache, tokens) -> (logits, cache)``; recsys ``serve``:
    ``(params, batch) -> logits (B,)``; recsys ``retrieval``: ``(params,
    batch) -> scores (n_cand,)``; all four without grad.  ``optimizer``
    defaults to :func:`make_optimizer`."""
    _refuse_ssh(arch)
    cfg = _config(arch, shape, smoke)

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
            # a leaf the loss does not reach (the last NequIP layer's
            # l > 0 weights at one layer) has no grad: zeros, as jax.grad
            grads = tree_map(lambda p: torch.zeros_like(p) if p.grad is None
                             else p.grad, params)
            params, opt_state, opt_metrics = opt.update(params, opt_state,
                                                        grads)
            del grads
            for p in leaves:
                p.grad = None
            metrics = {k: v.detach() for k, v in metrics.items()}
            metrics = dict(metrics, loss=l.detach(), **opt_metrics)
            return params, opt_state, metrics
        return train_step

    if arch.family == "lm":
        from repro_torch.models import transformer as T
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

    if arch.family == "recsys" and kind in ("serve", "retrieval"):
        fn = (_recsys_forward if kind == "serve" else _recsys_retrieval)(cfg)

        @torch.no_grad()
        def recsys_step(params, batch):
            return fn(params, batch)
        return recsys_step
    raise ValueError(f"no step for {arch.family}/{kind}")

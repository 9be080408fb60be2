"""Step-function builders, one per (family x kind) (counterpart of
``repro.launch.steps``).

``init_fn`` returns the parameter initialiser of a cell and ``make_step``
its step: ``train`` for every family but ssh (loss, ``backward()``,
AdamW), ``prefill`` and ``decode`` for the lm family, ``serve`` and
``retrieval`` for recsys, ``build`` and ``query`` for ssh.  The recsys
models are picked by the config's name up to its first ``-``, as the
reference picks them.

``abstract_state`` is the cell's whole argument tuple as
:class:`TensorSpec` trees (the reference's ``jax.eval_shape`` of the
initialisers): the parameters are drawn on ``torch.device("meta")``,
which holds shapes and dtypes and no data, so dbrx-132b's 131.6 B
parameters take no memory.  The dry run (``launch.dryrun``) reads it.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchDef, TensorSpec
from repro_torch.kernels import ops
from repro_torch.train.optimizer import (AdamW, AdamWState, tree_leaves,
                                         tree_map)

#: shingles (rows x shingles a row) the ssh build step hashes a chunk:
#: bounds the active CWS's (K, rows, shingles) float32 temporaries, about
#: 2.7 GB at K = 40 (6,523 rows of 643 shingles at length 2,048)
SSH_BUILD_CHUNK = 1 << 22


def make_optimizer(family: str) -> AdamW:
    if family == "lm":
        return AdamW(lr=3e-4, weight_decay=0.1)
    return AdamW(lr=1e-3, weight_decay=1e-4)


def _config(arch: ArchDef, shape: str, smoke: bool):
    return arch.smoke_config if smoke else arch.cell_config(shape)


def _recsys_model(cfg):
    """(init, forward, retrieval) of a recsys config's model."""
    from repro_torch.models.recsys import MODELS
    return MODELS[cfg.name.split("-")[0]]


def init_fn(arch: ArchDef, shape: str, smoke: bool = False,
            device=None) -> Callable[..., Dict[str, Any]]:
    """A ``(generator=None) -> params`` initialiser for the cell's config
    on ``device`` (CUDA unless the caller asks for the CPU); the default
    generator is seeded with 0, as the reference's ``PRNGKey(0)``; an ssh
    arch's, with its spec's seed (``{"filters", "cws": {"log_r", "r",
    "log_c", "beta"}}``, the encoder's draw: ``SSHFunctions.create``'s
    distributions)."""
    cfg = _config(arch, shape, smoke)
    if arch.family == "ssh":
        return lambda generator=None: _ssh_init(cfg, generator, device)
    if arch.family == "lm":
        from repro_torch.models.transformer import init_params
    elif arch.family == "gnn":
        from repro_torch.models.nequip import init_params
    elif arch.family == "recsys":
        init_params = _recsys_model(cfg)[0]
    else:
        raise ValueError(arch.family)
    return lambda generator=None: init_params(cfg, generator, device)


def _ssh_init(spec, generator: Optional[torch.Generator], device
              ) -> Dict[str, Any]:
    """The filter bank, then the CWS fields, drawn on the CPU from
    ``generator`` (default: seeded by ``spec.seed``), as
    ``SSHEncoder.materialize`` draws them, then moved to ``device``."""
    from repro_torch.core import minhash
    from repro_torch.encoders.pipeline import SSHEncoder
    dev = ops.resolve_device(device)
    enc = SSHEncoder(spec)
    gen = generator if generator is not None else (
        torch.Generator().manual_seed(spec.seed))
    state = enc.sketcher.materialize(gen)
    state.update(enc.hasher.materialize(gen, enc.dim))
    return {"filters": state["filters"].to(dev),
            "cws": {f: state[f"cws/{f}"].to(dev)
                    for f in minhash.CWSParams._fields}}


def _spec_of(x) -> TensorSpec:
    return TensorSpec(tuple(x.shape), x.dtype)


def abstract_params(arch: ArchDef, shape: str, smoke: bool = False):
    """The cell's parameter tree as :class:`TensorSpec`s: the
    initialiser run on the meta device (``jax.eval_shape``'s
    counterpart)."""
    return tree_map(_spec_of, init_fn(arch, shape, smoke, device="meta")())


def abstract_opt_state(arch: ArchDef, params_spec) -> AdamWState:
    """AdamW's state for ``params_spec``: a 0-d int32 step, float32
    moments and master weights of every parameter's shape."""
    f32 = tree_map(lambda s: TensorSpec(tuple(s.shape), torch.float32),
                   params_spec)
    return AdamWState(step=TensorSpec((), torch.int32), m=f32, v=f32,
                      master=f32)


def abstract_state(arch: ArchDef, shape: str
                   ) -> Tuple[str, Tuple[Any, ...]]:
    """(kind, the step's whole argument tuple as ``TensorSpec`` trees)."""
    kind, batch = arch.input_specs(shape)
    params = abstract_params(arch, shape)
    if kind == "train":
        return kind, (params, abstract_opt_state(arch, params), batch)
    if kind == "decode":
        return kind, (params, batch["cache"], batch["tokens"])
    if kind in ("prefill", "serve", "retrieval", "build", "query"):
        return kind, (params, batch)
    raise ValueError(kind)


def _loss_for(arch: ArchDef, shape: str, smoke: bool) -> Callable:
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
    batch) -> scores (n_cand,)``; ssh ``build``: ``(params, {"series"
    (B, m)}) -> signatures (B, K) int32``; ssh ``query``: ``(params,
    {"query" (m,), "db_sigs" (N, K), "db_series" (N, m)}) -> (ids (10,),
    distances (10,))``; all six without grad.  ``optimizer`` defaults to
    :func:`make_optimizer`."""
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

    if arch.family == "ssh":
        if kind == "build":
            return _make_ssh_build(cfg)
        if kind == "query":
            meta = arch.shapes[shape].meta
            return _make_ssh_query(cfg, top_c=meta["top_c"],
                                   band=meta["band"], topk=10)
    raise ValueError(f"no step for {arch.family}/{kind}")


# --------------------------------------------------------------------------
# SSH steps: the paper's technique as a serving workload
# --------------------------------------------------------------------------

def _ssh_encoder(spec, params):
    """The ``"ssh"`` encoder of ``spec`` holding ``params``' state."""
    from repro_torch.encoders.pipeline import SSHEncoder
    state = {"filters": params["filters"]}
    state.update({f"cws/{k}": v for k, v in params["cws"].items()})
    return SSHEncoder(spec).load_state(state)


def _make_ssh_build(spec) -> Callable:
    @torch.no_grad()
    def build_step(params, batch):
        """Hash a block of the database: series (B, m) -> signatures
        (B, K) int32.  Sketch bits of the whole block through one launch
        of the ``sketch_conv`` kernel (``ops.sketch_bits``), then, in
        chunks of at most ``chunk`` shingles, the shingle ids and 0-bit
        CWS over each row's active shingles
        (``core.minhash.cws_hash_active``).  The reference hashes the
        dense (B, 2^n) histogram (``cws_hash_dense_batch``), 8.6 GB of
        float32 at B = 65,536; the active form gives the same
        signatures, ties to the lowest dimension included, without
        it.  ``chunk`` is :data:`SSH_BUILD_CHUNK`."""
        enc = _ssh_encoder(spec, params)
        state = enc.state()
        bits = enc.sketcher.sketch(batch["series"], state)  # (B, N_B, F)
        shingles = bits.shape[2] * max(1, bits.shape[1] - enc.ngram + 1)
        rows = max(1, SSH_BUILD_CHUNK // shingles)
        return torch.cat([enc.hasher.hash_ids(enc.shingler.shingle_ids(
            bits[lo:lo + rows]), state)
            for lo in range(0, bits.shape[0], rows)])
    return build_step


def _make_ssh_query(spec, top_c: int, band: int, topk: int) -> Callable:
    from repro_torch.core.search import top_c_by_count

    @torch.no_grad()
    def query_step(params, batch):
        """Probe the database's signatures, gather the candidates, re-rank
        them by banded DTW: the query's signature, its collision counts
        through the ``collision_count`` kernel, the ``top_c`` rows by
        count (ties to the lowest id, as ``lax.top_k``), their DTW at
        radius ``band`` through the ``dtw_wavefront`` kernel, then the
        ``topk`` smallest (ties to the lowest candidate rank).  Returns
        (ids int64, squared DTW costs float32)."""
        q = batch["query"]
        sig = _ssh_encoder(spec, params).encode_batch(q[None])[0]
        db_sigs = batch["db_sigs"]
        counts = ops.collision_count(sig.to(db_sigs.device), db_sigs)
        ids = top_c_by_count(counts[None], min(top_c, counts.shape[0]),
                             max_count=int(sig.shape[-1]))[0][0]
        cands = batch["db_series"].index_select(0, ids)
        d = ops.dtw_rerank(q.to(cands.device), cands, band)
        order = torch.sort(d, stable=True).indices[:topk]
        return ids[order], d[order]
    return query_step

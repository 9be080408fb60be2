"""Distributed SSH index: row-sharded fan-out (counterpart of
``repro.distributed.dist_index``).

Layout: signatures (N, K) and series (N, m) are cut into equal row
ranges, one a mesh entry, each placed on its entry's device.  A query is
encoded once and broadcast; each shard

  1. counts signature collisions locally       (``collision_count`` kernel)
  2. takes its local top-C/shards candidates   (``top_c_by_count``: ties
                                                 to the lowest local id)
  3. re-ranks them with banded DTW             (``dtw_wavefront`` kernel,
                                                 after a seed threshold)
  4. contributes (global ids, dists) to the gather: a concatenation onto
     the first mesh device, then the global top-k by a stable ascending
     sort, ``lax.top_k(-all_d)``'s order.

A mesh is a sequence of ``torch.device``s, the counterpart of
``jax.make_mesh((n,), ("data",))``: :func:`default_mesh` gives one entry
per visible CUDA device (one on a one-card machine), and a device may
repeat, which puts several row shards on one card as
``--xla_force_host_platform_device_count`` gives JAX several CPU
devices.  :func:`local_query` is the one shard-local schedule; the
fleet's ``FleetWorker.query_shard`` calls it too.
"""
from __future__ import annotations

import inspect
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from repro_torch.core import minhash
from repro_torch.core.index import SSHFunctions, SSHParams, encoder_of
from repro_torch.core.search import top_c_by_count
from repro_torch.db.config import SearchConfig, config_from_legacy_kwargs
from repro_torch.encoders.registry import encoder_class
from repro_torch.kernels import ops

Mesh = Sequence[torch.device]
#: (device, first row, end row) of one row shard
RowShard = Tuple[torch.device, int, int]


def default_mesh(device: torch.device) -> List[torch.device]:
    """The mesh for an index on ``device``: every visible CUDA device for
    a CUDA index (``jax.device_count()``'s counterpart), the CPU for a
    CPU one."""
    if device.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [device]


def as_mesh(mesh: Mesh) -> List[torch.device]:
    """``mesh`` as a non-empty list of CUDA or CPU devices."""
    devs = [torch.device(d) for d in mesh]
    if not devs:
        raise ValueError("a mesh needs at least one device")
    bad = [d for d in devs if d.type not in ("cuda", "cpu")]
    if bad:
        raise ValueError(f"repro_torch shards over cuda or cpu devices, "
                         f"got {bad}")
    return devs


def index_shardings(mesh: Mesh, n_rows: int) -> List[RowShard]:
    """Where each shard's rows live: equal row ranges in mesh order (the
    reference's ``P(axes, None)``).  The rows must divide the mesh."""
    devs = as_mesh(mesh)
    if n_rows % len(devs):
        raise ValueError(
            f"index rows ({n_rows}) must divide the mesh ({len(devs)} "
            f"devices) to row-shard; pad the stream to a multiple of "
            f"{len(devs)}")
    n_local = n_rows // len(devs)
    return [(d, i * n_local, (i + 1) * n_local) for i, d in enumerate(devs)]


def place_rows(x: torch.Tensor, shardings: Sequence[RowShard]
               ) -> List[torch.Tensor]:
    """Each shard's rows of ``x`` on its device (a view where the device
    is ``x``'s own)."""
    return [x[lo:hi].to(dev) for dev, lo, hi in shardings]


def encoder_on(encoder, device: torch.device):
    """``encoder`` itself on its own device, else a copy of its state on
    ``device``."""
    if encoder.device == device:
        return encoder
    return type(encoder)(encoder.spec).load_state(
        {k: v.to(device) for k, v in encoder._require_state().items()})


_FORM = inspect.Signature([inspect.Parameter(
    n, inspect.Parameter.POSITIONAL_OR_KEYWORD) for n in ("encoder", "mesh")])
_LEGACY_FORM = inspect.Signature([inspect.Parameter(
    n, inspect.Parameter.POSITIONAL_OR_KEYWORD)
    for n in ("filters", "cws", "params", "mesh")])


def build_sharded(series: torch.Tensor, *args, encoder=None,
                  mesh: Optional[Mesh] = None, filters=None, cws=None,
                  params: Optional[SSHParams] = None) -> List[torch.Tensor]:
    """series (N, m) -> each row shard's (N / shards, K) signatures on its
    device, encoded there (no communication).

    Two call forms: ``build_sharded(series, encoder, mesh)``, and the
    reference's ``build_sharded(series, filters, cws, params, mesh)``
    (``repro/distributed/dist_index.py:52-62``), whose filter bank,
    ``cws`` (a dict of the ``CWSParams`` fields, or a ``CWSParams``) and
    ``SSHParams`` make the ``"ssh"`` encoder that ``SSHFunctions`` holds
    (``core.index.encoder_of``, no copy), so both give the same
    signatures.  Either takes its arguments by position or by name.
    """
    given = {k: v for k, v in dict(encoder=encoder, mesh=mesh,
                                   filters=filters, cws=cws,
                                   params=params).items() if v is not None}
    legacy = len(args) > 2 or bool({"filters", "cws", "params"} & set(given))
    form = _LEGACY_FORM if legacy else _FORM
    bound = form.bind(*args, **given).arguments
    if legacy:
        cws = bound["cws"]
        if not isinstance(cws, minhash.CWSParams):
            cws = minhash.CWSParams(**cws)
        encoder = encoder_of(SSHFunctions(params=bound["params"],
                                          filters=bound["filters"],
                                          cws=cws))
    else:
        encoder = bound["encoder"]
    mesh = bound["mesh"]
    shards = index_shardings(mesh, int(series.shape[0]))
    return [encoder_on(encoder, dev).encode_chunked(rows)
            for (dev, _, _), rows in zip(shards, place_rows(series, shards))]


def local_query(sig: torch.Tensor, q: torch.Tensor, series: torch.Tensor,
                sigs: torch.Tensor, *, local_c: int, topk: int,
                band: int, abandon: bool, seed_always: bool
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One shard's probe (``repro/distributed/dist_index.py:82-110``,
    ``repro/fleet/worker.py:66-102``): (local candidate ids int64, their
    banded squared DTW), both on the shard's device, in candidate order.

    The count goes through ``ops.collision_count`` over the raw
    signatures, looked up on the module at call time; the top-``c``
    (c = min(local_c, rows)) takes ties to the lowest local id, as
    ``lax.top_k``.  With ``abandon`` the threshold is the topk-th best
    DTW over the first topk candidates: a lane over it cannot reach the
    global top-k (the global k-th best is at most every shard's k-th) and
    comes back BIG.  The distributed path seeds whenever it can
    (``seed_always``), the fleet only when c > topk, as each reference
    does.
    """
    c = min(local_c, int(sigs.shape[0]))
    coll = ops.collision_count(sig, sigs)
    cand = top_c_by_count(coll[None], c, max_count=int(sig.shape[-1]))[0][0]
    cand_series = series.index_select(0, cand)
    thr = None
    if abandon and (c > topk or (seed_always and c == topk)):
        seed = ops.dtw_rerank(q, cand_series[:topk], band)
        thr = torch.sort(seed).values[topk - 1]
    return cand, ops.dtw_rerank(q, cand_series, band, threshold=thr)


def merge_topk(ids: torch.Tensor, dists: torch.Tensor, topk: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The global top-k of the shards' lists concatenated in shard order:
    a stable ascending sort of the distances, so ties go to the earlier
    shard and the earlier lane."""
    order = torch.sort(dists, stable=True).indices[:min(topk,
                                                        dists.shape[0])]
    return ids[order], dists[order]


def _make_query_core(encode: Callable[[torch.Tensor], torch.Tensor],
                     mesh: Mesh, config: SearchConfig):
    """The one shard-local query schedule over a mesh, parameterised by
    ``encode(q) -> (K,)``: returns ``query(series_shards, sig_shards, q)
    -> (ids, dists)`` on the first mesh device.  Each shard launches on
    its own device; nothing waits for the device until the caller reads
    the answer."""
    if config.band is None:
        raise ValueError("the sharded query fn requires a band radius "
                         "(config.band is None)")
    devs = as_mesh(mesh)
    top_c, band, topk = config.top_c, config.band, config.topk
    abandon = config.use_lb_cascade and config.early_abandon
    local_c = max(topk, top_c // len(devs))

    def query(series_shards, sig_shards, q):
        sig = encode(q)
        ids, dists = [], []
        base = 0
        for dev, series, sigs in zip(devs, series_shards, sig_shards):
            with ops.device_scope(dev):
                cand, d = local_query(
                    sig.to(dev), q.to(dev), series, sigs, local_c=local_c,
                    topk=topk, band=band, abandon=abandon, seed_always=True)
                ids.append((cand + base).to(devs[0]))
                dists.append(d.to(devs[0]))
            base += int(series.shape[0])
        return merge_topk(torch.cat(ids), torch.cat(dists), topk)

    return query


def make_query_fn(params, mesh: Mesh, *, length: Optional[int] = None,
                  config: Optional[SearchConfig] = None,
                  top_c: Optional[int] = None, band: Optional[int] = None,
                  topk: Optional[int] = None,
                  backend: Optional[str] = None):
    """``query(series_shards, sig_shards, filters, cws, q) -> (ids,
    dists)`` for the ``"ssh"`` encoder of ``params`` (the reference's
    ``SSHParams``, lowered by ``to_spec``, or an ``IndexSpec``), whose filter
    bank and CWS fields stay call-time operands (the reference's
    historical signature; ``cws`` maps the ``CWSParams`` field names to
    tensors).  ``length`` is accepted for the reference's signature; the
    state's shapes do not depend on it.  The loose ``top_c``, ``band``,
    ``topk`` and ``backend`` kwargs still work for one release in place
    of ``config`` (``repro/distributed/dist_index.py:117-147``).  The
    schedule is :func:`_make_query_core`.
    """
    spec = params.to_spec() if isinstance(params, SSHParams) else params
    loose = dict(top_c=top_c, band=band, topk=topk, backend=backend)
    if config is None:
        config = config_from_legacy_kwargs(
            "make_query_fn", {k: v for k, v in loose.items()
                              if v is not None})
    elif any(v is not None for v in loose.values()):
        raise TypeError("make_query_fn() takes either config= or legacy "
                        "top_c/band/topk/backend kwargs, not both")
    if config.band is None:
        raise ValueError("make_query_fn requires a band radius "
                         "(config.band is None)")
    cls = encoder_class(spec.encoder)

    def query(series_shards, sig_shards, filters, cws, q):
        enc = cls(spec).load_state(
            {"filters": filters, **{f"cws/{k}": v for k, v in cws.items()}})
        core = _make_query_core(
            lambda x: enc.encode_batch(x.to(enc.device)[None])[0], mesh,
            config)
        return core(series_shards, sig_shards, q)

    return query


def make_encoder_query_fn(encoder, mesh: Mesh, *, config: SearchConfig):
    """The facade's form: ``query(series_shards, sig_shards, q) -> (ids,
    dists)`` encoding through ``encoder`` (any registered encoder) on its
    own device."""
    return _make_query_core(
        lambda q: encoder.encode_batch(q.to(encoder.device)[None])[0], mesh,
        config)

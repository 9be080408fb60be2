"""Numpy arrays in, the port's tensors out: the one path from host
arrays to an encoder and an index.

It serves two callers.  ``jax.random`` cannot be reproduced in torch, so
holding the port against the reference on the same index needs the
reference's random state and derived arrays carried across; and
``db.persistence`` loads a saved directory, written by either package,
through the same functions:

* :func:`encoder_state_from_arrays` takes the dict that an encoder's
  ``arrays()`` returns in either package: ``filters`` and ``cws/{log_r,
  r, log_c, beta}`` for ``"ssh"`` and ``"ssh-multires"`` (the CWS fields
  at the encoder's shingle dimension); for ``"ssh-cs"`` also the uint32
  hash coefficients ``cs/{bucket_a, bucket_b, sign_a, sign_b}``, held as
  int64 of the same values, and the aggregate ``cs/agg``; ``planes``
  (m, K) for ``"srp"``;
* :func:`encoder_from_arrays` adopts such a state;
* :func:`ssh_functions_from_arrays` makes the paper's ``SSHFunctions``
  from the seven hyper-parameters, the filter bank and the CWS fields;
* :func:`index_from_arrays` adds the index arrays (``signatures``,
  ``keys``, ``series`` and, when cached, the envelopes);
* :func:`lm_params_from_arrays` takes an LM's parameter pytree
  (``repro.models.transformer.init_params``) as numpy arrays;
* :func:`params_from_arrays` takes any other model's parameter tree
  (recsys, NequIP: nested dicts and lists) as numpy arrays.

Nothing here imports the reference: its arrays arrive as numpy.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

import numpy as np
import torch

from repro_torch.core.index import SSHFunctions, SSHIndex, SSHParams
from repro_torch.encoders import IndexSpec, encoder_class
from repro_torch.kernels import ops
from repro_torch.models import transformer


def _leaf_tensor(a, dev) -> torch.Tensor:
    a = np.asarray(a)
    dtype = np.int64 if np.issubdtype(a.dtype, np.integer) else np.float32
    return torch.tensor(a.astype(dtype), device=dev)


def encoder_state_from_arrays(arrays: Mapping[str, np.ndarray],
                              device=None, *,
                              spec: Optional[IndexSpec] = None) -> dict:
    """Encoder state dict on ``device`` (CUDA unless the caller asks for
    the CPU): float leaves as float32, integer leaves (the ``"ssh-cs"``
    hash coefficients) as int64.  Refuses a leaf set other than that of
    ``spec``'s encoder (the ``"ssh"`` encoder's when no spec is given);
    shapes are checked against the spec by ``load_state``."""
    spec = spec if spec is not None else IndexSpec()
    enc = encoder_class(spec.encoder)(spec)
    enc._check_leaves(arrays, enc.expected_shapes())
    dev = ops.resolve_device(device)
    return {k: _leaf_tensor(v, dev) for k, v in arrays.items()}


def encoder_from_arrays(spec: IndexSpec,
                        arrays: Mapping[str, np.ndarray], device=None):
    """The encoder of ``spec`` holding the state ``arrays`` on
    ``device``; refuses leaves or shapes the spec does not imply."""
    return encoder_class(spec.encoder)(spec).load_arrays(arrays, device)


def ssh_functions_from_arrays(params, filters: np.ndarray,
                              cws_fields: Mapping[str, np.ndarray],
                              device=None) -> SSHFunctions:
    """``SSHFunctions`` on ``device`` (CUDA unless the caller asks for the
    CPU) from host arrays: ``params`` an ``SSHParams`` or any object with
    its seven fields (the reference's), ``filters`` (W, F), ``cws_fields``
    the ``CWSParams`` field names to (K, F·2^n) arrays.  Shapes are
    checked against ``params``."""
    if not isinstance(params, SSHParams):
        params = SSHParams(**{f.name: int(getattr(params, f.name))
                              for f in dataclasses.fields(SSHParams)})
    arrays = {"filters": filters,
              **{f"cws/{k}": v for k, v in cws_fields.items()}}
    return encoder_from_arrays(params.to_spec(), arrays,
                               device).legacy_functions()


def _tensor(a, dtype, dev) -> torch.Tensor:
    """A copy of host array ``a`` as ``dtype`` on ``dev``, with one
    transfer (no staging copy on the host)."""
    a = np.asarray(a)
    if not a.flags.writeable:        # torch.from_numpy needs a writable one
        a = a.copy()
    return torch.from_numpy(a).to(dev, dtype, copy=True)


def index_from_arrays(spec: IndexSpec, encoder_arrays: Mapping[str,
                                                              np.ndarray],
                      signatures: np.ndarray, keys: np.ndarray,
                      series: np.ndarray, *,
                      env_upper: Optional[np.ndarray] = None,
                      env_lower: Optional[np.ndarray] = None,
                      env_radius: Optional[int] = None,
                      build_backend: str = "cpu",
                      device=None) -> SSHIndex:
    """An ``SSHIndex`` on ``device`` from host arrays.

    ``keys`` may be the reference's uint32 band keys: they are stored as
    the same 32-bit pattern in int32 (``repro/serving/batched.py:142-144``
    casts them so).  ``build_backend`` records what encoded the
    signatures.
    """
    dev = ops.resolve_device(device)
    enc = encoder_from_arrays(spec, encoder_arrays, dev)
    keys = np.asarray(keys)
    if keys.dtype == np.uint32:
        keys = keys.view(np.int32)
    sigs = _tensor(signatures, torch.int32, dev)
    if tuple(sigs.shape[1:]) != (enc.num_hashes,):
        raise ValueError(f"signatures have shape {tuple(sigs.shape)}, the "
                         f"spec implies K={enc.num_hashes}")
    idx = SSHIndex(encoder=enc, signatures=sigs,
                   keys=_tensor(keys, torch.int32, dev),
                   series=_tensor(series, torch.float32, dev),
                   build_backend=build_backend)
    if tuple(idx.keys.shape) != (sigs.shape[0], enc.num_tables):
        raise ValueError(f"band keys have shape {tuple(idx.keys.shape)}, "
                         f"the spec implies L={enc.num_tables} for "
                         f"{sigs.shape[0]} rows")
    if env_upper is not None:
        idx.env_upper = _tensor(env_upper, torch.float32, dev)
        idx.env_lower = _tensor(env_lower, torch.float32, dev)
        idx.env_radius = env_radius
    return idx


def _lm_leaf(a, dev) -> torch.Tensor:
    """float32 as it is; ``ml_dtypes.bfloat16`` through float32 to
    ``torch.bfloat16`` (exact both ways)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.tensor(a.astype(np.float32), device=dev).to(
            torch.bfloat16)
    if a.dtype != np.float32:
        raise TypeError(f"parameters are float32 or bfloat16, got "
                        f"{a.dtype}")
    return torch.tensor(a, device=dev)


def lm_params_from_arrays(arrays: Mapping, cfg, device=None) -> dict:
    """The port's LM parameter dict on ``device`` (CUDA unless the caller
    asks for the CPU) from the reference's parameter pytree with numpy
    leaves (``{"embed", "head", "ln_f", "layers": {...}}``), dense, MoE
    or MLA.  The layouts are the same; names and shapes are checked
    against ``cfg`` (a ``repro_torch`` ``LMConfig``), and each leaf's
    dtype against ``transformer.param_dtype`` (the float32 MoE router
    beside bf16 weights)."""
    dev = ops.resolve_device(device)
    shapes = transformer.param_shapes(cfg)
    flat = transformer.flatten(arrays)
    if set(flat) != set(shapes):
        raise ValueError(f"LM arrays: missing {sorted(set(shapes) - set(flat))}"
                         f", unknown {sorted(set(flat) - set(shapes))}")
    out = {}
    for path, shape in shapes.items():
        t = _lm_leaf(flat[path], dev)
        dt = transformer.param_dtype(cfg, path)
        if tuple(t.shape) != shape or t.dtype != dt:
            raise ValueError(f"LM array {path}: {tuple(t.shape)} {t.dtype}, "
                             f"the config implies {shape} {dt}")
        out[path] = t
    return transformer.unflatten(out)


def params_from_arrays(arrays, device=None):
    """A parameter tree of nested dicts and lists (the recsys models'
    ``[{"w", "b"}, ...]`` MLPs and BST blocks, NequIP's stacked layers
    with ``self_mix`` keyed by ``str(l)``) with numpy leaves, as tensors
    on ``device`` (CUDA unless the caller asks for the CPU) in the same
    structure: float32 as it is, ``ml_dtypes.bfloat16`` as
    ``torch.bfloat16``; any other dtype is refused."""
    dev = ops.resolve_device(device)

    def walk(tree):
        if isinstance(tree, Mapping):
            return {k: walk(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [walk(v) for v in tree]
        return _lm_leaf(tree, dev)
    return walk(arrays)

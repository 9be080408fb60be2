"""Fault-tolerant checkpoints: npz shards plus a JSON manifest
(counterpart of ``repro.checkpoint.checkpointer``, same on-disk format).

A checkpoint of step s is the directory ``step_%010d``:

* ``shard_<k>.npz`` for k < ``n_shards``: every array whose first axis
  divides by ``n_shards`` (when there is more than one shard) is split
  along it, one piece a shard; every other array lives whole in shard 0;
* ``manifest.json``: the step, the shard count and, per array key, its
  global shape, dtype and split axis (``null`` when whole).

It is written to a temporary directory and published with ``os.replace``,
so a crashed writer never leaves a half-written step behind; the newest
``keep`` steps are kept.  Trees are nested dicts (keys taken in sorted
order, as jax flattens dicts), NamedTuples, lists and tuples of arrays;
an array's key is its path joined by ``/``, a NamedTuple's field named
``.<field>`` as jax's ``GetAttrKey`` prints it (``"a/b"``, ``"layers/0"``,
``"opt/.m/embed"``).  Leaves may be numpy arrays, CPU or CUDA tensors, or
Python numbers; a restore returns numpy arrays in the structure of
``tree_like``.

bfloat16 is stored as the reference stores it: numpy has no bfloat16, so
``np.savez`` writes the 2-byte void type ``|V2`` and the manifest says
``"bfloat16"``.  The port writes a bf16 tensor through a ``uint16`` view
(no ``ml_dtypes`` needed) and restores such an array, by the manifest's
dtype, as a ``torch.bfloat16`` CPU tensor, bit for bit.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

Tree = Any


BF16 = "bfloat16"


def _host(leaf) -> Tuple[np.ndarray, str]:
    """(the leaf as a numpy array, the dtype name the manifest records);
    a bf16 tensor becomes its bits as ``|V2``."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.uint16).numpy().view(np.dtype("V2")), BF16
        return t.numpy(), str(t.numpy().dtype)
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _snapshot(leaf):
    """A host copy of ``leaf`` that later in-place updates of it do not
    reach (a tensor stays a tensor, so bf16 keeps its type)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return np.array(leaf, copy=True)


def _from_disk(arr: np.ndarray, dtype: str):
    """An array read back, by its manifest dtype: ``|V2`` bfloat16 as a
    ``torch.bfloat16`` tensor, the rest as numpy arrays."""
    if dtype == BF16:
        return torch.from_numpy(
            np.ascontiguousarray(arr).view(np.uint16)).view(torch.bfloat16)
    return arr


def _is_namedtuple(tree) -> bool:
    return isinstance(tree, tuple) and hasattr(tree, "_fields")


def _flatten_with_paths(tree: Tree, prefix: str = ""
                        ) -> List[Tuple[str, Any]]:
    """(key, leaf) pairs in jax's order: dict keys sorted, NamedTuple
    fields in order as ``.<field>``, sequences by index; ``None`` holds no
    leaf."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif _is_namedtuple(tree):
        items = [(f".{f}", getattr(tree, f)) for f in tree._fields]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return [(prefix, tree)]
    out = []
    for k, v in items:
        out.extend(_flatten_with_paths(v, f"{prefix}/{k}" if prefix else k))
    return out


def _unflatten(tree_like: Tree, leaves: Dict[str, Any], prefix: str = ""
               ) -> Tree:
    if tree_like is None:
        return None
    if isinstance(tree_like, dict):
        return {k: _unflatten(v, leaves, f"{prefix}/{k}" if prefix
                              else str(k))
                for k, v in tree_like.items()}
    if _is_namedtuple(tree_like):
        return type(tree_like)._make(
            _unflatten(getattr(tree_like, f), leaves,
                       f"{prefix}/.{f}" if prefix else f".{f}")
            for f in tree_like._fields)
    if isinstance(tree_like, (list, tuple)):
        return type(tree_like)(
            _unflatten(v, leaves, f"{prefix}/{i}" if prefix else str(i))
            for i, v in enumerate(tree_like))
    return leaves[prefix]


def save_checkpoint(directory: str | Path, step: int, tree: Tree,
                    keep: int = 3, n_shards: int = 1) -> Path:
    """Write checkpoint ``step`` atomically; returns its final path."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    tmp = directory / f".tmp_step_{step}_{os.getpid()}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()

    manifest: Dict[str, Any] = {"step": step, "time": time.time(),
                                "n_shards": n_shards, "arrays": {}}
    shards: List[Dict[str, np.ndarray]] = [{} for _ in range(n_shards)]
    for key, leaf in _flatten_with_paths(tree):
        arr, dtype = _host(leaf)
        ax = (0 if arr.ndim and arr.shape[0] % n_shards == 0
              and n_shards > 1 else None)
        manifest["arrays"][key] = {"shape": list(arr.shape),
                                   "dtype": dtype,
                                   "shard_axis": ax}
        if ax is None:
            shards[0][key] = arr
        else:
            for k, piece in enumerate(np.split(arr, n_shards, axis=ax)):
                shards[k][key] = piece
    for k, shard in enumerate(shards):
        np.savez(tmp / f"shard_{k}.npz", **shard)
    (tmp / "manifest.json").write_text(json.dumps(manifest))

    final = directory / f"step_{step:010d}"
    if final.exists():
        shutil.rmtree(final)
    os.replace(tmp, final)                       # atomic publish

    for old in all_steps(directory)[:-keep]:
        shutil.rmtree(directory / f"step_{old:010d}", ignore_errors=True)
    return final


def all_steps(directory: str | Path) -> List[int]:
    """Published steps under ``directory``, ascending."""
    directory = Path(directory)
    if not directory.exists():
        return []
    return sorted(int(p.name.split("_")[1]) for p in directory.iterdir()
                  if p.name.startswith("step_")
                  and (p / "manifest.json").exists())


def latest_step(directory: str | Path) -> Optional[int]:
    steps = all_steps(directory)
    return steps[-1] if steps else None


def restore_checkpoint(directory: str | Path, tree_like: Tree,
                       step: Optional[int] = None,
                       shardings: Optional[Tree] = None) -> Tuple[int, Tree]:
    """Restore step ``step`` (the latest when None) into the structure of
    ``tree_like``, whose leaves give the expected shapes (arrays or
    tensors); returns ``(step, tree of numpy arrays)``, bfloat16 arrays
    as ``torch.bfloat16`` tensors.  ``shardings``, a tree of the same
    paths, places each leaf it names (a ``torch.device``, a device name,
    or a ``distributed.sharding.Sharding`` of a one-device mesh) as a
    tensor on that device (``checkpointer.py:105-140``); a leaf it omits
    or gives None comes back as a host array."""
    directory = Path(directory)
    step = step if step is not None else latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoints in {directory}")
    cdir = directory / f"step_{step:010d}"
    manifest = json.loads((cdir / "manifest.json").read_text())
    shards = [np.load(cdir / f"shard_{k}.npz")
              for k in range(manifest["n_shards"])]
    try:
        arrays: Dict[str, np.ndarray] = {}
        for key, info in manifest["arrays"].items():
            if info["shard_axis"] is None:
                arr = shards[0][key]
            else:
                arr = np.concatenate(
                    [s[key] for s in shards], axis=info["shard_axis"])
            arrays[key] = _from_disk(arr, info["dtype"])
    finally:
        for s in shards:
            s.close()

    for key, like in _flatten_with_paths(tree_like):
        if key not in arrays:
            raise KeyError(f"checkpoint missing array {key!r}")
        want = tuple(like.shape)
        if tuple(arrays[key].shape) != want:
            raise ValueError(f"{key}: checkpoint shape "
                             f"{arrays[key].shape} != expected {want}")
    if shardings is not None:
        for key, where in _flatten_with_paths(shardings):
            if where is not None and key in arrays:
                arrays[key] = torch.as_tensor(arrays[key]).to(
                    torch.device(getattr(where, "device", where)))
    return step, _unflatten(tree_like, arrays)


class Checkpointer:
    """Checkpoint manager with restart discovery and an optional
    background writer (``async_save``)."""

    def __init__(self, directory: str | Path, keep: int = 3,
                 async_save: bool = False, n_shards: int = 1):
        self.directory = Path(directory)
        self.keep = keep
        self.async_save = async_save
        self.n_shards = n_shards
        self._pending: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None

    def save(self, step: int, tree: Tree) -> None:
        """Snapshot ``tree`` to the host now and write it (in a thread
        with ``async_save``; the previous write is waited for first)."""
        self.wait()
        if not self.async_save:
            save_checkpoint(self.directory, step, tree, self.keep,
                            self.n_shards)
            return
        # the writer must not see later in-place updates of the caller's
        # arrays: copy every leaf to the host now
        host = _unflatten(tree, {k: _snapshot(v)
                                 for k, v in _flatten_with_paths(tree)})

        def write():
            try:
                save_checkpoint(self.directory, step, host, self.keep,
                                self.n_shards)
            except Exception as exc:         # re-raised by wait()
                self._error = exc
        self._pending = threading.Thread(target=write, daemon=True)
        self._pending.start()

    def wait(self) -> None:
        """Block until the pending write is on disk; re-raise its error."""
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def restore_latest(self, tree_like: Tree,
                       shardings: Optional[Tree] = None
                       ) -> Tuple[Optional[int], Tree]:
        """``(step, tree)`` of the newest checkpoint, or ``(None,
        tree_like)`` when there is none; ``shardings`` places leaves as
        :func:`restore_checkpoint` places them."""
        if latest_step(self.directory) is None:
            return None, tree_like
        return restore_checkpoint(self.directory, tree_like,
                                  shardings=shardings)

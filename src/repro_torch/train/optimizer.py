"""AdamW with mixed-precision state (counterpart of
``repro.train.optimizer``; no torch.optim).

State: float32 first and second moments and float32 master weights,
whatever the parameters' type (bf16 in production), in trees that mirror
the parameter tree (nested dicts and lists), and the step count, a 0-d
int32 CPU tensor: the schedule is computed on the host without waiting for the
card.  ``update`` follows the reference's arithmetic: float32 gradients,
a global-norm clip over every leaf, the warm-up at the new step, bias
correction, weight decay decoupled on the master, parameters re-cast to
their own type.  It works leaf by leaf, in place, under
``torch.no_grad()``, in slices of at most ``CHUNK`` elements, so that a
float32 copy of one slice of one gradient exists at a time and never a
float32 copy of every gradient.  The operations are elementwise, so the
slicing changes nothing but the grad-norm's summation order.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

Tree = Any
#: elements of one slice of a leaf in ``update`` and the grad norm
CHUNK = 1 << 25


def tree_leaves(tree: Tree) -> List[Any]:
    """Leaves of nested dicts and lists, dict keys in sorted order and
    lists by index (as jax flattens)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, list):
        return [leaf for item in tree for leaf in tree_leaves(item)]
    return [tree]


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """``fn`` over the leaves of nested dicts and lists of one
    structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, list):
        return [tree_map(fn, item, *(r[i] for r in rest))
                for i, item in enumerate(tree)]
    return fn(tree, *rest)


def _slices(*tensors: torch.Tensor):
    """Matching flat slices of at most ``CHUNK`` elements of tensors of
    one shape (views of contiguous tensors, which the in-place updates
    need; a gradient laid out otherwise is copied)."""
    flats = [t.reshape(-1) for t in tensors]
    n = flats[0].numel()
    for i in range(0, n, CHUNK):
        yield tuple(f[i:i + CHUNK] for f in flats)


class AdamWState(NamedTuple):
    step: torch.Tensor   # () int32, on the CPU
    m: Any
    v: Any
    master: Any          # float32 params


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: float = 1e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: Optional[float] = 1.0
    warmup_steps: int = 100

    def init(self, params: Tree) -> AdamWState:
        """Zero moments and a float32 master copy, each on its
        parameter's device."""
        def zeros(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return AdamWState(
            step=torch.zeros((), dtype=torch.int32),
            m=tree_map(zeros, params), v=tree_map(zeros, params),
            master=tree_map(lambda p: p.detach().to(torch.float32,
                                                     copy=True), params))

    def schedule(self, step: int) -> float:
        """The learning rate at ``step``, in float32 as the reference's
        (``lr * min(1, (step + 1) / warmup)``)."""
        warm = min(np.float32(1.0), np.float32(step + 1)
                   / np.float32(max(self.warmup_steps, 1)))
        return float(np.float32(self.lr) * warm)

    def grad_norm(self, grads: Tree) -> torch.Tensor:
        """sqrt(sum of every float32 gradient's squares + 1e-20), a 0-d
        float32 tensor on the gradients' device."""
        total = None
        for g in tree_leaves(grads):
            for (piece,) in _slices(g.detach()):
                sq = piece.float().square().sum()
                total = sq if total is None else total + sq
        return torch.sqrt(total + 1e-20)

    @torch.no_grad()
    def update(self, params: Tree, state: AdamWState, grads: Tree
               ) -> Tuple[Tree, AdamWState, Dict[str, Any]]:
        """One step, in place: ``params``, ``state.m``, ``state.v`` and
        ``state.master`` are updated and returned with the new step and
        the metrics {"grad_norm": 0-d device tensor, "lr": float}."""
        gnorm = self.grad_norm(grads)
        scale = (torch.clamp(self.grad_clip / gnorm, max=1.0)
                 if self.grad_clip is not None else None)
        step = int(state.step) + 1
        lr = self.schedule(step)
        b1c = float(np.float32(1.0) - np.float32(self.b1) ** np.float32(step))
        b2c = float(np.float32(1.0) - np.float32(self.b2) ** np.float32(step))
        leaves = zip(tree_leaves(params), tree_leaves(grads),
                     tree_leaves(state.m), tree_leaves(state.v),
                     tree_leaves(state.master))
        for p, g, m, v, master in leaves:
            p_flat = p.detach()
            for ps, gs, ms, vs, mp in _slices(p_flat, g, m, v, master):
                g32 = gs.float()
                if scale is not None:
                    g32 = g32 * scale
                ms.mul_(self.b1).add_(g32, alpha=1 - self.b1)
                vs.mul_(self.b2).add_(g32 * g32, alpha=1 - self.b2)
                denom = (vs / b2c).sqrt_().add_(self.eps)
                upd = (ms / b1c).div_(denom).add_(mp,
                                                  alpha=self.weight_decay)
                mp.sub_(upd.mul_(lr))
                ps.copy_(mp)
        new_state = AdamWState(torch.tensor(step, dtype=torch.int32),
                               state.m, state.v, state.master)
        return params, new_state, {"grad_norm": gnorm, "lr": lr}

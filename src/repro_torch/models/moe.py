"""GShard-style capacity-based Mixture-of-Experts (counterpart of
``repro.models.moe``).

The semantics are the reference's, assignment for assignment: tokens
viewed as G groups of n_g = min(group_size, n); router logits and
softmax gates in float32; the top-k experts of each token (the lowest
index first on ties, as ``lax.top_k``), their gates renormalised; each
(token, choice) placed in its expert's queue of the group in
token-major, choice-minor order and dropped when its place is at or past
the capacity C = max(int(n_g k cf / E), k); the GShard auxiliary loss;
and the ragged tail, the tokens past G n_g, through expert 0 alone with
weight 1.

The dispatch differs in form only.  The reference builds one-hot
(G, N, E, C) dispatch and combine tensors for GSPMD's sake
(``repro/models/moe.py:1-10``); here :func:`gating` returns each
assignment's expert, queue position, keep flag and weight, the kept
tokens are gathered into an (E, G C, d) buffer whose empty slots are
zero (and one more slot an expert for the dropped assignments, never
combined), the three expert products run as batched ``torch.matmul``
(the reference leaves them to XLA), and the outputs are gathered back
and summed over the k choices with the gate weights.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """The reference's ``MoEConfig``, field for field."""
    n_experts: int
    top_k: int
    d_model: int
    d_ff: int                      # per-expert hidden
    n_shared: int = 0              # shared (always-on) experts
    capacity_factor: float = 1.25
    group_size: int = 2048         # tokens per dispatch group


def capacity(cfg: MoEConfig, n_g: int) -> int:
    c = int(n_g * cfg.top_k * cfg.capacity_factor / cfg.n_experts)
    return max(c, cfg.top_k)


class Routing(NamedTuple):
    """Each (group, token, choice)'s assignment, all (G, N_g, k)."""
    expert: torch.Tensor     # int64, the chosen expert
    position: torch.Tensor   # int64, its place in the expert's queue
    keep: torch.Tensor       # bool, position < capacity
    weight: torch.Tensor     # float32, the renormalised gate


def top_k_lowest_first(x: torch.Tensor, k: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest entries of the last axis and their indices, the
    lower index first among equal values (``lax.top_k``'s order, which
    ``torch.topk`` does not promise): a stable descending sort."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def gating(logits: torch.Tensor, cfg: MoEConfig, n_g: int
           ) -> Tuple[Routing, torch.Tensor]:
    """Top-k gating with per-group capacity (GShard §3.2).

    logits (G, N_g, E) -> (routing, aux_loss scalar float32).  The
    reference's dispatch[g, n, e, c] is keep & (expert == e) &
    (position == c) over the k choices, its combine the same times
    weight.
    """
    e, k = cfg.n_experts, cfg.top_k
    c = capacity(cfg, n_g)
    gates = torch.softmax(logits.float(), dim=-1)
    topv, expert = top_k_lowest_first(gates, k)               # (G, N, k)
    topv = topv / topv.sum(-1, keepdim=True).clamp_min(1e-9)
    # position of each (token, choice) in its expert's queue: earlier
    # assignments to the same expert, token-major then choice-minor
    g_, n_ = expert.shape[:2]
    onehot = F.one_hot(expert.reshape(g_, n_ * k), e)         # (G, N k, E)
    position = (onehot.cumsum(1).gather(
        2, expert.reshape(g_, n_ * k, 1)) - 1).reshape(expert.shape)
    keep = position < c
    # load-balance auxiliary loss (GShard eq. 4 / Switch §2.2): the share
    # of the group's tokens choosing each expert (every choice, kept or
    # not) against the mean gate
    density = onehot.sum(1).float() / n_                      # (G, E)
    density_proxy = gates.mean(1)                             # (G, E)
    aux = (density * density_proxy).mean() * (e * e)
    return Routing(expert, position, keep, topv), aux


def _expert_ffn(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
                w_down: torch.Tensor) -> torch.Tensor:
    """SwiGLU of each expert on its rows: x (E, R, d) -> (E, R, d)."""
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def moe_ffn(x: torch.Tensor, router_w: torch.Tensor, w_gate: torch.Tensor,
            w_up: torch.Tensor, w_down: torch.Tensor, cfg: MoEConfig
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Routed expert SwiGLU FFN.

    x (B, S, d); router_w (d, E) float32; experts w_gate/w_up (E, d, ff),
    w_down (E, ff, d).  Returns (out (B, S, d) in x's type, aux_loss).
    The router product runs in float32 (the reference's einsum promotes
    bf16 tokens against the float32 router); the gate weights are cast to
    x's type before they scale the expert outputs, as the reference casts
    its combine tensor, and the k weighted outputs are summed in float32.
    """
    b, s, d = x.shape
    tokens = x.reshape(-1, d)
    n = tokens.shape[0]
    n_g = min(cfg.group_size, n)
    g = n // n_g
    xt = tokens[: g * n_g].reshape(g, n_g, d)
    routing, aux = gating(xt.float() @ router_w.float(), cfg, n_g)

    # dispatch: every kept (token, choice) to its slot (expert, group,
    # position) of the buffer, every dropped one to a last slot of its
    # expert that is never combined (no boolean indexing, so no wait for
    # the card); slots nobody fills stay zero
    c = capacity(cfg, n_g)
    k = cfg.top_k
    grp = torch.arange(g, device=x.device)[:, None, None]
    slot = torch.where(routing.keep, grp * c + routing.position, g * c)
    xe = x.new_zeros((cfg.n_experts, g * c + 1, d))
    xe[routing.expert, slot] = xt[:, :, None, :].expand(-1, -1, k, -1)
    ye = _expert_ffn(xe, w_gate, w_up, w_down)             # (E, G C + 1, d)

    # combine: each choice's expert output at its slot, times its weight
    # (0 where dropped), summed over the k choices
    w = torch.where(routing.keep, routing.weight, 0.0).to(x.dtype).float()
    y = (w[..., None] * ye[routing.expert, slot].float()).sum(2)
    out = y.to(x.dtype).reshape(g * n_g, d)
    if g * n_g < n:   # ragged tail, past the last whole group: expert 0
        tail = tokens[g * n_g:]
        out = torch.cat([out, _expert_ffn(tail, w_gate[0], w_up[0],
                                          w_down[0])], dim=0)
    return out.reshape(b, s, d), aux


def moe_dispatch_flops(cfg: MoEConfig, n_tokens: int) -> int:
    """MACs the reference spends on its dispatch/combine einsums
    (overhead accounting; the port's gathers do no MACs)."""
    n_g = min(cfg.group_size, n_tokens)
    g = max(1, n_tokens // n_g)
    c = capacity(cfg, n_g)
    return 2 * g * n_g * cfg.n_experts * c * cfg.d_model


def moe_expert_flops(cfg: MoEConfig, n_tokens: int) -> int:
    """MACs in the expert FFNs over every capacity slot, filled or not
    (the port's buffer products run over the same slots)."""
    n_g = min(cfg.group_size, n_tokens)
    g = max(1, n_tokens // n_g)
    c = capacity(cfg, n_g)
    return 3 * g * cfg.n_experts * c * cfg.d_model * cfg.d_ff

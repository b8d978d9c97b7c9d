"""Mixture-of-Experts FFN: token-choice top-k routing with capacity (port
of ``repro.models.moe``).

The routing function is the reference's, step for step: a float32
router, softmax, top-k with the reference's tie order (the lower expert
index first: a stable descending sort, since ``torch.topk`` promises no
order among equal values), gates renormalised, the Switch aux loss,
capacity ranks from the token-major one-hot cumsum with the trash slot
``e * cap``, a scatter-add dispatch, the expert products by
``torch.bmm`` over every expert's capacity buffer, and the gather
combine. A near-tie resolved differently would send a token elsewhere
and change the output by far more than rounding, so the order matters.

Side output: the (token -> expert) ids for the routing DegreeSketch
(``data.telemetry.RoutingSketch``, DESIGN.md §5). The reference routes
every token globally too: its per-data-shard ``shard_map`` dispatch is
described in its docstring but not shipped (XLA's backward refused it).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.layers import Dense, normal

__all__ = ["MoE", "moe_ffn"]


class MoE(nn.Module):
    """The float32 router and the stacked expert matrices ``gate``/``up``
    ``(E, D, F)`` and ``down`` ``(E, F, D)``."""

    def __init__(self, gen, cfg, dtype, device):
        super().__init__()
        d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.num_experts
        self.router = Dense(gen, d, e, torch.float32, device)
        self.gate = normal(gen, (e, d, f), d ** -0.5, dtype, device)
        self.up = normal(gen, (e, d, f), d ** -0.5, dtype, device)
        self.down = normal(gen, (e, f, d), f ** -0.5, dtype, device)


def _top_k(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k largest of each row in descending order, ties to the lower
    index first (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def _capacity_slots(flat_ids: torch.Tensor, e: int, cap: int):
    """Capacity ranks from the token-major one-hot cumsum: (rank of each
    assignment among those to its expert, keep = rank < cap, its slot
    ``expert * cap + rank`` or the trash slot ``e * cap``).

    The cumsum runs along the last dim of the transposed one-hot (E rows
    of T*k): on an H100 a scan down the first dim of the (T*k, E) tensor
    took 13 ms a call at 49,152 x 64, 45% of a full-width Moonlight
    prefill (``scripts/profile_lm_serve.py``).
    """
    oh = F.one_hot(flat_ids, e).t().contiguous()          # (E, T*k)
    rank = ((torch.cumsum(oh, dim=1) - oh) * oh).sum(dim=0)
    keep = rank < cap
    slot = torch.where(keep, flat_ids * cap + rank,
                       torch.full_like(flat_ids, e * cap))
    return rank, keep, slot


def _moe_tokens(p: MoE, xt: torch.Tensor, cfg):
    """Route a flat token block (T, D). Returns (y (T, D), aux, ids
    int32 (T, k))."""
    t, d = xt.shape
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    cap = max(int(t // e * k * cfg.capacity_factor) + 1, k)

    logits = xt.float() @ p.router.w                             # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_ids = _top_k(probs, k)                     # (T, k)
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)

    # load-balance aux loss (Switch eq. 4)
    assign_frac = F.one_hot(expert_ids[:, 0], e).float().mean(dim=0)
    prob_frac = probs.mean(dim=0)
    aux = e * torch.sum(assign_frac * prob_frac)

    flat_ids = expert_ids.reshape(t * k)
    _, keep, slot = _capacity_slots(flat_ids, e, cap)

    # dispatch: token j's k copies are slots [j*k, (j+1)*k)
    x_src = xt[:, None, :].expand(t, k, d).reshape(t * k, d)
    x_disp = torch.zeros((e * cap + 1, d), dtype=xt.dtype, device=xt.device)
    x_disp.index_add_(0, slot, torch.where(keep[:, None], x_src, 0))
    x_disp = x_disp[:-1].reshape(e, cap, d)

    h = torch.bmm(x_disp, p.gate)
    u = torch.bmm(x_disp, p.up)
    y_e = torch.bmm(F.silu(h) * u, p.down)

    # combine: gather + reshape-sum over the k slots of each token
    y_tok = y_e.reshape(e * cap, d)[torch.clamp(slot, max=e * cap - 1)]
    y_tok = torch.where(keep[:, None], y_tok, 0)
    y_tok = y_tok * gate_vals.reshape(t * k, 1).to(y_tok.dtype)
    return (y_tok.reshape(t, k, d).sum(dim=1), aux,
            expert_ids.to(torch.int32))


def moe_ffn(p: MoE, x: torch.Tensor, cfg):
    """x: (B, L, D) -> (y (B, L, D), aux_loss, expert_ids int32 (B*L, k))."""
    b, l, d = x.shape
    y, aux, ids = _moe_tokens(p, x.reshape(b * l, d), cfg)
    return y.reshape(b, l, d), aux, ids

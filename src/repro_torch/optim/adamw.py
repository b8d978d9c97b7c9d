"""AdamW with global-norm clipping; the moments' dtype per config (port of
``repro.optim.adamw``).

``params`` is the port's model (an ``nn.Module``: its parameters by name)
or a tree of tensors (dicts, lists and tuples). The state is ``{"m",
"v", "count"}``: ``m`` and ``v`` mirror the parameters (for a module, a
dict keyed by parameter name) in ``cfg.dtype`` (float32, or bfloat16 as
grok-1's ``adam_dtype`` asks), ``count`` an int32 scalar on the
parameters' device. ``models.convert`` carries the state to and from the
JAX package's tree (``train_state_to_tree``).

The math is the reference's, per leaf in float32 and in its order: the
clip scale, bias corrections ``1 - b^count`` in float32, the decoupled
weight decay added to the step, the cast back to the parameter's dtype.
Unlike the reference, :func:`adamw_update` writes the parameters, ``m``,
``v`` and ``count`` in place (under ``torch.no_grad()``) and returns
them: a second copy of the moments would not fit beside a full-width
model on one card. So a failure partway through is not safe to retry
in place: ``count`` is written last, and an error after the first leaf
is written surfaces as :class:`PartialUpdateError` (``state_written``
true), on which ``runtime.ft.train_loop`` restores its newest checkpoint
instead of retrying. The global norm sums the leaves in the port's order
(one leaf a layer, where the reference stacks each pattern position over
the periods), so the clip scale may differ from the reference's by an
ulp.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

__all__ = ["AdamWConfig", "adamw_init", "adamw_update"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class PartialUpdateError(RuntimeError):
    """:func:`adamw_update` failed after it wrote some of the state in
    place: the parameters and moments are neither the step's inputs nor
    its outputs. The cause is chained (``__cause__``)."""

    state_written = True


@dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    dtype: str = "float32"


def _tree(params):
    """A module's parameters by name; any other tree as it is."""
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return params


def _leaves(tree) -> list:
    """The tensors of ``tree`` in the JAX package's leaf order (dict keys
    sorted, sequences in order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for sub in tree for x in _leaves(sub)]
    return [] if tree is None else [tree]


def _map(fn, tree):
    """``tree``'s structure with ``fn`` applied to each tensor."""
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return None if tree is None else fn(tree)


def adamw_init(params, cfg: AdamWConfig) -> dict:
    """Zero moments mirroring ``params`` in ``cfg.dtype`` and a zero
    ``count``, on the parameters' device."""
    tree = _tree(params)
    dt = _DTYPES[cfg.dtype]
    device = _leaves(tree)[0].device
    zeros = lambda p: torch.zeros(p.shape, dtype=dt, device=device)
    return {"m": _map(zeros, tree), "v": _map(zeros, tree),
            "count": torch.zeros((), dtype=torch.int32, device=device)}


def _global_norm(leaves) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in leaves))


def adamw_update(params, grads, state: dict, lr, cfg: AdamWConfig):
    """One AdamW step: ``params``, ``state["m"]``, ``state["v"]`` and
    ``state["count"]`` updated in place. ``grads`` mirrors ``params``
    (for a module, a dict keyed by parameter name); ``lr`` is a float32
    scalar tensor. Returns ``(params, state, {"grad_norm"})``.

    An error before the first write leaves the state as it was and
    propagates as it is; one after it raises :class:`PartialUpdateError`
    (``count`` is written last, so it is then still the old count)."""
    pf = _leaves(_tree(params))
    gf = _leaves(grads)
    mf, vf = _leaves(state["m"]), _leaves(state["v"])
    if not len(pf) == len(gf) == len(mf) == len(vf):
        raise ValueError(f"{len(pf)} parameters, {len(gf)} gradients, "
                         f"{len(mf)} and {len(vf)} moments")
    with torch.no_grad():
        gnorm = _global_norm(gf)
        one = torch.ones((), dtype=torch.float32, device=gnorm.device)
        # tensor / tensor: a Python number over a tensor is a reciprocal
        # times the number in PyTorch, which rounds differently
        scale = torch.minimum(
            one, (one * cfg.clip_norm) / torch.clamp(gnorm, min=1e-9))
        count = state["count"].float() + 1
        c1 = 1.0 - torch.pow(one * cfg.b1, count)
        c2 = 1.0 - torch.pow(one * cfg.b2, count)
        written = False
        try:
            for p, g, m, v in zip(pf, gf, mf, vf):
                g32 = g.float() * scale
                m32 = m.float() * cfg.b1 + g32 * (1 - cfg.b1)
                v32 = v.float() * cfg.b2 + g32 * g32 * (1 - cfg.b2)
                del g32
                step = (m32 / c1).div_(torch.sqrt(v32 / c2).add_(cfg.eps))
                written = True
                m.copy_(m32)
                v.copy_(v32)
                del m32, v32
                step.add_(p.float() * cfg.weight_decay)
                p.copy_(p.float() - step.mul_(lr))
            state["count"].add_(1)
        except Exception as e:
            if not written:
                raise
            raise PartialUpdateError(
                f"AdamW failed after writing part of the state: {e}") from e
    return params, state, {"grad_norm": gnorm}

"""Shared layer primitives: norms, RoPE, dense/SwiGLU FFN, embeddings
(port of ``repro.models.layers``).

Parameters live in small ``nn.Module``s whose attribute names are the
JAX package's tree keys (``Dense.w``/``.b``, ``RMSNorm.scale``,
``Embedding.w``), so ``models.convert`` carries a JAX tree across by
name. A dense weight is stored as the reference stores it, ``(d_in,
d_out)``, and applied as ``x @ w``: the conversion is a copy. The forward
functions take the module as the reference takes its parameter dict.

Each module is built from a ``torch.Generator`` with the reference's
distribution and scale (a float32 normal, scaled, then cast to the
dtype), one tensor at a time, or left uninitialised (``gen=None``) for a
conversion to fill.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

__all__ = [
    "dtype_of", "normal", "Dense", "dense", "RMSNorm", "rmsnorm",
    "Embedding", "embed", "rope", "SwiGLU", "swiglu", "softcap",
]


def dtype_of(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


def normal(gen: torch.Generator | None, shape, scale: float, dtype,
           device) -> nn.Parameter:
    """A parameter drawn as the reference draws it: a float32 standard
    normal times ``scale``, cast to ``dtype`` (``gen=None``: left
    uninitialised, for a conversion to fill)."""
    if gen is None:
        return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                            requires_grad=False)
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return nn.Parameter(w.mul_(scale).to(dtype), requires_grad=False)


def const(shape, value: float, dtype, device) -> nn.Parameter:
    """A parameter filled with ``value``."""
    return nn.Parameter(torch.full(shape, value, dtype=dtype, device=device),
                        requires_grad=False)


class Dense(nn.Module):
    """``y = x @ w (+ b)``; ``w`` is ``(d_in, d_out)``, drawn with scale
    ``d_in ** -0.5`` unless given; the bias starts at zero."""

    def __init__(self, gen, d_in: int, d_out: int, dtype, device,
                 bias: bool = False, scale: float | None = None):
        super().__init__()
        scale = scale if scale is not None else d_in ** -0.5
        self.w = normal(gen, (d_in, d_out), scale, dtype, device)
        if bias:
            self.b = const((d_out,), 0.0, dtype, device)


def dense(p: Dense, x: torch.Tensor) -> torch.Tensor:
    y = x @ p.w
    if hasattr(p, "b"):
        y = y + p.b
    return y


class RMSNorm(nn.Module):
    def __init__(self, d: int, dtype, device):
        super().__init__()
        self.scale = const((d,), 1.0, dtype, device)


def rmsnorm(p: RMSNorm, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Root-mean-square norm computed in float32, cast back to x's dtype."""
    x32 = x.float()
    y = x32 * torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
    return (y * p.scale.float()).to(x.dtype)


class Embedding(nn.Module):
    """The token table ``w`` ``(vocab, d)``, drawn with scale 0.02."""

    def __init__(self, gen, vocab: int, d: int, dtype, device):
        super().__init__()
        self.w = normal(gen, (vocab, d), 0.02, dtype, device)


def embed(p: Embedding, tokens: torch.Tensor) -> torch.Tensor:
    return p.w[tokens.long()]


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """Rotary embedding, in float32. x: (..., L, H, D); positions: (..., L)."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    angles = positions[..., None].float() * freqs     # (..., L, half)
    cos = torch.cos(angles)[..., None, :]              # (..., L, 1, half)
    sin = torch.sin(angles)[..., None, :]
    x1f, x2f = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1f * cos - x2f * sin, x2f * cos + x1f * sin], dim=-1)
    return out.to(x.dtype)


class SwiGLU(nn.Module):
    def __init__(self, gen, d: int, d_ff: int, dtype, device):
        super().__init__()
        self.gate = Dense(gen, d, d_ff, dtype, device)
        self.up = Dense(gen, d, d_ff, dtype, device)
        self.down = Dense(gen, d_ff, d, dtype, device, scale=d_ff ** -0.5)


def swiglu(p: SwiGLU, x: torch.Tensor) -> torch.Tensor:
    return dense(p.down, F.silu(dense(p.gate, x)) * dense(p.up, x))


def softcap(x: torch.Tensor, cap: float | None) -> torch.Tensor:
    """Gemma2-style logit soft capping: ``cap * tanh(x / cap)``."""
    if cap is None:
        return x
    return (cap * torch.tanh(x.float() / cap)).to(x.dtype)

"""int8 gradient compression with error feedback (port of
``repro.optim.compression``).

Quantizing the cross-pod gradient all-reduce to int8 cuts its wire
volume 4x against float32 gradients (2x against bf16); error feedback
folds each step's quantization residual into the next step's gradient
(Karimireddy et al. 2019). Per-tensor symmetric scaling.

One difference of signature: the JAX package's ``compressed_psum(x,
pod_axis)`` runs inside ``shard_map`` and reduces over a named mesh
axis. The port has no collective layer, so :func:`compressed_psum`
takes the axis's members as a list of tensors, one per pod, and returns
the dequantized total that every member would receive: the same shared
scale (the max over the pods of each member's ``max |x|``), the same
rounding and the same int32 accumulation.
"""
from __future__ import annotations

import torch

__all__ = ["int8_compress", "int8_decompress", "compressed_psum",
           "apply_error_feedback"]


def _quantize(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x.float() / scale), -127, 127)


def _scale(amax: torch.Tensor) -> torch.Tensor:
    # over a tensor: CUDA divides by a Python number as a product with its
    # reciprocal, which rounds apart from the reference's division
    return torch.clamp(amax, min=1e-12) / torch.full_like(amax, 127.0)


def int8_compress(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization: returns (q int8, scale
    float32 scalar)."""
    scale = _scale(torch.max(torch.abs(x.float())))
    return _quantize(x, scale).to(torch.int8), scale


def int8_decompress(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compressed_psum(xs) -> torch.Tensor:
    """The int8-quantized sum of ``xs`` (one tensor a pod, equal shapes,
    on one device), dequantized to float32."""
    # shared scale: the max over the pods, so every pod quantizes into the
    # same grid
    amax = torch.stack([torch.max(torch.abs(x.float())) for x in xs]).max()
    scale = _scale(amax)
    # int32 accumulation: no int8 overflow across pods
    total = sum(_quantize(x, scale).to(torch.int32) for x in xs)
    return total.float() * scale


def apply_error_feedback(grad: torch.Tensor, residual: torch.Tensor
                         ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fold ``residual`` into ``grad`` and quantize: returns (the
    dequantized gradient float32, scale, the new residual)."""
    adj = grad.float() + residual
    q, scale = int8_compress(adj)
    deq = int8_decompress(q, scale)
    return deq, scale, adj - deq

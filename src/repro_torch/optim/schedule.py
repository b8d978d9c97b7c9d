"""Learning-rate schedules, pure functions of the step counter (port of
``repro.optim.schedule``).

The arithmetic is the reference's in float32, operation for operation,
so that a step's rate equals the JAX package's bit for bit. The one
transcendental, the cosine, is libm's float32 ``cosf``, the function
XLA's CPU backend calls for ``jnp.cos``: ``torch.cos`` rounds about one
step in thirty differently (an ulp), and a float64 cosine rounded to
float32 one in a hundred. The rate is a host value (the step is a
Python ``int`` in ``runtime.ft.train_loop``), so the cosine runs on the
host, one call a step.
"""
from __future__ import annotations

import ctypes
import ctypes.util
import functools
import math

import torch

__all__ = ["cosine_schedule"]


@functools.lru_cache(maxsize=None)
def _cosf():
    """libm's ``cosf``, bound with ctypes."""
    fn = ctypes.CDLL(ctypes.util.find_library("m")).cosf
    fn.restype, fn.argtypes = ctypes.c_float, [ctypes.c_float]
    return fn


def _cos32(x: torch.Tensor) -> torch.Tensor:
    """float32 cosine of a float32 CPU tensor, element by element."""
    cosf = _cosf()
    return torch.tensor([cosf(v) for v in x.reshape(-1).tolist()],
                        dtype=torch.float32).reshape(x.shape)


def cosine_schedule(step, *, peak_lr: float, warmup: int, total: int,
                    floor_frac: float = 0.1) -> torch.Tensor:
    """Linear warmup over ``warmup`` steps to ``peak_lr``, then a cosine
    decay to ``floor_frac * peak_lr`` at ``total``; a float32 CPU tensor
    of ``step``'s shape (an ``int`` or an integer tensor)."""
    step = torch.as_tensor(step).to("cpu", torch.float32)
    warm = peak_lr * (step + 1.0) / max(warmup, 1)
    progress = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0,
                           1.0)
    cos = peak_lr * (floor_frac + (1 - floor_frac)
                     * 0.5 * (1 + _cos32(math.pi * progress)))
    return torch.where(step < warmup, warm, cos)

"""64-bit hashing for HLL sketches, emulated in two uint32 lanes.

Same hash as ``repro.core.hashing``: two murmur3 finalizers (fmix32) with
distinct seed mixing, cross-mixed, giving a (hi, lo) pair; the bucket is
the top ``p`` bits of ``hi`` and rho the leading-zero count of the
remaining ``q = 64 - p`` bits, plus one.

PyTorch has no wrapping uint32 arithmetic on every device (the CPU build
lacks shifts on ``uint32``), so each lane is held in ``int64`` with values
in ``[0, 2^32)`` and masked with ``& 0xFFFFFFFF`` after every multiply
and add. A 32x32-bit multiply is split into 16-bit halves so that no
int64 product overflows. ``clz`` is a five-step binary search on
integers. The functions run on any device; the CUDA accumulate kernel
computes the same bits natively in ``uint32_t`` (``csrc/common.cuh``).
"""
from __future__ import annotations

import torch

__all__ = ["fmix32", "mul32", "hash64", "bucket_rho", "seed_words", "clz32"]

MASK32 = 0xFFFFFFFF
_GOLD_HI = 0x9E3779B9  # golden-ratio odd constant (splitmix)
_GOLD_LO = 0x85EBCA6B


def mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``(x * c) mod 2^32`` for int64 ``x`` in [0, 2^32) and a constant or
    tensor ``c`` in [0, 2^32), without int64 overflow."""
    lo = x & 0xFFFF
    hi = x >> 16
    return ((lo * c) + (((hi * c) & 0xFFFF) << 16)) & MASK32


def fmix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3 32-bit finalizer over int64-held uint32 values."""
    x = x & MASK32
    x = x ^ (x >> 16)
    x = mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = mul32(x, 0xC2B2AE35)
    x = x ^ (x >> 16)
    return x


def seed_words(seed: int) -> tuple[int, int]:
    """The two per-lane seed words, folded on the host (``hashing.py``)."""
    s_hi = (int(seed) * 0x9E3779B9 + 0x27D4EB2F) & MASK32
    s_lo = (int(seed) * 0x85EBCA6B + 0x165667B1) & MASK32
    return s_hi, s_lo


def hash64(keys: torch.Tensor, seed: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """Hash integer keys to an emulated 64-bit word (hi, lo), int64 lanes.

    ``keys`` may be any integer dtype; values are taken mod 2^32 like the
    JAX ``astype(uint32)``.
    """
    if keys.dtype == torch.uint32:  # reinterpret: not every device converts
        keys = keys.view(torch.int32)  # uint32 to int64 directly
    k = keys.to(torch.int64) & MASK32
    s_hi, s_lo = seed_words(seed)
    hi = fmix32(k ^ s_hi)
    lo = fmix32(((k + _GOLD_LO) & MASK32) ^ s_lo)
    hi = fmix32((hi + mul32(lo, _GOLD_HI)) & MASK32)
    return hi, lo


def clz32(x: torch.Tensor) -> torch.Tensor:
    """Leading zeros of int64-held uint32 values; ``clz32(0) == 32``."""
    n = torch.zeros_like(x)
    y = x
    for s in (16, 8, 4, 2, 1):
        top_zero = (y >> (32 - s)) == 0
        n = n + top_zero.to(x.dtype) * s
        y = torch.where(top_zero, (y << s) & MASK32, y)
    return torch.where(x == 0, torch.full_like(x, 32), n)


def bucket_rho(keys: torch.Tensor, p: int, seed: int = 0,
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Map keys -> (bucket int32 in [0, 2^p), rho uint8 in [1, q+1]).

    Element for element equal to ``repro.core.hashing.bucket_rho``.
    """
    if not (1 <= p <= 31):
        raise ValueError(f"p must be in [1, 31], got {p}")
    q = 64 - p
    hi, lo = hash64(keys, seed=seed)
    bucket = (hi >> (32 - p)).to(torch.int32)
    w_hi = ((hi << p) & MASK32) | (lo >> (32 - p))
    w_lo = (lo << p) & MASK32
    lz = torch.where(w_hi != 0, clz32(w_hi), 32 + clz32(w_lo))
    rho = torch.clamp(lz, max=q) + 1
    return bucket, rho.to(torch.uint8)

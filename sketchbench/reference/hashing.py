"""The sketch's 64-bit hash, frozen here for the reference.

Two murmur3 finalizers (fmix32) with distinct seed mixing, cross-mixed
into a (hi, lo) pair of 32-bit words. A key's bucket is the top ``p``
bits of ``hi``; its rho is one plus the leading-zero count of the
remaining ``64 - p`` bits, capped at ``64 - p + 1``.

Each 32-bit lane is held in int64 with values in ``[0, 2^32)``, masked
after every multiply and add; a 32x32-bit multiply is split into 16-bit
halves so that no int64 product overflows. Runs on any device.
"""
from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    lo = x & 0xFFFF
    hi = x >> 16
    return ((lo * c) + (((hi * c) & 0xFFFF) << 16)) & MASK32


def _fmix32(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def _clz32(x: torch.Tensor) -> torch.Tensor:
    n = torch.zeros_like(x)
    y = x
    for s in (16, 8, 4, 2, 1):
        top_zero = (y >> (32 - s)) == 0
        n = n + top_zero.to(x.dtype) * s
        y = torch.where(top_zero, (y << s) & MASK32, y)
    return torch.where(x == 0, torch.full_like(x, 32), n)


def bucket_rho(keys: torch.Tensor, p: int, seed: int = 0,
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Integer keys (read mod 2^32) -> (bucket int64 in [0, 2^p), rho int64
    in [1, 65 - p])."""
    k = keys.to(torch.int64) & MASK32
    s_hi = (int(seed) * 0x9E3779B9 + 0x27D4EB2F) & MASK32
    s_lo = (int(seed) * 0x85EBCA6B + 0x165667B1) & MASK32
    hi = _fmix32(k ^ s_hi)
    lo = _fmix32(((k + 0x85EBCA6B) & MASK32) ^ s_lo)
    hi = _fmix32((hi + _mul32(lo, 0x9E3779B9)) & MASK32)
    q = 64 - p
    bucket = hi >> (32 - p)
    w_hi = ((hi << p) & MASK32) | (lo >> (32 - p))
    w_lo = (lo << p) & MASK32
    lz = torch.where(w_hi != 0, _clz32(w_hi), 32 + _clz32(w_lo))
    return bucket, torch.clamp(lz, max=q) + 1

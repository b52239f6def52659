"""Branch-free 32-bit hashing for sketch states (counterpart of ``metrics_tpu/functional/sketches/hashing.py``).

The JAX package hashes in uint32. PyTorch has no uint32 shift on the CPU, so
the port holds each 32-bit word in an int64 masked to its low 32 bits. Each
multiply by a 32-bit constant is split into the constant's two 16-bit halves,
so that no product passes 2^63 and the low 32 bits are those of the uint32
product. The results are the JAX package's, bit for bit, as int64 values in
``[0, 2^32)``.
"""

from __future__ import annotations

import torch

from metrics_tpu_torch.utils.compute import _flush_subnormals

__all__ = ["fmix32", "hash32"]

_MASK32 = 0xFFFFFFFF


def _mul32(h: torch.Tensor, const: int) -> torch.Tensor:
    """``h * const mod 2^32`` for ``h`` in ``[0, 2^32)``: each partial product stays below 2^48."""
    hi, lo = const >> 16, const & 0xFFFF
    return ((((h * hi) & 0xFFFF) << 16) + h * lo) & _MASK32


def fmix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3's 32-bit finalizer on int64 words in ``[0, 2^32)``: full avalanche, same words out."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def _bits32(values: torch.Tensor) -> torch.Tensor:
    """The 32-bit word each value hashes: a float's float32 bit pattern (``-0.0`` and subnormals as ``+0.0``),
    an integer's or a bool's value modulo 2^32; int64 in ``[0, 2^32)``."""
    if values.is_floating_point():
        v32 = _flush_subnormals(values.to(torch.float32))
        v32 = torch.where(v32 == 0.0, torch.zeros_like(v32), v32)
        return v32.view(torch.int32).to(torch.int64) & _MASK32
    return values.to(torch.int64) & _MASK32


def hash32(values: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """Elementwise 32-bit hash of ``values`` (same shape), as int64 words in ``[0, 2^32)``.

    Floats hash their float32 bit pattern (float64, float16 and bfloat16 are
    rounded to float32 first; ``-0.0`` and subnormals count as ``+0.0``); integers and bools
    hash their value modulo 2^32. A NaN hashes its own bits: callers mask NaNs
    out with their validity mask.

    >>> hash32(torch.tensor([0.0, -0.0, 1.0]))
    tensor([         0,          0, 2980753846])
    """
    return fmix32(_bits32(torch.as_tensor(values)) ^ (int(seed) & _MASK32))

"""JAX's threefry2x32 PRNG in partitionable mode, on torch tensors.

The counterpart of ``jax.random`` under ``jax_threefry_partitionable=True``
(``jax/_src/prng.py``: ``threefry_seed``, ``_threefry2x32_lowering``,
``_threefry_split_foldlike``, ``_threefry_fold_in``,
``_threefry_random_bits_partitionable``, ``iota_2x32_shape``;
``jax/_src/random.py``: ``_uniform``, ``_randint``, ``_normal_real``), for
the draws the reference makes with fixed seeds: the proxy evaluator's
weights, its probe's batches and the eval noise.

A key is an int64 tensor of shape ``(2,)`` holding the two uint32 words of
``jax.random.key_data``; ``split`` returns ``(n, 2)``.  Every 32-bit word
is carried in int64 and masked with ``0xFFFFFFFF`` after each add, shift
and multiply (torch's ``uint32`` lacks most arithmetic and shift ops).
Work runs on the key's device.

``key``, ``fold_in``, ``split``, ``random_bits``, ``uniform`` and
``randint`` give the bits of JAX on the CPU, on every device.  ``normal``
follows XLA's float32 ``erf_inv`` polynomial but rounds ``log1p`` from
float64, so it agrees with JAX's to 3 ulps, not bits; on a GPU, where
float64 ``log1p`` may differ in its last bit, a few normals in a million
differ from the CPU's by as much.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_INT32_MIN, _INT32_MAX = -(1 << 31), (1 << 31) - 1


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & MASK) | (x >> (32 - r))


def _hash2x32(k1, k2, x1: torch.Tensor, x2: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The threefry2x32 block: 20 rounds, a key injection every 4.  ``k1``,
    ``k2``: words (ints or 0-dim tensors); ``x1``, ``x2``: the count words."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    a, b = (x1 + ks[0]) & MASK, (x2 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            a = (a + b) & MASK
            b = _rotl(b, r) ^ a
        a = (a + ks[(i + 1) % 3]) & MASK
        b = (b + ks[(i + 2) % 3] + (i + 1)) & MASK
    return a, b


def key(seed: int, device="cpu") -> torch.Tensor:
    """``jax.random.key_data(jax.random.key(seed))``: the seed's high and
    low 32-bit words."""
    seed = int(seed)
    if not 0 <= seed < 1 << 64:
        raise ValueError(f"seed {seed} is not a non-negative 64-bit int")
    return torch.tensor([seed >> 32, seed & MASK], dtype=torch.int64,
                        device=device)


def _words(k: torch.Tensor):
    if tuple(k.shape) != (2,):
        raise ValueError(f"a key has shape (2,), got {tuple(k.shape)}")
    return k[0], k[1]


def fold_in(k: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in``: the hash of the count ``(0, data)``."""
    k1, k2 = _words(k)
    z = torch.zeros((1,), dtype=torch.int64, device=k.device)
    a, b = _hash2x32(k1, k2, z, z + (int(data) & MASK))
    return torch.cat([a, b])


def _iota_2x32(shape: Sequence[int], device) -> Tuple[torch.Tensor,
                                                      torch.Tensor]:
    """``iota_2x32_shape``: the row-major index of each element as high and
    low 32-bit words."""
    n = math.prod(shape)
    idx = torch.arange(n, dtype=torch.int64, device=device).reshape(
        tuple(shape))
    return idx >> 32, idx & MASK


def split(k: torch.Tensor, n: int = 2) -> torch.Tensor:
    """``jax.random.split`` (partitionable): ``(n, 2)`` keys."""
    k1, k2 = _words(k)
    hi, lo = _iota_2x32((n,), k.device)
    a, b = _hash2x32(k1, k2, hi, lo)
    return torch.stack([a, b], dim=1)


def random_bits(k: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` (uint32) as int64 in [0, 2**32)."""
    k1, k2 = _words(k)
    hi, lo = _iota_2x32(tuple(shape), k.device)
    a, b = _hash2x32(k1, k2, hi, lo)
    return a ^ b


def _f32(x: float) -> float:
    """``x`` rounded to float32, as a Python float (exact in float32 and
    float64 ops alike: no host-to-device copy)."""
    return float(np.float32(x))


def uniform(k: torch.Tensor, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in float32: 23 random mantissa bits under the
    exponent of 1.0, minus 1, scaled to ``[minval, maxval)``, clamped below
    at ``minval``.  XLA contracts ``floats * (maxval - minval) + minval``
    into one fused multiply-add; it runs here in float64, where the product
    of two float32s is exact, and rounds once to float32."""
    lo = _f32(minval)
    span = float(np.float32(maxval) - np.float32(lo))   # a float32 subtraction
    bits = (random_bits(k, shape) >> 9) | 0x3F800000
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    return (floats.double() * span + lo).float().clamp_min(lo)


_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_SQRT2 = _f32(np.sqrt(2))
# XLA's float32 erf_inv (M. Giles' single-precision approximation), one
# polynomial in w for w < 5 and one in sqrt(w) beyond
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once, as XLA's fused multiply-add: the
    product of two float32s is exact in float64."""
    return (a.double() * b.double() + c.double()).float()


def erfinv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``erf_inv``, with its Horner steps fused as XLA fuses
    them on the CPU.  ``log1p`` runs in float64 and rounds once; JAX's
    differs from it by at most 2 ulps (its own float32 ``log1p``)."""
    w = -torch.log1p((x * -x).double()).float()
    small = w < 5.0
    w = torch.where(small, w - 2.5, torch.sqrt(w) - 3.0)
    coef = lambda i: torch.where(small, _f32(_ERFINV_LT5[i]),
                                 _f32(_ERFINV_GE5[i]))
    p = coef(0).expand_as(x)
    for i in range(1, len(_ERFINV_LT5)):
        p = _fma(p, w, coef(i))
    return torch.where(x.abs() == 1.0, x * float("inf"), p * x)


def normal(k: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.normal`` in float32: ``sqrt(2) * erf_inv(u)`` for ``u``
    uniform on ``(-1, 1)``."""
    u = uniform(k, shape, _NORMAL_LO, 1.0)
    return erfinv(u) * _SQRT2


def randint(k: torch.Tensor, shape: Sequence[int], minval: int,
            maxval: int) -> torch.Tensor:
    """``jax.random.randint`` in int32 over ``[minval, maxval)``: two
    32-bit draws from ``split(key)`` reduced modulo the span, with JAX's
    multiplier for the high word (``_randint``)."""
    if not (_INT32_MIN <= minval <= _INT32_MAX
            and _INT32_MIN <= maxval <= _INT32_MAX):
        raise ValueError(f"randint bounds [{minval}, {maxval}) leave int32")
    keys = split(k)
    higher, lower = random_bits(keys[0], shape), random_bits(keys[1], shape)
    span = (maxval - minval) & MASK if maxval > minval else 1
    multiplier = (1 << 16) % span
    multiplier = ((multiplier * multiplier) & MASK) % span
    offset = (((higher % span) * multiplier) & MASK) + (lower % span)
    offset = (offset & MASK) % span
    out = (offset + minval) & MASK
    return torch.where(out > _INT32_MAX, out - (1 << 32), out) \
        .to(torch.int32)

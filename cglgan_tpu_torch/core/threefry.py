"""JAX's threefry2x32 PRNG in partitionable mode, on torch tensors.

The counterpart of ``jax.random`` under ``jax_threefry_partitionable=True``
(``jax/_src/prng.py``: ``threefry_seed``, ``_threefry2x32_lowering``,
``_threefry_split_foldlike``, ``_threefry_fold_in``,
``_threefry_random_bits_partitionable``, ``iota_2x32_shape``;
``jax/_src/random.py``: ``_uniform``, ``_randint``, ``_normal_real``,
``_shuffle``), for every draw of the port: the algorithms' init and round
streams (``core/prng.py``), the 2DMG data, the conv D's dropout masks and
the proxy evaluator's weights, probe batches and eval noise.

A key is an int64 tensor of shape ``(2,)`` holding the two uint32 words of
``jax.random.key_data``; ``split`` returns ``(n, 2)``.  Every function also
takes a batch of keys ``(..., 2)`` and returns one result a key, leading
axes first, as ``jax.vmap`` over the keys would.  The ``*_parts``
functions draw several parts, one key each (``(..., n, 2)``), in one pass.
Work runs on the key's device: every draw is one call of
``ops/threefry.py`` ``draw``, which launches ``csrc/threefry.cu`` for CUDA
keys and runs its plain int64 torch version for CPU keys.

``key``, ``fold_in``, ``split``, ``random_bits``, ``uniform`` (float32 and
bfloat16), ``bernoulli``, ``randint`` and ``permutation`` give the bits of
JAX on the CPU, on every device.  ``normal`` follows XLA's float32
``erf_inv`` polynomial but rounds ``log1p`` from float64, so it agrees with
JAX's to 3 ulps, not bits (bfloat16: to one bfloat16 step, where the
float32 value lies next to a rounding boundary); on a GPU, where float64
``log1p`` may differ in its last bit and the kernel fuses its multiply-adds
in float32, a few normals in a million differ from the CPU's by as much.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from cglgan_tpu_torch.ops import threefry as kernel

MASK = kernel.MASK
_INT32_MIN, _INT32_MAX = -(1 << 31), (1 << 31) - 1


def key(seed: int, device="cpu") -> torch.Tensor:
    """``jax.random.key_data(jax.random.key(seed))``: the seed's high and
    low 32-bit words."""
    seed = int(seed)
    if not 0 <= seed < 1 << 64:
        raise ValueError(f"seed {seed} is not a non-negative 64-bit int")
    return torch.tensor([seed >> 32, seed & MASK], dtype=torch.int64,
                        device=device)


def _one(mode, k: torch.Tensor, shape, **kw) -> torch.Tensor:
    """A one-part draw of ``shape`` under each key of ``k`` (..., 2)."""
    if k.ndim < 1 or k.shape[-1] != 2:
        raise ValueError(f"a key has shape (..., 2), got {tuple(k.shape)}")
    return kernel.draw(mode, k.unsqueeze(-2), [tuple(shape)], **kw)[0]


def fold_in(k: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: the hash of the count ``(0, data)``.
    ``data`` an int gives ``(..., 2)``; a ``range`` of step 1 gives the keys
    of all its values in one pass, ``(..., len(data), 2)``."""
    if isinstance(data, range):
        if data.step != 1 or data.start < 0 or data.stop > 1 << 32:
            raise ValueError(f"fold_in takes a range of step 1 inside "
                             f"[0, 2**32), got {data}")
        return _one(kernel.WORDS, k, (len(data),), base=data.start)
    return _one(kernel.WORDS, k, (1,), base=int(data) & MASK)[..., 0, :]


def split(k: torch.Tensor, n: int = 2) -> torch.Tensor:
    """``jax.random.split`` (partitionable): ``(..., n, 2)`` keys."""
    return _one(kernel.WORDS, k, (n,))


_BITS = {32: kernel.BITS32, 16: kernel.BITS16, 8: kernel.BITS8}


def random_bits(k: torch.Tensor, shape: Sequence[int],
                bit_width: int = 32) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint{bit_width})`` as int64: the low
    ``bit_width`` bits of the two hash words' xor."""
    if bit_width not in _BITS:
        raise ValueError(f"bit_width {bit_width}: 8, 16 or 32")
    return _one(_BITS[bit_width], k, shape)


def _f32(x: float) -> float:
    return float(np.float32(x))


def _bf16(x: float) -> float:
    """``x`` rounded to float32, then to bfloat16 (nearest, ties to even),
    as a Python float."""
    u = int(np.float32(x).view(np.uint32))
    u = ((u + 0x7FFF + ((u >> 16) & 1)) >> 16) << 16
    return float(np.uint32(u).view(np.float32))


def _bounds(minval: float, maxval: float, dtype):
    """``_uniform``'s ``minval`` and ``maxval - minval`` in ``dtype``, each
    rounded as JAX rounds them."""
    if dtype == torch.float32:
        lo = _f32(minval)
        return lo, float(np.float32(maxval) - np.float32(lo))
    if dtype == torch.bfloat16:
        lo = _bf16(minval)
        return lo, _bf16(_bf16(maxval) - lo)
    raise ValueError(f"dtype {dtype}: float32 or bfloat16")


def _uniform_mode(dtype):
    return kernel.UNIFORM_F32 if dtype == torch.float32 \
        else kernel.UNIFORM_BF16


def uniform(k: torch.Tensor, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0, dtype=torch.float32) -> torch.Tensor:
    """``jax.random.uniform`` in ``dtype``.  float32: 23 random mantissa
    bits under the exponent of 1.0, minus 1, scaled by one fused
    multiply-add (XLA contracts ``floats * (maxval - minval) + minval``) and
    clamped below at ``minval``.  bfloat16: 8 random bits, 7 of them under
    the exponent of 1.0, the product and the sum each rounded to
    bfloat16."""
    lo, span = _bounds(minval, maxval, dtype)
    return _one(_uniform_mode(dtype), k, shape, lo=lo, span=span)


def uniform_parts(keys: torch.Tensor, shapes, minval: float, maxval: float,
                  dtype=torch.float32):
    """``[uniform(keys[..., j, :], shapes[j], minval, maxval, dtype) for
    j]`` in one pass."""
    lo, span = _bounds(minval, maxval, dtype)
    return kernel.draw(_uniform_mode(dtype), keys, shapes, lo=lo, span=span)


_NORMAL_LO = {torch.float32: float(np.nextafter(np.float32(-1.0),
                                                np.float32(0.0))),
              torch.bfloat16: -0.99609375}     # nextafter(-1, 0) in bf16


def normal_parts(keys: torch.Tensor, shapes, dtype=torch.float32):
    """``[normal(keys[..., j, :], shapes[j], dtype) for j]`` in one pass."""
    lo, span = _bounds(_NORMAL_LO[dtype], 1.0, dtype)
    mode = kernel.NORMAL_F32 if dtype == torch.float32 \
        else kernel.NORMAL_BF16
    return kernel.draw(mode, keys, shapes, lo=lo, span=span)


def normal(k: torch.Tensor, shape: Sequence[int],
           dtype=torch.float32) -> torch.Tensor:
    """``jax.random.normal``: ``sqrt(2) * erf_inv(u)`` for ``u`` uniform on
    ``(-1, 1)`` in ``dtype``; in bfloat16 ``erf_inv`` runs in float32 and
    rounds, then the product with bfloat16 ``sqrt(2)`` rounds (XLA upcasts
    ``erf_inv``)."""
    return normal_parts(k.unsqueeze(-2), [tuple(shape)], dtype)[0]


def bernoulli(k: torch.Tensor, p: float, shape: Sequence[int]
              ) -> torch.Tensor:
    """``jax.random.bernoulli(key, p, shape)``: bool, ``uniform(key, shape)
    < p`` with ``p`` a float32 (on ``[0, 1)`` the uniform is exact)."""
    return _one(kernel.BERNOULLI, k, shape, p=_f32(p))


def bernoulli_parts(keys: torch.Tensor, p: float,
                    shapes: Sequence[Sequence[int]]):
    """``[bernoulli(keys[..., j, :], p, shapes[j]) for j]`` in one pass
    over the parts' counts laid end to end (``keys``: ``(..., n, 2)``, one
    key a part)."""
    return kernel.draw(kernel.BERNOULLI, keys, shapes, p=_f32(p))


def randint(k: torch.Tensor, shape: Sequence[int], minval: int,
            maxval: int) -> torch.Tensor:
    """``jax.random.randint`` in int32 over ``[minval, maxval)``: two
    32-bit draws from ``split(key)`` reduced modulo the span, with JAX's
    multiplier for the high word (``_randint``)."""
    if not (_INT32_MIN <= minval <= _INT32_MAX
            and _INT32_MIN <= maxval <= _INT32_MAX):
        raise ValueError(f"randint bounds [{minval}, {maxval}) leave int32")
    span = (maxval - minval) & MASK if maxval > minval else 1
    multiplier = (1 << 16) % span
    multiplier = ((multiplier * multiplier) & MASK) % span
    return _one(kernel.RANDINT, k, shape, rand=(span, multiplier, minval))


def permutation(k: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.permutation(key, n)`` as int64 ``(n,)``: JAX's
    ``_shuffle`` of ``arange(n)``, ``ceil(3 ln n / ln(2**32 - 1))`` rounds
    (one for n < 1 626), each ``key, sub = split(key)``, 32-bit sort keys
    from ``sub`` and a stable sort (XLA's ``sort_key_val`` is stable: a
    tie keeps index order)."""
    if k.shape != (2,):
        raise ValueError(f"permutation takes one key (2,), got "
                         f"{tuple(k.shape)}")
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(float(MASK))))
    x = torch.arange(n, dtype=torch.int64, device=k.device)
    for _ in range(rounds):
        k, sub = split(k)
        order = torch.sort(random_bits(sub, (n,)), stable=True).indices
        x = x[order]
    return x

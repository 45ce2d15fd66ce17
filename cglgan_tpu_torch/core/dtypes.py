"""The run's compute dtype, and JAX's rounding rules for it in torch.

``cfg.dtype`` is ``"float32"`` or ``"bfloat16"`` (the reference's
``--dtype``).  In bfloat16 mode params, BatchNorm state, activations and
Adam moments are bfloat16; losses and the Lambda game stay float32
(``cglgan_tpu/algos/common.py:28-45``).

Two places where torch and JAX round differently on bfloat16, and the
helpers that make the port round as JAX does:

* **Weak-typed Python scalars.**  JAX rounds a Python scalar that meets a
  bfloat16 array to bfloat16 before the op (``0.999`` becomes ``1.0``,
  ``0.2`` becomes ``0.2001953125``); torch keeps it as a float32 "opmath"
  scalar.  ``weak(c, like)`` returns ``c`` rounded to ``like``'s dtype, so
  ``weak(c, x) * x`` rounds as ``c * x`` does in JAX.  In float32 it returns
  ``c`` itself: torch already rounds a Python scalar to float32 there, so
  the float32 paths keep their bits.
* **Means.**  ``jnp.mean`` / ``jnp.var`` of bfloat16 sum and divide in
  float32 and round once; torch's CPU ``mean`` of bfloat16 rounds the sum to
  bfloat16 before it divides.  ``mean`` and ``var`` accumulate bfloat16 in
  float32 and round once; float32 goes through torch's own ``mean``.
"""
from __future__ import annotations

import functools
import math
import struct
from typing import Sequence, Union

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(cfg_or_name) -> torch.dtype:
    """``cfg.dtype`` (or the name itself) as a torch dtype."""
    name = getattr(cfg_or_name, "dtype", cfg_or_name)
    if name not in DTYPES:
        raise ValueError(f"unsupported dtype {name!r}")
    return DTYPES[name]


@functools.lru_cache(maxsize=None)
def _rounded(c: float) -> float:
    """``c`` rounded to float32, then to bfloat16 (nearest, ties to even),
    as ``torch.tensor(c, dtype=torch.bfloat16)`` rounds it, in host
    arithmetic: a round body reads no tensor on the host."""
    u = struct.unpack("<I", struct.pack("<f", c))[0]
    u = ((u + 0x7FFF + ((u >> 16) & 1)) >> 16) << 16
    return struct.unpack("<f", struct.pack("<I", u))[0]


def weak(c: float, like: Union[torch.Tensor, torch.dtype]) -> float:
    """Python scalar ``c`` as JAX's weak typing uses it against ``like``
    (a tensor or a dtype): rounded to bfloat16 for a bfloat16 ``like``,
    ``c`` itself otherwise."""
    dtype = like if isinstance(like, torch.dtype) else like.dtype
    if dtype != torch.bfloat16:
        return c
    return _rounded(float(c))


def _dims(dim) -> tuple:
    return (dim,) if isinstance(dim, int) else tuple(dim)


def _count(x: torch.Tensor, dims: Sequence[int]) -> int:
    return math.prod(x.shape[d] for d in dims)


def _keep(t: torch.Tensor, dims: Sequence[int]) -> torch.Tensor:
    """``t`` reduced over ``dims`` without keepdim -> broadcastable again."""
    for d in sorted(d % (t.ndim + len(dims)) for d in dims):
        t = t.unsqueeze(d)
    return t


def mean(x: torch.Tensor, dim, keepdim: bool = False) -> torch.Tensor:
    """``jnp.mean(x, dim)`` over one axis or a tuple of them: bfloat16
    summed and divided in float32, rounded once; other dtypes through
    ``torch.mean``."""
    if x.dtype != torch.bfloat16:
        return x.mean(dim=dim, keepdim=keepdim)
    dims = _dims(dim)
    s = x.float().sum(dim=dims, keepdim=keepdim)
    return (s / _count(x, dims)).to(x.dtype)


def var(x: torch.Tensor, dim, x_mean: torch.Tensor) -> torch.Tensor:
    """``jnp.var(x, dim)`` (biased) over one axis or a tuple of them.
    bfloat16: every step in float32 (its own float32 mean, the squared
    deviations, their sum over the count), rounded once, as JAX computes
    it.  Other dtypes: the squared deviations from ``x_mean`` (``x``'s
    mean over ``dim``, without keepdim), averaged."""
    dims = _dims(dim)
    if x.dtype != torch.bfloat16:
        return ((x - _keep(x_mean, dims)) ** 2).mean(dim=dims)
    x32 = x.float()
    n = _count(x, dims)
    m = x32.sum(dim=dims, keepdim=True) / n
    return (((x32 - m) ** 2).sum(dim=dims) / n).to(x.dtype)

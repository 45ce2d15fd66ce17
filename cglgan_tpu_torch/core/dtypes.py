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
def _rounded(c: float, dtype: torch.dtype) -> float:
    return float(torch.tensor(c, dtype=dtype))


def weak(c: float, like: Union[torch.Tensor, torch.dtype]) -> float:
    """Python scalar ``c`` as JAX's weak typing uses it against ``like``
    (a tensor or a dtype): rounded to bfloat16 for a bfloat16 ``like``,
    ``c`` itself otherwise."""
    dtype = like if isinstance(like, torch.dtype) else like.dtype
    if dtype != torch.bfloat16:
        return c
    return _rounded(float(c), dtype)


def _count(x: torch.Tensor, dim: Sequence[int]) -> int:
    return math.prod(x.shape[d] for d in dim)


def mean(x: torch.Tensor, dim, keepdim: bool = False) -> torch.Tensor:
    """``jnp.mean(x, dim)``: bfloat16 summed and divided in float32, rounded
    once; other dtypes through ``torch.mean``."""
    if x.dtype != torch.bfloat16:
        return x.mean(dim=dim, keepdim=keepdim)
    dims = (dim,) if isinstance(dim, int) else tuple(dim)
    s = x.float().sum(dim=dims, keepdim=keepdim)
    return (s / _count(x, dims)).to(x.dtype)


def var(x: torch.Tensor, dim: int, x_mean: torch.Tensor) -> torch.Tensor:
    """``jnp.var(x, dim)`` (biased).  bfloat16: every step in float32 (its
    own float32 mean, the squared deviations, their sum over the count),
    rounded once, as JAX computes it.  Other dtypes: the squared deviations
    from ``x_mean`` (``x``'s mean over ``dim``), averaged."""
    if x.dtype != torch.bfloat16:
        return ((x - x_mean.unsqueeze(dim)) ** 2).mean(dim=dim)
    x32 = x.float()
    n = x.shape[dim]
    m = x32.sum(dim=dim, keepdim=True) / n
    return (((x32 - m) ** 2).sum(dim=dim) / n).to(x.dtype)

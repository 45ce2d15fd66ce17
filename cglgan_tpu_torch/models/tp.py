"""Tensor parallelism of the generators over a mesh's ``model`` axis.

The reference places a G's leaves Megatron-style (``place_model_tp``: the
last dim of every leaf past the servers axis split over ``model`` where the
shards divide it) and lets GSPMD partition the jitted G.  Here the G
forward runs on this rank's blocks (``core/meshes.py`` ``place_model_tp``)
through Megatron's column-parallel pair and the helpers below, which
``models/zoo.py`` calls with ``tp``, the mesh's ``ModelAxis``, or None off
a tensor-parallel mesh, where each helper is the plain layer it wraps:

* ``copy_to_model``: identity forward; its backward all-reduces the input's
  gradient over ``model`` (each rank's column block contributes a part);
* ``gather_from_model``: all-gathers the feature axis over ``model``; its
  backward returns this rank's block;
* ``scatter_to_model``: this rank's block of a whole activation; its
  backward all-gathers the blocks' gradients, so the whole op before it
  (a conv) takes the whole gradient on every rank.

A linear whose ``w`` and ``b`` are split computes ``x @ w_blk + b_blk`` on
the whole input; BatchNorm, LeakyReLU and Tanh act on the block (they are
per feature, so this is exact); the activations are gathered only before an
op that needs every feature: the next linear, the conv trunk's reshape, a
conv, or the G's output.  A whole leaf (a ``dout`` the shards do not
divide) is computed whole on every rank; a split bias or BatchNorm after
it takes this rank's channel block of the whole output.  The conv runs
whole on every rank: its OIHW weight is whole at 2 and 4 shards, and at 3
the rule splits its kW axis, so ``conv`` all-gathers the blocks first.

Feature axes: the last of an MLP activation ``(N, B, features)``; the
channels of the grouped image layout ``(B, N*C, H, W)``
(``models/nn.py``), member n's block of each member's C.
"""
from __future__ import annotations

from typing import Tuple

import torch

from cglgan_tpu_torch.core import meshes
from cglgan_tpu_torch.core.meshes import MODEL
from cglgan_tpu_torch.models import nn


def _axis(x: torch.Tensor, groups: int) -> Tuple[int, int]:
    """(feature axis, member groups on it): the channels of a grouped
    image, the last axis of an MLP activation."""
    return (1, groups) if x.ndim == 4 else (x.ndim - 1, 1)


def _joined(parts: torch.Tensor, dim: int, groups: int) -> torch.Tensor:
    """Stacked blocks ``(size, *x.shape)`` -> ``x`` with each group of axis
    ``dim`` the blocks joined in rank order."""
    size, shape = parts.shape[0], tuple(parts.shape[1:])
    p = parts.reshape((size,) + shape[:dim] + (groups, -1)
                      + shape[dim + 1:])
    return p.movedim(0, dim + 1).reshape(
        shape[:dim] + (shape[dim] * size,) + shape[dim + 1:])


def _block(x: torch.Tensor, tp, dim: int, groups: int) -> torch.Tensor:
    """This rank's block of each group of axis ``dim``."""
    shape = tuple(x.shape)
    v = x.reshape(shape[:dim] + (groups, tp.size, -1) + shape[dim + 1:])
    return v.select(dim + 1, tp.rank).reshape(
        shape[:dim] + (shape[dim] // tp.size,) + shape[dim + 1:]) \
        .contiguous()


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return meshes.all_reduce([grad], ctx.tp.mesh, MODEL)[0], None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp, dim, groups):
        ctx.args = (tp, dim, groups)
        return _joined(meshes.all_gather(x, tp.mesh, MODEL), dim, groups)

    @staticmethod
    def backward(ctx, grad):
        return _block(grad, *ctx.args), None, None, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp, dim, groups):
        ctx.args = (tp, dim, groups)
        return _block(x, tp, dim, groups)

    @staticmethod
    def backward(ctx, grad):
        tp, dim, groups = ctx.args
        return (_joined(meshes.all_gather(grad, tp.mesh, MODEL), dim,
                        groups), None, None, None)


def copy_to_model(x: torch.Tensor, tp) -> torch.Tensor:
    return x if tp is None else _Copy.apply(x, tp)


def gather_from_model(x: torch.Tensor, tp, groups: int = 1) -> torch.Tensor:
    if tp is None:
        return x
    return _Gather.apply(x, tp, *_axis(x, groups))


def scatter_to_model(x: torch.Tensor, tp, groups: int = 1) -> torch.Tensor:
    if tp is None:
        return x
    return _Scatter.apply(x, tp, *_axis(x, groups))


def splits(dim: int, tp) -> bool:
    """Whether the rule splits a leaf whose last dim is ``dim``."""
    return tp is not None and dim % tp.size == 0


def whole(x: torch.Tensor, blk: bool, tp, groups: int = 1) -> torch.Tensor:
    """``x`` with every feature: gathered where it is a block."""
    return gather_from_model(x, tp, groups) if blk else x


def linear(p, x: torch.Tensor, blk: bool, tp, dout: int):
    """``nn.linear`` of a layer of ``dout`` outputs on ``x`` (a block where
    ``blk``): the input gathered whole, and with a split layer copied to
    the model axis.  Returns (output, whether it is a block)."""
    x = whole(x, blk, tp)
    if splits(dout, tp):
        return nn.linear(p, copy_to_model(x, tp)), True
    return nn.linear(p, x), False


def batchnorm(p, s, x: torch.Tensor, blk: bool, tp, dim: int, train: bool,
              groups: int = 1):
    """``nn.batchnorm`` of ``dim`` features on ``x`` (a block where
    ``blk``), on the block where the rule splits its leaves.  Returns
    (output, new state, whether the output is a block)."""
    split = splits(dim, tp)
    if split and not blk:
        x = scatter_to_model(x, tp, groups)
    elif blk and not split:
        x = gather_from_model(x, tp, groups)
    y, new_s = nn.batchnorm(p, s, x, train)
    return y, new_s, split


def conv(p, x: torch.Tensor, blk: bool, tp, stride: int = 1,
         padding: int = 1):
    """``nn.group_conv2d`` of grouped ``x`` (a block where ``blk``): the
    whole input and the whole (OIHW) weights on every rank, a weight the
    rule splits (its kW axis, at 3 shards) gathered first; a split bias
    adds to this rank's channel block of the output.  Returns (output,
    whether it is a block)."""
    if tp is None:
        return nn.group_conv2d(p, x, stride, padding), False
    n, cout = p["w"].shape[0], p["w"].shape[1]
    x = whole(x, blk, tp, n)
    # the kernels are square: the rule splits kW where it divides kH.  A
    # split weight is gathered whole on its last axis (named: ``_axis``
    # would read a 4-D leaf as a grouped image); the backward of the
    # gather returns this rank's block of the whole gradient with no
    # collective, because every model rank computes the same whole
    # gradient from the same whole input and output gradient
    w = p["w"]
    if splits(w.shape[-2], tp):
        w = _Gather.apply(w, tp, w.ndim - 1, 1)
    y = nn.group_conv2d({"w": w}, x, stride, padding, bias=False)
    split = splits(cout, tp)
    if split:
        y = scatter_to_model(y, tp, n)
    return y + p["b"].reshape(1, -1, 1, 1), split

"""Federated exchanges as ops on stacked tensors (leading axis = members).

The functions of ``cglgan_tpu/fed/collectives.py`` that the CAP-GAN and
FedAvg-family rounds reach, on trees (lists/dicts) of stacked tensors.  Single-device:
the multi-GPU forms (``torch.distributed``) are a later ROADMAP item.

bfloat16 leaves round as the reference's do under JAX: weights are cast to
the leaf's dtype before the product, sums and means over the members
accumulate in float32 and round once (``jnp.sum`` / ``jnp.mean`` of
bfloat16), and the mixing constants are weak scalars (``core/dtypes.py``).
"""
from __future__ import annotations

import torch

from cglgan_tpu_torch.core import dtypes
from cglgan_tpu_torch.core.dtypes import weak
from cglgan_tpu_torch.utils.tree import tree_map


def _lead(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(N,) -> (N, 1, ..., 1) to broadcast against ``x``."""
    return v.reshape((-1,) + (1,) * (x.ndim - 1)).to(x.dtype)


def weighted_avg_tree(stacked, weights: torch.Tensor):
    """Weighted sum over the leading axis of every leaf (callers normalise):
    the products in the leaf's dtype, their sum accumulated in float32."""
    return tree_map(lambda x: torch.sum((x * _lead(weights, x)).float(),
                                        dim=0).to(x.dtype), stacked)


def fedavg_tree(stacked):
    """Uniform FedAvg over the leading axis (FL-GAN server running mean,
    FLGAN/MNIST/flgan.py:148-162)."""
    return tree_map(lambda x: dtypes.mean(x, 0), stacked)


def broadcast_tree(tree, n: int):
    """Replicate an unstacked tree to a leading axis of size n (the server
    'put p_g to every worker' fan-out, FLGAN/MNIST/flgan.py:145-147); a
    view, no copy."""
    return tree_map(lambda x: x.unsqueeze(0).expand((n,) + tuple(x.shape)),
                    tree)


def sigma_mix(self_tree, avg_tree, segema: float):
    """sigma*self + (1-sigma)*average (CGLGAN/MNIST/main.py:182-183)."""
    return tree_map(lambda a, b: weak(segema, a) * a
                    + weak(1.0 - segema, b) * b, self_tree, avg_tree)


def neighbor_share_tree(stacked, group_size: int, *, blocked: bool = False):
    """Replace each member with the mean of its contiguous group.
    ``blocked=True``: leaves are already ``(G, group_size, ...)``."""
    def share(x):
        if blocked:
            if x.shape[1] != group_size:
                raise ValueError(f"blocked share: axis 1 is {x.shape[1]}, "
                                 f"expected {group_size}")
            return dtypes.mean(x, 1, keepdim=True).expand_as(x).clone()
        g = x.shape[0] // group_size
        grouped = x.reshape((g, group_size) + tuple(x.shape[1:]))
        mean = dtypes.mean(grouped, 1, keepdim=True)
        return mean.expand_as(grouped).reshape(x.shape)

    return tree_map(share, stacked)


def masked_weighted_avg_tree(stacked, weights: torch.Tensor,
                             mask: torch.Tensor):
    """Weighted average over the ``mask``-selected members, weights
    renormalised over the active set."""
    w = weights * mask
    w = w / torch.clamp(w.sum(), min=1e-12)
    return weighted_avg_tree(stacked, w)


def select_update_tree(old_stacked, new_stacked, mask: torch.Tensor):
    """Members with mask=1 take the new state, others keep the old."""
    def sel(o, nw):
        m = _lead(mask, o)
        return o * (1 - m) + nw * m
    return tree_map(sel, old_stacked, new_stacked)

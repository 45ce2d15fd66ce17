"""Federated exchanges as ops on stacked tensors (leading axis = members).

The functions of ``cglgan_tpu/fed/collectives.py``, on trees (lists/dicts)
of stacked tensors.  Single-device: the multi-GPU forms
(``torch.distributed``) are a later ROADMAP item.

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


def _group_mean(x: torch.Tensor) -> torch.Tensor:
    """``jnp.mean(x, axis=1, keepdims=True)`` over a small group axis as
    XLA computes it on the CPU, bit for bit: the members added in order (in
    float32 for bfloat16), times float32(1 / n), rounded once."""
    n = x.shape[1]
    acc = x[:, 0].float() if x.dtype == torch.bfloat16 else x[:, 0]
    for i in range(1, n):
        acc = acc + x[:, i]
    return (acc * (1.0 / n)).to(x.dtype).unsqueeze(1)


def neighbor_share_tree(stacked, group_size: int, *, blocked: bool = False):
    """Replace each member with the mean of its contiguous group.
    ``blocked=True``: leaves are already ``(G, group_size, ...)``."""
    def share(x):
        if blocked:
            if x.shape[1] != group_size:
                raise ValueError(f"blocked share: axis 1 is {x.shape[1]}, "
                                 f"expected {group_size}")
            return _group_mean(x).expand_as(x).clone()
        g = x.shape[0] // group_size
        grouped = x.reshape((g, group_size) + tuple(x.shape[1:]))
        return _group_mean(grouped).expand_as(grouped).reshape(x.shape)

    return tree_map(share, stacked)


def ring_shift_tree(stacked, shift: int = 1):
    """Client i's model moves to client (i + shift) mod N: MD-GAN's ring
    D-swap (MDGAN/MNIST/mdgan.py:158-164)."""
    return tree_map(lambda x: torch.roll(x, shift, dims=0), stacked)


def permute_tree(stacked, perm: torch.Tensor):
    """Client i takes member ``perm[i]``'s state: MD-GAN's shuffle D-swap,
    with ``perm`` drawn fresh per swap event."""
    return tree_map(lambda x: x.index_select(0, perm), stacked)


def delta_share_tree(stacked, anchor, group_size: int, *,
                     blocked: bool = False):
    """AC-GAN's delta-accumulating gossip (ACGAN/MNIST/acgan.py:240-263):
    every member's delta ``p - w`` from its anchor ``w`` is averaged over
    its group, the new state is ``w + mean delta`` and the new anchor the
    pre-exchange state.  From the zero anchor the first exchange equals the
    group mean; later ones do not.  Returns ``(new_stacked, new_anchor)``;
    ``blocked`` as in ``neighbor_share_tree``."""
    deltas = tree_map(lambda p, w: p - w, stacked, anchor)
    mean_delta = neighbor_share_tree(deltas, group_size, blocked=blocked)
    return tree_map(lambda w, s: w + s, anchor, mean_delta), stacked


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

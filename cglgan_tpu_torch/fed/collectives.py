"""Federated exchanges as ops on stacked tensors (leading axis = members).

The functions of ``cglgan_tpu/fed/collectives.py``, on trees (lists/dicts)
of stacked tensors.  Each exchange takes an optional clients mesh
(``core/meshes.py``): ``stacked`` then holds this rank's members, the
function computes the rank-local partial and makes the one collective the
reference's sharded round lowers to (``tests/test_hlo_comm.py``):
* ``weighted_avg_tree`` / ``fedavg_tree`` / ``masked_weighted_avg_tree``:
  local partial sums, then ONE all-reduce of a flat bucket of every leaf;
* ``neighbor_share_tree`` / ``delta_share_tree`` (blocked): the in-order
  group sum of this rank's part of each group, then one all-reduce of the
  ``(S, ...)`` partials, never the ``(W, ...)`` stack;
* ``ring_shift_tree``: the boundary member to the next rank, one
  send / recv of a flat bucket;
* ``permute_tree``: the members whose source is on another rank, one
  send / recv a pair of ranks.  The reference's jitted round lowers its
  traced permutation to an all-gather of every whole stacked D leaf (its
  compiled HLO on the 8-device CPU mesh, read as ``tests/test_hlo_comm.py``
  reads it); here the permutation is replicated, so every rank knows
  which rows move and only those move;
* ``select_update_tree``: local.
A partial is written so that on a mesh of one rank the result is the
unsharded function's, bit for bit.

bfloat16 leaves round as the reference's do under JAX: weights are cast to
the leaf's dtype before the product, sums and means over the members
accumulate in float32 and round once (``jnp.sum`` / ``jnp.mean`` of
bfloat16), and the mixing constants are weak scalars (``core/dtypes.py``).
"""
from __future__ import annotations

import torch

from cglgan_tpu_torch.core import dtypes, meshes
from cglgan_tpu_torch.core.dtypes import weak
from cglgan_tpu_torch.utils.tree import tree_leaves, tree_map, tree_unflatten


def _lead(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(N,) -> (N, 1, ..., 1) to broadcast against ``x``."""
    return v.reshape((-1,) + (1,) * (x.ndim - 1)).to(x.dtype)


def _reduced(stacked, partial, finish, mesh):
    """``finish(total, leaf)`` of every leaf's ``partial`` summed over the
    mesh's ranks (one all-reduce of all leaves), or of the partial itself
    without a mesh."""
    leaves = tree_leaves(stacked)
    totals = meshes.all_reduce([partial(x) for x in leaves], mesh)
    return tree_unflatten(stacked, [finish(t, x)
                                    for t, x in zip(totals, leaves)])


def weighted_avg_tree(stacked, weights: torch.Tensor, mesh=None):
    """Weighted sum over the leading axis of every leaf (callers normalise):
    the products in the leaf's dtype, their sum accumulated in float32.
    With a mesh, ``weights`` are this rank's members'."""
    return _reduced(stacked,
                    lambda x: torch.sum((x * _lead(weights, x)).float(), 0),
                    lambda t, x: t.to(x.dtype), mesh)


def fedavg_tree(stacked, mesh=None):
    """Uniform FedAvg over the leading axis (FL-GAN server running mean,
    FLGAN/MNIST/flgan.py:148-162).  With a mesh, of every rank's members:
    a float32 leaf's partial is ``torch.mean`` of this rank's members times
    their share (on one rank torch's own mean, whose sum order and final
    scaling differ by device, times 1), a bfloat16 leaf's its float32
    sum."""
    if mesh is None:
        return tree_map(lambda x: dtypes.mean(x, 0), stacked)
    n = mesh.size

    def partial(x):
        if x.dtype == torch.bfloat16:
            return x.float().sum(0)
        return x.mean(0) * (1.0 / n)

    def finish(t, x):
        if x.dtype == torch.bfloat16:
            return (t / (x.shape[0] * n)).to(x.dtype)
        return t
    return _reduced(stacked, partial, finish, mesh)


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


def _group_sum(x: torch.Tensor) -> torch.Tensor:
    """The members of a small group axis (axis 1) added in order, in
    float32 for bfloat16."""
    acc = x[:, 0].float() if x.dtype == torch.bfloat16 else x[:, 0]
    for i in range(1, x.shape[1]):
        acc = acc + x[:, i]
    return acc


def _group_mean(acc: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """``jnp.mean(x, axis=1, keepdims=True)`` over a small group axis as
    XLA computes it on the CPU, bit for bit, from ``_group_sum(x)``: times
    float32(1 / n), rounded once."""
    return (acc * (1.0 / n)).to(dtype).unsqueeze(1)


def neighbor_share_tree(stacked, group_size: int, *, blocked: bool = False,
                        mesh=None):
    """Replace each member with the mean of its contiguous group.
    ``blocked=True``: leaves are already ``(G, group_size, ...)``; with a
    mesh (blocked only) ``(G, group_size / ranks, ...)``, this rank's part
    of each group: its in-order sums are all-reduced as ``(G, ...)``
    partials, one bucket for every leaf."""
    if mesh is not None:
        if not blocked:
            raise ValueError("a sharded neighbour share takes the blocked "
                             "(G, group, ...) layout")
        for x in tree_leaves(stacked):
            if x.shape[1] * mesh.size != group_size:
                raise ValueError(f"blocked share: axis 1 is {x.shape[1]} "
                                 f"of {mesh.size} ranks, expected "
                                 f"{group_size}")
        return _reduced(stacked, _group_sum, lambda t, x: _group_mean(
            t, group_size, x.dtype).expand_as(x).clone(), mesh)

    def share(x):
        if blocked:
            if x.shape[1] != group_size:
                raise ValueError(f"blocked share: axis 1 is {x.shape[1]}, "
                                 f"expected {group_size}")
            return _group_mean(_group_sum(x), group_size,
                               x.dtype).expand_as(x).clone()
        g = x.shape[0] // group_size
        grouped = x.reshape((g, group_size) + tuple(x.shape[1:]))
        return _group_mean(_group_sum(grouped), group_size, x.dtype) \
            .expand_as(grouped).reshape(x.shape)

    return tree_map(share, stacked)


def ring_shift_tree(stacked, shift: int = 1, mesh=None):
    """Client i's model moves to client (i + shift) mod N: MD-GAN's ring
    D-swap (MDGAN/MNIST/mdgan.py:158-164).  With a mesh of more than one
    rank (``shift=1``, contiguous blocks): this rank's last member goes to
    the next rank's first, the previous rank's last comes in."""
    if mesh is None or mesh.size == 1:
        return tree_map(lambda x: torch.roll(x, shift, dims=0), stacked)
    if shift != 1:
        raise ValueError("a sharded ring shift moves by one member")
    n = tree_leaves(stacked)[0].shape[0]
    nxt, prv = (mesh.rank + 1) % mesh.size, (mesh.rank - 1) % mesh.size
    return meshes.move_rows(stacked, {nxt: [n - 1]}, {prv: [0]},
                            (list(range(1, n)), list(range(n - 1))), mesh)


def permute_tree(stacked, perm: torch.Tensor, mesh=None):
    """Client i takes member ``perm[i]``'s state: MD-GAN's shuffle D-swap,
    with ``perm`` drawn fresh per swap event.  With a mesh (contiguous
    blocks), ``perm`` is the whole permutation, the same on every rank:
    the rows whose source is on another rank move there point to point,
    one bucket a pair of ranks."""
    if mesh is None or mesh.size == 1:
        return tree_map(lambda x: x.index_select(0, perm), stacked)
    p = [int(v) for v in perm.tolist()]
    per = len(p) // mesh.size
    me, lo = mesh.rank, mesh.rank * per
    rows_out: dict = {}
    rows_in: dict = {}
    keep = ([], [])
    for i, src in enumerate(p):
        dst_rank, src_rank = i // per, src // per
        if dst_rank == me and src_rank == me:
            keep[0].append(i - lo)
            keep[1].append(src - lo)
        elif dst_rank == me:
            rows_in.setdefault(src_rank, []).append(i - lo)
        elif src_rank == me:
            rows_out.setdefault(dst_rank, []).append(src - lo)
    return meshes.move_rows(stacked, rows_out, rows_in, keep, mesh)


def delta_share_tree(stacked, anchor, group_size: int, *,
                     blocked: bool = False, mesh=None):
    """AC-GAN's delta-accumulating gossip (ACGAN/MNIST/acgan.py:240-263):
    every member's delta ``p - w`` from its anchor ``w`` is averaged over
    its group, the new state is ``w + mean delta`` and the new anchor the
    pre-exchange state.  From the zero anchor the first exchange equals the
    group mean; later ones do not.  Returns ``(new_stacked, new_anchor)``;
    ``blocked`` and ``mesh`` as in ``neighbor_share_tree``."""
    deltas = tree_map(lambda p, w: p - w, stacked, anchor)
    mean_delta = neighbor_share_tree(deltas, group_size, blocked=blocked,
                                     mesh=mesh)
    return tree_map(lambda w, s: w + s, anchor, mean_delta), stacked


def masked_weighted_avg_tree(stacked, weights: torch.Tensor,
                             mask: torch.Tensor, mesh=None):
    """Weighted average over the ``mask``-selected members, weights
    renormalised over the active set.  ``weights`` and ``mask`` cover
    every member; with a mesh ``stacked`` holds this rank's contiguous
    block of them."""
    w = weights * mask
    w = w / torch.clamp(w.sum(), min=1e-12)
    if mesh is not None:
        w = w[mesh.block(w.shape[0])]
    return weighted_avg_tree(stacked, w, mesh)


def select_update_tree(old_stacked, new_stacked, mask: torch.Tensor):
    """Members with mask=1 take the new state, others keep the old (local
    on a mesh: ``mask`` is this rank's members')."""
    def sel(o, nw):
        m = _lead(mask, o)
        return o * (1 - m) + nw * m
    return tree_map(sel, old_stacked, new_stacked)

"""The conv LSGAN pair on MD-GAN and AC-GAN, port against the JAX package.

The slice as a whole: MD-GAN (4 clients, 1 server) and AC-GAN (4 clients,
2 servers of 2) with ``conv=True``, 32x32 images, batch 4, start from the
JAX ``init_state()`` carried across by ``utils/transplant.py`` and run 2
rounds on each side with the reference's draws injected into the port's
``round_fn``: the window starts and latents
(``benchmarks/trajectory_parity.py`` ``cgl_round_streams``), each
server's ``(k_d, k_drop)`` as threefry key data at slots 3 and 4 (so every
Dropout2d mask is the reference's), then the survival draw and MD-GAN's
shuffle permutation at slots 5 and 6.  Cases: MD-GAN at epoch 1 with the
ring D-swap every round, MD-GAN at epoch 2 with the shuffle D-swap at
E=2, AC-GAN with the delta gossip every round (its anchors, the conv D's
params and BatchNorm buffers, compared after each round) and AC-GAN with
``dropout_rate=0.5``.  The reference's round is jitted once a config; its
init and ``gen`` are compiled at XLA's backend optimization level 0.
Tolerances are ``tests/test_torch_port_conv.py``'s (its ``_close_net``);
TF32 is off and torch runs on one thread.
"""
import jax
import numpy as np
import pytest
import torch

from benchmarks.trajectory_parity import cgl_round_streams
from cglgan_tpu.algos.registry import build_runner as jax_build_runner
from cglgan_tpu.core import prng as jprng
from cglgan_tpu.core.config import FedGANConfig as JaxConfig
from cglgan_tpu_torch.algos.registry import build_runner
from cglgan_tpu_torch.core.config import FedGANConfig
from cglgan_tpu_torch.ops import fused_dstep
from cglgan_tpu_torch.utils.transplant import from_jax_numpy, to_numpy
from cglgan_tpu_torch.utils.tree import tree_leaves
# the conv file's helpers and tolerances, and its autouse fixture (TF32
# off)
from test_torch_port_conv import (LR, NW, TOL_FWD, TOL_METRIC,  # noqa: F401
                                  TOL_PARAMS, _close, _close_net, _jit,
                                  _no_tf32, _noisy_leaves, _partition,
                                  _paths, _t)
from test_torch_port_threads import one_torch_thread  # noqa: F401

ROUNDS = 2
B, L = 4, 24

# The share of a net's elements of one kind that may miss the bounds, after
# round 1 and round 2, as tests/test_torch_port_conv.py allows.  Measured
# here, the largest share of a net's elements of one kind: after round 1
# none in any case; after round 2 1.8e-5 (AC-GAN delta, the D) and 7.6e-6
# (MD-GAN shuffle at epoch 2, the D), none in the other two.
FLIP_SHARE = (0.001, 0.01)

CASES = {
    # id: (algo, epoch, config fields)
    "mdgan_epoch1_ring": ("mdgan", 1, dict(E=1, d_swap="ring")),
    "mdgan_epoch2_shuffle": ("mdgan", 2, dict(E=2, d_swap="shuffle")),
    "acgan_delta": ("acgan", 1, dict(E=1, gossip="delta")),
    "acgan_dropout": ("acgan", 1, dict(dropout_rate=0.5)),
}


def _config(case):
    algo, epoch, extra = CASES[case]
    kw = dict(algo=algo, dataset="synthetic-mnist", conv=True,
              num_workers=NW, num_servers=1 if algo == "mdgan" else 2,
              iid=1, batch_size=B, epoch=epoch, **extra)
    return JaxConfig(**kw), FedGANConfig(**kw)


def _streams(jcfg):
    """Round t's injected streams in the conv layout: ``(starts, z_d, z_g,
    k_d, k_drop, alive, perm)``, the keys each server's ``split(key_s,
    4)[2:]`` as the reference's ``server_round`` splits them, ``alive``
    the draw behind its participation mask (``fold_in(key, 7)``) and
    ``perm`` MD-GAN's shuffle (``ROLE_SWAP``), None where unused."""
    root = jprng.root_key(jcfg.seed)
    base = cgl_round_streams(root, jcfg, L)

    def at(t):
        starts, z_d, z_g = base(t)
        key = jprng.for_round(jprng.for_role(root, jprng.ROLE_LOCAL), t)
        per = [jax.random.split(k, 4)
               for k in jax.random.split(key, jcfg.num_servers)]
        keys = [_t(np.stack([np.asarray(jax.random.key_data(p[j]))
                             for p in per]).astype(np.int64))
                for j in (2, 3)]
        alive = perm = None
        if jcfg.dropout_rate > 0:
            alive = _t(np.asarray(jax.random.bernoulli(
                jax.random.fold_in(key, 7), 1.0 - jcfg.dropout_rate,
                (NW,))))
        if jcfg.d_swap == "shuffle" and jcfg.E > 0:
            perm = _t(np.asarray(jax.random.permutation(
                jprng.for_role(key, jprng.ROLE_SWAP), NW)))
        return (starts, _t(z_d), _t(z_g), *keys, alive, perm)

    return at


_JAX_INIT = {}


def _jax_init(jrun, algo):
    """The reference's init, jitted once an algorithm: the configs of one
    algorithm differ in it only by the delta gossip's zero anchors, which
    the caller sets."""
    if algo not in _JAX_INIT:
        _JAX_INIT[algo] = jax.tree.map(np.asarray, _jit(jrun.init_state))
    return _JAX_INIT[algo]


def _close_anchors(got, ref, noisy, t):
    """The delta anchors (the conv D's params and BN buffers before the
    last exchange, flattened (W, ...)): TOL_PARAMS elementwise, the
    BN-fed biases and running means by lr a local step, with the flip
    share of the D's params."""
    n_bad = size = 0
    for kind, mine, theirs in (("params", got[0], ref[0]),
                               ("bn", got[1], ref[1])):
        for path, a, b in zip(_paths(mine), tree_leaves(mine),
                              jax.tree.leaves(theirs)):
            b = np.asarray(b).reshape(a.shape)
            diff = np.abs(a - b)
            assert diff.max() <= LR * (t + 1), (kind, path)
            size += b.size
            if path not in noisy[0] | noisy[1]:
                n_bad += int((diff > TOL_PARAMS[1]
                              + TOL_PARAMS[0] * np.abs(b)).sum())
    assert n_bad <= FLIP_SHARE[t] * size, (n_bad, size)


@pytest.mark.parametrize("case", sorted(CASES))
def test_conv_mdgan_rounds_match_jax(case):
    algo, epoch, extra = CASES[case]
    jcfg, cfg = _config(case)
    jpart, part = _partition()
    assert not fused_dstep.eligible(cfg)        # conv: autograd, as JAX
    jrun = jax_build_runner(jcfg, jpart)
    jstate = _jax_init(jrun, algo)
    jstate = jstate._replace(lam=jax.tree.map(
        np.zeros_like, (jstate.d.params, jstate.d.bn))
        if extra.get("gossip") == "delta" else None)
    jround = jax.jit(jrun.round_fn)
    draw = _streams(jcfg)
    run = build_runner(cfg, part, device="cpu")
    state = from_jax_numpy(jstate, cfg, "cpu")
    assert set(state.d.params) == {"c1", "c2", "c3", "c4", "adv", "bn2",
                                   "bn3", "bn4"}
    launched, dropped = fused_dstep.launches, 0
    g_noisy, d_noisy = _noisy_leaves(algo)
    for t in range(ROUNDS):
        drawn = draw(t)
        jstate, jm = jround(jstate)
        state, m = run.round_fn(state, drawn)
        if drawn[5] is not None:
            dropped += int((~drawn[5]).sum())
        assert set(m) == set(jm)
        for key in jm:
            assert abs(float(m[key]) - float(jm[key])) < TOL_METRIC, \
                (t, key, float(m[key]), float(jm[key]))
        got = to_numpy(state)
        ref = jax.tree.map(np.asarray, jstate)
        assert got["t"] == int(ref.t) == t + 1
        _close_net(got["g"], ref.g, "g", *g_noisy, steps=t + 1,
                   share=FLIP_SHARE[t])
        _close_net(got["d"], ref.d, "d", *d_noisy, steps=(t + 1) * epoch,
                   share=FLIP_SHARE[t])
        if ref.lam is None:
            assert got["lam"] is None
        else:
            _close_anchors(got["lam"], ref.lam, d_noisy, t)
    assert fused_dstep.launches == launched
    if extra.get("dropout_rate"):
        assert dropped > 0                  # the draws dropped someone
    if ref.lam is not None:
        # the anchors, no longer zero, carry over both ways bit for bit
        back = to_numpy(from_jax_numpy(ref, cfg, "cpu"))
        mine, theirs = tree_leaves(back["lam"]), jax.tree.leaves(ref.lam)
        assert len(mine) == len(theirs) > 0
        for a, b in zip(mine, theirs):
            np.testing.assert_array_equal(
                a.view(np.uint32), np.asarray(b).reshape(a.shape)
                .view(np.uint32))
        assert any(np.abs(a).max() > 0 for a in mine)
        # serving: each server's G on its block of the latents
        z = np.random.default_rng(1).normal(size=(4, 100)) \
            .astype(np.float32)
        _close(run.gen(from_jax_numpy(ref, cfg, "cpu"), _t(z)).numpy(),
               _jit(jrun.gen, jstate, z), TOL_FWD, "gen")


def test_conv_stream_layout():
    """A conv round takes the dropout keys at slots 3 and 4: without them
    (the MLP layout, the survival draw at slot 3) it raises ValueError, and
    so does a stream with more than the survival draw and the permutation
    after them; with them and nothing after, the round draws its survival
    draw itself."""
    _, part = _partition()
    cfg = FedGANConfig(algo="acgan", dataset="synthetic-mnist", conv=True,
                       num_workers=NW, num_servers=2, batch_size=B,
                       dropout_rate=0.5)
    run = build_runner(cfg, part, device="cpu")
    state = run.init_state()
    z = torch.zeros(2, B, 100)
    keys = torch.zeros(2, 2, dtype=torch.int64)
    alive = torch.ones(NW, dtype=torch.bool)
    for bad in (((0,), z, z), ((0,), z, z, alive),
                ((0,), z, z, keys, keys, alive, None, None)):
        with pytest.raises(ValueError, match="k_d, k_drop"):
            run.round_fn(state, bad)
    state, m = run.round_fn(state, ((0,), z, z, keys, keys))
    assert state.t == 1 and all(np.isfinite(float(v)) for v in m.values())


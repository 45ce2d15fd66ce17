"""The conv LSGAN pair on FL-GAN and FeGAN, port against the JAX package.

Module: one local step of the sweep (a D step on real, then fake, through
two forwards, then a G step through the updated D) for 2 lanes with each
lane's ``kd1, kd2`` injected, against the reference's ``_local_sweep`` at
one step (its ``d_loss_fn`` / ``g_loss_fn``,
``cglgan_tpu/algos/fedavg_family.py:112-121``).

The slice as a whole: 4 workers with 32x32 images and batch 4 start from
the JAX ``init_state()`` carried across by ``utils/transplant.py`` and run
2 rounds on each side with the reference's draws injected into the port's
``round_fn``: the window starts and latents
(``benchmarks/trajectory_parity.py`` ``flgan_round_streams``), each lane's
``kd1, kd2`` a local step as threefry key data at slots 3 and 4 (so every
Dropout2d mask is the reference's) and, with dropout, the survival draw at
slot 5.  Cases: FL-GAN on the ragged "epochs" sweep (shard lengths 4, 8,
8 and 4: 1 and 2 local steps a lane; the JAX runner takes its two
step-count buckets, the port one masked sweep), FL-GAN with
``dropout_rate=0.5``, FeGAN at ``frac_workers=1.0`` (full width, the conv
D's BatchNorm buffers per worker) and at 0.5 (gather mode, ragged lanes).
Then FeGAN's ``gen`` and ``sample`` (its eval G on the untrained init BN)
and its per-worker D BatchNorm carried over both ways; and the port's
float32 rounds against its own float64 rounds, the measured cause of the
wider limits below.  The reference's
round and local step are jitted once a config; its init and eval forwards
are compiled at XLA's backend optimization level 0.  TF32 is off and torch
runs on one thread.
"""
import functools

import jax
import numpy as np
import optax
import pytest
import torch

from benchmarks.trajectory_parity import flgan_round_streams
from cglgan_tpu.algos import common as jcommon
from cglgan_tpu.algos import fedavg_family as jfedavg
from cglgan_tpu.algos.registry import build_runner as jax_build_runner
from cglgan_tpu.core import prng as jprng
from cglgan_tpu.core.config import FedGANConfig as JaxConfig
from cglgan_tpu.data.partition import Partition as JaxPartition
from cglgan_tpu.models import zoo as jzoo
from cglgan_tpu_torch.algos import common, fedavg_family
from cglgan_tpu_torch.algos.registry import build_runner
from cglgan_tpu_torch.core.config import FedGANConfig
from cglgan_tpu_torch.data.partition import Partition
from cglgan_tpu_torch.models import zoo
from cglgan_tpu_torch.ops import fused_sweep
from cglgan_tpu_torch.utils.transplant import from_jax_numpy, to_numpy
from cglgan_tpu_torch.utils.tree import tree_leaves, tree_map
# the conv file's helpers and tolerances, and its autouse fixture (TF32
# off)
from test_torch_port_conv import (LR, TOL_FWD, TOL_METRIC,  # noqa: F401
                                  _close, _close_net, _jit, _no_tf32,
                                  _noisy_leaves, _port, _t)
from test_torch_port_threads import one_torch_thread  # noqa: F401

ROUNDS = 2
NW, L, B, DIN = 4, 12, 4, 1024
STEPS = 2                        # the largest local step count of a lane

# Tolerances: those of tests/test_torch_port_conv.py (its ``_close_net``),
# but for one measured cause.  A G BatchNorm output that feeds a LeakyReLU
# within float32 rounding of 0 takes slope 1 on one side and 0.2 on the
# other, that channel's gradient moves by a few percent, and Adam, whose
# step is ~lr whatever a gradient's size, turns a gradient element near 0
# into a step of the other sign.  A lane takes several G steps a round and
# the rounds average them, so this compounds: the port in float32 against
# itself in float64 (``test_conv_fedavg_float32_against_float64``, lanes of
# 1 to 3 steps) misses the conv file's bounds on 5.4% of the G's moments
# after round 2 and parts by 0.017 of their group's largest entry.  So, as
# tests/test_torch_port_fedavg_image.py's ``FLIPPED`` cases: params within
# two lr (an Adam step of either sign) a local step, Adam moments within
# ``TOL_FLIP_MOMENT`` of their group's largest entry, and ``FLIP_SHARE`` of
# a net's elements of one kind may miss the conv file's bounds.  Measured
# against JAX, the largest share of a net's elements of one kind that
# missed them: after the local step and round 1 at most 0.08% (the G),
# after round 2 8.2% (FeGAN gather mode, the G; FL-GAN 6.5%, FeGAN at full
# width 3.2%, FL-GAN with dropout 0.41%, the D at most 0.1%); the moments
# at most 0.0013 of their group's largest entry after round 1 and 0.034
# after round 2 (FeGAN gather mode, the G).
FLIP_SHARE = (0.01, 0.1)
TOL_FLIP_MOMENT = 0.05

CASES = {
    # id: (algo, shard lengths (local steps ceil(length / B)), config
    # fields); the ragged cases take 1 and 2 steps a lane, the others 1
    "flgan_ragged": ("flgan", (4, 8, 8, 4), {}),
    "flgan_dropout": ("flgan", (4, 4, 4, 4), dict(dropout_rate=0.5)),
    "fegan_full": ("fegan", (4, 4, 4, 4), dict(frac_workers=1.0)),
    "fegan_gather": ("fegan", (4, 8, 8, 4), dict(frac_workers=0.5)),
}


def _fields(lengths):
    rng = np.random.default_rng(0)
    data = rng.integers(0, 256, (NW, L, DIN)).astype(np.uint8)
    class_freq = rng.integers(1, 6, (NW, 10)).astype(np.int64)
    return (data, np.zeros((NW, L), np.int32), np.asarray(lengths, np.int32),
            class_freq, np.zeros((10, DIN), np.uint8))


def _config(case):
    algo, _, extra = CASES[case]
    kw = dict(algo=algo, dataset="synthetic-mnist", conv=True,
              num_workers=NW, num_class=10, iid=1, batch_size=B,
              num_communication=8, **extra)
    return JaxConfig(**kw), FedGANConfig(**kw)


@functools.partial(jax.jit, static_argnums=(1, 2))
def _step_keys(key, workers, steps):
    """Every lane's step keys split four ways, (W, steps, 4): ``kzd, kzg,
    kdrop1, kdrop2`` of ``split(split(key, W)[w], steps)[i]``, as the
    reference's sweep splits them (``cglgan_tpu/algos/fedavg_family.py:
    128,153,237``)."""
    return jax.vmap(lambda kw: jax.vmap(lambda ks: jax.random.split(ks, 4))(
        jax.random.split(kw, steps)))(jax.random.split(key, workers))


def _dropout_keys(root, cfg, steps):
    """Each lane's ``(kd1, kd2)`` for round t, (W, steps, 2) key data each:
    the ``kdrop1, kdrop2`` of its step keys."""
    def at(t):
        key = jprng.for_round(jprng.for_role(root, jprng.ROLE_LOCAL), t)
        data = np.asarray(jax.random.key_data(
            _step_keys(key, cfg.num_workers, steps))).astype(np.int64)
        return _t(data[:, :, 2]), _t(data[:, :, 3])
    return at


def _survival_draw(jcfg, t):
    """FL-GAN's round-t Bernoulli(1 - dropout_rate) draw (``fold_in(key,
    7)`` of its round key, ``cglgan_tpu/algos/fedavg_family.py:278``)."""
    key = jprng.for_round(jprng.for_role(jprng.root_key(jcfg.seed),
                                         jprng.ROLE_LOCAL), t)
    return _t(np.asarray(jax.random.bernoulli(
        jax.random.fold_in(key, 7), 1.0 - jcfg.dropout_rate, (NW,))))


# ---------------------------------------------------------------------------
# one local step
# ---------------------------------------------------------------------------

def _close_lanes(got, jnet, net, steps, share):
    """``_close_net`` at two lr a local step, then every Adam moment within
    TOL_FLIP_MOMENT of its group's largest entry.  Returns the largest
    share that missed the conv file's bounds and the largest moment error
    over its group's scale."""
    noisy = _noisy_leaves("flgan")[net == "d"]
    worst = _close_net(got, jnet, net, *noisy, steps=2 * steps,
                       flat=np.asarray, share=share)
    worst_m = 0.0
    for kind in ("mu", "nu"):
        refs = jax.tree.leaves(getattr(jnet.opt[0], kind))
        group = max(float(np.abs(x).max()) for x in refs)
        worst_m = max(worst_m, max(float(np.abs(a - b).max()) for a, b in
                                   zip(tree_leaves(got[kind]), refs))
                      / group)
    assert worst_m <= TOL_FLIP_MOMENT, (net, worst_m)
    return worst, worst_m


def _jax_init(jrun, algo):
    """The reference's init, jitted once an algorithm (it depends on the
    config's nets and W only)."""
    if algo not in _JAX_INIT:
        _JAX_INIT[algo] = jax.tree.map(np.asarray, _jit(jrun.init_state))
    return _JAX_INIT[algo]


_JAX_INIT = {}


def test_conv_local_step_matches_reference():
    """2 lanes from the broadcast FL-GAN init, each with its own BN
    buffers (moved off 0 / 1), shard and step key, take one D step and one
    G step with the reference's ``kd1, kd2``: losses, params, BN buffers,
    moments and counts."""
    n = 2
    jcfg, cfg = _config("flgan_ragged")
    fields = _fields(CASES["flgan_ragged"][1])
    jrun = jax_build_runner(jcfg, JaxPartition(*fields))
    init = _jax_init(jrun, "flgan")
    g_model, d_model = zoo.models_for_config(cfg)
    jg, jd = jzoo.models_for_config(jcfg)
    opt = optax.adam(LR, b1=0.5, b2=0.999)
    jsweep = jfedavg._local_sweep(jcfg, jg, jd, jcommon.make_adv_loss("raw"),
                                  opt, opt)
    rng = np.random.default_rng(4)
    lanes = lambda tree: jax.tree.map(lambda v: np.broadcast_to(
        v, (n,) + v.shape) + np.abs(rng.normal(size=(n,) + v.shape))
        .astype(np.float32) * 0.1, tree)
    gbn, dbn = lanes(init.g.bn), lanes(init.d.bn)
    first = lambda tree: jax.tree.map(lambda v: v[:n], tree)
    gopt, dopt = first(init.g.opt), first(init.d.opt)
    shards = fields[0][:n]
    key = jax.random.key(5)
    starts = np.asarray([3])

    def worker(gp, gbn, gopt, dp, dbn, dopt, shard, k):
        return jsweep(gp, gbn, gopt, dp, dbn, dopt, shard, starts, 1, 1, k)
    ref, ref_dl, ref_gl = jax.jit(jax.vmap(
        worker, in_axes=(None, 0, 0, None, 0, 0, 0, 0)))(
        init.g.params, gbn, gopt, init.d.params, dbn, dopt, shards,
        jax.random.split(key, n))

    # the lanes' draws from their keys, as the reference's step makes them
    parts = _step_keys(key, n, 1)                          # (n, 1, 4)
    z1, z2 = (_t(np.asarray(jax.vmap(jax.vmap(lambda k: jax.random.normal(
        k, (B, 100))))(parts[:, :, j]))) for j in (0, 1))
    kd1, kd2 = (_t(np.asarray(jax.random.key_data(parts[:, :, j]))
                   .astype(np.int64)) for j in (2, 3))

    sweep = fedavg_family._local_sweep(cfg, g_model, d_model,
                                       common.make_adv_loss("raw"))
    bcast = lambda tree: tree_map(lambda x: x.unsqueeze(0).expand(
        (n,) + tuple(x.shape)), _port(tree))
    net = lambda jn, bn, o: common.NetState(
        bcast(jn.params), _port(bn), common.AdamState(
            _t(o[0].count).to(torch.int64), _port(o[0].mu),
            _port(o[0].nu)))
    g, d, d_loss, g_loss = sweep(
        net(init.g, gbn, gopt), net(init.d, dbn, dopt), _t(shards), starts,
        z1, z2, np.ones(n, np.int32), keys=(kd1, kd2))
    np.testing.assert_allclose(d_loss.numpy(), np.asarray(ref_dl), rtol=0,
                               atol=TOL_METRIC)
    np.testing.assert_allclose(g_loss.numpy(), np.asarray(ref_gl), rtol=0,
                               atol=TOL_METRIC)
    ref = jax.tree.map(np.asarray, ref)
    for mine, (p, s, o), what in ((g, ref[:3], "g"), (d, ref[3:], "d")):
        got = tree_map(lambda x: x.numpy(), {
            "params": mine.params, "bn": mine.bn, "count": mine.opt.count,
            "mu": mine.opt.mu, "nu": mine.opt.nu})
        _close_lanes(got, jcommon.NetState(p, s, o), what, 1, FLIP_SHARE[0])


# ---------------------------------------------------------------------------
# the slice as a whole: 2 shrunk conv rounds against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", sorted(CASES))
def test_conv_fedavg_rounds_match_jax(case):
    algo, lengths, extra = CASES[case]
    jcfg, cfg = _config(case)
    fields = _fields(lengths)
    assert not fused_sweep.eligible(cfg)        # conv: autograd, as JAX
    steps = jfedavg._local_steps(jcfg, fields[2])
    assert steps.max() <= STEPS
    assert (len(set(steps.tolist())) > 1) == case.endswith(("ragged",
                                                            "gather"))
    jrun = jax_build_runner(jcfg, JaxPartition(*fields))
    jstate = _jax_init(jrun, algo)
    jround = jax.jit(jrun.round_fn)
    root = jprng.root_key(jcfg.seed)
    draw = flgan_round_streams(root, jcfg, L, int(steps.max()))
    keys = _dropout_keys(root, jcfg, int(steps.max()))
    run = build_runner(cfg, Partition(*fields), device="cpu")
    state = from_jax_numpy(jstate, cfg, "cpu")
    launched, dropped = fused_sweep.launches, 0
    for t in range(ROUNDS):
        starts, z1, z2 = draw(t)
        streams = (starts, _t(z1), _t(z2), *keys(t))
        if cfg.dropout_rate > 0:
            streams += (_survival_draw(jcfg, t),)
            dropped += int((~streams[5]).sum())
        jstate, jm = jround(jstate)
        state, m = run.round_fn(state, streams)
        assert set(m) == set(jm)
        for key in jm:
            assert abs(float(m[key]) - float(jm[key])) < TOL_METRIC, \
                (t, key, float(m[key]), float(jm[key]))
        got = to_numpy(state)
        ref = jax.tree.map(np.asarray, jstate)
        assert got["t"] == int(ref.t) == t + 1 and got["lam"] is None
        for net in ("g", "d"):
            _close_lanes(got[net], getattr(ref, net), net,
                         (t + 1) * int(steps.max()), FLIP_SHARE[t])
    assert fused_sweep.launches == launched
    if extra.get("dropout_rate"):
        assert dropped > 0                  # the draws dropped someone
    if algo == "fegan":
        # the D's BatchNorm buffers per worker, carried over both ways
        back = to_numpy(from_jax_numpy(ref, cfg, "cpu"))
        for a, b in zip(tree_leaves(back["d"]["bn"]),
                        jax.tree.leaves(ref.d.bn)):
            assert a.shape[0] == NW
            np.testing.assert_array_equal(a.view(np.uint32),
                                          np.asarray(b).view(np.uint32))
    if case == "fegan_gather":
        # serving: FeGAN's eval G runs on the untrained init BN
        carried = from_jax_numpy(ref, cfg, "cpu")
        z = np.random.default_rng(1).normal(size=(4, 100)) \
            .astype(np.float32)
        _close(run.gen(carried, _t(z)).numpy(), _jit(jrun.gen, jstate, z),
               TOL_FWD, "gen")
        _close(run.sample(carried, 4).numpy(),
               _jit(lambda s: jrun.sample(s, 4), jstate), TOL_FWD, "sample")


def test_conv_fedavg_float32_against_float64(monkeypatch):
    """The cause of the wider limits, on the port alone: FL-GAN conv rounds
    in float32 against the same rounds in float64, from the JAX init and
    draws, with lanes of 1, 2, 3 and 3 local steps (shard lengths 4, 8, 12
    and 10).  The float32 rounds hold the wider limits against the float64
    ones, and the share of the G's moments that misses the conv file's
    bounds after round 2 is measured beside ``FLIP_SHARE``."""
    lengths, steps = (4, 8, 12, 10), 3
    jcfg, cfg = _config("flgan_ragged")
    fields = _fields(lengths)
    jstate = _jax_init(jax_build_runner(jcfg, JaxPartition(*fields)),
                       "flgan")
    root = jprng.root_key(jcfg.seed)
    draw = flgan_round_streams(root, jcfg, L, steps)
    keys = _dropout_keys(root, jcfg, steps)
    run32 = build_runner(cfg, Partition(*fields), device="cpu")
    monkeypatch.setattr(fedavg_family, "torch_dtype",
                        lambda _: torch.float64)
    run64 = build_runner(cfg, Partition(*fields), device="cpu")
    wide = lambda tree: tree_map(lambda x: x.double(), tree)
    as64 = lambda n: common.NetState(wide(n.params), wide(n.bn),
                                     common.AdamState(n.opt.count,
                                                      wide(n.opt.mu),
                                                      wide(n.opt.nu)))
    s32 = from_jax_numpy(jstate, cfg, "cpu")
    s64 = s32._replace(g=as64(s32.g), d=as64(s32.d))
    for t in range(ROUNDS):
        starts, z1, z2 = draw(t)
        s32, _ = run32.round_fn(s32, (starts, _t(z1), _t(z2), *keys(t)))
        s64, _ = run64.round_fn(s64, (starts, _t(z1).double(),
                                      _t(z2).double(), *keys(t)))
        got, ref = to_numpy(s32), to_numpy(s64)
        for net in ("g", "d"):
            r = ref[net]
            ref_net = jcommon.NetState(r["params"], r["bn"], (
                optax.ScaleByAdamState(r["count"], r["mu"], r["nu"]),))
            _close_lanes(got[net], ref_net, net, (t + 1) * steps,
                         FLIP_SHARE[t])

"""The conv LSGAN pair in bfloat16 (``conv=True, dtype="bfloat16"``), port
against the JAX package, on the CPU.

Modules: ``core/dtypes.mean`` / ``var`` over the image axes (0, 2, 3)
bit-equal to ``jnp.mean`` / ``jnp.var`` of bf16; ``nn.batchnorm2d`` in
bf16 (train and eval) against the reference's ``batchnorm`` on 4-D inputs;
the conv G, conv Mix-G and conv D forwards in bf16 on weights carried over
from a JAX bf16 init (3 stacked members, dropout keys injected);
``utils/transplant.py`` on the conv bf16 trees, bit for bit both ways.

The slice as a whole: CAP-GAN (a single-path conv G) and Mix-G (the conv
Mix-G, DCGAN init) in bf16, 4 clients on 2 servers, 32x32 images, batch
4, start from the JAX ``init_state()`` carried across and run 2 rounds on
each side with the reference's bf16 draws injected (the latents drawn in
bf16 as the reference draws them, each server's ``(k_d, k_drop)`` as
threefry key data), ``segema > 0`` (tests/test_torch_port_cgl.py: the
jitted reference round departs from its eager run at segema 0).  A cloud
sync fires at round 0.  Then ``gen`` on bf16 latents and ``sample``.

Tolerances: those of the bf16 MLP rounds (tests/test_torch_port_bf16.py,
``TOL_STEPS``, ``TOL_MOMENT``, ``TOL_METRIC``), except where named below
with the cause measured.  The reference's jitted functions are compiled at
XLA's backend optimization level 0 (the same HLO in a third of the compile
time).  TF32 is off and torch runs on one thread.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from cglgan_tpu.algos.registry import build_runner as jax_build_runner
from cglgan_tpu.core import prng as jprng
from cglgan_tpu.core.config import FedGANConfig as JaxConfig
from cglgan_tpu.models import nn as jnn
from cglgan_tpu.models import zoo as jzoo
from cglgan_tpu_torch.algos.registry import build_runner
from cglgan_tpu_torch.algos.runner import train
from cglgan_tpu_torch.core import dtypes, threefry
from cglgan_tpu_torch.core.config import FedGANConfig
from cglgan_tpu_torch.evalx.evaluator import make_evaluator
from cglgan_tpu_torch.models import nn, zoo
from cglgan_tpu_torch.ops import fused_dstep
from cglgan_tpu_torch.utils.transplant import (from_jax_numpy,
                                               tensor_from_numpy, to_numpy)
from cglgan_tpu_torch.utils.tree import tree_leaves, tree_map
# the bf16 file's helpers and round limits; the conv file's partition,
# dropout keys and autouse fixture (TF32 off)
from test_torch_port_bf16 import (TOL_METRIC, TOL_MOMENT, TOL_STEPS,
                                  _bits, _cgl_streams, _pair, _spacing)
from test_torch_port_conv import (B, LR, NW, S, _dropout_keys,  # noqa: F401
                                  _key_data, _no_tf32, _partition,
                                  _paths, _t)
from test_torch_port_threads import one_torch_thread  # noqa: F401

BF = ml_dtypes.bfloat16
ROUNDS = 2
TOL_FWD_STEPS = 2      # a forward: bf16 steps at its output's largest entry


def _jit(fn, *args, fast: bool = True):
    """``jax.jit(fn)`` lowered on ``args`` and compiled, at XLA's backend
    optimization level 0 when ``fast`` (the same HLO in a third of the
    compile time, but bf16 runs unoptimized: a FedAvg conv round takes
    40 s there, 3 s at the default level)."""
    lowered = jax.jit(fn).lower(*args)
    return lowered.compile({"xla_backend_optimization_level": 0}) if fast \
        else lowered.compile()


def _port(tree):
    """A JAX tree of bf16 (or other) arrays as the port's tensors, bit for
    bit."""
    return tree_map(lambda x: tensor_from_numpy(x, "cpu"),
                    jax.tree.map(np.asarray, tree))


def _steps_apart(got, ref) -> float:
    """max |got - ref| in bf16 steps at ``ref``'s largest entry."""
    a = got.float().numpy() if isinstance(got, torch.Tensor) else \
        np.asarray(got, np.float32)
    r = np.asarray(ref, np.float32)
    assert a.shape == r.shape, (a.shape, r.shape)
    return float(np.abs(a - r).max()) / _spacing(float(np.abs(r).max()))


# ---------------------------------------------------------------------------
# core/dtypes and nn.batchnorm2d
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(25, 8, 16, 16), (4, 128, 8, 8),
                                   (7, 3, 5, 9)])
def test_mean_var_image_axes_bit_equal(shape):
    """``dtypes.mean`` / ``dtypes.var`` of 4-D bf16 over (0, 2, 3): summed
    in float32 and rounded once, bit-equal to ``jnp.mean`` / ``jnp.var``;
    one axis and a negative one as well.  In float32 they are torch's own
    mean and the biased variance."""
    rng = np.random.default_rng(sum(shape))
    jx, tx = _pair(rng.normal(size=shape) * 3 + 0.7)
    for axes in ((0, 2, 3), (0,), (1, -1)):
        m = dtypes.mean(tx, axes)
        assert m.dtype == torch.bfloat16
        np.testing.assert_array_equal(_bits(m),
                                      _bits(jnp.mean(jx, axis=axes)))
        np.testing.assert_array_equal(_bits(dtypes.var(tx, axes, m)),
                                      _bits(jnp.var(jx, axis=axes)))
    x32 = tx.float()
    m32 = dtypes.mean(x32, (0, 2, 3))
    torch.testing.assert_close(dtypes.var(x32, (0, 2, 3), m32),
                               x32.var(dim=(0, 2, 3), unbiased=False))


@pytest.mark.parametrize("train", [True, False])
def test_batchnorm2d_bf16_matches(train):
    """BatchNorm2d of 2 members of 8 channels on the grouped layout, B=25 at
    16x16: B*H*W = 6 400 and 6 399 rounds to 6 400 in bf16, so the
    unbiased factor is 1 (weak count and count - 1).  The new running
    stats are bit-equal to the reference's ``batchnorm`` a member; the
    output is bit-equal on every channel whose inverse std,
    rsqrt(var + eps) in bf16, is (XLA's float32 rsqrt is not correctly
    rounded: tests/test_torch_port_bf16.py ``test_batchnorm_bf16_matches``)
    and within 2 bf16 steps at its largest entry everywhere."""
    rng = np.random.default_rng(4)
    n, b, c, h = 2, 25, 8, 16
    x = rng.normal(size=(n, b, c, h, h)) * 2 + 0.5
    jx, tx = _pair(x)
    pp = {k: _pair(v) for k, v in (
        ("scale", 1 + 0.1 * rng.normal(size=(n, c))),
        ("bias", 0.1 * rng.normal(size=(n, c))))}
    ss = {k: _pair(v) for k, v in (
        ("mean", 0.1 * rng.normal(size=(n, c))),
        ("var", 1 + 0.1 * np.abs(rng.normal(size=(n, c)))))}
    ref_y, ref_s = jax.vmap(lambda p, s, xx: jnn.batchnorm(p, s, xx, train))(
        {k: v[0] for k, v in pp.items()}, {k: v[0] for k, v in ss.items()},
        jx)
    y, new_s = nn.batchnorm({k: v[1] for k, v in pp.items()},
                            {k: v[1] for k, v in ss.items()},
                            nn.to_groups(tx), train)
    y = nn.from_groups(y, n)
    assert y.dtype == torch.bfloat16
    for key in ("mean", "var"):
        assert new_s[key].dtype == torch.bfloat16
        np.testing.assert_array_equal(_bits(new_s[key]), _bits(ref_s[key]))
    if train:
        assert dtypes.weak(b * h * h - 1, torch.bfloat16) == b * h * h
    var_j = jnp.var(jx, axis=(1, 3, 4)) if train else ss["var"][0]
    inv_j = _bits(jax.lax.rsqrt(var_j + 0.8))
    var_t = dtypes.var(tx, (1, 3, 4), dtypes.mean(tx, (1, 3, 4))) \
        if train else ss["var"][1]
    inv_t = _bits(torch.rsqrt(var_t + dtypes.weak(0.8, var_t)))
    same = inv_t == inv_j                                       # (n, c)
    assert same.any()               # measured: 9 of the 16 channels
    mask = np.broadcast_to(same[:, None, :, None, None], y.shape)
    np.testing.assert_array_equal(_bits(y)[mask], _bits(ref_y)[mask])
    assert _steps_apart(y, ref_y) <= 2


# ---------------------------------------------------------------------------
# the conv models in bf16
# ---------------------------------------------------------------------------

def _init(model, keys):
    """The reference's bf16 init of one member a key, jitted (eager, its
    threefry draws take seconds op by op)."""
    init = jax.vmap(lambda kk: model.init(kk, jnp.bfloat16))
    return _jit(init, keys)(keys)


def _perturbed_bn(state, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda v: (v.astype(np.float32) + np.abs(
        rng.normal(size=v.shape)).astype(np.float32) * 0.1).astype(BF),
        jax.tree.map(np.asarray, state))


@pytest.mark.parametrize("family,train", [("conv", True), ("conv", False),
                                          ("conv-multipath", True),
                                          ("conv-multipath", False)])
def test_conv_generators_bf16_match(family, train):
    """Conv G and Mix-G (2 heads) in bf16 on 3 stacked members from the
    reference's bf16 init (BN stats moved off 0 / 1), bf16 latents: the
    outputs and new BN running stats are bf16 and within
    ``TOL_FWD_STEPS`` bf16 steps of the reference's at each one's largest
    entry."""
    n, k = 3, 2
    jg, g = jzoo.build_generator(family, k), zoo.build_generator(family, k)
    p, s = _init(jg, jax.random.split(jax.random.key(0), n))
    s = _perturbed_bn(s, 1)
    jz, tz = _pair(np.random.default_rng(2).normal(size=(n, B, 100)))
    fwd = jax.vmap(lambda pp, ss, zz: jg.apply(pp, ss, zz, train=train))
    ref_y, ref_s = _jit(fwd, p, s, jz)(p, s, jz)
    y, new_s = g.apply(_port(p), _port(s), tz, train=train)
    assert y.dtype == torch.bfloat16 and ref_y.dtype == jnp.bfloat16
    worst = _steps_apart(y, ref_y)
    ref_l = jax.tree.leaves(ref_s)
    assert len(tree_leaves(new_s)) == len(ref_l)
    for a, r in zip(tree_leaves(new_s), ref_l):
        assert a.dtype == torch.bfloat16
        worst = max(worst, _steps_apart(a, r))
    assert worst <= TOL_FWD_STEPS, worst
    # the port's own bf16 init from the same keys is the reference's, bit
    # for bit, in bf16
    gp, _ = g.init(threefry.split(threefry.key(0), n), torch.bfloat16)
    assert all(x.dtype == torch.bfloat16 for x in tree_leaves(gp))
    for a, b in zip(tree_leaves(gp), jax.tree.leaves(p), strict=True):
        np.testing.assert_array_equal(a.float().numpy(),
                                      np.asarray(b, np.float32))


@pytest.mark.parametrize("train,flat", [(True, True), (True, False),
                                        (False, True)])
def test_conv_discriminator_bf16_matches(train, flat):
    """The conv D in bf16 on 3 stacked members, flat (N, B, 1024) rows or
    (N, B, 1, 32, 32) images, each member's dropout key: the logits and
    the new BN running stats are bf16 and within ``TOL_FWD_STEPS`` bf16
    steps of the reference's at each one's largest entry."""
    n = 3
    jd, d = jzoo.build_discriminator("conv"), zoo.build_discriminator("conv")
    p, s = _init(jd, jax.random.split(jax.random.key(1), n))
    s = _perturbed_bn(s, 4)
    x = np.random.default_rng(5).uniform(-1, 1, (n, B, 1024))
    if not flat:
        x = x.reshape(n, B, 1, 32, 32)
    jx, tx = _pair(x)
    keys = jax.random.split(jax.random.key(6), n)
    fwd = jax.vmap(lambda pp, ss, xx, kk: jd.apply(pp, ss, xx, train=train,
                                                   rng=kk))
    ref_y, ref_s = _jit(fwd, p, s, jx, keys)(p, s, jx, keys)
    y, new_s = d.apply(_port(p), _port(s), tx, train=train,
                       rng=_key_data(keys))
    assert tuple(y.shape) == (n, B, 1) and y.dtype == torch.bfloat16
    worst = _steps_apart(y, ref_y)
    for a, r in zip(tree_leaves(new_s), jax.tree.leaves(ref_s)):
        worst = max(worst, _steps_apart(a, r))
    assert worst <= TOL_FWD_STEPS, worst


# ---------------------------------------------------------------------------
# transplant
# ---------------------------------------------------------------------------

def _config(algo, **kw):
    kw = dict(algo=algo, dataset="synthetic-mnist", conv=True,
              num_workers=NW, num_servers=S, iid=1, batch_size=B,
              dtype="bfloat16", **kw)
    return JaxConfig(**kw), FedGANConfig(**kw)


_JAX_INIT = {}


def _jax_init(jrun, algo):
    if algo not in _JAX_INIT:
        init = _jit(jrun.init_state)
        _JAX_INIT[algo] = jax.tree.map(np.asarray, init())
    return _JAX_INIT[algo]


@pytest.mark.parametrize("algo", ["capgan", "mixgan"])
def test_conv_transplant_bf16_bit_exact(algo):
    """The reference's bf16 conv FedState (CAP-GAN: the conv G; Mix-G: the
    conv Mix-G; both the conv D, the BN state, the Adam moments) crosses
    to the port and back bit for bit: every float leaf bf16, Lambda
    float32, counts int."""
    jcfg, cfg = _config(algo)
    jpart, _ = _partition()
    ref = _jax_init(jax_build_runner(jcfg, jpart), algo)
    state = from_jax_numpy(ref, cfg, "cpu")
    assert all(x.dtype == torch.bfloat16 for x in tree_leaves(
        (state.g.params, state.g.bn, state.g.opt.mu, state.d.params,
         state.d.bn, state.d.opt.nu)))
    assert state.lam.dtype == torch.float32
    got = to_numpy(state)
    pairs = [(got["g"]["params"], ref.g.params), (got["g"]["bn"], ref.g.bn),
             (got["g"]["mu"], ref.g.opt[0].mu),
             (got["d"]["params"], ref.d.params), (got["d"]["bn"], ref.d.bn),
             (got["d"]["nu"], ref.d.opt[0].nu)]
    n = 0
    for mine, theirs in pairs:
        for a, b in zip(tree_leaves(mine), jax.tree.leaves(theirs)):
            assert a.dtype == BF and b.dtype == BF
            np.testing.assert_array_equal(a.reshape(-1).view(np.uint16),
                                          b.reshape(-1).view(np.uint16))
            n += 1
    assert n == sum(len(jax.tree.leaves(t)) for _, t in pairs)
    w = got["g"]["params"]["trunk"]["c1"]["w"] if algo == "mixgan" \
        else got["g"]["params"]["c1"]["w"]
    assert w.shape == (S, 128, 128, 3, 3)


# ---------------------------------------------------------------------------
# the slice as a whole: 2 shrunk bf16 conv rounds against JAX
# ---------------------------------------------------------------------------

ROUND_CASES = {
    # id: (algo, epoch, segema)
    "capgan": ("capgan", 1, 0.5),
    "mixgan": ("mixgan", 1, 0.25),
}


# Tolerances of the rounds: tests/test_torch_port_bf16.py's (params and BN
# state within TOL_STEPS bf16 steps at a leaf's largest entry plus 3 lr for
# every Adam step; Adam moments within TOL_MOMENT of their group's largest
# entry; metrics and Lambda TOL_METRIC), with one wider limit.  The
# moments of the conv biases and of the D's ``adv`` bias (8 leaves in a
# conv G / D pair) are held to TOL_BIAS_MOMENT of their group's largest
# entry.  Their gradient is a sum over the batch and every pixel (4 096
# terms a member for the G's last conv at B=4), XLA on the CPU sums a
# broadcast's gradient in bf16 (the port in float32:
# test_xla_cpu_sums_bias_gradients_in_bf16), and behind a BatchNorm or the
# D's last layers the terms cancel, so the two sums part by far more than a
# step.  Measured against JAX over the six round cases of the three conv
# bf16 files: 3 of the 8 (the G's c3 bias, the D's c4 and adv biases) miss
# TOL_MOMENT in some case, up to 0.47 of their group's scale (FeGAN gather,
# the G's c3 bias); their params hold the bound above (a bf16 step near 0
# is tiny, so it is mostly its 3 lr a step).  Every other moment is within
# 0.139 of its group's scale (FeGAN gather after round 2, the G's c3
# weight).  The params closest to their limit: Mix-G's trunk BatchNorm
# scales (DCGAN init, near 1, where a bf16 step is 39 lr), 36 of 256 two
# steps apart after round 1 (0.96 of the limit).  XLA computes the round-0
# cloud sync's sigma mix with excess precision (its
# ``xla_allow_excess_precision``, on by default); with it off they agree
# exactly.
TOL_BIAS_MOMENT = 0.75


def _sum_biases(tree):
    """The paths of the conv biases and the D's adv bias: every ``b`` but
    the G's ``l1`` bias."""
    return {p for p in _paths(tree) if p[-1] == "b" and p[-2] != "l1"}


def _close_bf16(got, jnet, net, t, adam_steps, flat):
    """The port's net (``to_numpy(..., bf16="float32")``) against the
    reference's ``jnet``, whose leaves ``flat`` lays out as the port's:
    the Adam counts equal, params and BN state within TOL_STEPS bf16 steps
    at each leaf's largest entry plus 3 lr an Adam step, moments within
    TOL_MOMENT (the sum biases TOL_BIAS_MOMENT) of their group's largest
    entry.  Returns the largest share of each kind's limit used, by
    kind, and of the sum biases' moments (``"bias"``)."""
    later = int(t > 0)
    jadam = jnet.opt[0]
    np.testing.assert_array_equal(
        got["count"], flat(jadam.count).reshape(-1).astype(np.int64))
    biases = _sum_biases(got["params"])
    used = {}
    for kind, ref_tree in (("params", jnet.params), ("bn", jnet.bn),
                           ("mu", jadam.mu), ("nu", jadam.nu)):
        mine, paths = tree_leaves(got[kind]), _paths(got[kind])
        refs = [np.asarray(flat(x), np.float32)
                for x in jax.tree.leaves(ref_tree)]
        assert len(mine) == len(refs) == len(paths)
        scale = max(float(np.abs(x).max()) for x in refs)
        for path, a, b in zip(paths, mine, refs):
            assert a.shape == b.shape, (net, kind, path)
            err = float(np.abs(a - b).max())
            if kind in ("params", "bn"):
                limit = TOL_STEPS[later] * _spacing(float(np.abs(b).max())) \
                    + 3 * LR * adam_steps
                key = kind
            elif path in biases:
                limit, key = TOL_BIAS_MOMENT * scale, "bias"
            else:
                limit, key = TOL_MOMENT[later] * scale, kind
            assert err <= limit, (t, net, kind, path, err, limit)
            used[key] = max(used.get(key, 0.0), err / limit)
    return used


def _stacked(n):
    """The reference's D state (S, k, ...) flattened to the port's (n,
    ...)."""
    return lambda x: np.asarray(x).reshape((n,) + np.shape(x)[2:])


@pytest.mark.parametrize("case", sorted(ROUND_CASES))
def test_conv_bf16_rounds_match_jax(case):
    """2 rounds of CAP-GAN and Mix-G conv in bf16 from the reference's
    init on its bf16 draws: metrics and Lambda within TOL_METRIC, each
    net within ``_close_bf16``'s limits after each round, every leaf still
    bf16; then ``gen`` on the reference's final state and bf16 latents
    within TOL_FWD_STEPS of the reference's, and ``sample`` (the float32
    eval draws through the bf16 G) bf16 of shape (4, 1, 32, 32)."""
    algo, epoch, segema = ROUND_CASES[case]
    jcfg, cfg = _config(algo, epoch=epoch, E=0, cloud_epoch=2,
                        segema=segema, num_communication=10)
    jpart, part = _partition()
    assert not fused_dstep.eligible(cfg)
    jrun = jax_build_runner(jcfg, jpart)
    jstate = _jax_init(jrun, algo)
    jround = _jit(jrun.round_fn, jstate)
    root = jprng.root_key(jcfg.seed)
    draw, keys = _cgl_streams(root, jcfg, jpart.data.shape[1]), \
        _dropout_keys(root, jcfg)
    run = build_runner(cfg, part, device="cpu")
    state = from_jax_numpy(jstate, cfg, "cpu")
    launched = fused_dstep.launches
    for t in range(ROUNDS):
        starts, z_d, z_g = draw(t)
        k_d, k_drop = keys(t)
        jstate, jm = jround(jstate)
        state, m = run.round_fn(state, (starts, z_d, z_g, _t(k_d),
                                        _t(k_drop)))
        assert set(m) == set(jm)
        for key in jm:
            assert m[key].dtype == torch.float32
            assert abs(float(m[key]) - float(jm[key])) < TOL_METRIC, \
                (t, key, float(m[key]), float(jm[key]))
        got = to_numpy(state, bf16="float32")
        ref = jax.tree.map(np.asarray, jstate)
        np.testing.assert_allclose(got["lam"], ref.lam, rtol=0,
                                   atol=TOL_METRIC)
        _close_bf16(got["g"], ref.g, "g", t, t + 1, np.asarray)
        _close_bf16(got["d"], ref.d, "d", t, (t + 1) * epoch, _stacked(NW))
    assert fused_dstep.launches == launched
    assert all(x.dtype == torch.bfloat16 for x in tree_leaves(
        (state.g.params, state.g.bn, state.g.opt.mu, state.d.params,
         state.d.bn, state.d.opt.nu)))
    # serving on the reference's final state
    carried = from_jax_numpy(ref, cfg, "cpu")
    jz, tz = _pair(np.random.default_rng(1).normal(size=(4, 100)))
    out = run.gen(carried, tz)
    assert out.dtype == torch.bfloat16
    assert _steps_apart(out, _jit(jrun.gen, jstate, jz)(jstate, jz)) \
        <= TOL_FWD_STEPS
    imgs = run.sample(carried, 4)
    assert tuple(imgs.shape) == (4, 1, 32, 32)
    assert imgs.dtype == torch.bfloat16 and bool(torch.isfinite(
        imgs.float()).all())


def test_conv_bf16_train_scores_ticks():
    """``train`` on a bf16 conv CGL-GAN run with the image evaluator: every
    tick has a finite FID and IS.  The samples are bf16 (n, 1, 32, 32);
    the evaluator (float32, as the reference's) scores them upcast, which
    is exact: the same scores as for the samples in float32."""
    _, cfg = _config("cglgan")
    _, part = _partition()
    run = build_runner(cfg, part, device="cpu")
    evaluate = make_evaluator(cfg, part, eval_n=8, probe_steps=5,
                              device="cpu")
    out = train(run, rounds=2, eval_every=1, evaluator=evaluate)
    assert [t["round"] for t in out["history"]] == [1, 2]
    for tick in out["history"]:
        assert np.isfinite(tick["fid"]) and np.isfinite(
            tick["inception_score"])
    samples = run.sample(out["state"], 8)
    assert tuple(samples.shape) == (8, 1, 32, 32)
    assert samples.dtype == torch.bfloat16
    assert evaluate(run, out["state"], samples=samples) == \
        evaluate(run, out["state"], samples=samples.float())

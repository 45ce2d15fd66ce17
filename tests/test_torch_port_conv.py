"""The conv LSGAN family on the CGL family, port against the JAX package.

Modules: threefry's ``bernoulli`` (and ``bernoulli_parts``, four draws in
one pass) and ``nn.dropout2d``'s masks bit-equal to ``jax.random``; the
conv G, conv Mix-G (``conv-multipath``) and conv D train and eval
forwards and their BatchNorm running stats on weights carried over from a
JAX init (3 stacked members, batch 4, dropout keys injected); the D step
without the real/fake concat against the reference's
``common.d_step_fn(fuse_concat=False)``; ``load_partition``'s 28 -> 32 zero
pad.

The slice as a whole: CAP-GAN (S=2 single-path G), CGL-GAN (iid=1,
multipath) and Mix-G conv rounds, 4 clients on 2 servers, 32x32 images,
batch 4, at epoch 1 and 2, start from the JAX ``init_state()`` carried
across by ``utils/transplant.py`` and run 2 rounds on each side with the
reference's draws injected into the port's ``round_fn``: the window starts
and latents (``benchmarks/trajectory_parity.py`` ``cgl_round_streams``) and
each server's ``(k_d, k_drop)`` as threefry key data, so every Dropout2d
mask is the reference's.  A cloud sync fires at round 0.  segema > 0 (see
``tests/test_torch_port_cgl.py``: the jitted reference round departs from
its eager run at segema 0).  The reference's round is jitted once a
config; its one-shot forwards, D step, init and ``gen`` are compiled at
XLA's backend optimization level 0 (the same HLO, a third of the compile
time).  TF32 is off.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks.trajectory_parity import cgl_round_streams
from cglgan_tpu.algos import common as jcommon
from cglgan_tpu.algos.registry import build_runner as jax_build_runner
from cglgan_tpu.core import prng as jprng
from cglgan_tpu.core.config import FedGANConfig as JaxConfig
from cglgan_tpu.data.partition import Partition as JaxPartition
from cglgan_tpu.models import nn as jnn
from cglgan_tpu.models import zoo as jzoo
from cglgan_tpu_torch.algos import common, registry
from cglgan_tpu_torch.algos.registry import build_runner
from cglgan_tpu_torch.core import threefry
from cglgan_tpu_torch.core.config import FedGANConfig
from cglgan_tpu_torch.data.partition import Partition
from cglgan_tpu_torch.models import nn, zoo
from cglgan_tpu_torch.ops import fused_dstep
from cglgan_tpu_torch.utils.transplant import from_jax_numpy, to_numpy
from cglgan_tpu_torch.utils.tree import tree_leaves, tree_map
from test_torch_port_threads import one_torch_thread  # noqa: F401

ROUNDS = 2
NW, S, L, B, DIN = 4, 2, 24, 4, 1024
LENGTHS = np.asarray([20, 24, 22, 21], np.int32)
LR = 2e-4

# Tolerances.  Both sides are float32 on the CPU and sum in another order
# (a conv, a BatchNorm over B*H*W), so one forward agrees to ~1e-6 of its
# output's largest entry: held to 1e-5 of it ("of scale").  Rounds: params
# and BN buffers elementwise to (rtol, atol) = (1e-4, 1e-5), as
# tests/test_torch_port_cgl.py (atol 1e-4 of the unit scale of BN scales,
# 5% of one Adam step); Adam moments to 1e-4 of their group's largest
# entry; metrics 1e-5 absolute (losses ~0.7).  The BN-fed biases are bound
# by lr a local step instead (``_noisy_leaves``).  Adam turns the rounding
# of a near-zero gradient into a full step of either sign, and the D's
# BN-fed biases (apart by up to ~0.6 lr after a round) move the next
# round's gradients: a share of the elements miss those bounds, each still
# within lr a step, and round 2 compounds round 1's.  Measured, of a net's
# elements of one kind (params, BN buffers, each moment), from the jitted
# and the eager reference init (a few ulps apart, so other elements flip):
# after round 1 at most 53 of the G's 2.1 M params (0.003%); after round 2
# at most 3 215 of the G's params (0.15%, Mix-G at epoch 2, nearly all in
# the 1.6 M-element first linear layer) and 316 of the D's 392 452 (0.08%).
# ``FLIP_SHARE`` allows 0.1% after round 1 and 1% after round 2; the rest
# hold the bounds.
FLIP_SHARE = (0.001, 0.01)
TOL_FWD = 1e-5
TOL_PARAMS = (1e-4, 1e-5)
TOL_MOMENT = 1e-4
TOL_METRIC = 1e-5



@pytest.fixture(autouse=True)
def _no_tf32():
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = saved


def _t(x):
    return torch.from_numpy(np.array(x))


def _jit(fn, *args):
    """``jax.jit(fn)(*args)`` compiled at XLA's backend optimization level
    0: the same HLO in a third of the compile time."""
    return jax.jit(fn).lower(*args).compile(
        {"xla_backend_optimization_level": 0})(*args)


def _port(tree):
    return tree_map(_t, jax.tree.map(np.asarray, tree))


def _key_data(keys) -> torch.Tensor:
    return torch.from_numpy(np.asarray(jax.random.key_data(keys))
                            .astype(np.int64))


def _close(got, ref, tol, what):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(got - ref).max()) / scale
    assert err <= tol, (what, err)


def _partition(seed=0):
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 256, (NW, L, DIN)).astype(np.uint8)
    fields = (data, np.zeros((NW, L), np.int32), LENGTHS,
              np.zeros((NW, 10), np.int64), np.zeros((10, DIN), np.uint8))
    return JaxPartition(*fields), Partition(*fields)


# ---------------------------------------------------------------------------
# threefry.bernoulli and dropout2d
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,shape", [(0, (4, 16, 1, 1)),
                                        (20211212, (7, 3, 5))])
def test_bernoulli_bit_equal(seed, shape):
    """``bernoulli`` for one key and for a batch of keys, and
    ``bernoulli_parts`` (the conv D's four masks in one pass), equal
    ``jax.random.bernoulli`` element for element."""
    keys = jax.random.split(jax.random.key(seed), 3)
    for p in (0.75, 0.5, 0.1):
        ref = jax.vmap(lambda k: jax.random.bernoulli(k, p, shape))(keys)
        got = threefry.bernoulli(_key_data(keys), p, shape)
        assert got.dtype == torch.bool
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
        np.testing.assert_array_equal(
            threefry.bernoulli(_key_data(keys[0]), p, shape).numpy(),
            np.asarray(ref[0]))
    shapes = [(5, c, 1, 1) for c in (16, 32, 64, 128)]
    four = jax.vmap(lambda k: jax.random.split(k, 4))(keys)
    parts = threefry.bernoulli_parts(_key_data(four), 0.75, shapes)
    for j, s in enumerate(shapes):
        ref = jax.vmap(lambda k: jax.random.bernoulli(k, 0.75, s))(four[:, j])
        np.testing.assert_array_equal(parts[j].numpy(), np.asarray(ref))


def test_dropout2d_masks_bit_equal():
    """``nn.dropout2d`` on stacked members equals the reference's
    ``dropout2d`` a member: the same channels dropped, the kept ones scaled
    by 1/(1-rate) bit for bit; eval mode and rate 0 are the identity."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(3, 6, 8, 5, 5)).astype(np.float32)
    keys = jax.random.split(jax.random.key(11), 3)
    ref = jax.vmap(lambda k, xx: jnn.dropout2d(k, xx, 0.25, True))(keys, x)
    got = nn.dropout2d(_key_data(keys), _t(x), 0.25, True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    dropped = (np.asarray(ref) == 0).all(axis=(3, 4))
    assert 0 < dropped.mean() < 0.5
    for train, rate in ((False, 0.25), (True, 0.0)):
        assert nn.dropout2d(_key_data(keys), _t(x), rate, train) is not None
        np.testing.assert_array_equal(
            nn.dropout2d(_key_data(keys), _t(x), rate, train).numpy(), x)


# ---------------------------------------------------------------------------
# the conv models
# ---------------------------------------------------------------------------

def _perturbed_bn(state, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda v: v + np.abs(rng.normal(size=v.shape))
                        .astype(np.float32) * 0.1, state)


@pytest.mark.parametrize("family,train", [("conv", True), ("conv", False),
                                          ("conv-multipath", True),
                                          ("conv-multipath", False)])
def test_conv_generators_match(family, train):
    """Conv G and Mix-G (2 heads) on 3 stacked members: outputs (N, B, 1,
    32, 32) / (N, k, B, 1, 32, 32) and new BN running stats within 1e-5 of
    scale of the reference's, on its init with BN stats moved off 0 / 1."""
    n, k = 3, 2
    jg, g = jzoo.build_generator(family, k), zoo.build_generator(family, k)
    p, s = jax.vmap(lambda kk: jg.init(kk))(
        jax.random.split(jax.random.key(0), n))
    s = _perturbed_bn(s, 1)
    z = np.random.default_rng(2).normal(size=(n, B, 100)).astype(np.float32)
    ref_y, ref_s = _jit(jax.vmap(lambda pp, ss, zz: jg.apply(
        pp, ss, zz, train=train)), p, s, jnp.asarray(z))
    y, new_s = g.apply(_port(p), _port(s), _t(z), train=train)
    assert g.multipath == (family == "conv-multipath")
    _close(y.numpy(), ref_y, TOL_FWD, "y")
    ref_l = jax.tree.leaves(ref_s)
    assert len(tree_leaves(new_s)) == len(ref_l)
    for i, (a, b) in enumerate(zip(tree_leaves(new_s), ref_l)):
        _close(a.numpy(), b, TOL_FWD, f"bn leaf {i}")
    # the port's own init from the same keys is the reference's, bit for
    # bit, leaf for leaf
    gp, gbn = g.init(threefry.split(threefry.key(0), n))
    for a, b in zip(tree_leaves(gp), jax.tree.leaves(p), strict=True):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert [tuple(x.shape) for x in tree_leaves(gbn)] == \
        [tuple(np.shape(x)) for x in jax.tree.leaves(s)]


@pytest.mark.parametrize("train,flat", [(True, True), (True, False),
                                        (False, True)])
def test_conv_discriminator_matches(train, flat):
    """The conv D on 3 stacked members, flat (N, B, 1024) rows or (N, B, 1,
    32, 32) images, with each member's dropout key: logits (N, B, 1) and
    the new BN running stats within 1e-5 of scale of the reference's."""
    n = 3
    jd, d = jzoo.build_discriminator("conv"), zoo.build_discriminator("conv")
    p, s = jax.vmap(lambda kk: jd.init(kk))(
        jax.random.split(jax.random.key(1), n))
    s = _perturbed_bn(s, 4)
    x = np.random.default_rng(5).uniform(-1, 1, (n, B, DIN)) \
        .astype(np.float32)
    if not flat:
        x = x.reshape(n, B, 1, 32, 32)
    keys = jax.random.split(jax.random.key(6), n)
    ref_y, ref_s = _jit(jax.vmap(lambda pp, ss, xx, kk: jd.apply(
        pp, ss, xx, train=train, rng=kk)), p, s, jnp.asarray(x), keys)
    y, new_s = d.apply(_port(p), _port(s), _t(x), train=train,
                       rng=_key_data(keys))
    assert d.out_dim == 1 and tuple(y.shape) == (n, B, 1)
    _close(y.numpy(), ref_y, TOL_FWD, "logits")
    for i, (a, b) in enumerate(zip(tree_leaves(new_s),
                                   jax.tree.leaves(ref_s))):
        _close(a.numpy(), b, TOL_FWD, f"bn leaf {i}")


@pytest.mark.parametrize("half", [True, False])
def test_split_d_step_matches_reference(half):
    """One local D step without the real/fake concat: real through the D
    with ``r1``, fake with ``r2`` from the BN state the real forward left,
    loss ``bce_logits(out_r, 1) + bce_logits(out_f, 0)`` (halved for
    CAP/Mix), then Adam: loss, params, BN state and moments against the
    reference's ``d_step_fn(fuse_concat=False)`` vmapped over 3 clients."""
    import optax

    n = 3
    jd, d = jzoo.build_discriminator("conv"), zoo.build_discriminator("conv")
    opt = optax.adam(LR, b1=0.5, b2=0.999)
    p, s = jax.vmap(lambda kk: jd.init(kk))(
        jax.random.split(jax.random.key(2), n))
    jnet = jcommon.NetState(p, s, jax.vmap(opt.init)(p))
    rng = np.random.default_rng(7)
    shards = rng.integers(0, 256, (n, L, DIN)).astype(np.uint8)
    fake = rng.uniform(-1, 1, (n, B, 1, 32, 32)).astype(np.float32)
    keys = jax.random.split(jax.random.key(8), n)
    jstep = jcommon.d_step_fn(jd, jcommon.make_adv_loss("raw"), opt, B,
                              True, half, fuse_concat=False)
    ref_net, ref_loss = _jit(jax.vmap(jstep, in_axes=(0, 0, None, 0, 0)),
                             jnet, shards, 5, fake, keys)

    step = common.d_step_fn(d, common.make_adv_loss("raw"), LR, 0.5, 0.999,
                            B, True, half, fuse_concat=False)
    net = common.NetState(_port(p), _port(s),
                          common.adam_init(_port(p), n))
    new, loss = step(net, _t(shards), 5, _t(fake).reshape(n, B, DIN),
                     _key_data(keys))
    np.testing.assert_allclose(loss.numpy(), np.asarray(ref_loss), rtol=0,
                               atol=TOL_METRIC)
    got = {"params": new.params, "bn": new.bn, "count": new.opt.count,
           "mu": new.opt.mu, "nu": new.opt.nu}
    got = tree_map(lambda x: x.numpy(), got)
    _close_net(got, jax.tree.map(np.asarray, ref_net), "d",
               *_noisy_leaves("capgan")[1], steps=1, flat=np.asarray)


def test_load_partition_pads_28_to_32(monkeypatch):
    """With ``conv=True`` the 28x28 images are zero-padded 2 px a side to
    32x32 before partitioning (``cglgan_tpu/algos/registry.py:30-33``);
    without it they stay 28x28."""
    rng = np.random.default_rng(9)
    imgs = rng.integers(1, 256, (200, 28, 28)).astype(np.uint8)
    labels = np.repeat(np.arange(10), 20).astype(np.int64)
    monkeypatch.setattr(registry, "load_image_dataset",
                        lambda *a, **kw: (imgs, labels))
    cfg = FedGANConfig(algo="cglgan", dataset="synthetic-mnist",
                       num_workers=4, num_servers=2, iid=1, num_sample=20)
    flat = registry.load_partition(cfg)
    conv = registry.load_partition(cfg.replace(conv=True))
    assert flat.data.shape[2] == 28 * 28 and conv.data.shape[2] == 32 * 32
    assert flat.data.shape[:2] == conv.data.shape[:2]
    sq = conv.data.reshape(conv.data.shape[:2] + (32, 32))
    assert not sq[..., :2, :].any() and not sq[..., -2:, :].any()
    assert not sq[..., :, :2].any() and not sq[..., :, -2:].any()
    np.testing.assert_array_equal(
        sq[..., 2:30, 2:30].reshape(flat.data.shape), flat.data)


# ---------------------------------------------------------------------------
# the slice as a whole: 2 shrunk conv rounds against JAX
# ---------------------------------------------------------------------------

ROUND_CASES = {
    # id: (algo, epoch, E, segema)
    "capgan_epoch1": ("capgan", 1, 0, 0.5),
    "capgan_epoch2": ("capgan", 2, 0, 0.25),
    "cglgan_epoch1": ("cglgan", 1, 2, 0.5),
    "cglgan_epoch2": ("cglgan", 2, 0, 0.25),
    "mixgan_epoch1": ("mixgan", 1, 0, 0.25),
    "mixgan_epoch2": ("mixgan", 2, 1, 0.5),
}


def _dropout_keys(root, cfg):
    """Each server's (k_d, k_drop) key data for round t, as the reference's
    ``round_fn`` / ``server_round`` split them."""
    def at(t):
        key = jprng.for_round(jprng.for_role(root, jprng.ROLE_LOCAL), t)
        per = [jax.random.split(k, 4) for k in jax.random.split(
            key, cfg.num_servers)]
        return (np.stack([np.asarray(jax.random.key_data(p[2]))
                          for p in per]),
                np.stack([np.asarray(jax.random.key_data(p[3]))
                          for p in per]))
    return at


def _noisy_leaves(algo):
    """The BN-fed biases (by path) and their BN running means, G's and D's.
    A G conv bias that feeds a BatchNorm has an exactly-zero gradient, so
    Adam moves it by rounding noise alone (up to lr a step) on either side.
    A D conv bias reaches its BatchNorm through a LeakyReLU and Dropout2d:
    the BN cancels the shift but for the slope and mask differences, its
    gradient is ~1e-8 and Adam's step on it is as noisy.  The BN running
    means move with those biases."""
    d = ({("c2", "b"), ("c3", "b"), ("c4", "b")},
         {("bn2", "mean"), ("bn3", "mean"), ("bn4", "mean")})
    if algo not in ("cglgan", "mixgan"):         # a single-path conv G
        return ({("c1", "b"), ("c2", "b")}, {("bn1", "mean"),
                                              ("bn2", "mean")}), d
    return ({("trunk", "c1", "b"), ("trunk", "c2", "b")},
            {("trunk", "bn1", "mean"), ("heads", "bn", "mean")}), d


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        out = []
        for key in sorted(tree):
            out += _paths(tree[key], prefix + (key,))
        return out
    return [prefix]


def _close_net(got, jnet, net, noisy, noisy_bn, steps, flat=None,
               share=FLIP_SHARE[0]):
    """Params and BN buffers elementwise to ``TOL_PARAMS``, Adam moments to
    ``TOL_MOMENT`` of their group's largest entry; the BN-fed biases and
    their running means to lr a step.  ``share`` of the net's elements of
    a kind may miss those bounds, each param still within lr a step.
    Returns the largest share that missed them, over the kinds."""
    if flat is None:     # the reference stacks D state (S, k, ...)
        flat = (lambda x: np.asarray(x).reshape((NW,) + np.shape(x)[2:])) \
            if net == "d" else np.asarray
    jadam = jnet.opt[0]
    np.testing.assert_array_equal(got["count"],
                                  flat(jadam.count).astype(np.int64))
    trees = (("params", jnet.params), ("bn", jnet.bn), ("mu", jadam.mu),
             ("nu", jadam.nu))
    worst = 0.0
    for kind, ref_tree in trees:
        paths = _paths(got[kind])
        refs = [flat(x) for x in jax.tree.leaves(ref_tree)]
        mine = tree_leaves(got[kind])
        assert len(mine) == len(refs) == len(paths)
        group = max(float(np.abs(x).max()) for x in refs)
        n_bad = 0
        for path, a, b in zip(paths, mine, refs):
            what = f"{net} {kind} {path}"
            diff = np.abs(a - b)
            if kind in ("params", "bn") and path in noisy | noisy_bn:
                assert diff.max() <= LR * steps, what
                continue
            if kind in ("params", "bn"):
                bad = diff > TOL_PARAMS[1] + TOL_PARAMS[0] * np.abs(b)
            else:
                bad = diff > TOL_MOMENT * group
            n_bad += int(bad.sum())
            if kind in ("params", "bn"):
                assert diff.max() <= LR * steps, what
        size = sum(x.size for x in refs)
        assert n_bad <= share * size, (net, kind, n_bad, size)
        worst = max(worst, n_bad / size)
    return worst


_JAX_INIT = {}


@pytest.mark.parametrize("case", sorted(ROUND_CASES))
def test_conv_rounds_match_jax(case):
    algo, epoch, e_share, segema = ROUND_CASES[case]
    jpart, part = _partition()
    kw = dict(algo=algo, dataset="synthetic-mnist", conv=True,
              num_workers=NW, num_servers=S, iid=1, batch_size=B,
              epoch=epoch, E=e_share, cloud_epoch=2, segema=segema,
              num_communication=10)
    jcfg, cfg = JaxConfig(**kw), FedGANConfig(**kw)
    assert not fused_dstep.eligible(cfg)         # conv: autograd, as JAX

    jrun = jax_build_runner(jcfg, jpart)
    if algo not in _JAX_INIT:     # the same init at either epoch
        _JAX_INIT[algo] = jax.tree.map(np.asarray, _jit(jrun.init_state))
    jstate = _JAX_INIT[algo]
    jround = jax.jit(jrun.round_fn)
    root = jprng.root_key(jcfg.seed)
    streams, keys = cgl_round_streams(root, jcfg, L), _dropout_keys(root,
                                                                    jcfg)
    run = build_runner(cfg, part, device="cpu")
    state = from_jax_numpy(jax.tree.map(np.asarray, jstate), cfg, "cpu")
    assert set(state.d.params) == {"c1", "c2", "c3", "c4", "adv", "bn2",
                                   "bn3", "bn4"}
    launched = fused_dstep.launches
    g_noisy, d_noisy = _noisy_leaves(algo)
    for t in range(ROUNDS):
        starts, z_d, z_g = streams(t)
        k_d, k_drop = keys(t)
        jstate, jm = jround(jstate)
        state, m = run.round_fn(state, (starts, _t(z_d), _t(z_g), _t(k_d),
                                        _t(k_drop)))
        assert set(m) == set(jm)
        for key in jm:
            assert abs(float(m[key]) - float(jm[key])) < TOL_METRIC, \
                (t, key, float(m[key]), float(jm[key]))
        got = to_numpy(state)
        ref = jax.tree.map(np.asarray, jstate)
        assert got["t"] == int(ref.t) == t + 1
        np.testing.assert_allclose(got["lam"], ref.lam, rtol=0,
                                   atol=TOL_METRIC)
        _close_net(got["g"], ref.g, "g", *g_noisy, steps=t + 1,
                   share=FLIP_SHARE[t])
        _close_net(got["d"], ref.d, "d", *d_noisy, steps=(t + 1) * epoch,
                   share=FLIP_SHARE[t])
    assert fused_dstep.launches == launched
    # serving: gen (painter routing) on the reference's final state
    z = np.random.default_rng(1).normal(size=(4, 100)).astype(np.float32)
    carried = from_jax_numpy(ref, cfg, "cpu")
    _close(run.gen(carried, _t(z)).numpy(), _jit(jrun.gen, jstate, z),
           TOL_FWD, "gen")


def test_conv_entry_points():
    """``build_runner`` builds CAP-GAN, CGL-GAN (iid 0: a single-path G,
    iid 1: Mix-G's multipath) and Mix-G with ``conv=True`` on the CPU when
    asked, and they run a round from their own streams (dropout keys drawn
    from the round's generator); the card is the default device; MD-GAN,
    AC-GAN, FL-GAN and FeGAN build and run a conv round too; in bfloat16
    all seven (FeGAN in gather mode and at full width) build, run a conv
    round and sample (4, 1, 32, 32) in bfloat16; tensor parallelism
    (``model_shards > 1``) is the CGL family's: the others' configs raise
    ValueError, as the reference's."""
    _, part = _partition()
    for algo, iid, multi in (("capgan", 1, False), ("cglgan", 0, False),
                             ("cglgan", 1, True), ("mixgan", 1, True)):
        cfg = FedGANConfig(algo=algo, dataset="synthetic-mnist", conv=True,
                           num_workers=NW, num_servers=S, iid=iid,
                           batch_size=B)
        g, d = zoo.models_for_config(cfg)
        assert g.multipath == multi and d.spec == "conv"
        run = build_runner(cfg, part, device="cpu")
        state, m = run.round_fn(run.init_state())
        assert state.t == 1 and all(np.isfinite(float(v))
                                    for v in m.values())
        out = run.sample(state, 4)
        assert tuple(out.shape) == (4, 1, 32, 32)
        with pytest.raises(ValueError, match="k_d, k_drop"):
            run.round_fn(state, ([0], torch.zeros(S, B, 100),
                                 torch.zeros(S, B, 100)))
        assert bool(torch.isfinite(out).all())
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="device='cpu'"):
                build_runner(cfg, part)
    cfg = FedGANConfig(algo="cglgan", dataset="synthetic-mnist", conv=True,
                       num_workers=NW, num_servers=S, batch_size=B)
    for kw in (dict(algo="mdgan", num_servers=1), dict(algo="acgan"),
               dict(algo="flgan"), dict(algo="fegan", frac_workers=0.5)):
        run = build_runner(cfg.replace(**kw), part, device="cpu")
        state, m = run.round_fn(run.init_state())
        assert state.t == 1 and all(np.isfinite(float(v))
                                    for v in m.values())
        assert tuple(run.sample(state, 4).shape) == (4, 1, 32, 32)
    for algo, frac in (("capgan", 1.0), ("cglgan", 1.0), ("mixgan", 1.0),
                       ("mdgan", 1.0), ("acgan", 1.0), ("flgan", 1.0),
                       ("fegan", 0.5), ("fegan", 1.0)):
        bf16 = cfg.replace(algo=algo, dtype="bfloat16",
                           num_servers=1 if algo == "mdgan" else S,
                           frac_workers=frac)
        run = build_runner(bf16, part, device="cpu")
        state, m = run.round_fn(run.init_state())
        assert state.t == 1 and all(np.isfinite(float(v))
                                    for v in m.values())
        assert all(x.dtype == torch.bfloat16 for x in tree_leaves(
            (state.g.params, state.d.params, state.d.opt.mu)))
        out = run.sample(state, 4)
        assert tuple(out.shape) == (4, 1, 32, 32)
        assert out.dtype == torch.bfloat16
        # a clients mesh runs every algorithm; a model axis the CGL family
        common.check_supported(bf16)
        if algo in ("capgan", "cglgan", "mixgan"):
            common.check_supported(bf16.replace(model_shards=2))
        else:
            with pytest.raises(ValueError, match="model_shards"):
                bf16.replace(model_shards=2)

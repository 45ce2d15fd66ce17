"""FL-GAN and FeGAN on MNIST shapes: port against the JAX package.

Module by module (``_local_steps``, ``_plan_buckets``, the image models and
FeGAN's 1-logit D) and as a whole: a shrunk setup (800 synthetic 28x28
images, 4 workers, batch 32, ``num_sample=100``; the full-width MNIST G
and D, as ``tests/test_algos_image.py`` uses) starts from the JAX
``init_state()`` carried across by ``utils/transplant.py`` and runs 3
rounds on each side from the JAX partition, with the JAX draws of the
ragged sweep injected into the port's ``round_fn``
(``benchmarks/trajectory_parity.py`` ``flgan_round_streams`` at the
largest step count; with dropout the reference's survival draw).  The JAX
runner runs jitted and takes its step-count buckets where it would; the
port sweeps every lane as one masked sweep.  Cases: the "epochs" sweep at
iid=1 (ragged counts) and iid=0 (equal counts), the "batches" sweep,
dropout, FeGAN's gather mode (ragged lanes) and its full width
(per-worker BatchNorm), and a bf16 FL-GAN round held at bf16 steps.  Then
the masked sweep against each lane swept alone, ``train``, ``sample`` and
the entry points.

Tolerances.  Params and BN state rtol 1e-4 / atol 1e-5 and 2e-3 of each
leaf's norm, Adam moments 1e-4 of their group's largest entry, metrics
1e-5 absolute and Adam counts equal, as for the 2DMG rounds.  The G's
linear biases that feed a BatchNorm have an exactly zero gradient, so
Adam moves them by rounding noise alone: they, and the running means of
those BatchNorms (moving averages of ``x @ w + b``), get lr for every
local step taken.  Two cases, ``FLIPPED``, get more: there a G BatchNorm
output lies within float32 rounding of 0 (|y| ~ 3e-9 at the 1024-wide
layer, where a sum in another order moves it by ~4e-9), so the LeakyReLU
after it takes slope 1 on one side and 0.2 on the other, that channel's
gradient moves by ~10% of its leaf's largest entry, and Adam, which steps
by ~lr whatever a gradient's size, carries it on (ROADMAP.md queue 3).
They hold every param and BN leaf to half an lr a local step
beyond rtol / atol and the moments to 0.05 of their group's largest entry
(measured: up to 0.13 lr a step and 0.017 of scale; at the limits of the
other cases ``flgan_dropout`` fails on the G's mu, 2.3e-4 of its scale,
and ``fegan_full`` on one G weight, 9.8e-5 off).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks.trajectory_parity import flgan_round_streams
from cglgan_tpu.algos import common as jcommon
from cglgan_tpu.algos import fedavg_family as jfedavg
from cglgan_tpu.algos.registry import build_runner as jax_build_runner
from cglgan_tpu.core import prng as jprng
from cglgan_tpu.core.config import FedGANConfig as JaxConfig
from cglgan_tpu.data.mnist import synthetic_mnist
from cglgan_tpu.data.partition import partition as jax_partition
from cglgan_tpu.models import zoo as jzoo
from cglgan_tpu_torch.algos import common, fedavg_family
from cglgan_tpu_torch.algos.common import NetState
from cglgan_tpu_torch.algos.registry import build_runner
from cglgan_tpu_torch.algos.runner import train
from cglgan_tpu_torch.core.config import FedGANConfig
from cglgan_tpu_torch.data.partition import Partition
from cglgan_tpu_torch.fed import collectives
from cglgan_tpu_torch.models import zoo
from cglgan_tpu_torch.ops import fused_sweep
from cglgan_tpu_torch.utils.transplant import (from_jax_numpy,
                                               tensor_from_numpy, to_numpy)
from cglgan_tpu_torch.utils.tree import tree_leaves, tree_map
from test_torch_port_threads import one_torch_thread  # noqa: F401

BF = jnp.bfloat16
LR = 2e-4                        # lr_g = lr_d, the config default
ROUNDS = 3
TOL_PARAMS = (1e-4, 1e-5)        # (rtol, atol), float32 sums reordered
TOL_MOMENT = 1e-4                # of the group's largest entry
TOL_METRIC = 1e-5                # absolute, losses ~0.7-1.4
TOL_NORM = 2e-3                  # of a leaf's norm, as a whole
# the cases where a LeakyReLU slope flips (module docstring): half an lr
# a local step on every param and BN leaf, moments 0.05 of their group's
# largest entry
FLIPPED = {"flgan_dropout", "fegan_full"}
TOL_FLIP = 0.5                   # lr a local step
TOL_FLIP_MOMENT = 0.05           # of the group's largest entry
SHRUNK = dict(dataset="synthetic-mnist", num_workers=4, num_class=10,
              num_sample=100, iid=1, batch_size=32, num_communication=8,
              num_plt=1)
# the archived mnist-ref-iid1-flgan run's step vector (W=10, B=100,
# synthetic-mnist at epoch=1, through load_partition)
ARCHIVED_STEPS = np.asarray([96, 144, 108, 18, 12, 6, 54, 132, 18, 12])


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's side runs on one thread here: its products are small
    (B=32 lanes of the MNIST nets), and under the suite's parallel workers
    a thread pool the size of the machine spends its time waiting for
    cores (one round case took 45 s on 8 threads and 3 s on 1 beside six
    busy processes).  The setting is restored after the module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(x):
    return torch.from_numpy(np.array(x))


@functools.lru_cache(maxsize=None)
def _fields(iid):
    """The JAX partition of the shrunk setup, as numpy fields."""
    imgs, labels = synthetic_mnist(n=800, seed=3)
    part = jax_partition(imgs.reshape(800, -1), labels, 4, iid,
                         num_class=10, num_sample=100,
                         seed=FedGANConfig().seed)
    return (part.data, part.labels, part.lengths, part.class_freq,
            part.eval_pool)


# ---------------------------------------------------------------------------
# step counts and buckets: host numpy, equal to the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("iid,sweep,epoch", [
    (0, None, 1), (1, None, 1), (2, None, 1), (1, None, 5),
    (1, "batches", 3), (0, "epochs", 2)])
def test_local_steps_match_reference(iid, sweep, epoch):
    kw = dict(SHRUNK, algo="flgan", iid=iid, local_sweep=sweep, epoch=epoch)
    lengths = _fields(iid)[2]
    got = fedavg_family._local_steps(FedGANConfig(**kw), lengths)
    ref = jfedavg._local_steps(JaxConfig(**kw), lengths)
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)


def _same_plan(got, ref):
    if ref is None:
        assert got is None
        return
    assert got is not None and len(got) == len(ref)
    for (gi, gm), (ri, rm) in zip(got, ref):
        assert gi.dtype == ri.dtype and gm == rm
        np.testing.assert_array_equal(gi, ri)


def _step_vectors():
    out = {"archived_e1": ARCHIVED_STEPS, "archived_e5": 5 * ARCHIVED_STEPS,
           "equal": np.full(6, 60), "one": np.asarray([7]),
           "empty": np.zeros(0, np.int64)}
    for iid in (0, 1, 2):
        cfg = JaxConfig(algo="flgan", **{**SHRUNK, "iid": iid})
        out[f"shrunk_iid{iid}"] = jfedavg._local_steps(cfg, _fields(iid)[2])
    rng = np.random.default_rng(0)
    for i in range(6):
        n = int(rng.integers(2, 13))
        out[f"random{i}"] = rng.integers(1, 40 if i % 2 else 4, size=n)
    return out


@pytest.mark.parametrize("max_buckets", [1, 2, 4, 6])
def test_plan_buckets_match_reference(max_buckets):
    """The same DP and the same output as the reference's, including None
    when one bucket is optimal (equal counts, n < 2, max_buckets < 2)."""
    for name, steps in _step_vectors().items():
        got = fedavg_family._plan_buckets(steps, max_buckets)
        ref = jfedavg._plan_buckets(steps, max_buckets)
        _same_plan(got, ref)
        if name in ("equal", "one", "empty") or max_buckets < 2:
            assert got is None, name
    # the archived run is bucketed: 648 lane-steps where the masked sweep
    # runs 1440, in 324 sequential steps where it runs 144
    plan = fedavg_family._plan_buckets(ARCHIVED_STEPS)
    assert [m for _, m in plan] == [18, 54, 108, 144]
    assert sum(len(i) * m for i, m in plan) == 648


# ---------------------------------------------------------------------------
# models: leaf layout and outputs from one transplanted init
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("algo,d_head,d_out", [
    ("flgan", None, 1), ("flgan", "logits2", 2), ("fegan", None, 1),
    ("fegan", "logits2", 1)])       # FeGAN's D is 1-logit on image data
def test_runner_state_layout_matches_jax(algo, d_head, d_out):
    kw = dict(SHRUNK, algo=algo, d_head=d_head, frac_workers=0.5)
    fields = _fields(1)
    jstate = jax_build_runner(JaxConfig(**kw),
                              _jax_partition(fields)).init_state()
    state = build_runner(FedGANConfig(**kw), Partition(*fields),
                         device="cpu").init_state()
    for mine, theirs in ((state.g.params, jstate.g.params),
                         (state.g.bn, jstate.g.bn),
                         (state.d.params, jstate.d.params),
                         (state.g.opt.mu, jstate.g.opt[0].mu),
                         (state.d.opt.nu, jstate.d.opt[0].nu)):
        a, b = tree_leaves(mine), jax.tree.leaves(theirs)
        assert [tuple(x.shape) for x in a] == [tuple(x.shape) for x in b]
    last = [p for p in state.d.params if p is not None][-1]
    assert tuple(last["w"].shape) == (256, d_out)
    assert tree_leaves(state.g.bn)[0].shape == ((4, 256) if algo == "fegan"
                                                else (256,))


def _jax_partition(fields):
    from cglgan_tpu.data.partition import Partition as JaxPartition
    return JaxPartition(*fields)


@pytest.mark.parametrize("kind", ["g", "d1"])
def test_image_models_match_jax(kind):
    """The MNIST G (train mode: outputs and BN running stats) and the
    1-logit D FeGAN takes, from one JAX init of 3 members."""
    n, b = 3, 6
    if kind == "g":
        jm, m = jzoo.build_generator("mnist-mlp"), \
            zoo.build_generator("mnist-mlp")
        x = np.random.default_rng(1).normal(size=(n, b, 100))
    else:
        jm, m = jzoo.build_discriminator("mnist", 1), \
            zoo.build_discriminator("mnist", 1)
        x = np.random.default_rng(2).uniform(-1, 1, size=(n, b, 784))
    x = x.astype(np.float32)
    p, s = jax.vmap(lambda k: jm.init(k))(
        jax.random.split(jax.random.key(4), n))
    ref, ref_s = jax.vmap(lambda pp, ss, xx: jm.apply(pp, ss, xx, train=True))(
        p, s, jnp.asarray(x))
    conv = lambda tree: tree_map(_t, list(jax.tree.map(np.asarray, tree)))
    got, got_s = m.apply(conv(p), conv(s), _t(x), train=True)
    np.testing.assert_allclose(got.numpy().reshape(ref.shape),
                               np.asarray(ref), rtol=1e-5, atol=1e-5)
    for a, r in zip(tree_leaves(got_s), jax.tree.leaves(ref_s)):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-6)


# ---------------------------------------------------------------------------
# the slice as a whole: rounds against the JAX runner
# ---------------------------------------------------------------------------

CASES = {
    # id: (algo, extra config)
    "flgan_epochs_iid1": ("flgan", dict(iid=1)),
    "flgan_epochs_iid0": ("flgan", dict(iid=0)),
    "flgan_batches": ("flgan", dict(local_sweep="batches", epoch=2)),
    "flgan_dropout": ("flgan", dict(dropout_rate=0.5)),
    "fegan_gather": ("fegan", dict(frac_workers=0.5)),
    "fegan_full": ("fegan", dict(frac_workers=1.0)),
    "flgan_bf16": ("flgan", dict(dtype="bfloat16")),
}


def _survival_draw(jcfg, t):
    """The reference's round-t Bernoulli(1 - dropout_rate) draw: FL-GAN
    folds 7 into its round key, FeGAN into the root's round key
    (``cglgan_tpu/algos/fedavg_family.py:278,391-394``)."""
    root = jprng.root_key(jcfg.seed)
    base = jprng.for_round(root, t) if jcfg.algo == "fegan" else \
        jprng.for_round(jprng.for_role(root, jprng.ROLE_LOCAL), t)
    return np.array(jax.random.bernoulli(
        jax.random.fold_in(base, 7), 1.0 - jcfg.dropout_rate,
        (jcfg.num_workers,)))


def _bf16_streams(root, cfg, max_len, steps):
    """``flgan_round_streams`` with the latents drawn in bf16, as the
    reference's sweep draws them (``jax.random.normal(..., bfloat16)``,
    ``cglgan_tpu/algos/fedavg_family.py:133,141``)."""
    W, B, zdim = cfg.num_workers, cfg.batch_size, cfg.latent_dim

    def at(t):
        key = jprng.for_round(jprng.for_role(root, jprng.ROLE_LOCAL), t)
        starts = [int(jcommon.batch_start(kk, max_len, B))
                  for kk in jax.random.split(
                      jprng.for_role(key, jprng.ROLE_BATCH), steps)]
        z1 = np.zeros((W, steps, B, zdim), BF)
        z2 = np.zeros((W, steps, B, zdim), BF)
        for w, kw in enumerate(jax.random.split(key, W)):
            for i, ks in enumerate(jax.random.split(kw, steps)):
                kzd, kzg, _, _ = jax.random.split(ks, 4)
                z1[w, i] = np.asarray(jax.random.normal(kzd, (B, zdim), BF))
                z2[w, i] = np.asarray(jax.random.normal(kzg, (B, zdim), BF))
        return (starts, tensor_from_numpy(z1, "cpu"),
                tensor_from_numpy(z2, "cpu"))
    return at


def _config(case):
    algo, extra = CASES[case]
    return dict(SHRUNK, algo=algo, **extra)


@functools.lru_cache(maxsize=None)
def _jax_rounds(case):
    """The JAX runner's 3 jitted rounds: the initial state, each round's
    streams and metrics, the state after each round (numpy) and the FeGAN
    schedule."""
    kw = _config(case)
    jcfg = JaxConfig(**kw)
    fields = _fields(kw["iid"])
    jrun = jax_build_runner(jcfg, _jax_partition(fields))
    state = jrun.init_state()
    init = jax.tree.map(np.asarray, state)
    steps = jfedavg._local_steps(jcfg, fields[2])
    draw_of = _bf16_streams if jcfg.dtype == "bfloat16" else \
        flgan_round_streams
    draw = draw_of(jprng.root_key(jcfg.seed), jcfg, fields[0].shape[1],
                   int(steps.max()))
    step = jax.jit(jrun.round_fn)
    streams, metrics, states = [], [], []
    for t in range(ROUNDS):
        drawn = draw(t)
        if jcfg.dropout_rate > 0:
            drawn = (*drawn, _survival_draw(jcfg, t))
        streams.append(drawn)
        state, m = step(state)
        metrics.append({k: float(v) for k, v in m.items()})
        states.append(jax.tree.map(np.asarray, state))
    schedule = jrun.extras["schedule"] if jcfg.algo == "fegan" else None
    return init, streams, metrics, states, schedule, steps


def _port_rounds(case):
    kw = _config(case)
    cfg = FedGANConfig(**kw)
    init, streams, _, _, _, _ = _jax_rounds(case)
    run = build_runner(cfg, Partition(*_fields(kw["iid"])), device="cpu")
    state = from_jax_numpy(init, cfg, "cpu")
    for t in range(ROUNDS):
        before = state
        state, m = run.round_fn(state, streams[t])
        yield t, before, state, m


def _pre_bn_biases(cfg):
    """Leaf indices, in the G's param and BN-state leaf order, of the
    linear biases that feed a BatchNorm and of that BatchNorm's running
    mean.  A bias's gradient is exactly zero, so Adam moves it by rounding
    noise alone, up to ~lr a local step, on either side (as
    ``tests/test_torch_port_capgan.py`` bounds it); the running mean is a
    moving average of the batch means of ``x @ w + b``, so it carries that
    bias's drift."""
    g, _ = zoo.models_for_config(cfg)
    idx = {"params": set(), "bn": set()}
    leaf = bn = 0
    for i, entry in enumerate(g.spec):
        if entry[0] == "linear":
            if i + 1 < len(g.spec) and g.spec[i + 1][0] == "bn":
                idx["params"].add(leaf)   # leaves sort as b, w
                idx["bn"].add(bn)         # state leaves sort as mean, var
            leaf += 2
        elif entry[0] == "bn":
            leaf += 2                     # bias, scale
            bn += 2
    return idx


def _close(a, b, what, extra=0.0):
    """One float32 leaf against its reference: rtol / atol plus ``extra``
    absolute, and 2e-3 of its norm as a whole."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, what
    limit = TOL_PARAMS[0] * np.abs(b) + TOL_PARAMS[1] + extra
    worst = float((np.abs(a - b) - limit).max(initial=-1.0))
    assert worst <= 0, (what, float(np.abs(a - b).max()))
    norm = np.linalg.norm(a - b)
    assert norm <= TOL_NORM * np.linalg.norm(b) + TOL_PARAMS[1], \
        (what, norm / max(np.linalg.norm(b), 1e-30))


def _close_moments(mine, theirs, what, tol=TOL_MOMENT):
    scale = max(float(np.abs(x).max()) for x in theirs)
    for i, (a, b) in enumerate(zip(mine, theirs)):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        assert a.shape == b.shape
        assert float(np.abs(a - b).max()) <= tol * scale, \
            (what, i, float(np.abs(a - b).max()) / scale)


def _check_net(got, jnet, net, steps_taken, noisy, flipped):
    """A net's params, BN state, Adam moments and counts after a round,
    ``steps_taken`` local steps in: the G's BN-fed biases and their
    BatchNorms' running means (``noisy``) get lr a step; a ``flipped`` case
    gets the limits of its slope flips."""
    jadam = jnet.opt[0]
    np.testing.assert_array_equal(got["count"],
                                  np.asarray(jadam.count).astype(np.int64))
    flip = TOL_FLIP * LR * steps_taken if flipped else 0.0
    for group, ref in (("params", jnet.params), ("bn", jnet.bn)):
        for i, (a, b) in enumerate(zip(tree_leaves(got[group]),
                                       jax.tree.leaves(ref))):
            bias = LR * steps_taken if i in noisy[group] else 0.0
            _close(a, b, f"{net} {group} leaf {i}", max(bias, flip))
    for moment in ("mu", "nu"):
        _close_moments(tree_leaves(got[moment]),
                       jax.tree.leaves(getattr(jadam, moment)),
                       f"{net} {moment}",
                       TOL_FLIP_MOMENT if flipped else TOL_MOMENT)


@pytest.mark.parametrize("case", sorted(c for c in CASES if "bf16" not in c))
def test_rounds_match_jax(case):
    kw = _config(case)
    cfg = FedGANConfig(**kw)
    assert not fused_sweep.eligible(cfg)
    _, streams, jmetrics, jstates, schedule, steps = _jax_rounds(case)
    # the reference buckets the ragged cases; the port sweeps them masked
    plan = fedavg_family._plan_buckets(steps)
    if case in ("flgan_epochs_iid1", "flgan_dropout", "fegan_full"):
        assert plan is not None
    if case in ("flgan_epochs_iid0", "flgan_batches"):
        assert plan is None                      # equal counts
    if case == "fegan_gather":
        # some round samples lanes whose step counts differ
        assert any(len(set(steps[g].tolist())) > 1 for g in schedule[:3])
    if kw.get("dropout_rate"):
        assert any((~s[3]).any() for s in streams)
    W = cfg.num_workers
    for t, before, state, m in _port_rounds(case):
        assert set(m) == set(jmetrics[t])
        for key in jmetrics[t]:
            assert abs(float(m[key]) - jmetrics[t][key]) < TOL_METRIC, \
                (t, key, float(m[key]), jmetrics[t][key])
        got, ref = to_numpy(state), jstates[t]
        steps_taken = (t + 1) * int(steps.max())
        for net, noisy in (("g", _pre_bn_biases(cfg)),
                           ("d", {"params": set(), "bn": set()})):
            _check_net(got[net], getattr(ref, net), net, steps_taken, noisy,
                       case in FLIPPED)
        assert got["t"] == int(ref.t) == t + 1 and got["lam"] is None
        if kw["algo"] != "fegan":
            continue
        old = to_numpy(before)
        idle = sorted(set(range(W)) - set(schedule[t].tolist()))
        if kw["frac_workers"] < 1.0:
            # unsampled workers keep their BN and Adam state bit for bit
            assert idle
            for net in ("g", "d"):
                for part in ("bn", "mu", "nu"):
                    for a, b in zip(tree_leaves(got[net][part]),
                                    tree_leaves(old[net][part])):
                        np.testing.assert_array_equal(a[idle], b[idle])
                np.testing.assert_array_equal(got[net]["count"][idle],
                                              old[net]["count"][idle])
        else:
            # per-worker BN: every worker trained, and their stats differ
            assert not idle
            for leaf in tree_leaves(got["g"]["bn"]):
                assert all(not np.array_equal(leaf[0], leaf[w])
                           for w in range(1, W))


def _spacing(x: float) -> float:
    """The distance between bf16 values next to |x| (normal range)."""
    return 2.0 ** (np.floor(np.log2(max(abs(x), 2.0 ** -126))) - 7)


# bf16 rounds, as tests/test_torch_port_bf16.py holds them: XLA on the CPU
# sums bias and BatchNorm gradients in bf16 where the port sums in float32,
# so params and BN state are held to N bf16 steps at the leaf's largest
# entry (N = 2 after round 1, 4 after) plus 3 lr for every Adam step taken,
# Adam moments to 0.25 / 0.15 of their group's largest entry, metrics 5e-3.
TOL_STEPS = (2, 4)
TOL_BF16_MOMENT = (0.25, 0.15)
TOL_BF16_METRIC = 5e-3


def test_bf16_rounds_match_jax():
    case = "flgan_bf16"
    _, _, jmetrics, jstates, _, steps = _jax_rounds(case)
    assert fedavg_family._plan_buckets(steps) is not None
    for t, _, state, m in _port_rounds(case):
        for key in jmetrics[t]:
            assert m[key].dtype == torch.float32
            assert abs(float(m[key]) - jmetrics[t][key]) < TOL_BF16_METRIC, \
                (t, key, float(m[key]), jmetrics[t][key])
        got = to_numpy(state, bf16="float32")
        later = int(t > 0)
        adam_steps = (t + 1) * int(steps.max())
        for net in ("g", "d"):
            jnet = getattr(jstates[t], net)
            jadam = jnet.opt[0]
            np.testing.assert_array_equal(
                got[net]["count"], np.asarray(jadam.count).astype(np.int64))
            for name, theirs in (("params", jnet.params), ("bn", jnet.bn)):
                for i, (a, b) in enumerate(zip(tree_leaves(got[net][name]),
                                               jax.tree.leaves(theirs))):
                    b = np.asarray(b, np.float32)
                    limit = TOL_STEPS[later] * _spacing(float(np.abs(b).max())) \
                        + 3 * LR * adam_steps
                    assert float(np.abs(a - b).max()) <= limit, \
                        (t, net, name, i, float(np.abs(a - b).max()), limit)
            for name in ("mu", "nu"):
                mine = tree_leaves(got[net][name])
                theirs = [np.asarray(x, np.float32)
                          for x in jax.tree.leaves(getattr(jadam, name))]
                scale = max(float(np.abs(x).max()) for x in theirs)
                worst = max(float(np.abs(a - b).max())
                            for a, b in zip(mine, theirs))
                assert worst <= TOL_BF16_MOMENT[later] * scale, \
                    (t, net, name, worst / scale)
    for leaf in tree_leaves((state.g.params, state.g.bn, state.d.params,
                             state.g.opt.mu, state.d.opt.nu)):
        assert leaf.dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# the masked sweep: a lane that has ended is left as it was
# ---------------------------------------------------------------------------

def test_masked_sweep_matches_lanes_alone():
    """One round's ragged local phase (``_local_sweep`` over every lane,
    masked past each lane's own count) against each lane swept alone for
    its own count on prefixes of the same draws: the property the
    reference's step-count buckets rest on.  In float64, so only the
    batch shapes of the products differ: 1e-10 of each group's largest
    entry (params, BN state, each Adam moment), counts equal."""
    case = "flgan_epochs_iid1"
    kw = _config(case)
    cfg = FedGANConfig(**kw)
    init, streams, _, _, _, steps = _jax_rounds(case)
    assert len(set(steps.tolist())) > 2
    g_model, d_model = zoo.models_for_config(cfg)
    sweep = fedavg_family._local_sweep(
        cfg, g_model, d_model, common.make_adv_loss(cfg.resolved_d_head))
    state = from_jax_numpy(init, cfg, "cpu")
    f64 = lambda tree: tree_map(
        lambda x: x.double() if x.is_floating_point() else x, tree)
    W = cfg.num_workers
    bcast = lambda tree: f64(collectives.broadcast_tree(tree, W))
    lanes = lambda net: NetState(bcast(net.params), bcast(net.bn),
                                 common.AdamState(*f64(tuple(net.opt))))
    g, d = lanes(state.g), lanes(state.d)
    shards, steps_dev = _t(_fields(kw["iid"])[0]), _t(steps.astype(np.int64))
    starts, z1, z2 = streams[0][:3]
    starts, z1, z2 = [int(s) for s in starts], _t(z1).double(), \
        _t(z2).double()
    masked = sweep(g, d, shards, starts, z1, z2, steps, steps_dev)
    one = lambda net, w: NetState(
        *[tree_map(lambda x: x[w:w + 1], part) for part in net[:2]],
        common.AdamState(*tree_map(lambda x: x[w:w + 1], tuple(net.opt))))
    for w in range(W):
        n = int(steps[w])
        alone = sweep(one(g, w), one(d, w), shards[w:w + 1], starts[:n],
                      z1[w:w + 1, :n], z2[w:w + 1, :n], steps[w:w + 1])
        for i in (2, 3):
            np.testing.assert_allclose(alone[i].numpy(),
                                       masked[i][w:w + 1].numpy(),
                                       rtol=1e-10, atol=0)
        for k in (0, 1):
            np.testing.assert_array_equal(alone[k].opt.count.numpy(),
                                          masked[k].opt.count[w:w + 1])
            for group in ("params", "bn", "mu", "nu"):
                of = lambda net: tree_leaves(getattr(
                    net.opt if group in ("mu", "nu") else net, group))
                pairs = [(a, b[w:w + 1]) for a, b in zip(of(alone[k]),
                                                         of(masked[k]))]
                if not pairs:                    # the D has no BatchNorm
                    continue
                scale = max(float(b.abs().max()) for _, b in pairs)
                worst = max(float((a - b).abs().max()) for a, b in pairs)
                assert all(a.dtype == b.dtype for a, b in pairs)
                assert worst <= 1e-10 * scale, (w, "gd"[k], group,
                                                worst / scale)


# ---------------------------------------------------------------------------
# train, sample, and the entry points
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("algo,frac", [("flgan", 1.0), ("fegan", 0.5)])
def test_train_and_sample(algo, frac):
    cfg = FedGANConfig(**dict(SHRUNK, algo=algo, frac_workers=frac))
    run = build_runner(cfg, Partition(*_fields(1)), device="cpu")
    out = train(run, rounds=2, eval_every=1, evaluator=False)
    assert [t["round"] for t in out["history"]] == [1, 2]
    for tick in out["history"]:
        assert all(np.isfinite(tick[k]) for k in ("d_loss", "g_loss"))
    x = run.sample(out["state"], 10)
    assert tuple(x.shape) == (10, 1, 28, 28) and x.dtype == torch.float32
    assert bool(torch.isfinite(x).all()) and float(x.abs().max()) <= 1.0
    counts = out["state"].g.opt.count
    steps = fedavg_family._local_steps(cfg, _fields(1)[2])
    if algo == "flgan":
        assert counts.tolist() == (2 * steps).tolist()
    else:
        assert int(counts.max()) <= 2 * int(steps.max())


@pytest.mark.parametrize("case", ["flgan_epochs_iid1", "fegan_gather",
                                  "flgan_bf16", "fegan_bf16"])
def test_gen_matches_jax(case):
    """Eval-mode samples from one carried-over state: FL-GAN with its
    global BN stats after 3 rounds, FeGAN with the untrained init BN, which
    the reference makes in float32 whatever the run's dtype (so a bf16
    FeGAN's samples are float32, as a bf16 FL-GAN's are: float32 latents
    promote the products)."""
    if case == "fegan_bf16":
        kw = dict(SHRUNK, algo="fegan", frac_workers=0.5, dtype="bfloat16")
        jstate = jax_build_runner(JaxConfig(**kw), _jax_partition(
            _fields(1))).init_state()
        ref_state = jax.tree.map(np.asarray, jstate)
    else:
        kw = _config(case)
        ref_state = _jax_rounds(case)[3][-1]
    jrun = jax_build_runner(JaxConfig(**kw), _jax_partition(_fields(1)))
    run = build_runner(FedGANConfig(**kw), Partition(*_fields(1)),
                       device="cpu")
    state = from_jax_numpy(ref_state, run.cfg, "cpu")
    z = np.random.default_rng(1).normal(size=(6, 100)).astype(np.float32)
    ref = np.asarray(jrun.gen(jax.tree.map(jnp.asarray, ref_state), z))
    got = run.gen(state, _t(z))
    assert got.dtype == torch.float32 and ref.dtype == np.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_entry_points():
    """Every image FedAvg variant builds on the CPU; the default device is
    the card; ``pallas_sweep=True`` on image data raises as the
    reference's ``eligible`` does; conv (on the 28x28 images zero-padded to
    32x32) builds and runs a round in float32 and in bfloat16."""
    cfg = FedGANConfig(**dict(SHRUNK, algo="flgan"))
    part = Partition(*_fields(1))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build_runner(cfg, part)
    for kw in (dict(), dict(local_sweep="batches"), dict(dtype="bfloat16"),
               dict(dropout_rate=0.2), dict(algo="fegan", frac_workers=0.2),
               dict(algo="fegan", frac_workers=1.0),
               dict(algo="fegan", dtype="bfloat16", dropout_rate=0.2)):
        build_runner(cfg.replace(**kw), part, device="cpu")
    for kw in (dict(), dict(algo="fegan")):
        with pytest.raises(ValueError, match="pallas_sweep"):
            build_runner(cfg.replace(pallas_sweep=True, **kw), part,
                         device="cpu")
    data, *rest = _fields(1)
    padded = np.pad(data.reshape(data.shape[:2] + (28, 28)),
                    ((0, 0), (0, 0), (2, 2), (2, 2)))
    conv_part = Partition(padded.reshape(data.shape[:2] + (-1,)), *rest[:3],
                          np.pad(rest[3].reshape(-1, 28, 28),
                                 ((0, 0), (2, 2), (2, 2))).reshape(
                                     len(rest[3]), -1))
    for kw in (dict(), dict(algo="fegan", frac_workers=0.5)):
        conv = cfg.replace(conv=True, local_sweep="batches", **kw)
        run = build_runner(conv, conv_part, device="cpu")
        state, m = run.round_fn(run.init_state())
        assert state.t == 1 and all(np.isfinite(float(v))
                                    for v in m.values())
        run = build_runner(conv.replace(dtype="bfloat16"), conv_part,
                           device="cpu")
        state, m = run.round_fn(run.init_state())
        assert state.t == 1 and all(np.isfinite(float(v))
                                    for v in m.values())
        assert state.g.params["c1"]["w"].dtype == torch.bfloat16

"""The FedAvg-family slice on 2DMG: port against the JAX package.

Module by module (2DMG models, ``data/gmm``, the 2DMG branch of
``load_partition``, ``fed/sampling``, the FedAvg collectives,
``evalx/hist2d``) and as a whole: a shrunk FL-GAN and FeGAN (4 workers,
4 classes, batch 16) start from the JAX ``init_state()`` carried across by
``utils/transplant.py`` and run 3 rounds on each side from the JAX partition,
with the JAX draws injected into the port's ``round_fn``
(``benchmarks/trajectory_parity.py`` ``flgan_round_streams``, and with
dropout the reference's survival draw).  The port runs
both its autograd path and its fused-sweep path (``pallas_sweep=True``: on
the CPU the kernel's plain version); FeGAN so covers gather mode and the
full-width mode.  Inputs come from numpy seeds; float32 math agrees to the
stated tolerance (sums run in another order in XLA and in PyTorch).
"""
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks.trajectory_parity import flgan_round_streams
from cglgan_tpu.algos import registry as jregistry
from cglgan_tpu.core import prng as jprng
from cglgan_tpu.core.config import FedGANConfig as JaxConfig
from cglgan_tpu.data import gmm as jgmm
from cglgan_tpu.fed import collectives as jcoll
from cglgan_tpu.fed import sampling as jsampling
from cglgan_tpu.models import zoo as jzoo
from cglgan_tpu_torch.algos import registry
from cglgan_tpu_torch.algos.runner import train
from cglgan_tpu_torch.core import threefry
from cglgan_tpu_torch.core.config import FedGANConfig
from cglgan_tpu_torch.data import gmm
from cglgan_tpu_torch.data.partition import Partition
from cglgan_tpu_torch.evalx import hist2d
from cglgan_tpu_torch.fed import collectives, sampling
from cglgan_tpu_torch.models import zoo
from cglgan_tpu_torch.ops import fused_sweep
from cglgan_tpu_torch.utils.transplant import from_jax_numpy, to_numpy
from cglgan_tpu_torch.utils.tree import tree_leaves, tree_map
from test_torch_port_threads import one_torch_thread  # noqa: F401

# the package re-exports the function ``hist2d`` under the module's name
jhist = importlib.import_module("cglgan_tpu.evalx.hist2d")

RTOL, ATOL = 1e-5, 1e-6          # float32 forward math, reordered sums
# Rounds: both sides float32 on the CPU; Adam divides by sqrt(nu), so a
# relative gradient difference of ~1e-6 moves a param by ~1e-6 of one step
# per local iteration (tests/test_pallas_sweep.py allows the same between the
# JAX package's own two paths).
TOL_PARAMS = (1e-4, 1e-5)        # (rtol, atol)
TOL_MOMENT = 1e-4                # of the group's largest entry
TOL_METRIC = 1e-5                # absolute, losses ~0.7-1.4
ROUNDS = 3
SHRUNK = dict(dataset="2dmg", num_workers=4, num_class=4, num_sample=64,
              batch_size=16, iid=1, num_communication=8)


def _t(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------------------
# models/zoo: same params (carried over from the JAX init) -> same outputs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind,family,din", [
    ("g", "2dmg-mlp", 100), ("g", "2dmg-small", 100), ("d", "2dmg", 2)])
def test_2dmg_models_match(kind, family, din):
    n, b = 3, 7
    build = "build_generator" if kind == "g" else "build_discriminator"
    jm, m = getattr(jzoo, build)(family), getattr(zoo, build)(family)
    p, s = jax.vmap(lambda k: jm.init(k))(
        jax.random.split(jax.random.key(4), n))
    x = np.random.default_rng(5).normal(size=(n, b, din)).astype(np.float32)
    ref, _ = jax.vmap(lambda pp, ss, xx: jm.apply(pp, ss, xx, train=True))(
        p, s, jnp.asarray(x))
    params = tree_map(_t, list(jax.tree.map(np.asarray, p)))
    got, state = m.apply(params, list(s), _t(x), train=True)
    assert tuple(got.shape) == tuple(ref.shape) == (n, b, 2 if kind == "g"
                                                    else 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL,
                                atol=ATOL)
    assert all(entry is None for entry in state)          # no BatchNorm
    # the port's own init from the same keys: the reference's layout,
    # bounds and bits
    ip, istate = m.init(threefry.split(threefry.key(4), n))
    for a, b in zip(tree_leaves(ip), jax.tree.leaves(p), strict=True):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, ref_p in zip(ip, p):
        assert (a is None) == (ref_p is None)
        if a is not None:
            assert tuple(a["w"].shape) == tuple(ref_p["w"].shape)
            bound = 1.0 / np.sqrt(a["w"].shape[1])
            assert float(a["w"].abs().max()) <= bound
            assert float(a["b"].abs().max()) <= bound


@pytest.mark.parametrize("algo,family_widths", [
    ("flgan", [100, 256, 128, 2]), ("fegan", [100, 32, 2]),
    ("mdgan", [100, 256, 128, 2]), ("capgan", [100, 32, 2])])
def test_models_for_config_2dmg(algo, family_widths):
    g, d = zoo.models_for_config(FedGANConfig(algo=algo, dataset="2dmg"))
    lin = [e for e in g.spec if e[0] == "linear"]
    assert [lin[0][1]] + [e[2] for e in lin] == family_widths
    assert [e for e in d.spec if e[0] == "linear"] == [
        ("linear", 2, 128), ("linear", 128, 256), ("linear", 256, 1)]
    assert d.spec[-1] == ("sigmoid",) and g.spec[-1] == ("tanh",)


# ---------------------------------------------------------------------------
# data/gmm and the 2DMG branch of load_partition
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_class", [4, 5, 8, 10])
def test_gmm_modes_bit_equal(n_class):
    a, b = gmm.gmm_modes(n_class), jgmm.gmm_modes(n_class)
    assert a.dtype == b.dtype
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(gmm.gmm_modes(n_class, 0.5),
                                  jgmm.gmm_modes(n_class, 0.5))


def test_gmm_dataset_statistics():
    """What the function promises: label-sorted float32 rows, multinomial
    class counts, per-mode mean and std; the same seed gives the same data,
    another seed other data (its bits are the reference's draw:
    ``tests/test_torch_port_prng_tree.py``)."""
    n_class, per = 8, 1000
    data, labels = gmm.gmm_dataset(n_class, per, seed=3)
    ref_data, ref_labels = jgmm.gmm_dataset(n_class, per, seed=3)
    assert data.shape == tuple(ref_data.shape) == (n_class * per, 2)
    assert data.dtype == np.float32 and labels.dtype == np.int32
    assert labels.dtype == np.asarray(ref_labels).dtype
    assert np.all(np.diff(labels) >= 0)
    counts = np.bincount(labels, minlength=n_class)
    assert counts.sum() == n_class * per and len(counts) == n_class
    # multinomial: each count within 5 sigma of n/k, and not all equal
    sigma = np.sqrt(n_class * per * (1 / n_class) * (1 - 1 / n_class))
    assert np.all(np.abs(counts - per) < 5 * sigma)
    assert counts.std() > 0
    modes = gmm.gmm_modes(n_class)
    for c in range(n_class):
        pts = data[labels == c]
        # mean within 5 standard errors, std within 10% of 0.01
        assert np.all(np.abs(pts.mean(0) - modes[c])
                      < 5 * 0.01 / np.sqrt(len(pts)))
        assert np.all(np.abs(pts.std(0) - 0.01) < 1e-3)
    again, _ = gmm.gmm_dataset(n_class, per, seed=3)
    other, _ = gmm.gmm_dataset(n_class, per, seed=4)
    np.testing.assert_array_equal(data, again)
    assert not np.array_equal(data, other)


@pytest.mark.parametrize("algo,iid", [("flgan", 1), ("fegan", 1),
                                      ("flgan", 0), ("fegan", 2),
                                      ("cglgan", 2), ("mixgan", 1),
                                      ("mdgan", 2), ("acgan", 2)])
def test_load_partition_2dmg_byte_equal(algo, iid, monkeypatch):
    """The 2DMG branch (eval pool of num_sample * num_class, composition
    scale 2 * num_workers for flgan and mdgan, num_workers**2 for the
    others, whole
    label runs at iid=2) on the
    reference's own ``(data, labels)``: byte-equal float32 rows of width 2."""
    kw = dict(algo=algo, dataset="2dmg", num_workers=6, num_class=6,
              num_sample=200, iid=iid, seed=11)
    ref = jregistry.load_partition(JaxConfig(**kw))
    data, labels = jgmm.gmm_dataset(6, 200, seed=11)
    monkeypatch.setattr(registry, "gmm_dataset", lambda *a, **k: (
        np.asarray(data), np.asarray(labels)))
    got = registry.load_partition(FedGANConfig(**kw))
    assert got.data.dtype == np.float32 and got.data.shape[2:] == (2,)
    assert got.eval_pool.shape == (6 * 200, 2)
    for field in ("data", "labels", "lengths", "class_freq", "eval_pool"):
        a, b = getattr(got, field), getattr(ref, field)
        assert a.dtype == b.dtype, field
        np.testing.assert_array_equal(a, b, err_msg=field)


def test_load_partition_2dmg_own_data():
    cfg = FedGANConfig(algo="flgan", **SHRUNK)
    part = registry.load_partition(cfg)
    assert part.data.dtype == np.float32 and part.data.shape[0] == 4
    assert part.data.shape[2] == 2 and np.all(np.abs(part.data) <= 1.1)
    assert part.class_freq.shape == (4, 4)


# ---------------------------------------------------------------------------
# fed/sampling and fed/collectives
# ---------------------------------------------------------------------------

def _class_freq(seed, W=8, C=6):
    rng = np.random.default_rng(seed)
    freq = rng.integers(0, 50, size=(W, C))
    freq[rng.uniform(size=freq.shape) < 0.4] = 0
    freq[0] = 0
    freq[0, 1] = 7                     # a one-class worker
    return freq.astype(np.int64)


@pytest.mark.parametrize("seed", [0, 1])
def test_fegan_scores_and_weights_bit_equal(seed):
    freq = _class_freq(seed)
    a = sampling.fegan_scores(freq, freq.sum(0))
    b = jsampling.fegan_scores(freq, freq.sum(0))
    assert a.dtype == b.dtype == np.float32
    np.testing.assert_array_equal(a, b)
    group = np.asarray([3, 0, 5])
    np.testing.assert_array_equal(sampling.fegan_round_weights(a, group),
                                  jsampling.fegan_round_weights(b, group))


@pytest.mark.parametrize("frac,seed", [(0.5, 0), (0.25, 1), (1.0, 0),
                                       (0.01, 1)])
def test_init_groups_bit_equal(frac, seed):
    freq = _class_freq(seed)
    a = sampling.init_groups(8, freq, frac, num_rounds=40, num_class=6)
    b = jsampling.init_groups(8, freq, frac, num_rounds=40, num_class=6)
    assert a.dtype == b.dtype and a.shape == b.shape == (
        40, max(1, int(frac * 8)))
    np.testing.assert_array_equal(a, b)


def test_fedavg_and_broadcast_tree():
    rng = np.random.default_rng(0)
    tree = [{"w": rng.normal(size=(4, 3, 2)).astype(np.float32),
             "b": rng.normal(size=(4, 2)).astype(np.float32)}, None]
    ttree = tree_map(_t, tree)
    for a, b in zip(tree_leaves(collectives.fedavg_tree(ttree)),
                    jax.tree.leaves(jcoll.fedavg_tree(tree))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                   atol=ATOL)
    one = tree_map(lambda x: x[0], tree)
    got = collectives.broadcast_tree(tree_map(_t, one), 5)
    ref = jcoll.broadcast_tree(one, 5)
    assert got[1] is None
    for a, b in zip(tree_leaves(got), jax.tree.leaves(ref)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# ---------------------------------------------------------------------------
# evalx/hist2d
# ---------------------------------------------------------------------------

def _points(seed):
    rng = np.random.default_rng(seed)
    modes = gmm.gmm_modes(8).astype(np.float32)
    real = modes[rng.integers(0, 8, 4000)] \
        + 0.01 * rng.normal(size=(4000, 2)).astype(np.float32)
    gen = np.tanh(rng.normal(size=(3000, 2)) * 0.8).astype(np.float32)
    gen[:5] = [[1.0, 1.0], [-1.0, -1.0], [1.0, -1.0], [0.0, 0.0],
               [1.0, 0.25]]                  # edges: right-inclusive last bin
    return gen, real.astype(np.float32)


@pytest.mark.parametrize("bins", [16, 32])
def test_hist2d_matches_numpy_and_jax(bins):
    gen, real = _points(0)
    wide = np.concatenate([gen, [[1.5, 0.0], [0.0, -1.01]]]) \
        .astype(np.float32)                  # out of range: dropped
    for pts in (wide, real):
        got = hist2d.hist2d(_t(pts), bins).numpy()
        ref_np, _, _ = np.histogram2d(pts[:, 0], pts[:, 1], bins=bins,
                                      range=[[-1, 1], [-1, 1]])
        np.testing.assert_array_equal(got, ref_np.astype(np.float32))
        np.testing.assert_array_equal(
            got, np.asarray(jhist.hist2d(jnp.asarray(pts), bins)))


@pytest.mark.parametrize("bins", [16, 32])
def test_kl_ds_and_coverage_match_jax(bins):
    gen, real = _points(1)
    for g, r in ((gen, real), (real[:1500], real), (gen[:0 + 300], real)):
        kl, ds = hist2d.kl_and_distribution_score(_t(g), _t(r), bins)
        jkl, jds = jhist.kl_and_distribution_score(jnp.asarray(g),
                                                   jnp.asarray(r), bins)
        np.testing.assert_allclose(float(kl), float(jkl), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(float(ds), float(jds), rtol=1e-6)
        np.testing.assert_allclose(
            float(hist2d.mode_coverage(_t(g), _t(r), bins)),
            float(jhist.mode_coverage(jnp.asarray(g), jnp.asarray(r), bins)),
            rtol=1e-6)
    kl, ds = hist2d.kl_and_distribution_score(_t(real), _t(real), bins)
    # a set against itself: no divergence; the modes on the square's edge
    # lose the samples that fall outside [-1, 1]^2
    inside = float((np.abs(real) <= 1.0).all(axis=1).mean())
    assert abs(float(kl)) < 1e-6 and abs(float(ds) - inside) < 1e-6


# ---------------------------------------------------------------------------
# the slice as a whole: rounds against the JAX runner
# ---------------------------------------------------------------------------

def _survival_draw(jcfg, t):
    """The Bernoulli(1 - dropout_rate) draw behind the reference's round-t
    participation mask, before it forces a survivor: FL-GAN folds 7 into
    its round key, FeGAN into the root's round key
    (``cglgan_tpu/algos/fedavg_family.py:278,388-391``)."""
    root = jprng.root_key(jcfg.seed)
    base = jprng.for_round(root, t) if jcfg.algo == "fegan" else \
        jprng.for_round(jprng.for_role(root, jprng.ROLE_LOCAL), t)
    return np.asarray(jax.random.bernoulli(
        jax.random.fold_in(base, 7), 1.0 - jcfg.dropout_rate,
        (jcfg.num_workers,)))


@functools.lru_cache(maxsize=None)
def _jax_rounds(algo, epoch, dropout=0.0):
    """The JAX runner's 3 rounds on its default (XLA) path: the partition,
    the initial state, each round's streams (with dropout, the survival
    draw as a 4th entry) and metrics, the final state and the FeGAN
    schedule, all as numpy."""
    extra = {"frac_workers": 0.5} if algo == "fegan" else {}
    jcfg = JaxConfig(algo=algo, epoch=epoch, dropout_rate=dropout, **SHRUNK,
                     **extra)
    jpart = jregistry.load_partition(jcfg)
    jrun = jregistry.build_runner(jcfg, jpart)
    state = jrun.init_state()
    init = jax.tree.map(np.asarray, state)
    draw = flgan_round_streams(jprng.root_key(jcfg.seed), jcfg,
                               jpart.data.shape[1])
    step = jax.jit(jrun.round_fn)
    streams, metrics = [], []
    for t in range(ROUNDS):
        drawn = draw(t)
        if dropout > 0:
            drawn = (*drawn, _survival_draw(jcfg, t))
        streams.append(drawn)
        state, m = step(state)
        metrics.append({k: float(v) for k, v in m.items()})
    fields = (jpart.data, jpart.labels, jpart.lengths, jpart.class_freq,
              jpart.eval_pool)
    schedule = jrun.extras["schedule"] if algo == "fegan" else None
    return (fields, init, streams, metrics, jax.tree.map(np.asarray, state),
            schedule)


@pytest.mark.parametrize("algo,epoch,kernel,dropout", [
    ("flgan", 2, False, 0.0), ("flgan", 2, True, 0.0),
    ("flgan", 3, False, 0.0), ("flgan", 3, True, 0.0),
    ("fegan", 2, False, 0.0),    # gather mode: only the sampled lanes train
    ("fegan", 2, True, 0.0),     # full-width mode through the fused sweep
    ("flgan", 2, False, 0.5),    # dropout: masked aggregate and Adam state
    ("fegan", 2, False, 0.5),    # dropout times the group schedule
], ids=["flgan_e2_autograd", "flgan_e2_kernel", "flgan_e3_autograd",
        "flgan_e3_kernel", "fegan_gather_autograd", "fegan_full_kernel",
        "flgan_dropout", "fegan_gather_dropout"])
def test_rounds_match_jax(algo, epoch, kernel, dropout):
    fields, init, streams, jmetrics, ref, schedule = _jax_rounds(
        algo, epoch, dropout)
    extra = {"frac_workers": 0.5} if algo == "fegan" else {}
    cfg = FedGANConfig(algo=algo, epoch=epoch, dropout_rate=dropout,
                       pallas_sweep=True if kernel else None, **SHRUNK,
                       **extra)
    assert fused_sweep.eligible(cfg) is kernel
    if dropout:
        # the injected draws drop someone the reference would have trained
        drops = [~streams[t][3] for t in range(ROUNDS)]
        assert any(d.any() for d in drops)
    run = registry.build_runner(cfg, Partition(*fields), device="cpu")
    state = from_jax_numpy(init, cfg, "cpu")
    assert state.lam is None
    W = cfg.num_workers
    if algo == "fegan":
        np.testing.assert_array_equal(run.extras["schedule"], schedule)
    for t in range(ROUNDS):
        starts, z1, z2 = streams[t][:3]
        before = to_numpy(state)
        state, m = run.round_fn(state, (starts, _t(z1), _t(z2),
                                        *map(_t, streams[t][3:])))
        assert set(m) == set(jmetrics[t])
        for key in jmetrics[t]:
            assert abs(float(m[key]) - jmetrics[t][key]) < TOL_METRIC, \
                (t, key, float(m[key]), jmetrics[t][key])
        if algo == "fegan":
            # unsampled workers' optimizer state is untouched, exactly
            after = to_numpy(state)
            idle = sorted(set(range(W)) - set(schedule[t].tolist()))
            assert idle
            for net in ("g", "d"):
                np.testing.assert_array_equal(after[net]["count"][idle],
                                              before[net]["count"][idle])
                for moment in ("mu", "nu"):
                    for a, b in zip(tree_leaves(after[net][moment]),
                                    tree_leaves(before[net][moment])):
                        np.testing.assert_array_equal(a[idle], b[idle])

    got = to_numpy(state)
    assert got["t"] == int(ref.t) == ROUNDS and got["lam"] is None
    for net, jnet in (("g", ref.g), ("d", ref.d)):
        jadam = jnet.opt[0]
        np.testing.assert_array_equal(
            got[net]["count"], np.asarray(jadam.count).astype(np.int64))
        assert got[net]["count"].shape == (W,)
        for i, (a, b) in enumerate(zip(tree_leaves(got[net]["params"]),
                                       jax.tree.leaves(jnet.params))):
            assert a.shape == b.shape            # global, unstacked
            np.testing.assert_allclose(a, b, rtol=TOL_PARAMS[0],
                                       atol=TOL_PARAMS[1],
                                       err_msg=f"{net} param leaf {i}")
        for moment in ("mu", "nu"):
            got_l = tree_leaves(got[net][moment])
            ref_l = jax.tree.leaves(getattr(jadam, moment))
            scale = max(float(np.abs(x).max()) for x in ref_l)
            for i, (a, b) in enumerate(zip(got_l, ref_l)):
                assert a.shape == b.shape and a.shape[0] == W
                np.testing.assert_allclose(
                    a, b, rtol=0, atol=TOL_MOMENT * scale,
                    err_msg=f"{net} {moment} leaf {i}")


def test_gen_and_sample_match_jax():
    for algo in ("flgan", "fegan"):
        fields, init, _, _, _, _ = _jax_rounds(algo, 2)
        extra = {"frac_workers": 0.5} if algo == "fegan" else {}
        kw = dict(algo=algo, epoch=2, **SHRUNK, **extra)
        jrun = jregistry.build_runner(JaxConfig(**kw),
                                      jregistry.load_partition(
                                          JaxConfig(**kw)))
        run = registry.build_runner(FedGANConfig(**kw), Partition(*fields),
                                    device="cpu")
        state = from_jax_numpy(init, run.cfg, "cpu")
        z = np.random.default_rng(1).normal(size=(6, 100)) \
            .astype(np.float32)
        np.testing.assert_allclose(
            run.gen(state, _t(z)).numpy(),
            np.asarray(jrun.gen(jrun.init_state(), z)), rtol=RTOL, atol=ATOL)
        pts = run.sample(state, 10)
        assert tuple(pts.shape) == (10, 2)
        assert bool(torch.isfinite(pts).all())
        assert float(pts.abs().max()) <= 1.0


@pytest.mark.parametrize("algo,kernel", [("flgan", False), ("flgan", True),
                                         ("fegan", False), ("fegan", True)])
def test_train_ticks_finite(algo, kernel):
    extra = {"frac_workers": 0.5} if algo == "fegan" else {}
    cfg = FedGANConfig(algo=algo, epoch=2, **SHRUNK, **extra,
                       pallas_sweep=True if kernel else None)
    run = registry.build_runner(cfg, device="cpu")   # the port's own data
    out = train(run, rounds=4, eval_every=2, evaluator=False)
    assert [t["round"] for t in out["history"]] == [2, 4]
    for tick in out["history"]:
        assert all(np.isfinite(tick[k]) for k in ("d_loss", "g_loss"))
    assert out["state"].t == 4 and out["state"].lam is None
    counts = out["state"].g.opt.count
    if algo == "flgan":                      # every worker, every round
        assert counts.tolist() == [8] * 4
    else:                                    # half the workers per round
        assert int(counts.sum()) == 4 * 2 * 2 and int(counts.max()) <= 8


def test_entry_point_contract():
    """The default device is the card; ``model_shards > 1`` is the CGL
    family's (a FedAvg config refuses it, as the reference's) and builds
    unsharded without a mesh;
    conv builds for every algorithm in float32 and, under force_dtype, in
    bfloat16 (on 2DMG only its rounds would need image data, as the
    reference's)."""
    cfg = FedGANConfig(algo="flgan", epoch=2, **SHRUNK)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            registry.build_runner(cfg)
    with pytest.raises(ValueError, match="model_shards"):
        cfg.replace(model_shards=2)
    registry.build_runner(cfg.replace(algo="capgan", model_shards=2),
                          device="cpu")
    # conv is ported in float32 and bfloat16: every algorithm builds (its
    # rounds take image data)
    for kw in (dict(), dict(algo="fegan"), dict(algo="mdgan"),
               dict(algo="acgan", num_servers=2), dict(algo="cglgan")):
        registry.build_runner(cfg.replace(conv=True, **kw), device="cpu")
        registry.build_runner(cfg.replace(conv=True, dtype="bfloat16",
                                          force_dtype=True, **kw),
                              device="cpu")
    # bf16 on 2DMG under force_dtype, dropout, MD-GAN and AC-GAN, and the
    # ragged "epochs" sweep (on 2DMG by request; the image configs are
    # tests/test_torch_port_fedavg_image.py's) are ported: they build
    for kw in (dict(dtype="bfloat16", force_dtype=True),
               dict(dropout_rate=0.2), dict(algo="fegan", dropout_rate=0.2),
               dict(algo="mdgan"), dict(algo="acgan"),
               dict(local_sweep="epochs"),
               dict(algo="fegan", local_sweep="epochs")):
        registry.build_runner(cfg.replace(**kw), device="cpu")

"""The proxy image evaluator (``cglgan_tpu_torch/evalx/fid.py`` and the
image branch of ``evalx/evaluator.py``) against the JAX package's, and
``train``'s default evaluator.

Tolerances.  ``conv2d``: 1e-6.  Inits drawn with threefry ``uniform``
(the probe's, ``conv_init``, ``keyed_linear_init``): bit-equal; the
random-conv extractor's weights (``normal``, then a scale): 4 ulps.  The
probe's batch indices: bit-equal.  The probe after 20 Adam steps at side
28: each leaf within 1e-2 of its largest entry (both sides are float32 and
sum in another order; Adam's first steps move a weight by about lr
whatever its gradient's size, so a gradient near 0 that differs in sign
moves it by up to 2 lr; measured 2.0e-3).  Features, ``activation_stats``,
FID and IS on transplanted params: 1e-5 relative (measured ~5e-7 on
features, ~1e-7 on FID and IS).  ``make_evaluator`` on its own threefry
weights and probe, on the same samples: FID 1e-5 relative, IS 1e-4
relative (the two probes trained 10 steps apart as above).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cglgan_tpu.algos.registry import build_runner as jax_build_runner
from cglgan_tpu.algos.runner import train as jax_train
from cglgan_tpu.core.config import FedGANConfig as JaxConfig
from cglgan_tpu.data.partition import Partition as JaxPartition
from cglgan_tpu.evalx import fid as jfid
from cglgan_tpu.evalx.evaluator import make_evaluator as jax_make_evaluator
from cglgan_tpu.models import nn as jnn
from cglgan_tpu_torch.algos.registry import build_runner
from cglgan_tpu_torch.algos.runner import train
from cglgan_tpu_torch.core import threefry
from cglgan_tpu_torch.core.config import FedGANConfig
from cglgan_tpu_torch.data.partition import Partition
from cglgan_tpu_torch.evalx import fid
from cglgan_tpu_torch.evalx.evaluator import make_evaluator
from cglgan_tpu_torch.models import nn
from cglgan_tpu_torch.utils.transplant import (fid_params_from_numpy,
                                               from_jax_numpy)
from cglgan_tpu_torch.utils.tree import tree_leaves
from test_torch_port_threads import one_torch_thread  # noqa: F401

PROBE_STEPS = 20
TOL_PROBE = 1e-2          # of each leaf's largest entry, after 20 steps
TOL_METRIC = 1e-5         # relative: features, stats, FID, IS



@pytest.fixture(autouse=True)
def _no_tf32():
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = saved


def _ulps(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _images(n, side, seed=0):
    """Class-structured u8 images: a fixed pattern a class, plus noise."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 10, n)
    protos = rng.uniform(0, 255, (10, side, side))
    noisy = protos[labels] * 0.6 + rng.normal(0, 40, (n, side, side))
    return np.clip(noisy, 0, 255).astype(np.uint8), labels


@pytest.mark.parametrize("stride", [1, 2])
def test_conv2d_matches_jax(stride):
    rng = np.random.default_rng(stride)
    p = {"w": rng.normal(0, 0.3, (5, 3, 3, 3)).astype(np.float32),
         "b": rng.normal(0, 0.3, (5,)).astype(np.float32)}
    x = rng.normal(0, 1, (2, 3, 9, 9)).astype(np.float32)
    ref = np.asarray(jnn.conv2d(jax.tree.map(jnp.asarray, p),
                                jnp.asarray(x), stride=stride))
    got = nn.conv2d({k: torch.from_numpy(v) for k, v in p.items()},
                    torch.from_numpy(x), stride=stride)
    assert tuple(got.shape) == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)


def test_keyed_inits_bit_equal():
    for seed in (0, 5):
        key, jkey = threefry.key(seed), jax.random.key(seed)
        for got, ref in ((nn.conv_init(key, 32, 64, 3),
                          jnn.conv_init(jkey, 32, 64, 3)),
                         (nn.linear_init(key, 3136, 128),
                          jnn.linear_init(jkey, 3136, 128))):
            for name in ("w", "b"):
                assert np.array_equal(got[name].numpy(),
                                      np.asarray(ref[name])), name


@pytest.mark.parametrize("side", [28, 32])
def test_extractor_weights_and_probe_init_match_jax(side):
    ref = jfid.conv_feature_extractor(side)
    got = fid.conv_feature_extractor(side, device="cpu")
    for a, b in zip(tree_leaves(got.params), jax.tree.leaves(ref.params)):
        assert a.shape == b.shape
        assert _ulps(a.numpy(), b).max() <= 4
    # the probe's init: key(0) split 5 ways, as classifier_probe draws it
    ks = jax.random.split(jax.random.key(0), 5)
    flat = 64 * (side // 4) ** 2
    ref = {"c0": jnn.conv_init(ks[0], 1, 32, 3),
           "c1": jnn.conv_init(ks[1], 32, 64, 3),
           "l0": jnn.linear_init(ks[2], flat, 128),
           "l1": jnn.linear_init(ks[3], 128, 10)}
    got = fid.probe_init(side, 10, 0, "cpu")
    for a, b in zip(tree_leaves(got), jax.tree.leaves(ref)):
        assert np.array_equal(a.numpy(), np.asarray(b))


def test_probe_batches_bit_equal():
    """``fid.py:114-116,101``: ``key(seed + 1)`` split once a step,
    ``randint`` from the second half."""
    for seed, n in ((0, 20000), (3, 777)):
        k, ref = jax.random.key(seed + 1), []
        for _ in range(6):
            k, sub = jax.random.split(k)
            ref.append(np.asarray(jax.random.randint(sub, (256,), 0, n)))
        got = list(fid.probe_batches(seed, 6, 256, n, "cpu"))
        assert len(got) == 6
        for a, b in zip(got, ref):
            assert a.dtype == torch.int32 and np.array_equal(a.numpy(), b)


@pytest.fixture(scope="module")
def probes():
    imgs, labels = _images(2000, 28)
    ref = jfid.classifier_probe(imgs, labels, 10, steps=PROBE_STEPS)
    got = fid.classifier_probe(imgs, labels, 10, steps=PROBE_STEPS,
                               device="cpu")
    return imgs, ref, got


def test_probe_training_matches_jax(probes):
    _, ref, got = probes
    ref_l, got_l = jax.tree.leaves(ref.params), tree_leaves(got.params)
    assert len(ref_l) == len(got_l) == 8
    for a, b in zip(got_l, ref_l):
        assert a.shape == b.shape
        assert _rel(a.numpy(), b) <= TOL_PROBE


def test_metrics_on_transplanted_params_match_jax(probes):
    """The same params on both sides (the port's ``fid_params_from_numpy``
    of the reference's): features of both extractors, ``activation_stats``
    over a batch and a part batch (150 images), FID and IS."""
    imgs, jprobe, port_probe = probes
    jext = jfid.conv_feature_extractor(28)
    port_ext = fid.conv_feature_extractor(28, device="cpu")
    pairs = []
    for jx, px in ((jext, port_ext), (jprobe, port_probe)):
        params = fid_params_from_numpy(jax.tree.map(np.asarray, jx.params),
                                       "cpu")
        pairs.append((jx, fid.Extractor(params, px.apply)))
    rng = np.random.default_rng(4)
    gen = rng.uniform(-1, 1, (150, 1, 28, 28)).astype(np.float32)
    real = ((imgs[:120].astype(np.float32) / 255.0 - 0.5) / 0.5) \
        .reshape(-1, 1, 28, 28)
    for jx, px in pairs:
        ref = np.asarray(jx.apply(jx.params, jnp.asarray(gen)))
        got = fid._features(px, torch.from_numpy(gen))
        assert got.dtype == np.float32 and got.shape == ref.shape
        assert _rel(got, ref) <= TOL_METRIC
        (mu, cov), (jmu, jcov) = (fid.activation_stats(px, gen),
                                  jfid.activation_stats(jx, gen))
        assert _rel(mu, jmu) <= TOL_METRIC and _rel(cov, jcov) <= TOL_METRIC
        ref_fid, got_fid = jfid.fid(jx, gen, real), fid.fid(px, gen, real)
        assert abs(got_fid - ref_fid) <= TOL_METRIC * abs(ref_fid)
    (jx, px) = pairs[1]
    ref_is = jfid.inception_score(jx, gen)
    assert abs(fid.inception_score(px, gen) - ref_is) <= TOL_METRIC * ref_is


def test_frechet_distance_and_split_are_the_reference_code():
    rng = np.random.default_rng(2)
    f1, f2 = rng.normal(size=(40, 8)), rng.normal(1, 2, size=(60, 8))
    args = (f1.mean(0), np.cov(f1, rowvar=False), f2.mean(0),
            np.cov(f2, rowvar=False))
    assert fid.frechet_distance(*args) == jfid.frechet_distance(*args)
    out = rng.normal(size=(5, 138)).astype(np.float32)
    for a, b in zip(fid.split_probe_output(torch.from_numpy(out)),
                    jfid.split_probe_output(out)):
        assert np.array_equal(a.numpy(), b)


def _image_partition(nw=4, length=48, pool=120, seed=0):
    imgs, labels = _images(nw * length + pool, 8, seed)
    data = imgs[:nw * length].reshape(nw, length, 64)
    labs = labels[:nw * length].reshape(nw, length).astype(np.int32)
    freq = np.stack([np.bincount(row, minlength=10) for row in labs])
    fields = (data, labs, np.full(nw, length, np.int32),
              freq.astype(np.int64), imgs[nw * length:].reshape(pool, 64))
    return JaxPartition(*fields), Partition(*fields)


IMAGE = dict(algo="capgan", dataset="synthetic-mnist", num_workers=4,
             num_servers=2, img_size=8, batch_size=8)


def test_make_evaluator_matches_jax():
    """The image branch on its own weights (threefry) and probe: FID and
    IS of the same samples against the reference's, and the inputs it
    refuses.  100 of the 120 pool images are the real stats."""
    jpart, part = _image_partition()
    ref = jax_make_evaluator(JaxConfig(**IMAGE), jpart, probe_steps=10)
    got = make_evaluator(FedGANConfig(**IMAGE), part, probe_steps=10,
                         device="cpu")
    rng = np.random.default_rng(5)
    for n in (100, 130):
        samples = rng.uniform(-1, 1, (n, 64)).astype(np.float32)
        r = ref(None, None, samples=samples)
        g = got(None, None, samples=torch.from_numpy(samples))
        assert set(g) == set(r) == {"fid", "inception_score"}
        assert abs(g["fid"] - r["fid"]) <= TOL_METRIC * abs(r["fid"])
        assert abs(g["inception_score"] - r["inception_score"]) \
            <= 1e-4 * r["inception_score"]
    for kw in (dict(fid_stats="stats.npz"),
               dict(inception_weights="pool3.npz")):
        # ported (tests/test_torch_port_inception.py): a missing file
        # raises, as the reference's np.load does
        with pytest.raises(FileNotFoundError, match="npz"):
            make_evaluator(FedGANConfig(**IMAGE), part, probe_steps=1,
                           device="cpu", **kw)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_evaluator(FedGANConfig(**IMAGE), part, probe_steps=1)


def _two_dmg_partition(nw=4, length=48, seed=0):
    rng = np.random.default_rng(seed)
    fields = (rng.uniform(-1, 1, (nw, length, 2)).astype(np.float32),
              np.zeros((nw, length), np.int32),
              np.full(nw, length, np.int32), np.zeros((nw, 10), np.int64),
              rng.uniform(-1, 1, (64, 2)).astype(np.float32))
    return JaxPartition(*fields), Partition(*fields)


@pytest.mark.parametrize("algo", ["mdgan", "flgan"])
def test_train_default_evaluator_2dmg(algo):
    """``train(runner)`` with no ``evaluator`` scores every tick as the
    reference's does: the reference's tick keys (its own ``train`` run for
    MD-GAN; XLA compiles each family's rounds for seconds), and from one
    carried-over state the default evaluator's KL / DS / coverage equal
    the reference's (the same eval noise through the same G)."""
    jpart, part = _two_dmg_partition()
    kw = dict(algo=algo, dataset="2dmg", num_workers=4, batch_size=8,
              num_sample=200)
    jrun = jax_build_runner(JaxConfig(**kw), jpart)
    run = build_runner(FedGANConfig(**kw), part, device="cpu")
    got = train(run, rounds=2, eval_every=1)["history"]
    keys = set(got[0]) - {"kl_score", "distribution_score", "mode_coverage"}
    assert [t["round"] for t in got] == [1, 2]
    assert [set(t) for t in got] == [keys | {"kl_score",
                                             "distribution_score",
                                             "mode_coverage"}] * 2
    if algo == "mdgan":
        ref = jax_train(jrun, rounds=2, eval_every=1)["history"]
        assert [set(t) for t in got] == [set(t) for t in ref]
    jstate = jrun.init_state()
    state = from_jax_numpy(jax.tree.map(np.asarray, jstate), run.cfg, "cpu")
    r = jax_make_evaluator(JaxConfig(**kw), jpart)(jrun, jstate)
    g = make_evaluator(FedGANConfig(**kw), part, device="cpu")(run, state)
    assert set(g) == set(r)
    for key in r:
        assert abs(g[key] - r[key]) <= 1e-5 * max(1.0, abs(r[key])), key


def test_train_default_evaluator_images():
    """On images the default evaluator trains its probe (300 steps) on the
    runner's device and every tick carries a finite FID and IS."""
    _, part = _image_partition()
    run = build_runner(FedGANConfig(**IMAGE), part, device="cpu")
    out = train(run, rounds=2, eval_every=1, eval_n=50)
    for tick in out["history"]:
        assert {"fid", "inception_score"} <= set(tick)
        assert np.isfinite(tick["fid"]) and tick["inception_score"] >= 1.0

"""InceptionV3 pool3 in the port against the JAX package, on the CPU.

``evalx/inception.py``: ``inception_init``'s random network for one key
against the reference's (threefry's normals are within 3 ulps of JAX's,
and the He scaling rounds once more); pool3 features of two 299x299 images
through the reference's ``inception_pool3`` on the same torchvision-keyed
dict; ``preprocess`` of 28x28 and 32x32 images against
``jax.image.resize``; the ``.npz`` and ``.pth`` loaders, their shape and
missing-key errors; ``load_fid_stats`` / ``save_fid_stats`` with the side
guard.  ``evalx/evaluator.py``: ``make_evaluator(inception_weights=...,
fid_stats=...)`` against the reference's on one weights file and the same
samples (100 a side, so the 2048-d covariances have rank 99), and the
dimension check.  TF32 is off; the reference's init and pool3 are compiled
at XLA's backend optimization level 0 (the same HLO, less compile time).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cglgan_tpu.core.config import FedGANConfig as JaxConfig
from cglgan_tpu.data.partition import Partition as JaxPartition
from cglgan_tpu.evalx import fid as jfid
from cglgan_tpu.evalx import inception as jinc
from cglgan_tpu.evalx.evaluator import make_evaluator as jax_make_evaluator
from cglgan_tpu_torch.core import threefry
from cglgan_tpu_torch.core.config import FedGANConfig
from cglgan_tpu_torch.data.partition import Partition
from cglgan_tpu_torch.evalx import inception
from cglgan_tpu_torch.evalx.evaluator import make_evaluator
from test_torch_port_threads import one_torch_thread  # noqa: F401

TOL_FEAT = 1e-4           # of the features' largest entry
TOL_FID = 1e-3            # relative, rank-99 covariances in 2048-d
TOL_IS = 1e-6             # relative
# inception_init: threefry's normals are within 3 ulps of JAX's; the
# reference's jitted init (once, 8 s on the CPU, against 29 s eager) fuses
# the He scaling into the draw and sits up to 2 ulps from its own eager
# init.  Measured: 4 ulps against the eager init, 5 against the jitted.
ULPS_INIT = 5


@pytest.fixture(autouse=True)
def _no_tf32():
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = saved


def _jit(fn, *args):
    """``jax.jit(fn)(*args)`` compiled at XLA's backend optimization level
    0: the same HLO in less compile time."""
    return jax.jit(fn).lower(*args).compile(
        {"xla_backend_optimization_level": 0})(*args)


@pytest.fixture(scope="module")
def weights():
    """The port's network for key(3) and the reference's (jitted once)."""
    got = inception.inception_init(threefry.key(3))
    ref = jax.tree.map(np.asarray,
                       _jit(jinc.inception_init, jax.random.key(3)))
    return got, ref


@pytest.fixture(scope="module")
def weights_file(weights, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("pool3") / "pool3.npz")
    np.savez(path, **{k: v.numpy() for k, v in weights[0].items()})
    return path


def _ulps(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


def test_inception_init_matches_reference(weights):
    """Same names and shapes (94 BasicConv2d, 5 tensors each); conv
    weights within 5 ulps of the reference's jitted draw, BN tensors
    equal."""
    got, ref = weights
    assert len(inception.CONV_SHAPES) == 94
    assert inception.CONV_SHAPES == jinc.CONV_SHAPES
    assert set(got) == set(ref) and len(got) == 94 * 5
    for name, a in got.items():
        assert a.dtype == torch.float32
        assert tuple(a.shape) == ref[name].shape, name
        if name.endswith("conv.weight"):
            assert _ulps(a.numpy(), ref[name]).max() <= ULPS_INIT, name
        else:
            np.testing.assert_array_equal(a.numpy(), ref[name])


def test_pool3_features_match_reference(weights):
    """(2, 3, 299, 299) -> (2, 2048) on the same dict (the reference's
    weights, BN statistics moved off the identity) within 1e-4 of scale."""
    _, ref = weights
    rng = np.random.default_rng(1)
    p = dict(ref)
    for name in inception.CONV_SHAPES:
        cout = ref[f"{name}.conv.weight"].shape[0]
        p[f"{name}.bn.weight"] = rng.uniform(0.5, 1.5, cout) \
            .astype(np.float32)
        p[f"{name}.bn.bias"] = rng.normal(0, 0.1, cout).astype(np.float32)
        p[f"{name}.bn.running_mean"] = rng.normal(0, 0.1, cout) \
            .astype(np.float32)
        p[f"{name}.bn.running_var"] = rng.uniform(0.5, 2.0, cout) \
            .astype(np.float32)
    x = rng.uniform(-1, 1, (2, 3, 299, 299)).astype(np.float32)
    want = np.asarray(_jit(jinc.inception_pool3, p, x))
    got = inception.inception_pool3(
        {k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x))
    assert tuple(got.shape) == want.shape == (2, inception.POOL3_DIM)
    err = np.abs(got.numpy() - want).max() / np.abs(want).max()
    assert err <= TOL_FEAT, err


@pytest.mark.parametrize("side,channels", [(28, 1), (32, 1), (32, 3)])
def test_preprocess_matches_jax_resize(side, channels):
    """1 or 3 channels, (N, H, W) or (N, C, H, W) -> (N, 3, 299, 299) as
    the reference's ``preprocess`` (``jax.image.resize`` bilinear)."""
    x = np.random.default_rng(side).uniform(
        -1, 1, (3, channels, side, side)).astype(np.float32)
    want = np.asarray(jinc.preprocess(x))
    got = inception.preprocess(torch.from_numpy(x))
    assert tuple(got.shape) == want.shape == (3, 3, 299, 299)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    if channels == 1:
        np.testing.assert_allclose(
            inception.preprocess(torch.from_numpy(x[:, 0])).numpy(), want,
            rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="channel count 2"):
        inception.preprocess(torch.zeros(1, 2, side, side))


def test_weight_loaders_round_trip(weights, weights_file, tmp_path):
    """``.npz`` and ``.pth`` (a state dict with an fc head, ignored) load
    back bit for bit; a missing tensor and a wrong shape raise, as the
    reference's loader does."""
    got, _ = weights
    back = inception.load_inception_weights(weights_file, device="cpu")
    pth = str(tmp_path / "pool3.pth")
    torch.save({**got, "fc.weight": torch.zeros(1000, 2048)}, pth)
    back_pth = inception.load_inception_weights(pth, device="cpu")
    for loaded in (back, back_pth):
        assert set(loaded) == set(got)
        for name, a in got.items():
            assert torch.equal(loaded[name], a), name
    name = "Mixed_6b.branch7x7_2"
    bad = {k: v.numpy() for k, v in got.items()
           if k != f"{name}.bn.running_var"}
    np.savez(str(tmp_path / "missing.npz"), **bad)
    with pytest.raises(ValueError, match="missing tensor .*running_var"):
        inception.load_inception_weights(str(tmp_path / "missing.npz"),
                                         device="cpu")
    bad[f"{name}.bn.running_var"] = got[f"{name}.bn.running_var"].numpy()
    bad[f"{name}.conv.weight"] = np.zeros((128, 128, 7, 1), np.float32)
    np.savez(str(tmp_path / "shape.npz"), **bad)
    with pytest.raises(ValueError, match="expected \\(128, 128, 1, 7\\)"):
        inception.load_inception_weights(str(tmp_path / "shape.npz"),
                                         device="cpu")
    del bad[f"{name}.conv.weight"]
    np.savez(str(tmp_path / "noconv.npz"), **bad)
    with pytest.raises(ValueError, match="missing tensor .*conv.weight"):
        inception.load_inception_weights(str(tmp_path / "noconv.npz"),
                                         device="cpu")


def test_fid_stats_round_trip_and_side_guard(tmp_path):
    """``save_fid_stats`` / ``load_fid_stats`` as the reference's: float64
    mu and sigma back, ``cov`` read for ``sigma``, bad shapes and a
    recorded side that is not the run's raise; the reference reads the
    port's file alike."""
    rng = np.random.default_rng(2)
    mu = rng.normal(size=8).astype(np.float32)
    sigma = np.eye(8, dtype=np.float32)
    path = str(tmp_path / "s.npz")
    inception.save_fid_stats(path, mu, sigma, side=32)
    for load in (inception.load_fid_stats, jinc.load_fid_stats):
        m, s = load(path, expect_side=32)
        assert m.dtype == s.dtype == np.float64
        np.testing.assert_array_equal(m, mu)
        np.testing.assert_array_equal(s, sigma)
    with pytest.raises(ValueError, match="32px"):
        inception.load_fid_stats(path, expect_side=28)
    np.savez(str(tmp_path / "cov.npz"), mu=mu, cov=sigma)
    m, s = inception.load_fid_stats(str(tmp_path / "cov.npz"), 28)
    np.testing.assert_array_equal(s, sigma)
    np.savez(str(tmp_path / "bad.npz"), mu=mu, sigma=sigma[:4])
    with pytest.raises(ValueError, match="bad stats shapes"):
        inception.load_fid_stats(str(tmp_path / "bad.npz"))


def _image_partition(side=28, nw=4, length=60, seed=0):
    rng = np.random.default_rng(seed)
    protos = rng.uniform(0, 255, (10, side * side))
    labels = rng.integers(0, 10, (nw, length))
    data = np.clip(protos[labels] * 0.6 + rng.normal(0, 40, labels.shape
                                                      + (side * side,)),
                   0, 255).astype(np.uint8)
    pool = data.reshape(-1, side * side)[:120]
    fields = (data, labels.astype(np.int32), np.full(nw, length, np.int32),
              np.zeros((nw, 10), np.int64), pool)
    return JaxPartition(*fields), Partition(*fields)


def test_make_evaluator_pool3_matches_reference(weights_file, tmp_path):
    """``make_evaluator(inception_weights=..., fid_stats=...)``: the port's
    real statistics (pool3 features of the pool's first 100 images) saved
    as a stats file; FID of the same 100 samples in pool3 space within
    1e-3 relative of the reference's evaluator, which computes its real
    statistics itself (two rank-99 covariances in 2048-d, scipy's ``sqrtm``
    on each side), IS through the probe within 1e-6; stats whose dimension
    is not the extractor's raise, as the reference's do."""
    from cglgan_tpu_torch.evalx import fid

    kw = dict(algo="capgan", dataset="synthetic-mnist", num_workers=4,
              img_size=28)
    jpart, part = _image_partition()
    ref = jax_make_evaluator(JaxConfig(**kw), jpart, probe_steps=5,
                             inception_weights=weights_file)
    real = (part.eval_pool[:100].astype(np.float32) / 255.0 - 0.5) / 0.5
    extractor = inception.inception_extractor(
        inception.load_inception_weights(weights_file, device="cpu"))
    mu, sigma = fid.activation_stats(extractor, real.reshape(-1, 1, 28, 28))
    assert mu.shape == (inception.POOL3_DIM,)
    stats = str(tmp_path / "pool3_stats.npz")
    inception.save_fid_stats(stats, mu, sigma, side=28)
    got = make_evaluator(FedGANConfig(**kw), part, probe_steps=5,
                         inception_weights=weights_file, fid_stats=stats,
                         device="cpu")
    samples = np.random.default_rng(5).uniform(-1, 1, (100, 1, 28, 28)) \
        .astype(np.float32)
    r = ref(None, None, samples=samples)
    g = got(None, None, samples=torch.from_numpy(samples))
    assert set(g) == set(r) == {"fid", "inception_score"}
    assert abs(g["fid"] - r["fid"]) <= TOL_FID * abs(r["fid"]), (g, r)
    assert abs(g["inception_score"] - r["inception_score"]) \
        <= TOL_IS * r["inception_score"], (g, r)

    # proxy-space (256-d) stats with pool3 weights, and pool3 stats with
    # the proxy extractor
    small = str(tmp_path / "proxy_stats.npz")
    inception.save_fid_stats(small, np.zeros(256), np.eye(256), side=28)
    for extra in (dict(inception_weights=weights_file, fid_stats=small),
                  dict(fid_stats=stats)):
        with pytest.raises(ValueError, match="-d features"):
            make_evaluator(FedGANConfig(**kw), part, probe_steps=1,
                           device="cpu", **extra)

"""threefry2x32 in torch (``cglgan_tpu_torch/core/threefry.py``) against
``jax.random`` in partitionable mode, and the eval noise every family's
``sample`` draws with it.

Tolerances.  ``key``, ``fold_in``, ``split``, ``random_bits``, ``uniform``
and ``randint`` are bit-equal (``uniform`` emulates the fused multiply-add
XLA makes of its scaling on the CPU).  ``normal`` is within 3 ulps: it
follows XLA's float32 ``erf_inv`` polynomial, but ``log1p`` is torch's in
float64 rounded once, where XLA's is its own float32 one (2 ulps on
``erf_inv``, one more from the product with sqrt(2)).  Samples through an
eval-mode G from one carried-over state: rtol 1e-5, atol 1e-6.
"""
import jax
import numpy as np
import pytest
import torch

from cglgan_tpu.algos.registry import build_runner as jax_build_runner
from cglgan_tpu.core import prng as jprng
from cglgan_tpu.core.config import FedGANConfig as JaxConfig
from cglgan_tpu.data.partition import Partition as JaxPartition
from cglgan_tpu_torch.algos.registry import build_runner
from cglgan_tpu_torch.core import prng, threefry
from cglgan_tpu_torch.core.config import FedGANConfig
from cglgan_tpu_torch.data.partition import Partition
from cglgan_tpu_torch.utils.transplant import from_jax_numpy
from test_torch_port_threads import one_torch_thread  # noqa: F401

SEEDS = (0, 7, 20211212)
SHAPES = ((), (7,), (3, 5), (2, 3, 4))
NORMAL_ULPS = 3


def _key_data(k):
    return np.asarray(jax.random.key_data(k)).astype(np.int64)


def _ulps(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


@pytest.fixture(autouse=True)
def _no_tf32():
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = saved


@pytest.mark.parametrize("seed", SEEDS)
def test_key_fold_in_split_bit_equal(seed):
    key, jkey = threefry.key(seed), jax.random.key(seed)
    assert np.array_equal(key.numpy(), _key_data(jkey))
    for data in (0, 1, 6, 2**31, 2**32 - 1):
        assert np.array_equal(threefry.fold_in(key, data).numpy(),
                              _key_data(jax.random.fold_in(jkey, data)))
    for n in (1, 2, 5):
        got, ref = threefry.split(key, n), jax.random.split(jkey, n)
        assert np.array_equal(got.numpy(), _key_data(ref))
        # a split key splits and folds as JAX's does
        assert np.array_equal(threefry.split(got[-1], 3).numpy(),
                              _key_data(jax.random.split(ref[-1], 3)))
        assert np.array_equal(threefry.fold_in(got[0], 9).numpy(),
                              _key_data(jax.random.fold_in(ref[0], 9)))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("seed", SEEDS)
def test_random_bits_and_uniform_bit_equal(seed, shape):
    key, jkey = threefry.key(seed), jax.random.key(seed)
    bits = threefry.random_bits(key, shape)
    assert tuple(bits.shape) == shape
    assert np.array_equal(bits.numpy(),
                          np.asarray(jax.random.bits(jkey, shape))
                          .astype(np.int64))
    # [0, 1), a symmetric bound (conv / linear init), normal's range
    lo = float(np.nextafter(np.float32(-1), np.float32(0)))
    for minval, maxval in ((0.0, 1.0), (-1 / 3, 1 / 3), (-0.3, 0.7),
                           (lo, 1.0)):
        got = threefry.uniform(key, shape, minval, maxval)
        ref = np.asarray(jax.random.uniform(jkey, shape, minval=minval,
                                            maxval=maxval))
        assert got.dtype == torch.float32
        assert np.array_equal(got.numpy(), ref), (minval, maxval)


@pytest.mark.parametrize("seed", SEEDS)
def test_normal_within_ulps(seed):
    key, jkey = threefry.key(seed), jax.random.key(seed)
    for shape in SHAPES + ((20000,),):
        got = threefry.normal(key, shape)
        ref = np.asarray(jax.random.normal(jkey, shape))
        assert got.dtype == torch.float32 and tuple(got.shape) == shape
        assert _ulps(got.numpy(), ref).max(initial=0) <= NORMAL_ULPS, shape


@pytest.mark.parametrize("maxval", [10, 20000, 2**31 - 1])
@pytest.mark.parametrize("seed", SEEDS)
def test_randint_bit_equal(seed, maxval):
    key, jkey = threefry.key(seed), jax.random.key(seed)
    for shape in SHAPES + ((4096,),):
        got = threefry.randint(key, shape, 0, maxval)
        ref = np.asarray(jax.random.randint(jkey, shape, 0, maxval))
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), ref), shape
    got = threefry.randint(key, (999,), -maxval, 17)
    assert np.array_equal(got.numpy(), np.asarray(
        jax.random.randint(jkey, (999,), -maxval, 17)))


def test_eval_z_is_the_reference_noise():
    """``prng.eval_z``: the reference's ``fold_in(fold_in(root, ROLE_EVAL),
    member)`` normals, and without a member the FedAvg family's."""
    root = jprng.root_key(20211212)
    role = jprng.for_role(root, jprng.ROLE_EVAL)
    for member in (None, 0, 3):
        k = role if member is None else jprng.for_member(role, member)
        ref = np.asarray(jax.random.normal(k, (50, 100)))
        got = prng.eval_z(20211212, (50, 100), "cpu", member)
        assert _ulps(got.numpy(), ref).max() <= NORMAL_ULPS


def _partition(dataset, nw=4, length=48, seed=0):
    rng = np.random.default_rng(seed)
    if dataset == "2dmg":
        data = rng.uniform(-1, 1, (nw, length, 2)).astype(np.float32)
        pool = rng.uniform(-1, 1, (64, 2)).astype(np.float32)
    else:
        data = rng.integers(0, 256, (nw, length, 64)).astype(np.uint8)
        pool = rng.integers(0, 256, (10, 64)).astype(np.uint8)
    labels = rng.integers(0, 10, (nw, length)).astype(np.int32)
    freq = np.stack([np.bincount(row, minlength=10) for row in labels])
    fields = (data, labels,
              rng.integers(length // 2, length + 1, nw).astype(np.int32),
              freq.astype(np.int64), pool)
    return JaxPartition(*fields), Partition(*fields)


SAMPLE_CASES = {
    "capgan": dict(algo="capgan", dataset="synthetic-mnist", num_servers=2),
    "cglgan": dict(algo="cglgan", dataset="2dmg", num_servers=2),
    "acgan": dict(algo="acgan", dataset="2dmg", num_servers=2),
    "flgan": dict(algo="flgan", dataset="2dmg"),
    "fegan": dict(algo="fegan", dataset="2dmg", frac_workers=0.5),
}


@pytest.mark.parametrize("case", list(SAMPLE_CASES))
def test_sample_draws_the_reference_eval_noise(case):
    """``runner.sample`` from one carried-over state equals the
    reference's: the CGL and MD-GAN families draw a server's latents under
    ``fold_in(fold_in(key(seed), ROLE_EVAL), server)``, the FedAvg family
    under ``fold_in(key(seed), ROLE_EVAL)``.  (The port drew them from
    ``torch.Generator``s before, and its samples, and so its KL / DS,
    differed from the reference's on the same state.)"""
    kw = dict(num_workers=4, img_size=8, batch_size=8, num_sample=64,
              **SAMPLE_CASES[case])
    jpart, part = _partition(kw["dataset"])
    jrun = jax_build_runner(JaxConfig(**kw), jpart)
    run = build_runner(FedGANConfig(**kw), part, device="cpu")
    jstate = jrun.init_state()
    state = from_jax_numpy(jax.tree.map(np.asarray, jstate), run.cfg, "cpu")
    for n in (6, 10):
        got = run.sample(state, n)
        ref = np.asarray(jrun.sample(jstate, n))
        assert tuple(got.shape) == ref.shape
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6)

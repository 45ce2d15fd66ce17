"""The reference's threefry split tree in the port, against the JAX package
on the CPU.

A port run from a seed is the reference's run from that seed: the same
init, window starts, latents, dropout keys, survival draws, permutations
and 2DMG data (``cglgan_tpu_torch/core/prng.py``).

Tolerances.  Integer draws, keys, uniforms (float32 and bfloat16) and
everything made from them (the init's uniform leaves, window starts,
survival draws, permutations, labels) are bit-equal; Adam state at init
(zeros and counts) too.  float32 normals (latents, ``dcgan_reinit``'s
weights) are within 3 ulps: XLA's float32 ``erf_inv`` polynomial with
``log1p`` rounded from float64 (``core/threefry.py``); a bfloat16 normal is
that float32 value rounded, so within one bfloat16 step.  The 2DMG data is
a mode centre plus ``std`` times a normal: within 3 ulps of the normal
times ``std``, plus one rounding of the sum.  Runs from a seed, two or
three rounds with no stream injected: ``test_torch_port_prng_runs.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks.trajectory_parity import (cgl_round_streams,
                                          flgan_round_streams)
from cglgan_tpu.algos import registry as jregistry
from cglgan_tpu.core import prng as jprng
from cglgan_tpu.core.config import FedGANConfig as JaxConfig
from cglgan_tpu.data import gmm as jgmm
from cglgan_tpu.data.partition import Partition as JaxPartition
from cglgan_tpu_torch.algos import registry
from cglgan_tpu_torch.core import prng, threefry
from cglgan_tpu_torch.core.config import FedGANConfig
from cglgan_tpu_torch.data import gmm
from cglgan_tpu_torch.data.partition import Partition
from cglgan_tpu_torch.utils.transplant import from_jax_numpy
from cglgan_tpu_torch.utils.tree import tree_leaves
from test_torch_port_threads import one_torch_thread  # noqa: F401

NORMAL_ULPS = 3
SEEDS = (0, 7, 20211212)


def _key_data(k):
    return np.asarray(jax.random.key_data(k)).astype(np.int64)


def _ulps(a, b, bf16=False):
    """Distance in units in the last place of float32 (or of bfloat16:
    the top 16 bits of the float32 pattern)."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    ia, ib = a.view(np.int32).astype(np.int64), b.view(np.int32).astype(
        np.int64)
    if bf16:
        ia, ib = ia >> 16, ib >> 16
    return np.abs(ia - ib)



# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", SEEDS)
def test_small_bits_and_bf16_uniform_bit_equal(seed):
    """16- and 8-bit bits (the low bits of the words' xor); bfloat16
    ``uniform`` (8 bits, 7 under 1.0) at the inits' bounds, [0, 1) and an
    asymmetric range."""
    key, jkey = threefry.key(seed), jax.random.key(seed)
    for bw, dt in ((16, jnp.uint16), (8, jnp.uint8)):
        np.testing.assert_array_equal(
            threefry.random_bits(key, (33, 5), bw).numpy(),
            np.asarray(jax.random.bits(jkey, (33, 5), dt)).astype(np.int64))
    for lo, hi in ((-1 / 28, 1 / 28), (-0.1, 0.1), (0.0, 1.0), (-0.3, 0.7),
                   (-1 / 1152 ** 0.5, 1 / 1152 ** 0.5)):
        got = threefry.uniform(key, (700, 9), lo, hi, torch.bfloat16)
        ref = jax.random.uniform(jkey, (700, 9), jnp.bfloat16, lo, hi)
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(ref, np.float32))


@pytest.mark.parametrize("seed", SEEDS)
def test_bf16_normal_within_one_step(seed):
    key, jkey = threefry.key(seed), jax.random.key(seed)
    got = threefry.normal(key, (500, 40), torch.bfloat16)
    ref = jax.random.normal(jkey, (500, 40), jnp.bfloat16)
    assert got.dtype == torch.bfloat16
    assert _ulps(got.float().numpy(), np.asarray(ref, np.float32),
                 bf16=True).max() <= 1


@pytest.mark.parametrize("n", [1, 2, 10, 16, 20, 40, 1700])
def test_permutation_bit_equal(n):
    """JAX's sort-based shuffle: one round below n = 1 626, two at 1 700."""
    for seed in SEEDS:
        got = threefry.permutation(threefry.key(seed), n)
        ref = jax.random.permutation(jax.random.key(seed), n)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_fold_in_range_and_parts_match_vmap():
    """``fold_in`` over a range of data is the keys of each value; the
    ``*_parts`` draws are the per-key draws."""
    key, jkey = threefry.key(3), jax.random.key(3)
    got = threefry.fold_in(key, range(7, 40))
    ref = jax.vmap(lambda t: jax.random.fold_in(jkey, t))(jnp.arange(7, 40))
    np.testing.assert_array_equal(got.numpy(), _key_data(ref))
    keys, jkeys = threefry.split(key, 3), jax.random.split(jkey, 3)
    shapes = [(4, 5), (6,), (2, 3)]
    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        parts = threefry.uniform_parts(keys, shapes, -0.5, 0.5, dt)
        for j, (x, shape) in enumerate(zip(parts, shapes)):
            np.testing.assert_array_equal(
                x.float().numpy(), np.asarray(jax.random.uniform(
                    jkeys[j], shape, jdt, -0.5, 0.5), np.float32))


# ---------------------------------------------------------------------------
# init_state of every algorithm
# ---------------------------------------------------------------------------

def _image_partition(nw=4, L=32, din=64, seed=0):
    rng = np.random.default_rng(seed)
    fields = (rng.integers(0, 256, (nw, L, din)).astype(np.uint8),
              np.zeros((nw, L), np.int32), np.full(nw, L, np.int32),
              np.ones((nw, 10), np.int64), np.zeros((10, din), np.uint8))
    return JaxPartition(*fields), Partition(*fields)


INIT_CASES = {
    "capgan": dict(algo="capgan"),
    "cglgan": dict(algo="cglgan", iid=1),
    "mixgan": dict(algo="mixgan"),
    "mdgan": dict(algo="mdgan", num_servers=1),
    "acgan": dict(algo="acgan"),
    "flgan": dict(algo="flgan", num_servers=1),
    "fegan": dict(algo="fegan", num_servers=1),
    "cglgan_conv": dict(algo="cglgan", iid=1, conv=True),
    "mdgan_conv": dict(algo="mdgan", num_servers=1, conv=True),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(INIT_CASES))
def test_init_state_matches_reference(case, dtype):
    """``build_runner(cfg, part).init_state()`` against the reference's
    ``init_state()`` (jitted at the default level: at level 0 XLA fuses no
    multiply-add and the float32 uniforms' bits change), leaf for leaf in
    the port's layout: uniform leaves, BN state and Adam state bit-equal,
    Mix-G's DCGAN normals within 3 ulps (bfloat16: 1 step)."""
    kw = {"num_servers": 2, **INIT_CASES[case]}
    conv = kw.get("conv", False)
    jpart, part = _image_partition(din=1024 if conv else 64)
    kw = dict(dataset="synthetic-mnist", num_workers=4, img_size=8,
              batch_size=8, dtype=dtype, **kw)
    jrun = jregistry.build_runner(JaxConfig(**kw), jpart)
    ref = jax.tree.map(np.asarray, jax.jit(jrun.init_state)())
    cfg = FedGANConfig(**kw)
    got = registry.build_runner(cfg, part, device="cpu").init_state()
    ref = from_jax_numpy(ref, cfg, "cpu")
    bf16 = dtype == "bfloat16"
    normal = kw["algo"] == "mixgan"
    leaves = lambda s: tree_leaves([s.g.params, s.g.bn, s.d.params,
                                    s.d.bn, tuple(s.g.opt), tuple(s.d.opt),
                                    s.lam])
    mine, theirs = leaves(got), leaves(ref)
    assert len(mine) == len(theirs) > 0
    for a, b in zip(mine, theirs):
        assert a.dtype == b.dtype and a.shape == b.shape
        if normal and a.is_floating_point():
            # dcgan_reinit: normals (within ulps), zeros and kept biases
            assert _ulps(a.float().numpy(), b.float().numpy(),
                         bf16).max() <= (1 if bf16 else NORMAL_ULPS)
        else:
            assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the round streams
# ---------------------------------------------------------------------------

def _z_close(got, ref):
    assert tuple(got.shape) == np.shape(ref)
    assert _ulps(got.numpy(), ref).max() <= NORMAL_ULPS


@pytest.mark.parametrize("t", [0, 7])
def test_round_streams_match_reference(t):
    """CGL / MD-GAN: starts, z_d, z_g (``cgl_round_streams``) and, with
    conv, each server's ``k_d, k_drop`` = ``split(key_s, 4)[2:]``; the
    survival draw and MD-GAN's shuffle permutation from the round key."""
    kw = dict(algo="acgan", dataset="synthetic-mnist", num_workers=4,
              num_servers=2, img_size=8, batch_size=8, epoch=3, conv=True,
              dropout_rate=0.3)
    jcfg, cfg = JaxConfig(**kw), FedGANConfig(**kw)
    root = jprng.root_key(jcfg.seed)
    starts, z_d, z_g = cgl_round_streams(root, jcfg, 40)(t)
    got = prng.round_streams(cfg, t, 40, "cpu")
    assert list(got[0]) == [int(s) for s in starts]
    _z_close(got[1], z_d)
    _z_close(got[2], z_g)
    key = jprng.for_round(jprng.for_role(root, jprng.ROLE_LOCAL), t)
    servers = [jax.random.split(k, 4) for k in jax.random.split(key, 2)]
    for slot, j in ((3, 2), (4, 3)):
        np.testing.assert_array_equal(
            got[slot].numpy(), np.stack([_key_data(s[j]) for s in servers]))
    alive = jax.random.bernoulli(jax.random.fold_in(key, 7), 0.7, (4,))
    np.testing.assert_array_equal(prng.survival(cfg, t, 4, "cpu").numpy(),
                                  np.asarray(alive))
    perm = jax.random.permutation(jprng.for_role(key, jprng.ROLE_SWAP), 4)
    np.testing.assert_array_equal(
        prng.swap_permutation(cfg, t, 4, "cpu").numpy(), np.asarray(perm))


@pytest.mark.parametrize("t", [0, 7])
def test_sweep_streams_match_reference_with_a_ragged_lane(t):
    """FedAvg: starts, z1, z2 (``flgan_round_streams`` at the sweep's
    largest step count) and, with conv, each lane step's ``kd1, kd2``; a
    ragged lane of fewer steps takes the prefix of the same keys
    (``split(k, n)[i] == split(k, m)[i]``), so its active steps draw what
    the reference's masked sweep draws.  FeGAN's survival draw folds 7
    into ``fold_in(root, t)``."""
    kw = dict(algo="fegan", dataset="synthetic-mnist", num_workers=3,
              img_size=8, batch_size=8, epoch=1, conv=True, dropout_rate=0.5)
    jcfg, cfg = JaxConfig(**kw), FedGANConfig(**kw)
    root = jprng.root_key(jcfg.seed)
    steps = 5
    starts, z1, z2 = flgan_round_streams(root, jcfg, 40, steps)(t)
    got = prng.sweep_streams(cfg, t, 40, steps, "cpu")
    assert list(got[0]) == [int(s) for s in starts]
    _z_close(got[1], z1)
    _z_close(got[2], z2)
    key = jprng.for_round(jprng.for_role(root, jprng.ROLE_LOCAL), t)
    lanes = [jax.random.split(k, steps) for k in jax.random.split(key, 3)]
    for slot, j in ((3, 2), (4, 3)):
        np.testing.assert_array_equal(got[slot].numpy(), np.stack([
            np.stack([_key_data(jax.random.split(k, 4)[j]) for k in lane])
            for lane in lanes]))
    ragged = prng.sweep_streams(cfg, t, 40, 2, "cpu")
    for full, short in zip(got[1:], ragged[1:]):
        assert torch.equal(full[:, :2], short)
    alive = jax.random.bernoulli(
        jax.random.fold_in(jprng.for_round(root, t), 7), 0.5, (3,))
    np.testing.assert_array_equal(prng.survival(cfg, t, 3, "cpu").numpy(),
                                  np.asarray(alive))


def test_round_keys_pieces_and_bf16_latents():
    """``RoundKeys`` draws a piece of rounds at once: the same keys and
    starts as one round at a time, across a piece's end; a bfloat16 run's
    latents are the reference's bfloat16 draws."""
    kw = dict(algo="cglgan", dataset="synthetic-mnist", num_workers=4,
              num_servers=2, img_size=8, batch_size=8, epoch=2,
              dtype="bfloat16")
    cfg = FedGANConfig(**kw)
    rk = prng.RoundKeys(cfg, 40, 2, "cpu", piece=3)
    for t in range(7):
        one = prng.RoundKeys(cfg, 40, 2, "cpu", piece=1)
        assert torch.equal(rk.key(t), one.key(t))
        assert rk.starts(t) == one.starts(t)
    z_d = prng.server_draws(cfg, rk.key(5))[0]
    key = jprng.for_round(jprng.for_role(jprng.root_key(cfg.seed),
                                         jprng.ROLE_LOCAL), 5)
    ref = np.stack([np.asarray(jax.random.normal(
        jax.random.split(k, 4)[0], (8, 100), jnp.bfloat16), np.float32)
        for k in jax.random.split(key, 2)])
    assert z_d.dtype == torch.bfloat16
    assert _ulps(z_d.float().numpy(), ref, bf16=True).max() <= 1


# ---------------------------------------------------------------------------
# the 2DMG data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_class,per,seed", [(5, 2000, 20211212),
                                              (8, 1000, 3)])
def test_gmm_dataset_is_the_reference_draw(n_class, per, seed):
    """Labels bit-equal (``randint`` and a stable sort, as the reference's
    ``argsort(stable=True)``), data within 3 ulps of the normal times std
    plus one rounding of the sum."""
    data, labels = gmm.gmm_dataset(n_class, per, seed=seed)
    ref_data, ref_labels = jgmm.gmm_dataset(n_class, per, seed=seed)
    ref_data = np.asarray(ref_data)
    np.testing.assert_array_equal(labels, np.asarray(ref_labels))
    assert data.dtype == ref_data.dtype == np.float32
    noise = np.abs(ref_data - gmm.gmm_modes(n_class)[labels]).astype(
        np.float32)
    bound = NORMAL_ULPS * np.spacing(noise) + np.spacing(np.abs(ref_data))
    assert np.all(np.abs(data - ref_data) <= bound)

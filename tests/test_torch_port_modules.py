"""Module-by-module parity of the PyTorch port against the JAX package.

Each test makes its inputs with numpy from a seed, runs the JAX function and
its ``cglgan_tpu_torch`` counterpart on them (on the CPU) and compares:
host-side integer work (config, data bytes, partitions, topology) must be
equal; float32 math agrees to the stated tolerance (sums run in another
order in XLA and in PyTorch).
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cglgan_tpu.algos import common as jcommon
from cglgan_tpu.algos import game as jgame
from cglgan_tpu.core import config as jconfig
from cglgan_tpu.data import mnist as jmnist
from cglgan_tpu.data import native as jnative
from cglgan_tpu.data.partition import partition as jpartition
from cglgan_tpu.fed import collectives as jcoll
from cglgan_tpu.fed import topology as jtopo
from cglgan_tpu.models import zoo as jzoo
from cglgan_tpu_torch.algos import common, game
from cglgan_tpu_torch.core import config
from cglgan_tpu_torch.data import mnist, native
from cglgan_tpu_torch.data.partition import partition
from cglgan_tpu_torch.fed import collectives, topology
from cglgan_tpu_torch.models import zoo
from cglgan_tpu_torch.utils.tree import tree_leaves, tree_map
from test_torch_port_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-5, 1e-6          # float32 forward math, reordered sums


def _t(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------------------
# core/config
# ---------------------------------------------------------------------------

CONFIGS = [
    {},
    dict(algo="capgan", dataset="synthetic-mnist", num_workers=16, iid=1,
         batch_size=100, epoch=5),
    dict(algo="acgan", dataset="mnist"),
    dict(algo="flgan", dataset="synthetic-mnist"),
    dict(algo="mixgan", dataset="2dmg", d_head="sigmoid", weighting="beta"),
    dict(algo="nope"),
    dict(dataset="cifar"),
    dict(iid=3),
    dict(num_workers=10, num_servers=3),
    dict(weighting="bogus"),
    dict(algo="capgan", dropout_rate=0.2),
    dict(algo="mdgan", dropout_rate=1.0),
    dict(model_shards=0),
    dict(algo="flgan", model_shards=2),
    dict(d_swap="bad"),
    dict(gossip="bad"),
    dict(dtype="bfloat16"),
    dict(dtype="bfloat16", force_dtype=True),
    dict(dtype="bfloat16", dataset="mnist"),
]


@pytest.mark.parametrize("kw", CONFIGS, ids=[str(i) for i in
                                              range(len(CONFIGS))])
def test_config_accept_reject_and_resolved(kw):
    def build(mod):
        try:
            return mod.FedGANConfig(**kw), None
        except ValueError as e:
            return None, str(e)
    ref, ref_err = build(jconfig)
    got, got_err = build(config)
    assert got_err == ref_err
    if ref is None:
        return
    assert got == config.FedGANConfig(**ref.__dict__)
    for prop in ("clients_per_server", "is_image", "img_shape",
                 "resolved_weighting", "resolved_local_sweep",
                 "resolved_d_head"):
        assert getattr(got, prop) == getattr(ref, prop), prop


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["numpy", "native", "auto"])
def test_synthetic_mnist_bytes(backend):
    if backend != "numpy":
        assert jnative.available()       # builds native/libdataplane.so
        assert native.available()
    ref = jmnist.synthetic_mnist(n=300, seed=3, backend=backend)
    got = mnist.synthetic_mnist(n=300, seed=3, backend=backend)
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])


def test_idx_loader_round_trip(tmp_path):
    imgs = np.random.default_rng(0).integers(0, 256, (5, 4, 4), np.uint8)
    labels = np.arange(5, dtype=np.uint8)
    with open(tmp_path / "train-images-idx3-ubyte", "wb") as f:
        f.write(bytes([0, 0, 8, 3]) + np.asarray([5, 4, 4], ">u4").tobytes()
                + imgs.tobytes())
    with open(tmp_path / "train-labels-idx1-ubyte", "wb") as f:
        f.write(bytes([0, 0, 8, 1]) + np.asarray([5], ">u4").tobytes()
                + labels.tobytes())
    for got, ref in zip(mnist.load_idx_dataset(str(tmp_path)),
                        jmnist.load_idx_dataset(str(tmp_path))):
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("iid", [0, 1, 2])
def test_partition_byte_equal(iid):
    data, labels = jmnist.synthetic_mnist(n=600, img=8, seed=1,
                                          backend="numpy")
    data = data.reshape(len(data), -1)
    ref = jpartition(data, labels, 4, iid, num_sample=50, seed=5)
    got = partition(data, labels, 4, iid, num_sample=50, seed=5)
    for field in ("data", "labels", "lengths", "class_freq", "eval_pool"):
        a, b = getattr(got, field), getattr(ref, field)
        assert a.dtype == b.dtype, field
        np.testing.assert_array_equal(a, b, err_msg=field)


def test_topology():
    lengths = np.asarray([30, 10, 25, 35, 5, 15], np.int32)
    for S in (1, 2, 3):
        np.testing.assert_array_equal(topology.server_beta(lengths, S),
                                      jtopo.server_beta(lengths, S))
        np.testing.assert_array_equal(topology.server_data_len(lengths, S),
                                      jtopo.server_data_len(lengths, S))
        assert topology.block_assignment(6, S) == \
            jtopo.block_assignment(6, S)


# ---------------------------------------------------------------------------
# fed/collectives
# ---------------------------------------------------------------------------

def _tree(rng, lead):
    return [{"w": rng.normal(size=lead + (3, 2)).astype(np.float32),
             "b": rng.normal(size=lead + (2,)).astype(np.float32)}, None]


def _close_trees(got, ref, rtol=RTOL, atol=ATOL):
    for a, b in zip(tree_leaves(got), jax.tree.leaves(ref)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=rtol,
                                   atol=atol)


def test_collectives():
    rng = np.random.default_rng(0)
    a, b = _tree(rng, (4,)), _tree(rng, (4,))
    ta, tb = tree_map(_t, a), tree_map(_t, b)
    w = np.asarray([0.1, 0.2, 0.3, 0.4], np.float32)
    mask = np.asarray([1, 0, 1, 0], np.float32)
    _close_trees(collectives.sigma_mix(ta, tb, 0.3),
                 jcoll.sigma_mix(a, b, 0.3))
    _close_trees(collectives.masked_weighted_avg_tree(ta, _t(w), _t(mask)),
                 jcoll.masked_weighted_avg_tree(a, w, mask))
    _close_trees(collectives.select_update_tree(ta, tb, _t(mask)),
                 jcoll.select_update_tree(a, b, mask))
    _close_trees(collectives.neighbor_share_tree(ta, 2),
                 jcoll.neighbor_share_tree(a, 2))
    blk = _tree(rng, (2, 3))
    _close_trees(collectives.neighbor_share_tree(tree_map(_t, blk), 3,
                                                 blocked=True),
                 jcoll.neighbor_share_tree(blk, 3, blocked=True))


# ---------------------------------------------------------------------------
# models: same params (carried over from the JAX init) -> same outputs
# ---------------------------------------------------------------------------

def _jax_stacked_init(model, n, seed):
    p, s = jax.vmap(lambda k: model.init(k))(
        jax.random.split(jax.random.key(seed), n))
    return p, s


@pytest.mark.parametrize("train", [True, False])
def test_generator_matches(train):
    S, Bz = 2, 6
    jg = jzoo.build_generator("mnist-mlp", img_shape=(1, 8, 8))
    g = zoo.build_generator("mnist-mlp", img_shape=(1, 8, 8))
    p, s = _jax_stacked_init(jg, S, 0)
    # a non-trivial BN state so eval mode is tested on real statistics
    rng = np.random.default_rng(1)
    s = jax.tree.map(lambda x: x + np.abs(rng.normal(size=x.shape))
                     .astype(np.float32) * 0.1, s)
    z = rng.normal(size=(S, Bz, 100)).astype(np.float32)
    ref_y, ref_s = jax.vmap(lambda pp, ss, zz: jg.apply(pp, ss, zz,
                                                         train=train))(
        p, s, jnp.asarray(z))
    conv = lambda tree: tree_map(_t, list(jax.tree.map(np.asarray, tree)))
    y, new_s = g.apply(conv(p), conv(s), _t(z), train=train)
    assert tuple(y.shape) == tuple(ref_y.shape) == (S, Bz, 1, 8, 8)
    np.testing.assert_allclose(y.numpy(), np.asarray(ref_y), rtol=1e-4,
                               atol=1e-5)
    _close_trees(new_s, ref_s)


@pytest.mark.parametrize("out_dim", [1, 2])
def test_discriminator_matches(out_dim):
    W, Bx = 3, 5
    jd = jzoo.build_discriminator("mnist", out_dim, in_dim=64)
    d = zoo.build_discriminator("mnist", out_dim, in_dim=64)
    p, s = _jax_stacked_init(jd, W, 2)
    x = np.random.default_rng(3).normal(size=(W, Bx, 64)).astype(np.float32)
    ref_y, _ = jax.vmap(lambda pp, ss, xx: jd.apply(pp, ss, xx))(
        p, s, jnp.asarray(x))
    y, _ = d.apply(tree_map(_t, list(jax.tree.map(np.asarray, p))),
                   list(s), _t(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(ref_y), rtol=RTOL,
                               atol=ATOL)


def test_models_for_config_and_unported():
    cfg = config.FedGANConfig(algo="capgan", dataset="synthetic-mnist",
                              img_size=8)
    g, d = zoo.models_for_config(cfg)
    assert d.out_dim == 2 and d.spec[0] == ("linear", 64, 512)
    assert g.spec[-2] == ("linear", 1024, 64)
    # the 2DMG single-path pairs, the multipath Gs and the conv family are
    # ported
    g2, d2 = zoo.models_for_config(cfg.replace(dataset="2dmg"))
    assert g2.spec[0] == ("linear", 100, 32) and d2.spec[0] == (
        "linear", 2, 128)
    for kw, multi in ((dict(algo="mixgan"), True),
                      (dict(algo="mixgan", dataset="2dmg"), True),
                      (dict(algo="cglgan", dataset="2dmg", iid=1), True),
                      (dict(algo="cglgan", iid=0), False)):
        assert zoo.models_for_config(cfg.replace(**kw))[0].multipath == multi
    g3, d3 = zoo.models_for_config(cfg.replace(conv=True))
    assert (g3.spec, g3.multipath, d3.spec, d3.out_dim) == ("conv", False,
                                                            "conv", 1)
    for family in ("conv", "conv-multipath"):
        g4 = zoo.build_generator(family, 2)
        assert g4.spec == family
        assert g4.multipath == (family == "conv-multipath")
    assert zoo.build_discriminator("conv").spec == "conv"


# ---------------------------------------------------------------------------
# algos/common and algos/game
# ---------------------------------------------------------------------------

def test_losses():
    rng = np.random.default_rng(4)
    p = np.concatenate([rng.uniform(size=(7, 1)), [[0.0], [1.0]]]) \
        .astype(np.float32)
    logits = rng.normal(size=(9, 2)).astype(np.float32) * 3
    for t in (0.0, 1.0):
        np.testing.assert_allclose(float(common.bce(_t(p), t)),
                                   float(jcommon.bce(jnp.asarray(p), t)),
                                   rtol=RTOL)
        np.testing.assert_allclose(
            float(common.ce2(_t(logits), int(t))),
            float(jcommon.ce2(jnp.asarray(logits), int(t))), rtol=RTOL)
        np.testing.assert_allclose(
            float(common.bce_logits(_t(logits[:, :1]), t)),
            float(jcommon.bce_logits(jnp.asarray(logits[:, :1]), t)),
            rtol=RTOL)


@pytest.mark.parametrize("head,out_dim,half", [("sigmoid", 1, False),
                                               ("logits2", 2, True)])
def test_d_epoch_steps_autograd(head, out_dim, half):
    """The autograd local-D path (epoch=1 and pallas_dstep=False) for W
    clients over E=2 steps, against the JAX d_step_fn + d_epoch_steps.
    Tolerances as tests/test_pallas_dstep.py (Adam-normalised updates)."""
    W, E, B, DIN = 3, 2, 8, 64
    jd = jzoo.build_discriminator("mnist", out_dim, in_dim=DIN)
    opt = optax.adam(2e-4, b1=0.5, b2=0.999)
    jnet = jcommon.init_net_stacked(jd, jax.random.key(0), opt, W)
    rng = np.random.default_rng(0)
    shard = rng.integers(0, 256, size=(W, 32, DIN)).astype(np.uint8)
    fake = rng.normal(size=(B, DIN)).astype(np.float32)
    starts = [1, 17]
    jstep = jcommon.d_epoch_steps(jcommon.d_step_fn(
        jd, jcommon.make_adv_loss(head), opt, B, True, half), E)
    ref, ref_loss = jax.vmap(jstep, in_axes=(0, 0, None, None, None))(
        jnet, jnp.asarray(shard), jnp.asarray(starts), jnp.asarray(fake),
        jax.random.key(9))

    d = zoo.build_discriminator("mnist", out_dim, in_dim=DIN)
    params = tree_map(_t, list(jax.tree.map(np.asarray, jnet.params)))
    net = common.NetState(params, list(jnet.bn), common.adam_init(params, W))
    step = common.d_epoch_steps(common.d_step_fn(
        d, common.make_adv_loss(head), 2e-4, 0.5, 0.999, B, True, half), E)
    got, loss = step(net, _t(shard), starts, _t(fake))
    _close_trees(got.params, ref.params, rtol=1e-4, atol=1e-6)
    _close_trees(got.opt.mu, ref.opt[0].mu, rtol=1e-4, atol=1e-6)
    _close_trees(got.opt.nu, ref.opt[0].nu, rtol=1e-4, atol=1e-9)
    np.testing.assert_array_equal(got.opt.count.numpy(),
                                  np.asarray(ref.opt[0].count))
    np.testing.assert_allclose(loss.numpy(), np.asarray(ref_loss),
                               rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("mode", ["cgl_mean_game", "cap_exp", "mix_bll",
                                  "beta_gamma", "beta", "gamma", "mean"])
def test_game_step_every_mode(mode):
    """Batched over S=2 servers, each row against the JAX function."""
    rng = np.random.default_rng(5)
    l = rng.uniform(0.3, 1.5, size=(2, 4)).astype(np.float32)
    beta = rng.uniform(size=(2, 4)).astype(np.float32)
    beta /= beta.sum(1, keepdims=True)
    lam = np.asarray([0.7, -0.4], np.float32)
    got = game.game_step(mode, _t(l), _t(beta), _t(lam), 0.1)
    for s in range(2):
        ref = jgame.game_step(mode, jnp.asarray(l[s]), jnp.asarray(beta[s]),
                              jnp.float32(lam[s]), 0.1)
        for field in ref._fields:
            np.testing.assert_allclose(
                getattr(got, field)[s].numpy(),
                np.asarray(getattr(ref, field)), rtol=RTOL, atol=ATOL,
                err_msg=field)


# ---------------------------------------------------------------------------
# the port imports neither jax nor the JAX package
# ---------------------------------------------------------------------------

def test_port_imports_no_jax():
    """Import every port module (and chip_smoke) in a fresh interpreter
    where ``jax``, ``optax`` and ``cglgan_tpu`` cannot be imported."""
    mods = sorted(
        os.path.relpath(os.path.join(dp, f), ROOT)[:-3].replace(os.sep, ".")
        for dp, _, fs in os.walk(os.path.join(ROOT, "cglgan_tpu_torch"))
        for f in fs if f.endswith(".py"))
    for name in ("ops.fused_dstep", "ops.fused_sweep", "ops.fused_adam",
                 "algos.fedavg_family", "algos.mdgan_family", "data.gmm",
                 "fed.sampling", "evalx.hist2d", "evalx.evaluator",
                 "core.threefry", "evalx.fid", "evalx.inception",
                 "utils.export", "utils.torch_import", "core.meshes",
                 "utils.dryrun", "models.tp"):
        assert f"cglgan_tpu_torch.{name}" in mods
    code = (
        "import sys, importlib\n"
        "for name in ('jax', 'jaxlib', 'optax', 'cglgan_tpu'):\n"
        "    sys.modules[name] = None\n"
        f"for m in {mods + ['chip_smoke']!r}:\n"
        "    importlib.import_module(m.removesuffix('.__init__'))\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'optax', 'cglgan_tpu') and sys.modules[m]]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"

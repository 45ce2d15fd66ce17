"""CGL-GAN and Mix-G in the port against the JAX package, on the CPU.

Modules: the multipath generators (``mnist-multipath``, ``2dmg-multipath``)
on weights carried over from the JAX init, ``dcgan_reinit`` by its
statistics and its zero and untouched leaves, and a transplant round trip of
a multipath ``FedState``.

The slice as a whole: a small hierarchy (2 servers of 2 clients, 8x8 images
or 2DMG rows, batch 8) starts from the JAX ``init_state()`` carried across
by ``utils/transplant.py`` (Mix-G's DCGAN draws cannot match JAX's bits) and
runs 5 rounds on each side with the JAX draws injected into the port's
``round_fn`` (``benchmarks/trajectory_parity.py`` ``cgl_round_streams``).
The autograd D path runs at epoch=1; the fused local-D path at epoch=2 (JAX
``pallas_dstep=True`` in interpret mode against the port's auto rule, which
runs the kernel's plain version on the CPU).  A cloud sync fires at rounds
0, 2 and 4.  Compared: G and D params, G BN running stats, Adam moments and
counts, Lambda, the round counter and every round's metrics; then ``gen``,
``gen_client`` and ``sample``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks.trajectory_parity import cgl_round_streams
from cglgan_tpu.algos.registry import build_runner as jax_build_runner
from cglgan_tpu.core import prng as jprng
from cglgan_tpu.core.config import FedGANConfig as JaxConfig
from cglgan_tpu.data.partition import Partition as JaxPartition
from cglgan_tpu.models import nn as jnn
from cglgan_tpu.models import zoo as jzoo
from cglgan_tpu_torch.algos.registry import build_runner
from cglgan_tpu_torch.algos.runner import train
from cglgan_tpu_torch.core.config import FedGANConfig
from cglgan_tpu_torch.data.partition import Partition
from cglgan_tpu_torch.models import nn, zoo
from cglgan_tpu_torch.ops import fused_dstep
from cglgan_tpu_torch.utils.transplant import from_jax_numpy, to_numpy
from cglgan_tpu_torch.utils.tree import tree_leaves, tree_map

ROUNDS = 5
NW, S, L, B = 4, 2, 48, 8
LENGTHS = np.asarray([30, 48, 41, 36], np.int32)
LR = 2e-4

# Tolerances.  Both sides are float32 on the CPU and sum in another order.
# As tests/test_torch_port_capgan.py: params (rtol, atol) elementwise,
# moments to 1e-4 of their group's largest entry, metrics 1e-5 absolute
# (losses ~0.7).  cgl_mean_game steps Lambda by 10x the loss variance under
# gamma, so Lambda is held like a metric: 1e-5 absolute.
TOL_PARAMS = (1e-4, 1e-5)
TOL_MOMENT = 1e-4
TOL_METRIC = 1e-5
TOL_FWD = (1e-4, 1e-5)           # one forward, reordered sums


def _t(x):
    return torch.from_numpy(np.array(x))


def _partition(dataset, seed=0):
    rng = np.random.default_rng(seed)
    if dataset == "2dmg":
        data = rng.uniform(-1, 1, (NW, L, 2)).astype(np.float32)
        pool = np.zeros((10, 2), np.float32)
    else:
        data = rng.integers(0, 256, (NW, L, 64)).astype(np.uint8)
        pool = np.zeros((10, 64), np.uint8)
    fields = (data, np.zeros((NW, L), np.int32), LENGTHS,
              np.zeros((NW, 10), np.int64), pool)
    return JaxPartition(*fields), Partition(*fields)


def _pre_bn_mask(spec):
    """A tree shaped like the params: True at linear biases that feed a
    BatchNorm.  Their gradient is exactly zero, so Adam moves them by
    rounding noise alone (up to ~lr a round) on either side."""
    if isinstance(spec, dict):
        return {key: _pre_bn_mask(sub) for key, sub in spec.items()}
    out = []
    for i, entry in enumerate(spec):
        if entry[0] == "linear":
            feeds_bn = i + 1 < len(spec) and spec[i + 1][0] == "bn"
            out.append({"w": False, "b": feeds_bn})
        elif entry[0] == "bn":
            out.append({"scale": False, "bias": False})
        else:
            out.append(None)
    return out


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family,train", [("mnist-multipath", True),
                                          ("mnist-multipath", False),
                                          ("2dmg-multipath", True)])
def test_multipath_generator_matches(family, train):
    """Same weights and BN state (carried over from a JAX init stacked over
    S servers, BN stats perturbed so eval mode reads real statistics) and
    latents: outputs (S, k, B, ...) and new BN state agree."""
    k, Bz = 3, 6
    kw = dict(img_shape=(1, 8, 8)) if family.startswith("mnist") else {}
    jg = jzoo.build_generator(family, k, **kw)
    g = zoo.build_generator(family, k, **kw)
    p, s = jax.vmap(lambda kk: jg.init(kk))(
        jax.random.split(jax.random.key(0), S))
    rng = np.random.default_rng(1)
    s = jax.tree.map(lambda x: x + np.abs(rng.normal(size=x.shape))
                     .astype(np.float32) * 0.1, s)
    z = rng.normal(size=(S, Bz, 100)).astype(np.float32)
    ref_y, ref_s = jax.vmap(lambda pp, ss, zz: jg.apply(pp, ss, zz,
                                                         train=train))(
        p, s, jnp.asarray(z))
    conv = lambda tree: tree_map(_t, jax.tree.map(np.asarray, tree))
    y, new_s = g.apply(conv(p), conv(s), _t(z), train=train)
    out = (1, 8, 8) if family.startswith("mnist") else (2,)
    assert g.multipath and tuple(y.shape) == tuple(ref_y.shape) \
        == (S, k, Bz) + out
    np.testing.assert_allclose(y.numpy(), np.asarray(ref_y),
                               rtol=TOL_FWD[0], atol=TOL_FWD[1])
    got_l, ref_l = tree_leaves(new_s), jax.tree.leaves(ref_s)
    assert len(got_l) == len(ref_l)
    for a, b in zip(got_l, ref_l):
        np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                   rtol=TOL_FWD[0], atol=TOL_FWD[1])
    # the port's own init: trunk (S, ...), heads (S, k, ...)
    gp, gbn = g.init(torch.Generator().manual_seed(0), S)
    assert all(x.shape[:2] == (S, k) for x in tree_leaves(gp["heads"]))
    assert [tuple(x.shape) for x in tree_leaves(gp["trunk"])] == \
        [tuple(np.shape(x)) for x in jax.tree.leaves(p["trunk"])]


def test_dcgan_reinit_statistics_and_rank_rule():
    """Weights ~ N(0, 0.02), BN scales ~ N(1, 0.02), linear and BN biases
    0, conv biases (sibling weight of rank 4 a member) untouched; the same
    leaves as the reference's, by path, on stacked (N, ...) and multipath
    (S, k, ...) leaves."""
    n = 3
    rng = np.random.default_rng(0)
    f32 = lambda *shape: rng.normal(size=shape).astype(np.float32)
    one = lambda lead: [
        {"w": f32(*lead, 64, 128), "b": f32(*lead, 128)},           # linear
        {"scale": f32(*lead, 128), "bias": f32(*lead, 128)},       # BN
        None,
        {"w": f32(*lead, 16, 8, 3, 3), "b": f32(*lead, 16)}]      # conv
    tree = {"trunk": one((n,)), "heads": one((n, 2))}
    port = nn.dcgan_reinit(torch.Generator().manual_seed(5),
                           tree_map(_t, tree))
    # the reference on one unstacked member
    ref = jnn.dcgan_reinit(jax.random.key(5),
                           jax.tree.map(lambda x: x[0], tree["trunk"]))
    for lead, sub in (((n,), port["trunk"]), ((n, 2), port["heads"])):
        src = tree["trunk"] if len(lead) == 1 else tree["heads"]
        for w in (sub[0]["w"], sub[3]["w"]):
            assert abs(float(w.mean())) < 2e-3
            assert abs(float(w.std()) - 0.02) < 2e-3
        assert abs(float(sub[1]["scale"].mean()) - 1.0) < 2e-3
        assert abs(float(sub[1]["scale"].std()) - 0.02) < 2e-3
        assert not sub[0]["b"].any() and not sub[1]["bias"].any()
        np.testing.assert_array_equal(sub[3]["b"].numpy(), src[3]["b"])
        assert sub[2] is None
        assert all(tuple(a.shape) == np.shape(b) for a, b in
                   zip(tree_leaves(sub), jax.tree.leaves(src)))
    # which leaves the reference zeroes and leaves alone
    assert not np.asarray(ref[0]["b"]).any()
    assert not np.asarray(ref[1]["bias"]).any()
    np.testing.assert_array_equal(np.asarray(ref[3]["b"]),
                                  tree["trunk"][3]["b"][0])


@pytest.mark.parametrize("algo,dataset", [("cglgan", "synthetic-mnist"),
                                          ("mixgan", "2dmg")])
def test_transplant_round_trip_multipath(algo, dataset):
    """A multipath FedState carries over leaf for leaf: G trees are dicts
    (trunk (S, ...), heads (S, k, ...)), D state is flattened (W, ...)."""
    jpart, _ = _partition(dataset)
    kw = dict(algo=algo, dataset=dataset, num_workers=NW, num_servers=S,
              img_size=8, batch_size=B)
    jstate = jax_build_runner(JaxConfig(**kw), jpart).init_state()
    ref = jax.tree.map(np.asarray, jstate)
    state = from_jax_numpy(ref, FedGANConfig(**kw), "cpu")
    got = to_numpy(state)
    assert set(state.g.params) == {"trunk", "heads"}
    pairs = [(got["g"][key], ref.g.params) for key in ("params",)] + \
        [(got["g"]["bn"], ref.g.bn), (got["g"]["mu"], ref.g.opt[0].mu),
         (got["g"]["nu"], ref.g.opt[0].nu)]
    for mine, theirs in pairs:
        a_l, b_l = tree_leaves(mine), jax.tree.leaves(theirs)
        assert len(a_l) == len(b_l)          # 2DMG: no BN buffers
        for a, b in zip(a_l, b_l):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(tree_leaves(got["d"]["params"]),
                    jax.tree.leaves(ref.d.params)):
        np.testing.assert_array_equal(a, b.reshape((NW,) + b.shape[2:]))
    np.testing.assert_array_equal(got["d"]["count"],
                                  ref.d.opt[0].count.reshape(NW))
    assert got["t"] == 0 and got["lam"].shape == (S,)


# ---------------------------------------------------------------------------
# the slice as a whole: 5 shrunk rounds against JAX
# ---------------------------------------------------------------------------

# segema is never 0 here.  At segema=0 a sync leaves every server with the
# same trunk, and the reference's jitted round then departs from the same
# round run eagerly (``jax.disable_jit()``) by up to two Adam steps of the
# synced G (cglgan: round 0; mixgan: round 3); the port follows the eager
# run to 1e-6 there.  Noted in ROADMAP queue 3.
ROUND_CASES = {
    # id: (algo, dataset, iid, epoch, kernel, E, segema)
    "cglgan_epoch1": ("cglgan", "synthetic-mnist", 1, 1, False, 2, 0.5),
    "cglgan_epoch2_kernel": ("cglgan", "synthetic-mnist", 1, 2, True, 0,
                             0.25),
    "cglgan_iid0_single_path": ("cglgan", "synthetic-mnist", 0, 1, False,
                                0, 0.5),
    "mixgan_epoch1": ("mixgan", "synthetic-mnist", 1, 1, False, 0, 0.25),
    "mixgan_epoch2_kernel": ("mixgan", "synthetic-mnist", 1, 2, True, 0,
                             0.5),
    "2dmg_cglgan_kernel": ("cglgan", "2dmg", 1, 2, True, 0, 0.5),
    "2dmg_mixgan_kernel": ("mixgan", "2dmg", 1, 2, True, 0, 0.25),
    "2dmg_capgan_kernel": ("capgan", "2dmg", 1, 2, True, 0, 0.5),
}


def _close_net(got, jnet, net, noisy):
    # the reference stacks D state (S, k, ...), the port (W, ...)
    flat = (lambda x: np.asarray(x).reshape((NW,) + np.shape(x)[2:])) \
        if net == "d" else np.asarray
    jadam = jnet.opt[0]
    np.testing.assert_array_equal(got["count"],
                                  flat(jadam.count).astype(np.int64))
    pairs = list(zip(tree_leaves(got["params"]),
                     jax.tree.leaves(jnet.params)))
    assert len(pairs) == len(noisy)
    for i, ((a, b), zero_grad) in enumerate(zip(pairs, noisy)):
        if zero_grad:
            # zero-gradient bias: bounded by one Adam step per round
            np.testing.assert_allclose(a, flat(b), rtol=0,
                                       atol=LR * ROUNDS)
            continue
        np.testing.assert_allclose(a, flat(b), rtol=TOL_PARAMS[0],
                                   atol=TOL_PARAMS[1],
                                   err_msg=f"{net} param leaf {i}")
    bn_pairs = list(zip(tree_leaves(got["bn"]), jax.tree.leaves(jnet.bn)))
    for i, (a, b) in enumerate(bn_pairs):
        np.testing.assert_allclose(a, flat(b), rtol=TOL_PARAMS[0],
                                   atol=TOL_PARAMS[1],
                                   err_msg=f"{net} BN buffer {i}")
    for moment in ("mu", "nu"):
        got_l = tree_leaves(got[moment])
        ref_l = [flat(x) for x in jax.tree.leaves(getattr(jadam, moment))]
        scale = max(float(np.abs(x).max()) for x in ref_l)
        for i, (a, b) in enumerate(zip(got_l, ref_l)):
            np.testing.assert_allclose(
                a, b, rtol=0, atol=TOL_MOMENT * scale,
                err_msg=f"{net} {moment} leaf {i}")
    return len(bn_pairs)


@pytest.mark.parametrize("case", sorted(ROUND_CASES))
def test_cgl_rounds_match_jax(case):
    algo, dataset, iid, epoch, kernel, e_share, segema = ROUND_CASES[case]
    jpart, part = _partition(dataset)
    kw = dict(algo=algo, dataset=dataset, num_workers=NW, num_servers=S,
              iid=iid, img_size=8, batch_size=B, epoch=epoch, E=e_share,
              cloud_epoch=2, segema=segema, num_communication=10)
    jcfg = JaxConfig(pallas_dstep=True if kernel else None, **kw)
    cfg = FedGANConfig(**kw)
    assert fused_dstep.eligible(cfg) == kernel

    jrun = jax_build_runner(jcfg, jpart)
    jstate = jrun.init_state()
    jround = jax.jit(jrun.round_fn)
    streams = cgl_round_streams(jprng.root_key(jcfg.seed), jcfg, L)

    run = build_runner(cfg, part, device="cpu")
    g_model = zoo.models_for_config(cfg)[0]
    assert g_model.multipath == (algo == "mixgan" or
                                 algo == "cglgan" and iid != 0)
    state = from_jax_numpy(jax.tree.map(np.asarray, jstate), cfg, "cpu")
    launched = fused_dstep.launches
    for t in range(ROUNDS):
        starts, z_d, z_g = streams(t)
        jstate, jm = jround(jstate)
        state, m = run.round_fn(state, (starts, torch.from_numpy(z_d),
                                        torch.from_numpy(z_g)))
        assert set(m) == set(jm)
        for key in jm:
            assert abs(float(m[key]) - float(jm[key])) < TOL_METRIC, \
                (t, key, float(m[key]), float(jm[key]))
    assert fused_dstep.launches == launched    # CPU: the plain version

    got = to_numpy(state)
    ref = jax.tree.map(np.asarray, jstate)
    assert got["t"] == int(ref.t) == ROUNDS
    np.testing.assert_allclose(got["lam"], ref.lam, rtol=0, atol=TOL_METRIC)
    noisy = tree_leaves(_pre_bn_mask(g_model.spec))
    n_bn = _close_net(got["g"], ref.g, "g", noisy)
    assert n_bn == (0 if dataset == "2dmg" else 6)   # 3 BatchNorms
    d_noisy = [False] * len(tree_leaves(got["d"]["params"]))
    _close_net(got["d"], ref.d, "d", d_noisy)


@pytest.mark.parametrize("algo,dataset", [("cglgan", "synthetic-mnist"),
                                          ("mixgan", "2dmg")])
def test_gen_gen_client_and_sample_match_jax(algo, dataset):
    """Serving paths from one carried-over multipath state: ``gen``
    (painter routing: the heads' concat strided back to the per-server
    quota) and each client's ``gen_client`` (head c % k of server c // k)
    equal the reference; ``sample`` gives finite values in [-1, 1] of the
    reference's shape."""
    jpart, part = _partition(dataset)
    kw = dict(algo=algo, dataset=dataset, num_workers=NW, num_servers=S,
              img_size=8, batch_size=B)
    jrun = jax_build_runner(JaxConfig(**kw), jpart)
    run = build_runner(FedGANConfig(**kw), part, device="cpu")
    jstate = jrun.init_state()
    # BN running stats away from the init's, so eval mode reads real ones
    rng = np.random.default_rng(2)
    bn = jax.tree.map(lambda x: x + np.abs(rng.normal(size=x.shape))
                      .astype(np.float32) * 0.1, jstate.g.bn)
    jstate = jstate._replace(g=jstate.g._replace(bn=bn))
    state = from_jax_numpy(jax.tree.map(np.asarray, jstate), run.cfg, "cpu")
    z = np.random.default_rng(1).normal(size=(6, 100)).astype(np.float32)
    np.testing.assert_allclose(run.gen(state, torch.from_numpy(z)).numpy(),
                               np.asarray(jrun.gen(jstate, z)),
                               rtol=TOL_FWD[0], atol=TOL_FWD[1])
    for client in range(NW):
        np.testing.assert_allclose(
            run.gen_client(state, torch.from_numpy(z), client).numpy(),
            np.asarray(jrun.gen_client(jstate, z, client)),
            rtol=TOL_FWD[0], atol=TOL_FWD[1])
    got = run.sample(state, 6)
    assert tuple(got.shape) == tuple(np.shape(jrun.sample(jstate, 6)))
    assert bool(torch.isfinite(got).all()) and float(got.abs().max()) <= 1


def test_train_and_entry_point_contract():
    """``build_runner`` builds cglgan (iid 0, 1, 2) and mixgan on both
    datasets on the CPU when asked, ``train`` runs them, Mix-G's init is
    DCGAN's; meshes still raise naming their ROADMAP item, and bf16 and
    conv build."""
    for dataset in ("synthetic-mnist", "2dmg"):
        _, part = _partition(dataset)
        for algo, iid in (("cglgan", 0), ("cglgan", 1), ("cglgan", 2),
                          ("mixgan", 1)):
            cfg = FedGANConfig(algo=algo, dataset=dataset, num_workers=NW,
                               num_servers=S, iid=iid, img_size=8,
                               batch_size=B, epoch=2)
            run = build_runner(cfg, part, device="cpu")
            out = train(run, rounds=2, eval_every=2, evaluator=False)
            assert out["state"].t == 2
            assert all(np.isfinite(v) for v in out["history"][0].values())
            if algo == "mixgan":
                w = run.init_state().g.params["trunk"][0]["w"]
                assert abs(float(w.std()) - 0.02) < 2e-3
            if not torch.cuda.is_available():
                with pytest.raises(RuntimeError, match="device='cpu'"):
                    build_runner(cfg, part)
            with pytest.raises(NotImplementedError, match="ROADMAP"):
                build_runner(cfg.replace(model_shards=2), part,
                             device="cpu")
            # bf16 mode and conv are ported: they build
            build_runner(cfg.replace(dtype="bfloat16", force_dtype=True),
                         part, device="cpu")
            build_runner(cfg.replace(conv=True), part, device="cpu")

"""MD-GAN and AC-GAN in the port against the JAX package, on the CPU.

Modules: the collectives the family adds (``ring_shift_tree``,
``permute_tree``, ``delta_share_tree`` flat and blocked) and
``participation_mask`` on injected draws, bit-equal to the JAX functions
(run eagerly: jitted, XLA may fuse ``p - w`` into the group sum and round
it otherwise); a transplant round trip of a state with delta anchors; the
2DMG evaluator against the reference's on the same samples.

The slice as a whole: a small hierarchy (4 clients: MD-GAN 1 server,
AC-GAN 2 servers of 2; AC-GAN on 2DMG 8 clients, 2 servers of 4; 8x8
images or 2DMG rows, batch 8) starts from the JAX ``init_state()`` carried
across by ``utils/transplant.py`` and runs 3 rounds on each side with the
reference's draws injected into the port's ``round_fn``: the latents and
window starts (``benchmarks/trajectory_parity.py`` ``cgl_round_streams``),
the survival draw behind the participation mask and MD-GAN's shuffle
permutation, computed here from the reference's round key.  The autograd D
path runs at epoch=1; the fused local-D path at epoch=2 (JAX
``pallas_dstep=True`` in interpret mode against the port's auto rule,
which runs the kernel's plain version on the CPU).  The exchanges run at
E=1, so 3 rounds hold 3 exchange events; one delta case runs at E=2, an
exchange between two rounds that keep the anchors.  Draws without a
shuffle permutation go in as 4 entries, as the FedAvg family's.  Compared: G and D params, G BN
running stats, Adam moments and counts, the delta anchors, the round
counter and every round's metrics; then ``gen`` and ``sample``.
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
from cglgan_tpu.evalx.evaluator import make_evaluator as jax_make_evaluator
from cglgan_tpu.fed import collectives as jcoll
from cglgan_tpu_torch.algos import common
from cglgan_tpu_torch.algos.registry import build_runner
from cglgan_tpu_torch.algos.runner import train
from cglgan_tpu_torch.core import dtypes
from cglgan_tpu_torch.core.config import FedGANConfig
from cglgan_tpu_torch.data.partition import Partition
from cglgan_tpu_torch.evalx import hist2d
from cglgan_tpu_torch.evalx.evaluator import make_evaluator
from cglgan_tpu_torch.fed import collectives
from cglgan_tpu_torch.models import zoo
from cglgan_tpu_torch.ops import fused_dstep
from cglgan_tpu_torch.utils.transplant import (from_jax_numpy,
                                               tensor_from_numpy, to_numpy)
from cglgan_tpu_torch.utils.tree import tree_leaves, tree_map
from test_torch_port_threads import one_torch_thread  # noqa: F401

ROUNDS = 3
L, B = 48, 8
LR = 2e-4

# Tolerances, float32 rounds: those of tests/test_torch_port_cgl.py.  Both
# sides are float32 on the CPU and sum in another order: params (rtol,
# atol) elementwise, moments to 1e-4 of their group's largest entry,
# metrics 1e-5 absolute (losses ~0.7-1.4).
TOL_PARAMS = (1e-4, 1e-5)
TOL_MOMENT = 1e-4
TOL_METRIC = 1e-5
TOL_FWD = (1e-4, 1e-5)           # one forward, reordered sums
# bf16 rounds: those of tests/test_torch_port_bf16.py (XLA on the CPU sums
# bias gradients in bf16 where the port sums in float32, so the two sides
# part at bf16 resolution): params per leaf within 2 (after round 1) / 4
# bf16 steps at the leaf's largest entry plus 3 lr an Adam step, moments
# 0.25 / 0.15 of their group's largest entry, metrics 5e-3 absolute.
TOL_BF16_STEPS = (2, 4)
TOL_BF16_MOMENT = (0.25, 0.15)
TOL_BF16_METRIC = 5e-3


def _t(x):
    return torch.from_numpy(np.array(x))


def _partition(dataset, nw=4, seed=0):
    rng = np.random.default_rng(seed)
    if dataset == "2dmg":
        data = rng.uniform(-1, 1, (nw, L, 2)).astype(np.float32)
        pool = rng.uniform(-1, 1, (64, 2)).astype(np.float32)
    else:
        data = rng.integers(0, 256, (nw, L, 64)).astype(np.uint8)
        pool = np.zeros((10, 64), np.uint8)
    lengths = rng.integers(L // 2, L + 1, nw).astype(np.int32)
    fields = (data, np.zeros((nw, L), np.int32), lengths,
              np.zeros((nw, 10), np.int64), pool)
    return JaxPartition(*fields), Partition(*fields)


def _pre_bn_mask(spec):
    """True at linear biases that feed a BatchNorm: their gradient is
    exactly zero, so Adam moves them by rounding noise alone (up to ~lr a
    round) on either side (ROADMAP queue 3, PR 1)."""
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
# collectives and participation_mask: bit-equal to JAX
# ---------------------------------------------------------------------------

def _stack(rng, lead):
    return [{"w": rng.normal(size=lead + (5, 3)).astype(np.float32),
             "b": rng.normal(size=lead + (3,)).astype(np.float32)}, None]


def _bit_equal(got, ref):
    a_l, b_l = tree_leaves(got), jax.tree.leaves(ref)
    assert len(a_l) == len(b_l)
    for a, b in zip(a_l, b_l):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("n", [4, 10])
def test_swap_collectives_bit_equal(n):
    """ring_shift_tree (shifts 1, -1 and 3) and permute_tree (a seeded
    permutation) over the members axis."""
    rng = np.random.default_rng(n)
    tree = _stack(rng, (n,))
    port = tree_map(_t, tree)
    for shift in (1, -1, 3):
        _bit_equal(collectives.ring_shift_tree(port, shift),
                   jcoll.ring_shift_tree(tree, shift))
    perm = rng.permutation(n)
    _bit_equal(collectives.permute_tree(port, _t(perm)),
               jcoll.permute_tree(tree, perm))


@pytest.mark.parametrize("groups,k", [(2, 2), (2, 3), (5, 4), (2, 5)])
def test_delta_and_mean_share_bit_equal(groups, k):
    """delta_share_tree (new state and new anchor) and neighbor_share_tree,
    flat (groups*k, ...) and blocked (groups, k, ...), over two exchange
    events from a zero anchor: the first equals the group mean, the
    second does not."""
    rng = np.random.default_rng(10 * groups + k)
    for blocked in (False, True):
        lead = (groups, k) if blocked else (groups * k,)
        p1, p2 = _stack(rng, lead), _stack(rng, lead)
        anchor = jax.tree.map(np.zeros_like, p1)
        mine = tree_map(_t, anchor)
        for p in (p1, p2):
            ref_p, ref_w = jcoll.delta_share_tree(p, anchor, k,
                                                  blocked=blocked)
            got_p, got_w = collectives.delta_share_tree(
                tree_map(_t, p), mine, k, blocked=blocked)
            _bit_equal(got_p, ref_p)
            _bit_equal(got_w, ref_w)
            _bit_equal(collectives.neighbor_share_tree(tree_map(_t, p), k,
                                                       blocked=blocked),
                       jcoll.neighbor_share_tree(p, k, blocked=blocked))
            anchor, mine = jax.tree.map(np.asarray, ref_w), got_w
        mean2 = jcoll.neighbor_share_tree(p2, k, blocked=blocked)
        assert not np.array_equal(np.asarray(mean2[0]["w"]),
                                  got_p[0]["w"].numpy())


def _all_dead_key(rate, n):
    """The first seed whose Bernoulli(1 - rate) draw keeps nobody."""
    for seed in range(1000):
        key = jax.random.key(seed)
        if not np.asarray(jax.random.bernoulli(key, 1.0 - rate, (n,))).any():
            return key
    raise AssertionError("no all-dead draw in 1000 seeds")


def test_participation_mask_bit_equal():
    """The mask from the reference's own draw: all ones at rate 0, the draw
    itself otherwise, client 0 forced alive when nobody survives."""
    cases = [(jax.random.key(s), rate, n) for s, rate, n in
             ((0, 0.0, 6), (1, 0.3, 6), (2, 0.5, 10), (3, 0.9, 7))]
    cases.append((_all_dead_key(0.95, 5), 0.95, 5))
    for key, rate, n in cases:
        ref = np.asarray(jcommon.participation_mask(key, n, rate))
        alive = np.asarray(jax.random.bernoulli(key, 1.0 - rate, (n,)))
        got = common.participation_mask(_t(alive), rate)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), ref)
    assert ref.tolist() == [1.0, 0.0, 0.0, 0.0, 0.0]      # the all-dead case


# ---------------------------------------------------------------------------
# the slice as a whole: 3 shrunk rounds against JAX
# ---------------------------------------------------------------------------

ROUND_CASES = {
    # id: (algo, dataset, epoch, config fields); the autograd cases carry
    # the exchanges and dropout, the kernel cases none (E=0)
    "mdgan_image_epoch1_ring": ("mdgan", "synthetic-mnist", 1,
                                dict(E=1, d_swap="ring")),
    "mdgan_image_epoch2_kernel": ("mdgan", "synthetic-mnist", 2, {}),
    "mdgan_2dmg_epoch1_shuffle": ("mdgan", "2dmg", 1,
                                  dict(E=1, d_swap="shuffle")),
    "mdgan_2dmg_epoch2_kernel": ("mdgan", "2dmg", 2, {}),
    "acgan_image_epoch1_mean": ("acgan", "synthetic-mnist", 1,
                                dict(E=1, gossip="mean")),
    "acgan_image_epoch1_delta": ("acgan", "synthetic-mnist", 1,
                                 dict(E=1, gossip="delta")),
    # one exchange (t=1) between two rounds without: the anchors stay
    "acgan_image_epoch1_delta_E2": ("acgan", "synthetic-mnist", 1,
                                    dict(E=2, gossip="delta")),
    "acgan_image_epoch1_dropout": ("acgan", "synthetic-mnist", 1,
                                   dict(dropout_rate=0.5)),
    "acgan_image_epoch2_kernel": ("acgan", "synthetic-mnist", 2, {}),
    "acgan_2dmg_epoch1": ("acgan", "2dmg", 1, {}),
    "acgan_2dmg_epoch2_kernel": ("acgan", "2dmg", 2, {}),
    "acgan_image_epoch2_kernel_bf16": (
        "acgan", "synthetic-mnist", 2,
        dict(dtype="bfloat16", pallas_dstep=True)),
}


def _config(case):
    algo, dataset, epoch, extra = ROUND_CASES[case]
    nw = 8 if algo == "acgan" and dataset == "2dmg" else 4
    servers = 1 if algo == "mdgan" else 2
    kw = dict(algo=algo, dataset=dataset, num_workers=nw,
              num_servers=servers, iid=1, img_size=8, batch_size=B,
              epoch=epoch, **extra)
    jkw = dict(kw, pallas_dstep=True if epoch > 1 else None)
    return JaxConfig(**jkw), FedGANConfig(**kw), nw


def _streams(jcfg):
    """Round t's draws as the reference's round takes them: (starts, z_d,
    z_g) from ``cgl_round_streams`` (in bf16 where the run is bf16, as the
    reference draws them), the survival draw behind its participation
    mask (``fold_in(key, 7)``) and MD-GAN's shuffle permutation
    (``ROLE_SWAP``), None where the config uses none."""
    root = jprng.root_key(jcfg.seed)
    W = jcfg.num_workers
    base = cgl_round_streams(root, jcfg, L)
    bf16 = jcfg.dtype == "bfloat16"

    def latents(key, role_index):
        dt = jnp.bfloat16 if bf16 else jnp.float32
        out = [np.asarray(jax.random.normal(
            jax.random.split(k, 4)[role_index], (B, jcfg.latent_dim), dt))
            for k in jax.random.split(key, jcfg.num_servers)]
        return tensor_from_numpy(np.stack(out), "cpu")

    def at(t):
        starts, z_d, z_g = base(t)
        key = jprng.for_round(jprng.for_role(root, jprng.ROLE_LOCAL), t)
        if bf16:
            z_d, z_g = latents(key, 0), latents(key, 1)
        else:
            z_d, z_g = _t(z_d), _t(z_g)
        alive = perm = None
        if jcfg.dropout_rate > 0:
            alive = _t(np.asarray(jax.random.bernoulli(
                jax.random.fold_in(key, 7), 1.0 - jcfg.dropout_rate, (W,))))
        if jcfg.algo == "mdgan" and jcfg.E > 0 and \
                jcfg.d_swap == "shuffle":
            perm = _t(np.asarray(jax.random.permutation(
                jprng.for_role(key, jprng.ROLE_SWAP), W)))
        return starts, z_d, z_g, alive, perm

    return at


def _run_pair(case):
    """The jitted JAX round and the port's from one carried-over state on
    the same draws; yields (t, draws, port state, port metrics, JAX state,
    JAX metrics) after each round."""
    jcfg, cfg, nw = _config(case)
    jpart, part = _partition(ROUND_CASES[case][1], nw)
    assert fused_dstep.eligible(cfg) == (cfg.epoch > 1)
    jrun = jax_build_runner(jcfg, jpart)
    jstate = jrun.init_state()
    jround = jax.jit(jrun.round_fn)
    draw = _streams(jcfg)
    run = build_runner(cfg, part, device="cpu")
    state = from_jax_numpy(jax.tree.map(np.asarray, jstate), cfg, "cpu")
    launched = fused_dstep.launches
    for t in range(ROUNDS):
        drawn = draw(t)
        jstate, jm = jround(jstate)
        state, m = run.round_fn(state,
                                drawn if drawn[4] is not None else drawn[:4])
        yield t, drawn, state, m, jstate, jm
    assert fused_dstep.launches == launched    # CPU: the plain version


def _flat_d(x):
    """The reference's (S, k, ...) D leaves as the port's flat (W, ...)."""
    x = np.asarray(x, np.float32)
    return x.reshape((-1,) + x.shape[2:])


def _close_net(got, jnet, net, noisy):
    flat = _flat_d if net == "d" else (lambda x: np.asarray(x, np.float32))
    jadam = jnet.opt[0]
    np.testing.assert_array_equal(got["count"],
                                  flat(jadam.count).astype(np.int64))
    pairs = list(zip(tree_leaves(got["params"]),
                     jax.tree.leaves(jnet.params)))
    assert len(pairs) == len(noisy)
    for i, ((a, b), zero_grad) in enumerate(zip(pairs, noisy)):
        atol = LR * ROUNDS if zero_grad else TOL_PARAMS[1]
        rtol = 0 if zero_grad else TOL_PARAMS[0]
        np.testing.assert_allclose(a, flat(b), rtol=rtol, atol=atol,
                                   err_msg=f"{net} param leaf {i}")
    for i, (a, b) in enumerate(zip(tree_leaves(got["bn"]),
                                   jax.tree.leaves(jnet.bn))):
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


FLOAT32_CASES = sorted(c for c in ROUND_CASES if not c.endswith("bf16"))


@pytest.mark.parametrize("case", FLOAT32_CASES)
def test_mdgan_rounds_match_jax(case):
    algo, dataset, epoch, extra = ROUND_CASES[case]
    dropped = 0
    for t, drawn, state, m, jstate, jm in _run_pair(case):
        assert set(m) == set(jm)
        for key in jm:
            assert abs(float(m[key]) - float(jm[key])) < TOL_METRIC, \
                (t, key, float(m[key]), float(jm[key]))
        if drawn[3] is not None:
            dropped += int((~drawn[3]).sum())
    if extra.get("dropout_rate"):
        assert dropped > 0          # the draws dropped someone

    got = to_numpy(state)
    ref = jax.tree.map(np.asarray, jstate)
    assert got["t"] == int(ref.t) == ROUNDS
    g_model = zoo.models_for_config(_config(case)[1])[0]
    assert not g_model.multipath
    _close_net(got["g"], ref.g, "g", tree_leaves(_pre_bn_mask(g_model.spec)))
    n_d = len(tree_leaves(got["d"]["params"]))
    _close_net(got["d"], ref.d, "d", [False] * n_d)
    if extra.get("gossip") == "delta":
        # the anchors: the pre-exchange Ds of the last exchange
        assert ref.lam is not None
        for a, b in zip(tree_leaves(got["lam"]), jax.tree.leaves(ref.lam)):
            np.testing.assert_allclose(a, _flat_d(b), rtol=TOL_PARAMS[0],
                                       atol=TOL_PARAMS[1])
    else:
        assert got["lam"] is None and ref.lam is None


def _spacing(x: float) -> float:
    """The distance between bf16 values next to |x| (normal range)."""
    return 2.0 ** (np.floor(np.log2(max(abs(x), 2.0 ** -126))) - 7)


def test_mdgan_rounds_match_jax_bf16_kernel():
    """AC-GAN on MNIST shapes in bf16 with the bf16-state kernel forced on
    both sides (2-logit CE head at x1, a server's batch to its k
    clients), held to bf16 steps (TOL_BF16_*)."""
    case = "acgan_image_epoch2_kernel_bf16"
    epoch = ROUND_CASES[case][2]
    for t, _, state, m, jstate, jm in _run_pair(case):
        assert set(m) == set(jm)
        for key in jm:
            assert m[key].dtype == torch.float32
            assert abs(float(m[key]) - float(jm[key])) < TOL_BF16_METRIC, \
                (t, key, float(m[key]), float(jm[key]))
        got = to_numpy(state, bf16="float32")
        ref = jax.tree.map(np.asarray, jstate)
        later = int(t > 0)
        for net in ("g", "d"):
            jnet = getattr(ref, net)
            flat = _flat_d if net == "d" else \
                (lambda x: np.asarray(x, np.float32))
            jadam = jnet.opt[0]
            np.testing.assert_array_equal(got[net]["count"],
                                          flat(jadam.count).astype(np.int64))
            steps = (t + 1) * (epoch if net == "d" else 1)
            for name, theirs in (("params", jnet.params), ("bn", jnet.bn)):
                for i, (a, b) in enumerate(zip(tree_leaves(got[net][name]),
                                               jax.tree.leaves(theirs))):
                    b = flat(b)
                    limit = TOL_BF16_STEPS[later] * _spacing(
                        float(np.abs(b).max())) + 3 * LR * steps
                    assert float(np.abs(a - b).max()) <= limit, \
                        (t, net, name, i, float(np.abs(a - b).max()), limit)
            for name in ("mu", "nu"):
                mine = tree_leaves(got[net][name])
                theirs = [flat(x) for x in jax.tree.leaves(getattr(jadam,
                                                                   name))]
                scale = max(float(np.abs(x).max()) for x in theirs)
                worst = max(float(np.abs(a - b).max())
                            for a, b in zip(mine, theirs))
                assert worst <= TOL_BF16_MOMENT[later] * scale, \
                    (t, net, name, worst / scale)
    for leaf in tree_leaves((state.g.params, state.d.params, state.d.opt.mu)):
        assert leaf.dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# transplant, serving, evaluator, entry points
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_transplant_round_trip_with_anchors(dtype):
    """An AC-GAN state with delta anchors, after two JAX rounds (anchors no
    longer zero), carries over leaf for leaf and bit for bit: G (S, ...),
    D and anchors flattened (W, ...)."""
    jpart, _ = _partition("synthetic-mnist")
    kw = dict(algo="acgan", dataset="synthetic-mnist", num_workers=4,
              num_servers=2, img_size=8, batch_size=B, E=1, gossip="delta",
              dtype=dtype)
    jcfg = JaxConfig(**kw)
    jrun = jax_build_runner(jcfg, jpart)
    jstate = jrun.init_state()
    for _ in range(2):
        jstate, _ = jax.jit(jrun.round_fn)(jstate)
    ref = jax.tree.map(np.asarray, jstate)
    state = from_jax_numpy(ref, FedGANConfig(**kw), "cpu")
    got = to_numpy(state)
    bits = lambda x: np.asarray(x).view(np.uint16 if dtype == "bfloat16"
                                        else np.uint32)
    pairs = [(got["g"][key], getattr(ref.g, key)) for key in ("params",
                                                              "bn")]
    pairs += [(got["g"]["mu"], ref.g.opt[0].mu),
              (got["d"]["params"], ref.d.params),
              (got["d"]["nu"], ref.d.opt[0].nu), (got["lam"], ref.lam)]
    n_anchor = 0
    for mine, theirs in pairs:
        a_l, b_l = tree_leaves(mine), jax.tree.leaves(theirs)
        assert len(a_l) == len(b_l) > 0
        for a, b in zip(a_l, b_l):
            if a.shape != b.shape:              # D and anchors: (S, k) -> W
                b = b.reshape(a.shape)
            np.testing.assert_array_equal(bits(a), bits(b))
    for a in tree_leaves(got["lam"]):
        assert a.shape[0] == 4
        n_anchor += int(np.abs(np.asarray(a, np.float32)).max() > 0)
    assert n_anchor > 0
    assert got["t"] == 2 and isinstance(state.lam, tuple)
    assert all(x.dtype == (torch.bfloat16 if dtype == "bfloat16"
                           else torch.float32)
               for x in tree_leaves(state.lam))


@pytest.mark.parametrize("algo,dataset", [("mdgan", "synthetic-mnist"),
                                          ("acgan", "2dmg")])
def test_gen_and_sample_match_jax(algo, dataset):
    """``gen`` (eval mode, server i from the block z[i*per:(i+1)*per])
    equals the reference's from one carried-over state; ``sample`` gives
    finite values in [-1, 1] of the reference's shape."""
    jpart, part = _partition(dataset)
    kw = dict(algo=algo, dataset=dataset, num_workers=4,
              num_servers=1 if algo == "mdgan" else 2, img_size=8,
              batch_size=B)
    jrun = jax_build_runner(JaxConfig(**kw), jpart)
    run = build_runner(FedGANConfig(**kw), part, device="cpu")
    assert run.gen_batch_multiple == jrun.gen_batch_multiple
    jstate = jrun.init_state()
    # BN running stats away from the init's, so eval mode reads real ones
    rng = np.random.default_rng(2)
    bn = jax.tree.map(lambda x: x + np.abs(rng.normal(size=x.shape))
                      .astype(np.float32) * 0.1, jstate.g.bn)
    jstate = jstate._replace(g=jstate.g._replace(bn=bn))
    state = from_jax_numpy(jax.tree.map(np.asarray, jstate), run.cfg, "cpu")
    z = np.random.default_rng(1).normal(size=(6, 100)).astype(np.float32)
    np.testing.assert_allclose(run.gen(state, _t(z)).numpy(),
                               np.asarray(jrun.gen(jstate, z)),
                               rtol=TOL_FWD[0], atol=TOL_FWD[1])
    got = run.sample(state, 6)
    assert tuple(got.shape) == tuple(np.shape(jrun.sample(jstate, 6)))
    assert bool(torch.isfinite(got).all()) and float(got.abs().max()) <= 1


@pytest.mark.parametrize("algo", ["mdgan", "acgan", "flgan"])
def test_evaluator_matches_jax(algo):
    """KL Score, Distribution Score and mode coverage of the same samples
    against the same eval pool: 32 bins for MD-GAN, 16 otherwise."""
    rng = np.random.default_rng(3)
    jpart, part = _partition("2dmg")
    cfg = dict(algo=algo, dataset="2dmg", num_workers=4,
               num_servers=2 if algo == "acgan" else 1)
    # points near the pool's, some in empty cells, some outside [-1, 1]
    pts = np.concatenate([
        jpart.eval_pool[rng.integers(0, 64, 300)]
        + rng.normal(0, 0.03, (300, 2)),
        rng.uniform(-1.2, 1.2, (100, 2))]).astype(np.float32)
    ref = jax_make_evaluator(JaxConfig(**cfg), jpart)(None, None,
                                                      samples=pts)
    got = make_evaluator(FedGANConfig(**cfg), part, device="cpu")(
        None, None, samples=_t(pts))
    assert set(got) == set(ref) == {"kl_score", "distribution_score",
                                    "mode_coverage"}
    for key in ref:
        assert abs(got[key] - ref[key]) <= 1e-5 * max(1.0, abs(ref[key])), \
            (key, got[key], ref[key])
    if algo == "mdgan":          # on these samples the 32-bin rule shows
        kl16, _ = hist2d.kl_and_distribution_score(
            _t(pts), _t(jpart.eval_pool), 16)
        assert abs(float(kl16) - ref["kl_score"]) > 1e-3


def test_train_and_entry_point_contract():
    """``build_runner`` builds MD-GAN and AC-GAN on both datasets, in
    float32 and bf16, with E at 0 and > 0, both swaps, both gossips and
    dropout, and ``train`` runs them (on 2DMG all of these, with the
    evaluator's metrics; on MNIST shapes, whose float32 rounds the round
    tests run, bf16 with an exchange and with the forced kernel, and the
    default evaluator's FID and IS); conv builds on 2DMG in float32 and,
    under force_dtype, in bfloat16 (only its rounds would need image data)
    and runs a round on 32x32 images in float32 and in bfloat16, MD-GAN
    with more than one server raises, and without ``device`` the card is
    asked for."""
    for dataset in ("synthetic-mnist", "2dmg"):
        _, part = _partition(dataset)
        for algo, servers in (("mdgan", 1), ("acgan", 2)):
            cfg = FedGANConfig(algo=algo, dataset=dataset, num_workers=4,
                               num_servers=servers, img_size=8,
                               batch_size=B, num_sample=50)
            exchanges = ((dict(E=2, d_swap="ring"),
                          dict(E=1, d_swap="shuffle")) if algo == "mdgan"
                         else (dict(E=2, gossip="mean"),
                               dict(E=1, gossip="delta")))
            extras = ({}, *exchanges, dict(dropout_rate=0.3),
                      dict(dtype="bfloat16", force_dtype=True, E=1),
                      dict(dtype="bfloat16", force_dtype=True,
                           pallas_dstep=True, epoch=2))
            for extra in extras if dataset == "2dmg" else extras[-2:]:
                run = build_runner(cfg.replace(**extra), part, device="cpu")
                evaluator = None if dataset == "2dmg" else False
                out = train(run, rounds=2, eval_every=2, evaluator=evaluator)
                tick = out["history"][0]
                assert out["state"].t == 2
                assert all(np.isfinite(v) for v in tick.values())
                if dataset == "2dmg":
                    assert {"kl_score", "distribution_score",
                            "mode_coverage"} <= set(tick)
            if not torch.cuda.is_available():
                with pytest.raises(RuntimeError, match="device='cpu'"):
                    build_runner(cfg, part)
            conv = cfg.replace(conv=True)
            run = build_runner(conv, part, device="cpu")
            if dataset != "2dmg":
                # the conv pair works at 32x32: rows of 1024 pixels
                rng = np.random.default_rng(2)
                conv_part = Partition(
                    rng.integers(0, 256, (4, L, 1024)).astype(np.uint8),
                    part.labels, part.lengths, part.class_freq,
                    np.zeros((10, 1024), np.uint8))
                for c in (conv, conv.replace(dtype="bfloat16")):
                    run = build_runner(c, conv_part, device="cpu")
                    state, m = run.round_fn(run.init_state())
                    assert state.t == 1 and all(np.isfinite(float(v))
                                                for v in m.values())
                    assert state.d.params["c1"]["w"].dtype == \
                        dtypes.torch_dtype(c)
            else:
                build_runner(conv.replace(dtype="bfloat16",
                                          force_dtype=True), part,
                             device="cpu")
            if dataset != "2dmg":
                run = build_runner(cfg, part, device="cpu")
                # the default evaluator trains its probe (300 small steps)
                # on one thread: a thread a core waits on the other test
                # workers for minutes
                threads = torch.get_num_threads()
                torch.set_num_threads(1)
                try:
                    tick = train(run, rounds=1, evaluator=None)["history"][0]
                finally:
                    torch.set_num_threads(threads)
                assert np.isfinite(tick["fid"])
                assert np.isfinite(tick["inception_score"])
    _, part = _partition("2dmg")
    with pytest.raises(ValueError, match="num_servers=1"):
        build_runner(FedGANConfig(algo="mdgan", dataset="2dmg",
                                  num_workers=4, num_servers=2), part,
                     device="cpu")
    # the engage rule: never with dropout, raising when forced
    base = FedGANConfig(algo="acgan", dataset="2dmg", num_workers=4,
                        num_servers=2, epoch=2)
    assert fused_dstep.eligible(base)
    assert not fused_dstep.eligible(base.replace(dropout_rate=0.2))
    with pytest.raises(ValueError, match="dropout"):
        fused_dstep.eligible(base.replace(dropout_rate=0.2,
                                          pallas_dstep=True))

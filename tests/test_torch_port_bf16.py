"""bfloat16 mode (``dtype="bfloat16"``) in the port against the JAX package,
on the CPU.

Modules: ``core/dtypes.weak`` against JAX's weak-typed scalars; the bf16
``adam_update`` against ``optax.adam`` on bf16 params; ``nn.linear``,
``leaky_relu``, ``sigmoid`` and ``batchnorm`` against
``cglgan_tpu.models.nn``; ``utils/transplant`` bit for bit both ways; the
engage rules (auto leaves ``fused_dstep`` off in bf16, ``pallas_dstep=True``
forces it, ``pallas_sweep=True`` raises).  The slice as a whole: shrunk
CAP-GAN (epoch=1 autograd, epoch=2 with the forced bf16-state kernel on
both sides), CGL-GAN and Mix-G (``segema > 0``, as in
tests/test_torch_port_cgl.py) and FL-GAN on 2DMG (``force_dtype``) start
from the JAX ``init_state()`` carried across by ``utils/transplant.py`` and
run 5 rounds (FL-GAN 3) with the JAX draws, drawn in bf16 as the reference
draws them, injected into the port's ``round_fn``.

Every input is made from a numpy seed and goes through both packages.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import optax
import pytest
import torch

from cglgan_tpu.algos import common as jcommon
from cglgan_tpu.algos.registry import build_runner as jax_build_runner
from cglgan_tpu.algos.registry import load_partition as jax_load_partition
from cglgan_tpu.core import prng as jprng
from cglgan_tpu.core.config import FedGANConfig as JaxConfig
from cglgan_tpu.data.partition import Partition as JaxPartition
from cglgan_tpu.models import nn as jnn
from cglgan_tpu.ops.pallas import fused_dstep as jfused
from cglgan_tpu_torch.algos import common
from cglgan_tpu_torch.algos.registry import build_runner
from cglgan_tpu_torch.core import dtypes, threefry
from cglgan_tpu_torch.core.config import FedGANConfig
from cglgan_tpu_torch.data.partition import Partition
from cglgan_tpu_torch.models import nn
from cglgan_tpu_torch.ops import fused_dstep, fused_sweep
from cglgan_tpu_torch.utils.transplant import (from_jax_numpy,
                                               tensor_from_numpy,
                                               tensor_to_numpy, to_numpy)
from cglgan_tpu_torch.utils.tree import tree_leaves
from test_torch_port_threads import one_torch_thread  # noqa: F401

BF = ml_dtypes.bfloat16
LR = 2e-4


def _pair(x):
    """One numpy array as the same bf16 values in JAX and in torch."""
    a = np.asarray(x, np.float32).astype(BF)
    return jnp.asarray(a), tensor_from_numpy(a, "cpu")


def _bits(x):
    """bf16 values (a JAX array or a torch tensor) as their uint16 bits."""
    if isinstance(x, torch.Tensor):
        return tensor_to_numpy(x).view(np.uint16)
    return np.asarray(x).view(np.uint16)


# ---------------------------------------------------------------------------
# core/dtypes: weak-typed scalars
# ---------------------------------------------------------------------------

def test_weak_scalars_round_as_jax():
    """JAX rounds a Python scalar that meets a bf16 array to bf16 first;
    ``weak`` does the same, so the chain ((x*1.3+0.7)*0.9-0.1)*1.1 on
    100 000 bf16 values is bit-equal to JAX's, jitted and eager.  Without
    ``weak`` torch keeps each scalar in float32 and most results differ.
    In float32 ``weak`` returns the scalar itself."""
    x = np.random.default_rng(0).normal(size=100_000)
    jx, tx = _pair(x)
    chain = lambda v: ((v * 1.3 + 0.7) * 0.9 - 0.1) * 1.1
    ref = _bits(chain(jx))
    np.testing.assert_array_equal(_bits(jax.jit(chain)(jx)), ref)
    w = lambda c: dtypes.weak(c, tx)
    got = ((tx * w(1.3) + w(0.7)) * w(0.9) - w(0.1)) * w(1.1)
    np.testing.assert_array_equal(_bits(got), ref)
    assert int((_bits(chain(tx)) != ref).sum()) > 10_000
    for c in (0.999, 1 - 0.999, 1e-8, 0.2, 0.8, 0.1, 0.9, -LR):
        assert dtypes.weak(c, tx) == float(jnp.asarray(c, jnp.bfloat16))
        assert dtypes.weak(c, torch.float32) == c
    assert dtypes.weak(0.999, tx) == 1.0
    assert dtypes.weak(1e-8, torch.bfloat16) == 1.0011717677116394e-08


# ---------------------------------------------------------------------------
# algos/common: Adam on bf16 params against optax
# ---------------------------------------------------------------------------

def test_adam_bf16_bit_equal_to_optax():
    """3 steps of ``adam_update`` on stacked bf16 params (2 members) against
    ``optax.adam`` per member: params, mu and nu bit-equal.  Leaf "b" has a
    gradient at step 1 only: optax's bf16 b2 is 0.999 rounded to 1.0, so its
    nu does not decay over steps 2 and 3 (and mu halves each step)."""
    rng = np.random.default_rng(1)
    n = 2
    p0 = {"w": rng.normal(size=(n, 33, 17)) * 0.05,
          "b": rng.normal(size=(n, 17)) * 0.05}
    grads = [{"w": rng.normal(size=(n, 33, 17)) * 1e-2,
              "b": rng.normal(size=(n, 17)) * 1e-2 * (t == 0)}
             for t in range(3)]
    jp = {k: _pair(v)[0] for k, v in p0.items()}
    tp = {k: _pair(v)[1] for k, v in p0.items()}
    opt = optax.adam(LR, b1=0.5, b2=0.999)
    jst = jax.vmap(opt.init)(jp)

    @jax.jit
    def jstep(params, st, g):
        def one(pp, ss, gg):
            up, ss = opt.update(gg, ss, pp)
            return optax.apply_updates(pp, up), ss
        return jax.vmap(one)(params, st, g)

    tst = common.adam_init(tp, n)
    nu_b_after_1 = None
    for t, g in enumerate(grads):
        jp, jst = jstep(jp, jst, {k: _pair(v)[0] for k, v in g.items()})
        tp, tst = common.adam_update(tp, {k: _pair(v)[1]
                                          for k, v in g.items()},
                                     tst, LR, 0.5, 0.999)
        for key in ("w", "b"):
            assert tp[key].dtype == tst.mu[key].dtype == torch.bfloat16
            np.testing.assert_array_equal(_bits(tp[key]), _bits(jp[key]))
            np.testing.assert_array_equal(_bits(tst.mu[key]),
                                          _bits(jst[0].mu[key]))
            np.testing.assert_array_equal(_bits(tst.nu[key]),
                                          _bits(jst[0].nu[key]))
        if t == 0:
            nu_b_after_1 = _bits(tst.nu["b"]).copy()
    np.testing.assert_array_equal(_bits(tst.nu["b"]), nu_b_after_1)
    assert tst.count.tolist() == [3, 3]


# ---------------------------------------------------------------------------
# models/nn: the layers in bf16
# ---------------------------------------------------------------------------

def test_linear_lrelu_sigmoid_bit_equal():
    """``linear`` (matmul summed in float32, rounded once), ``leaky_relu``
    (the slope 0.2 as a weak scalar, 0.2001953125) and ``sigmoid`` (JAX's
    1/(1+exp(-x)) rounded step by step) on bf16 stacked inputs: bit-equal.
    A float32 latent through bf16 params promotes to float32, as in JAX."""
    rng = np.random.default_rng(2)
    n, b, din, dout = 3, 16, 64, 48
    jx, tx = _pair(rng.normal(size=(n, b, din)))
    jw, tw = _pair(rng.normal(size=(n, din, dout)) * 0.1)
    jb, tb = _pair(rng.normal(size=(n, dout)) * 0.1)
    ref = jax.vmap(jnn.linear)({"w": jw, "b": jb}, jx)
    got = nn.linear({"w": tw, "b": tb}, tx)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(got), _bits(ref))
    np.testing.assert_array_equal(_bits(nn.leaky_relu(tx)),
                                  _bits(jnn.leaky_relu(jx)))
    z = rng.normal(size=(n, b, din)) * 3
    jz, tz = _pair(z)
    np.testing.assert_array_equal(_bits(nn.sigmoid(tz)),
                                  _bits(jax.nn.sigmoid(jz)))
    x32 = rng.normal(size=(n, b, din)).astype(np.float32)
    mixed = nn.linear({"w": tw, "b": tb}, torch.from_numpy(x32))
    ref32 = jax.vmap(jnn.linear)({"w": jw, "b": jb}, jnp.asarray(x32))
    assert mixed.dtype == torch.float32 and ref32.dtype == jnp.float32
    np.testing.assert_allclose(mixed.numpy(), np.asarray(ref32), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("train", [True, False])
def test_batchnorm_bf16_matches(train):
    """BatchNorm1d (eps 0.8, momentum 0.1 as weak scalars; batch mean and
    biased variance accumulated in float32 and rounded once, as
    ``jnp.mean`` / ``jnp.var`` of bf16 do): the new running mean and
    variance are bit-equal.  The output is bit-equal on every channel whose
    inverse std, rsqrt(var + eps) in bf16, is: XLA's float32 rsqrt is not
    correctly rounded (it differs from torch's in the last place on ~37% of
    inputs), so after the rounding to bf16 a few channels' inverse std is
    one step apart, and their outputs then by at most 2 bf16 steps at the
    output's largest entry (measured: 1)."""
    rng = np.random.default_rng(3)
    n, b, c = 3, 16, 48
    jx, tx = _pair(rng.normal(size=(n, b, c)) * 2 + 0.5)
    p = {k: _pair(v) for k, v in (
        ("scale", 1 + 0.1 * rng.normal(size=(n, c))),
        ("bias", 0.1 * rng.normal(size=(n, c))))}
    s = {k: _pair(v) for k, v in (
        ("mean", 0.1 * rng.normal(size=(n, c))),
        ("var", 1 + 0.1 * np.abs(rng.normal(size=(n, c)))))}
    ref_y, ref_s = jax.vmap(lambda pp, ss, xx: jnn.batchnorm(
        pp, ss, xx, train))({k: v[0] for k, v in p.items()},
                            {k: v[0] for k, v in s.items()}, jx)
    y, new_s = nn.batchnorm({k: v[1] for k, v in p.items()},
                            {k: v[1] for k, v in s.items()}, tx, train)
    for key in ("mean", "var"):
        np.testing.assert_array_equal(_bits(new_s[key]), _bits(ref_s[key]))
    var_j = jnp.var(jx, axis=1) if train else s["var"][0]
    var_t = dtypes.var(tx, 1, dtypes.mean(tx, 1)) if train else s["var"][1]
    np.testing.assert_array_equal(_bits(var_t), _bits(var_j))
    inv_j = jax.lax.rsqrt(var_j + 0.8)
    inv_t = torch.rsqrt(var_t + dtypes.weak(0.8, var_t))
    same = _bits(inv_t) == _bits(inv_j)                       # (n, c)
    assert same.mean() > 0.9
    yb, rb = _bits(y), _bits(ref_y)
    mask = np.broadcast_to(same[:, None, :], yb.shape)
    np.testing.assert_array_equal(yb[mask], rb[mask])
    a, r = y.float().numpy(), np.asarray(ref_y, np.float32)
    assert float(np.abs(a - r).max()) <= 2 * _spacing(float(np.abs(r).max()))


def test_xla_cpu_sums_bias_gradients_in_bf16():
    """Why the bf16 round tests hold params to bf16 steps, not to float32
    tolerances: on the CPU, XLA sums the gradient of a broadcast (every bias
    gradient) in bf16, while ``jnp.sum`` of bf16 and the port sum in
    float32 and round once.  On 200 rows of 256 columns most of the
    reference's column sums differ from the float32 sum rounded; the port's
    equal ``jnp.sum``'s bit for bit."""
    rng = np.random.default_rng(6)
    jg, tg = _pair(rng.normal(size=(200, 256)) * 1e-2)
    zero = jnp.zeros((256,), jnp.bfloat16)
    _, pull = jax.vjp(lambda b: jnp.zeros((200, 256), jnp.bfloat16) + b, zero)
    xla = _bits(pull(jg)[0])
    summed = _bits(jnp.sum(jg, axis=0))
    port = _bits(tg.float().sum(dim=0).to(torch.bfloat16))
    np.testing.assert_array_equal(port, summed)
    assert (xla != summed).mean() > 0.5


def test_dcgan_reinit_keeps_bf16():
    """Mix-G's DCGAN re-draw on bf16 leaves: bf16 draws, N(0, 0.02) weights,
    N(1, 0.02) BN scales, zero biases."""
    tree = [{"w": torch.zeros((3, 64, 128), dtype=torch.bfloat16),
             "b": torch.ones((3, 128), dtype=torch.bfloat16)},
            {"scale": torch.zeros((3, 128), dtype=torch.bfloat16),
             "bias": torch.ones((3, 128), dtype=torch.bfloat16)}]
    out = nn.dcgan_reinit(threefry.split(threefry.key(0), 3), tree)
    assert all(x.dtype == torch.bfloat16 for x in tree_leaves(out))
    assert abs(float(out[0]["w"].float().std()) - 0.02) < 2e-3
    assert abs(float(out[1]["scale"].float().mean()) - 1.0) < 2e-3
    assert not out[0]["b"].float().any() and not out[1]["bias"].float().any()


# ---------------------------------------------------------------------------
# transplant and the engage rules
# ---------------------------------------------------------------------------

def _image_partition(nw=4, length=48, din=64, seed=0):
    rng = np.random.default_rng(seed)
    fields = (rng.integers(0, 256, (nw, length, din)).astype(np.uint8),
              np.zeros((nw, length), np.int32),
              np.asarray([30, 48, 41, 36], np.int32)[:nw],
              np.zeros((nw, 10), np.int64), np.zeros((10, din), np.uint8))
    return JaxPartition(*fields), Partition(*fields)


@pytest.mark.parametrize("algo", ["capgan", "mixgan"])
def test_transplant_bf16_bit_exact(algo):
    """A bf16 FedState crosses from JAX to the port and back bit for bit:
    every float leaf stays bf16 (``from_jax_numpy``) and ``to_numpy``
    returns ``ml_dtypes.bfloat16`` arrays with the same bits; Lambda stays
    float32, counts int."""
    jpart, _ = _image_partition()
    kw = dict(algo=algo, dataset="synthetic-mnist", num_workers=4,
              num_servers=2, img_size=8, batch_size=8, dtype="bfloat16")
    jstate = jax_build_runner(JaxConfig(**kw), jpart).init_state()
    ref = jax.tree.map(np.asarray, jstate)
    state = from_jax_numpy(ref, FedGANConfig(**kw), "cpu")
    assert all(x.dtype == torch.bfloat16 for x in tree_leaves(
        (state.g.params, state.g.bn, state.d.params, state.g.opt.mu,
         state.d.opt.nu)))
    assert state.lam.dtype == torch.float32
    got = to_numpy(state)
    pairs = [(got["g"]["params"], ref.g.params), (got["g"]["bn"], ref.g.bn),
             (got["g"]["mu"], ref.g.opt[0].mu),
             (got["d"]["params"], ref.d.params),
             (got["d"]["nu"], ref.d.opt[0].nu)]
    for mine, theirs in pairs:
        for a, b in zip(tree_leaves(mine), jax.tree.leaves(theirs)):
            assert a.dtype == BF and b.dtype == BF
            np.testing.assert_array_equal(a.reshape(-1).view(np.uint16),
                                          b.reshape(-1).view(np.uint16))
    up = to_numpy(state, bf16="float32")["d"]["params"][0]["w"]
    assert up.dtype == np.float32
    np.testing.assert_array_equal(up.reshape(ref.d.params[0]["w"].shape),
                                  ref.d.params[0]["w"].astype(np.float32))


def test_engage_rules_in_bf16():
    """Auto never runs ``fused_dstep`` in bf16 (epoch=5 included);
    ``pallas_dstep=True`` forces it; ``pallas_sweep=True`` with bf16 raises,
    as in the reference; the ported algorithms accept bf16."""
    base = dict(dataset="2dmg", num_workers=4, num_class=4, num_sample=64,
                batch_size=16, dtype="bfloat16", force_dtype=True)
    for epoch in (2, 5):
        cfg = FedGANConfig(algo="capgan", epoch=epoch, **base)
        assert not fused_dstep.eligible(cfg)
        assert not jfused.eligible(JaxConfig(algo="capgan", epoch=epoch,
                                             **base), None)
        assert fused_dstep.eligible(cfg.replace(pallas_dstep=True))
        assert fused_dstep.eligible(cfg.replace(dtype="float32"))
    flgan = FedGANConfig(algo="flgan", pallas_sweep=True, **base)
    with pytest.raises(ValueError, match="float32"):
        fused_sweep.eligible(flgan)
    for algo in ("capgan", "cglgan", "mixgan", "flgan", "fegan"):
        common.check_supported(FedGANConfig(algo=algo, **base))
    with pytest.raises(ValueError, match="bfloat16"):
        FedGANConfig(algo="flgan", **{**base, "force_dtype": False})


# ---------------------------------------------------------------------------
# the slice as a whole: bf16 rounds against JAX
# ---------------------------------------------------------------------------

def _cgl_streams(root, cfg, max_len):
    """Per-round (starts, z_d, z_g) as the reference's CGL-family round
    draws them in bf16 (``jax.random.normal(..., bfloat16)``,
    ``cglgan_tpu/algos/cgl_family.py:152,163``)."""
    S, B, zdim = cfg.num_servers, cfg.batch_size, cfg.latent_dim

    def at(t):
        key = jprng.for_round(jprng.for_role(root, jprng.ROLE_LOCAL), t)
        starts = [int(jcommon.batch_start(kk, max_len, B))
                  for kk in jax.random.split(
                      jprng.for_role(key, jprng.ROLE_BATCH), cfg.epoch)]
        z_d, z_g = [], []
        for k in jax.random.split(key, S):
            k_zd, k_zg, _, _ = jax.random.split(k, 4)
            z_d.append(np.asarray(jax.random.normal(k_zd, (B, zdim),
                                                    jnp.bfloat16)))
            z_g.append(np.asarray(jax.random.normal(k_zg, (B, zdim),
                                                    jnp.bfloat16)))
        return (starts, tensor_from_numpy(np.stack(z_d), "cpu"),
                tensor_from_numpy(np.stack(z_g), "cpu"))
    return at


def _flgan_streams(root, cfg, max_len):
    """Per-round (starts, z1, z2) as the reference's FedAvg sweep draws them
    in bf16 (``cglgan_tpu/algos/fedavg_family.py:131-141``)."""
    W, B, zdim, steps = (cfg.num_workers, cfg.batch_size, cfg.latent_dim,
                         cfg.epoch)

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
                z1[w, i] = np.asarray(jax.random.normal(kzd, (B, zdim),
                                                        jnp.bfloat16))
                z2[w, i] = np.asarray(jax.random.normal(kzg, (B, zdim),
                                                        jnp.bfloat16))
        return (starts, tensor_from_numpy(z1, "cpu"),
                tensor_from_numpy(z2, "cpu"))
    return at


ROUND_CASES = {
    # id: (algo, dataset, epoch, pallas_dstep, segema)
    "capgan_epoch1": ("capgan", "synthetic-mnist", 1, None, 0.5),
    "capgan_epoch2_kernel": ("capgan", "synthetic-mnist", 2, True, 0.5),
    "cglgan_epoch1": ("cglgan", "synthetic-mnist", 1, None, 0.5),
    "mixgan_epoch1": ("mixgan", "synthetic-mnist", 1, None, 0.25),
    "flgan_2dmg": ("flgan", "2dmg", 2, None, 0.5),
}


def _run_pair(case):
    """The JAX runner (jitted) and the port from one carried-over state on
    the same bf16 draws; yields (t, port state, port metrics, JAX state,
    JAX metrics) after each round."""
    algo, dataset, epoch, force, segema = ROUND_CASES[case]
    if dataset == "2dmg":
        kw = dict(algo=algo, dataset="2dmg", num_workers=4, num_class=4,
                  num_sample=64, batch_size=16, iid=1, epoch=epoch,
                  num_communication=8, dtype="bfloat16", force_dtype=True)
        jcfg = JaxConfig(**kw)
        jpart = jax_load_partition(jcfg)
        part = Partition(jpart.data, jpart.labels, jpart.lengths,
                         jpart.class_freq, jpart.eval_pool)
        rounds, streams = 3, _flgan_streams
    else:
        kw = dict(algo=algo, dataset=dataset, num_workers=4, num_servers=2,
                  iid=1, img_size=8, batch_size=8, epoch=epoch, E=0,
                  cloud_epoch=2, segema=segema, num_communication=10,
                  dtype="bfloat16", pallas_dstep=force)
        jcfg = JaxConfig(**kw)
        jpart, part = _image_partition()
        rounds, streams = 5, _cgl_streams
    cfg = FedGANConfig(**kw)
    assert fused_dstep.eligible(cfg) == bool(force)
    jrun = jax_build_runner(jcfg, jpart)
    jstate = jrun.init_state()
    jround = jax.jit(jrun.round_fn)
    draw = streams(jprng.root_key(jcfg.seed), jcfg, jpart.data.shape[1])
    run = build_runner(cfg, part, device="cpu")
    state = from_jax_numpy(jax.tree.map(np.asarray, jstate), cfg, "cpu")
    launched = fused_dstep.launches
    for t in range(rounds):
        jstate, jm = jround(jstate)
        state, m = run.round_fn(state, draw(t))
        yield t, state, m, jstate, jm
    assert fused_dstep.launches == launched          # CPU: plain versions


def _groups(got, jnet, flatten):
    """(name, port leaves, reference leaves) per state group, float32."""
    flat = (lambda x: np.asarray(x, np.float32).reshape(
        (-1,) + np.shape(x)[2:])) if flatten else \
        (lambda x: np.asarray(x, np.float32))
    jadam = jnet.opt[0]
    for name, mine, theirs in (("params", got["params"], jnet.params),
                               ("bn", got["bn"], jnet.bn),
                               ("mu", got["mu"], jadam.mu),
                               ("nu", got["nu"], jadam.nu)):
        yield (name, tree_leaves(mine),
               [flat(x) for x in jax.tree.leaves(theirs)])


# Tolerances of the bf16 rounds.  Both sides round every op to bf16, but not
# in the same places: XLA on the CPU sums a broadcast's gradient (every bias
# gradient, and BatchNorm's batch sums in the backward) in bf16, where the
# port sums in float32 (test_xla_cpu_sums_bias_gradients_in_bf16); its
# matmuls sum in another order.  The gradients then part at bf16
# resolution, and a bias gradient whose terms cancel can part entirely.
# So:
# * params and BN state, per leaf: max|port - JAX| <= N bf16 steps at the
#   leaf's largest entry, plus 3 lr for every Adam step taken (an Adam step
#   moves a value by up to ~1.5 lr, and the two sides may step opposite
#   ways where a gradient is near 0); N = 2 after round 1 (measured <= 1.95),
#   N = 4 after the later rounds (measured <= 2.2);
# * Adam moments, per state group: max|port - JAX| <= TOL_MOMENT of the
#   group's largest entry (measured <= 0.078; Mix-G 0.15 after round 1).
#   Mix-G's moments are compared after round 1 only: its DCGAN-init D's
#   bias gradients cancel to where XLA's bf16 sums lose them, and from round
#   2 on its D moments are up to 0.8 of the group's scale apart, while its
#   params hold the limits above;
# * metrics (float32 losses of bf16 outputs, ~0.7-1.4) and Lambda 5e-3
#   absolute (measured <= 2.7e-3).
# A wrong dtype, route or rounding rule moves them by far more (a float32
# Adam constant, the whole update path: see the Adam test for the bits).
TOL_STEPS = (2, 4)
TOL_MOMENT = (0.25, 0.15)           # after round 1, after later rounds
TOL_METRIC = 5e-3


def _spacing(x: float) -> float:
    """The distance between bf16 values next to |x| (normal range)."""
    return 2.0 ** (np.floor(np.log2(max(abs(x), 2.0 ** -126))) - 7)


@pytest.mark.parametrize("case", sorted(ROUND_CASES))
def test_bf16_rounds_match_jax(case):
    algo, epoch = ROUND_CASES[case][0], ROUND_CASES[case][2]
    for t, state, m, jstate, jm in _run_pair(case):
        assert set(m) == set(jm)
        for key in jm:
            assert m[key].dtype == torch.float32
            assert abs(float(m[key]) - float(jm[key])) < TOL_METRIC, \
                (t, key, float(m[key]), float(jm[key]))
        got = to_numpy(state, bf16="float32")
        ref = jax.tree.map(np.asarray, jstate)
        later = int(t > 0)
        for net in ("g", "d"):
            jnet = getattr(ref, net)
            flatten = net == "d" and np.ndim(jnet.opt[0].count) == 2
            np.testing.assert_array_equal(
                got[net]["count"],
                np.asarray(jnet.opt[0].count).reshape(-1).astype(np.int64))
            adam_steps = (t + 1) * (epoch if net == "d" else 1)
            for name, mine, theirs in _groups(got[net], jnet, flatten):
                assert len(mine) == len(theirs)
                if name in ("params", "bn"):
                    for i, (a, b) in enumerate(zip(mine, theirs)):
                        top = float(np.abs(b).max())
                        limit = TOL_STEPS[later] * _spacing(top) \
                            + 3 * LR * adam_steps
                        assert float(np.abs(a - b).max()) <= limit, \
                            (t, net, name, i, float(np.abs(a - b).max()),
                             limit)
                elif algo != "mixgan" or not later:
                    scale = max(float(np.abs(x).max()) for x in theirs)
                    worst = max(float(np.abs(a - b).max())
                                for a, b in zip(mine, theirs))
                    assert worst <= TOL_MOMENT[later] * scale, \
                        (t, net, name, worst / scale)
        if ref.lam is not None:
            np.testing.assert_allclose(got["lam"], ref.lam, rtol=0,
                                       atol=TOL_METRIC)
    for leaf in tree_leaves((state.g.params, state.d.params, state.g.opt.mu,
                             state.d.opt.nu)):
        assert leaf.dtype == torch.bfloat16

"""The slice as a whole: shrunk CAP-GAN rounds, port against JAX.

A small CAP-GAN (4 clients, 8x8 images, batch 8) starts from the JAX
``init_state()`` carried across by ``utils/transplant.py`` and runs 5 rounds
on each side with the JAX draws injected into the port's ``round_fn``
(``benchmarks/trajectory_parity.py`` ``cgl_round_streams``).  A cloud sync
fires inside the 5 rounds.  Three cases: the autograd D path at epoch=1,
the fused local-D kernel path at epoch=2 (JAX ``pallas_dstep=True`` in
interpret mode against the port's auto rule, which runs the kernel's plain
version on the CPU) and the autograd path at epoch=2 on both sides.
Compared: G and D params, G BN running stats, Adam moments and counts,
Lambda, the round counter and every round's metrics.
"""
import jax
import numpy as np
import pytest
import torch

from benchmarks.trajectory_parity import cgl_round_streams
from cglgan_tpu.algos.registry import build_runner as jax_build_runner
from cglgan_tpu.core import prng as jprng
from cglgan_tpu.core.config import FedGANConfig as JaxConfig
from cglgan_tpu.data.partition import Partition as JaxPartition
from cglgan_tpu_torch.algos.registry import build_runner
from cglgan_tpu_torch.core.config import FedGANConfig
from cglgan_tpu_torch.data.partition import Partition
from cglgan_tpu_torch.ops import fused_dstep
from cglgan_tpu_torch.utils.transplant import from_jax_numpy, to_numpy
from cglgan_tpu_torch.utils.tree import tree_leaves
from test_torch_port_threads import one_torch_thread  # noqa: F401

ROUNDS = 5
NW, L, DIN, B = 4, 48, 64, 8
LENGTHS = np.asarray([30, 48, 41, 36], np.int32)
LR = 2e-4

# Tolerances.  Both sides are float32 on the CPU; XLA and PyTorch sum in
# another order, and Adam divides by sqrt(nu), so a relative gradient
# difference of ~1e-6 moves a param by ~1e-6 of one step per round.
TOL_PARAMS = (1e-4, 1e-5)        # (rtol, atol), as tests/test_pallas_dstep.py
TOL_MOMENT = 1e-4                # of the group's largest entry
TOL_METRIC = 1e-5                # absolute, losses ~0.7


def _partition(seed=0):
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 256, (NW, L, DIN)).astype(np.uint8)
    fields = (data, np.zeros((NW, L), np.int32), LENGTHS,
              np.zeros((NW, 10), np.int64), np.zeros((10, DIN), np.uint8))
    return JaxPartition(*fields), Partition(*fields)


def _pre_bn_biases(runner_cfg):
    """Indices (in G param-leaf order) of linear biases that feed a
    BatchNorm: their gradient is exactly zero, so Adam moves them by
    rounding noise alone (up to ~lr per round) on either side."""
    from cglgan_tpu_torch.models.zoo import models_for_config
    g, _ = models_for_config(runner_cfg)
    idx, leaf = [], 0
    for i, entry in enumerate(g.spec):
        if entry[0] == "linear":
            if i + 1 < len(g.spec) and g.spec[i + 1][0] == "bn":
                idx.append(leaf)          # leaves sort as b, w
            leaf += 2
        elif entry[0] == "bn":
            leaf += 2                     # bias, scale
    return set(idx)


@pytest.mark.parametrize("epoch,servers,e_share,jax_kernel,port_kernel", [
    (1, 2, 2, None, False),      # autograd D path, 2 servers, D share
    (2, 2, 0, True, True),       # fused local-D kernel path
    (2, 2, 0, False, False),     # autograd path at epoch > 1
], ids=["epoch1", "epoch2_kernel", "epoch2_autograd"])
def test_capgan_rounds_match_jax(epoch, servers, e_share, jax_kernel,
                                 port_kernel):
    jpart, part = _partition()
    data_len = LENGTHS.reshape(servers, -1).sum(1)
    period = int(max(1, (data_len * 1 // B).min()))
    kw = dict(algo="capgan", dataset="synthetic-mnist", num_workers=NW,
              num_servers=servers, img_size=8, batch_size=B, epoch=epoch,
              E=e_share, num_communication=period + 2)   # sync at round 2
    jcfg = JaxConfig(pallas_dstep=jax_kernel, **kw)
    cfg = FedGANConfig(pallas_dstep=None if port_kernel else False, **kw)
    assert fused_dstep.eligible(cfg) == port_kernel

    jrun = jax_build_runner(jcfg, jpart)
    jstate = jrun.init_state()
    jround = jax.jit(jrun.round_fn)
    streams = cgl_round_streams(jprng.root_key(jcfg.seed), jcfg, L)

    run = build_runner(cfg, part, device="cpu")
    state = from_jax_numpy(jax.tree.map(np.asarray, jstate), cfg, "cpu")
    for t in range(ROUNDS):
        starts, z_d, z_g = streams(t)
        jstate, jm = jround(jstate)
        state, m = run.round_fn(state, (starts, torch.from_numpy(z_d),
                                        torch.from_numpy(z_g)))
        for key in jm:
            assert abs(float(m[key]) - float(jm[key])) < TOL_METRIC, \
                (t, key, float(m[key]), float(jm[key]))

    got = to_numpy(state)
    ref = jax.tree.map(np.asarray, jstate)
    assert got["t"] == int(ref.t) == ROUNDS
    np.testing.assert_allclose(got["lam"], ref.lam, rtol=1e-6)
    noisy = _pre_bn_biases(cfg)
    for net, jnet in (("g", ref.g), ("d", ref.d)):
        # the reference stacks D state (S, k, ...), the port (W, ...)
        flat = (lambda x: np.asarray(x).reshape((NW,) + np.shape(x)[2:])) \
            if net == "d" else np.asarray
        jadam = jnet.opt[0]
        np.testing.assert_array_equal(got[net]["count"],
                                      flat(jadam.count).astype(np.int64))
        pairs = zip(tree_leaves(got[net]["params"]),
                    jax.tree.leaves(jnet.params))
        for i, (a, b) in enumerate(pairs):
            if net == "g" and i in noisy:
                # zero-gradient bias: bounded by one Adam step per round
                np.testing.assert_allclose(a, flat(b), rtol=0,
                                           atol=LR * ROUNDS)
                continue
            np.testing.assert_allclose(a, flat(b), rtol=TOL_PARAMS[0],
                                       atol=TOL_PARAMS[1],
                                       err_msg=f"{net} param leaf {i}")
        for i, (a, b) in enumerate(zip(tree_leaves(got[net]["bn"]),
                                       jax.tree.leaves(jnet.bn))):
            np.testing.assert_allclose(a, flat(b), rtol=TOL_PARAMS[0],
                                       atol=TOL_PARAMS[1],
                                       err_msg=f"{net} BN buffer {i}")
        for moment in ("mu", "nu"):
            got_l = tree_leaves(got[net][moment])
            ref_l = [flat(x) for x in jax.tree.leaves(getattr(jadam,
                                                              moment))]
            scale = max(float(np.abs(x).max()) for x in ref_l)
            for i, (a, b) in enumerate(zip(got_l, ref_l)):
                np.testing.assert_allclose(
                    a, b, rtol=0, atol=TOL_MOMENT * scale,
                    err_msg=f"{net} {moment} leaf {i}")


def test_gen_and_sample_match_jax():
    """Serving paths from one carried-over state: eval-mode ``gen`` from
    caller latents and each client's ``gen_client`` equal the reference;
    ``sample`` returns finite images of the expected shape."""
    jpart, part = _partition()
    kw = dict(algo="capgan", dataset="synthetic-mnist", num_workers=NW,
              num_servers=2, img_size=8, batch_size=B)
    jrun = jax_build_runner(JaxConfig(**kw), jpart)
    run = build_runner(FedGANConfig(**kw), part, device="cpu")
    jstate = jrun.init_state()
    state = from_jax_numpy(jax.tree.map(np.asarray, jstate),
                           run.cfg, "cpu")
    z = np.random.default_rng(1).normal(size=(6, 100)).astype(np.float32)
    np.testing.assert_allclose(run.gen(state, torch.from_numpy(z)).numpy(),
                               np.asarray(jrun.gen(jstate, z)),
                               rtol=1e-5, atol=1e-6)
    for client in range(NW):
        np.testing.assert_allclose(
            run.gen_client(state, torch.from_numpy(z), client).numpy(),
            np.asarray(jrun.gen_client(jstate, z, client)),
            rtol=1e-5, atol=1e-6)
    imgs = run.sample(state, 6)
    assert tuple(imgs.shape) == (6, 1, 8, 8)
    assert bool(torch.isfinite(imgs).all())


def test_train_and_entry_point_contract():
    """``train`` ticks and metric means; by default every tick carries the
    image evaluator's FID and IS; the default device is the card;
    ``model_shards > 1`` without a mesh is the unsharded runner, as the
    reference's (``place_model_tp`` places nothing there); conv runs a round
    in float32 and in bfloat16."""
    from cglgan_tpu_torch.algos.runner import train
    _, part = _partition()
    cfg = FedGANConfig(algo="capgan", dataset="synthetic-mnist",
                       num_workers=NW, img_size=8, batch_size=B)
    run = build_runner(cfg, part, device="cpu")
    out = train(run, rounds=3, eval_every=2, evaluator=False)
    assert [t["round"] for t in out["history"]] == [2, 3]
    for tick in out["history"]:
        assert all(np.isfinite(tick[k]) for k in ("d_loss", "g_loss",
                                                  "f_max", "lambda"))
    assert out["state"].t == 3
    # the default evaluator trains its probe (300 small steps) on one
    # thread: a thread a core waits on the other test workers for minutes
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        tick = train(run, rounds=1, evaluator=None)["history"][0]
    finally:
        torch.set_num_threads(threads)
    assert np.isfinite(tick["fid"]) and np.isfinite(tick["inception_score"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build_runner(cfg, part)
    tp = build_runner(cfg.replace(model_shards=2), part, device="cpu")
    whole = lambda g: tree_leaves((g.params, g.bn, g.opt.mu, g.opt.nu))
    assert all(torch.equal(a, b) for a, b in zip(
        whole(tp.init_state().g), whole(run.init_state().g)))
    # conv is ported in float32 and bfloat16 (CAP-GAN, MD-GAN, AC-GAN):
    # each builds and runs a round on 32x32 images
    rng = np.random.default_rng(1)
    conv_part = Partition(
        rng.integers(0, 256, (NW, L, 1024)).astype(np.uint8),
        np.zeros((NW, L), np.int32), LENGTHS, np.zeros((NW, 10), np.int64),
        np.zeros((10, 1024), np.uint8))
    for kw in (dict(), dict(algo="mdgan"), dict(algo="acgan",
                                                num_servers=2)):
        conv = cfg.replace(conv=True, batch_size=4, **kw)
        run = build_runner(conv, conv_part, device="cpu")
        state, m = run.round_fn(run.init_state())
        assert state.t == 1 and all(np.isfinite(float(v))
                                    for v in m.values())
        run = build_runner(conv.replace(dtype="bfloat16"), conv_part,
                           device="cpu")
        state, m = run.round_fn(run.init_state())
        assert state.t == 1 and all(np.isfinite(float(v))
                                    for v in m.values())
        assert state.g.opt.mu["c1"]["w"].dtype == torch.bfloat16
    # bf16 mode is ported: it builds and trains
    bf16 = train(build_runner(cfg.replace(dtype="bfloat16"), part,
                              device="cpu"), rounds=1, eval_every=1,
                 evaluator=False)
    assert np.isfinite(bf16["history"][0]["g_loss"])

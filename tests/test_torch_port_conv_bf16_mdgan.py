"""The conv LSGAN pair in bfloat16 on MD-GAN and AC-GAN, port against the
JAX package, on the CPU.

The slice as a whole: MD-GAN (4 clients, 1 server) and AC-GAN (4 clients,
2 servers of 2) with ``conv=True, dtype="bfloat16"``, 32x32 images, batch
4, start from the JAX bf16 ``init_state()`` carried across by
``utils/transplant.py`` and run 2 rounds on each side with the reference's
draws injected into the port's ``round_fn``: the window starts, the
latents drawn in bf16 as the reference draws them, each server's ``(k_d,
k_drop)`` as threefry key data at slots 3 and 4, then the survival draw
and the shuffle permutation at slots 5 and 6
(tests/test_torch_port_conv_mdgan.py ``_streams``).  Cases: MD-GAN with
the ring D-swap every round and ``dropout_rate=0.5`` (the survivors'
masked G loss; the swap moves bf16 D params and BatchNorm buffers), and
AC-GAN with the delta gossip at E=2 (it fires after round 2; its anchors
in ``FedState.lam``, the bf16 D params and BatchNorm buffers before the
exchange, compared then and carried both ways bit for bit).  Limits:
tests/test_torch_port_conv_bf16.py's ``_close_bf16``; TF32 is off and
torch runs on one thread.
"""
import jax
import numpy as np
import pytest
import torch

from cglgan_tpu.algos.registry import build_runner as jax_build_runner
from cglgan_tpu.core import prng as jprng
from cglgan_tpu.core.config import FedGANConfig as JaxConfig
from cglgan_tpu_torch.algos.registry import build_runner
from cglgan_tpu_torch.core.config import FedGANConfig
from cglgan_tpu_torch.ops import fused_dstep
from cglgan_tpu_torch.utils.transplant import from_jax_numpy, to_numpy
from cglgan_tpu_torch.utils.tree import tree_leaves
from test_torch_port_bf16 import (TOL_METRIC, TOL_STEPS, _cgl_streams,
                                  _pair, _spacing)
from test_torch_port_conv import (B, LR, NW, _no_tf32,  # noqa: F401
                                  _partition, _paths)
from test_torch_port_conv_bf16 import (TOL_FWD_STEPS, _close_bf16, _jit,
                                       _stacked, _steps_apart)
from test_torch_port_conv_mdgan import L, _streams
from test_torch_port_threads import one_torch_thread  # noqa: F401

ROUNDS = 2

CASES = {
    # id: (algo, config fields)
    "mdgan_ring_dropout": ("mdgan", dict(E=1, d_swap="ring",
                                         dropout_rate=0.5)),
    "acgan_delta_e2": ("acgan", dict(E=2, gossip="delta")),
}


def _config(case):
    algo, extra = CASES[case]
    kw = dict(algo=algo, dataset="synthetic-mnist", conv=True,
              num_workers=NW, num_servers=1 if algo == "mdgan" else 2,
              iid=1, batch_size=B, dtype="bfloat16", **extra)
    return JaxConfig(**kw), FedGANConfig(**kw)


def _streams_bf16(jcfg):
    """The conv layout's streams of tests/test_torch_port_conv_mdgan.py,
    with the latents the reference's bf16 draws."""
    base = _streams(jcfg)
    latents = _cgl_streams(jprng.root_key(jcfg.seed), jcfg, L)

    def at(t):
        starts, z_d, z_g = latents(t)
        return (starts, z_d, z_g) + tuple(base(t)[3:])
    return at


def _close_anchors(got, ref, t):
    """The delta anchors (the D's params and BN buffers before the last
    exchange, flattened (W, ...)) at the params' limit after round t."""
    for mine, theirs in zip(got, ref):
        for path, a, b in zip(_paths(mine), tree_leaves(mine),
                              jax.tree.leaves(theirs)):
            b = np.asarray(b, np.float32).reshape(a.shape)
            limit = TOL_STEPS[int(t > 0)] * _spacing(
                float(np.abs(b).max())) + 3 * LR * (t + 1)
            assert float(np.abs(a - b).max()) <= limit, (path, t)


@pytest.mark.parametrize("case", sorted(CASES))
def test_conv_bf16_mdgan_rounds_match_jax(case):
    """2 rounds from the reference's bf16 init on its draws: metrics within
    TOL_METRIC, G and D (and the delta anchors) within ``_close_bf16``'s
    limits after each round; the exchange and the dropout happened; then
    ``gen`` on the reference's final state within TOL_FWD_STEPS and a bf16
    ``sample``."""
    algo, extra = CASES[case]
    jcfg, cfg = _config(case)
    jpart, part = _partition()
    assert not fused_dstep.eligible(cfg)
    jrun = jax_build_runner(jcfg, jpart)
    init = _jit(jrun.init_state)
    jstate = jax.tree.map(np.asarray, init())
    if extra.get("gossip") == "delta":
        assert jstate.lam is not None
    jround = _jit(jrun.round_fn, jstate)
    draw = _streams_bf16(jcfg)
    run = build_runner(cfg, part, device="cpu")
    state = from_jax_numpy(jstate, cfg, "cpu")
    launched, dropped = fused_dstep.launches, 0
    for t in range(ROUNDS):
        drawn = draw(t)
        jstate, jm = jround(jstate)
        state, m = run.round_fn(state, drawn)
        if drawn[5] is not None:
            dropped += int((~drawn[5]).sum())
        assert set(m) == set(jm)
        for key in jm:
            assert abs(float(m[key]) - float(jm[key])) < TOL_METRIC, \
                (t, key, float(m[key]), float(jm[key]))
        got = to_numpy(state, bf16="float32")
        ref = jax.tree.map(np.asarray, jstate)
        assert got["t"] == int(ref.t) == t + 1
        _close_bf16(got["g"], ref.g, "g", t, t + 1, np.asarray)
        _close_bf16(got["d"], ref.d, "d", t, t + 1, _stacked(NW))
        if ref.lam is None:
            assert got["lam"] is None
        else:
            _close_anchors(got["lam"], ref.lam, t)
    assert fused_dstep.launches == launched
    assert all(x.dtype == torch.bfloat16 for x in tree_leaves(
        (state.g.params, state.d.params, state.d.bn, state.d.opt.mu)))
    if extra.get("dropout_rate"):
        assert dropped > 0                  # the draws dropped someone
    if ref.lam is not None:
        # the anchors, no longer zero, carry over both ways bit for bit
        back = to_numpy(from_jax_numpy(ref, cfg, "cpu"))
        mine, theirs = tree_leaves(back["lam"]), jax.tree.leaves(ref.lam)
        assert len(mine) == len(theirs) > 0
        for a, b in zip(mine, theirs):
            assert a.dtype == b.dtype and a.dtype.name == "bfloat16"
            np.testing.assert_array_equal(
                a.view(np.uint16), np.asarray(b).reshape(a.shape)
                .view(np.uint16))
        assert any(np.abs(a.astype(np.float32)).max() > 0 for a in mine)
    # serving: each server's G on its block of bf16 latents
    carried = from_jax_numpy(ref, cfg, "cpu")
    jz, tz = _pair(np.random.default_rng(1).normal(size=(4, 100)))
    assert _steps_apart(run.gen(carried, tz),
                        _jit(jrun.gen, jstate, jz)(jstate, jz)) \
        <= TOL_FWD_STEPS
    imgs = run.sample(carried, 4)
    assert tuple(imgs.shape) == (4, 1, 32, 32)
    assert imgs.dtype == torch.bfloat16

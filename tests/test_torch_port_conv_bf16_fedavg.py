"""The conv LSGAN pair in bfloat16 on FL-GAN and FeGAN, port against the
JAX package, on the CPU.

The slice as a whole: 4 workers with 32x32 images and batch 4 under
``conv=True, dtype="bfloat16"`` start from the JAX bf16 ``init_state()``
carried across by ``utils/transplant.py`` and run 2 rounds on each side
with the reference's draws injected into the port's ``round_fn``: the
window starts, each lane's latents a local step drawn in bf16 as the
reference's sweep draws them (``cglgan_tpu/algos/fedavg_family.py:
133,141``) and each lane's ``kd1, kd2`` a local step as threefry key data
at slots 3 and 4.  Cases: FL-GAN on the ragged "epochs" sweep (shard
lengths 4, 8, 8 and 4: 1 and 2 local steps a lane; the JAX runner takes
two step-count buckets, the port one masked sweep whose ``_merge`` keeps
a finished lane's bf16 state), and FeGAN in gather mode
(``frac_workers=0.5``, 2 of the 4 lanes a round, the D's BatchNorm
buffers per worker, the raw-logit head; its lanes take one local step
each: a second step-count bucket is a second scan for XLA to compile).
Then the per-worker D BatchNorm carried both ways bit for bit, ``gen``
(FL-GAN: against the reference's on bf16 latents) and ``sample``.  The
reference's round is compiled at XLA's default optimization level: at
level 0 its bf16 scan runs 40 s a round.

Limits: tests/test_torch_port_conv_bf16.py's ``_close_bf16``, with the
Adam-step term counted at the largest lane's local steps.  TF32 is off and
torch runs on one thread.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cglgan_tpu.algos import common as jcommon
from cglgan_tpu.algos import fedavg_family as jfedavg
from cglgan_tpu.algos.registry import build_runner as jax_build_runner
from cglgan_tpu.core import prng as jprng
from cglgan_tpu.core.config import FedGANConfig as JaxConfig
from cglgan_tpu.data.partition import Partition as JaxPartition
from cglgan_tpu_torch.algos.registry import build_runner
from cglgan_tpu_torch.core.config import FedGANConfig
from cglgan_tpu_torch.data.partition import Partition
from cglgan_tpu_torch.ops import fused_sweep
from cglgan_tpu_torch.utils.transplant import (from_jax_numpy,
                                               tensor_from_numpy, to_numpy)
from cglgan_tpu_torch.utils.tree import tree_leaves
from test_torch_port_bf16 import TOL_METRIC, _pair
from test_torch_port_conv import _no_tf32  # noqa: F401
from test_torch_port_conv_bf16 import (TOL_FWD_STEPS, _close_bf16, _jit,
                                       _steps_apart)
from test_torch_port_conv_fedavg import (L, NW, _dropout_keys, _fields,
                                         _step_keys)
from test_torch_port_threads import one_torch_thread  # noqa: F401

ROUNDS = 2

CASES = {
    # id: (algo, shard lengths (local steps ceil(length / B)), fields)
    "flgan_ragged": ("flgan", (4, 8, 8, 4), {}),
    "fegan_gather": ("fegan", (4, 4, 4, 4), dict(frac_workers=0.5)),
}


def _config(case):
    algo, _, extra = CASES[case]
    kw = dict(algo=algo, dataset="synthetic-mnist", conv=True,
              num_workers=NW, num_class=10, iid=1, batch_size=4,
              num_communication=8, dtype="bfloat16", **extra)
    return JaxConfig(**kw), FedGANConfig(**kw)


@functools.partial(jax.jit, static_argnums=(1, 2, 3))
def _bf16_latents(key, workers, steps, batch):
    """Each lane's ``(z1, z2)`` a local step, (W, steps, B, 100) bf16: the
    ``normal(kzd)`` / ``normal(kzg)`` of its step keys in bf16."""
    k = _step_keys(key, workers, steps)
    draw = jax.vmap(jax.vmap(lambda kk: jax.random.normal(
        kk, (batch, 100), jnp.bfloat16)))
    return draw(k[:, :, 0]), draw(k[:, :, 1])


def _streams(jcfg, steps):
    """Round t's ``(starts, z1, z2, kd1, kd2)`` in bf16, the starts as
    ``benchmarks/trajectory_parity.py`` ``flgan_round_streams`` draws
    them."""
    root = jprng.root_key(jcfg.seed)
    keys = _dropout_keys(root, jcfg, steps)
    B = jcfg.batch_size

    def at(t):
        key = jprng.for_round(jprng.for_role(root, jprng.ROLE_LOCAL), t)
        starts = [int(jcommon.batch_start(kk, L, B)) for kk in
                  jax.random.split(jprng.for_role(key, jprng.ROLE_BATCH),
                                   steps)]
        z1, z2 = (tensor_from_numpy(np.asarray(z), "cpu") for z in
                  _bf16_latents(key, NW, steps, B))
        return (starts, z1, z2, *keys(t))
    return at


@pytest.mark.parametrize("case", sorted(CASES))
def test_conv_bf16_fedavg_rounds_match_jax(case):
    """2 rounds from the reference's bf16 init on its draws: metrics within
    TOL_METRIC, G and D within ``_close_bf16``'s limits after each round,
    every leaf still bf16; FeGAN's per-worker D BatchNorm carried both ways
    bit for bit; ``gen`` and ``sample`` bf16 (4, 1, 32, 32)."""
    algo, lengths, extra = CASES[case]
    jcfg, cfg = _config(case)
    fields = _fields(lengths)
    assert not fused_sweep.eligible(cfg)
    steps = jfedavg._local_steps(jcfg, fields[2])
    assert (len(set(steps.tolist())) > 1) == (algo == "flgan")  # ragged
    jrun = jax_build_runner(jcfg, JaxPartition(*fields))
    jstate = jax.tree.map(np.asarray, _jit(jrun.init_state)())
    jround = _jit(jrun.round_fn, jstate, fast=False)
    draw = _streams(jcfg, int(steps.max()))
    run = build_runner(cfg, Partition(*fields), device="cpu")
    state = from_jax_numpy(jstate, cfg, "cpu")
    launched = fused_sweep.launches
    for t in range(ROUNDS):
        jstate, jm = jround(jstate)
        state, m = run.round_fn(state, draw(t))
        assert set(m) == set(jm)
        for key in jm:
            assert abs(float(m[key]) - float(jm[key])) < TOL_METRIC, \
                (t, key, float(m[key]), float(jm[key]))
        got = to_numpy(state, bf16="float32")
        ref = jax.tree.map(np.asarray, jstate)
        assert got["t"] == int(ref.t) == t + 1 and got["lam"] is None
        adam_steps = (t + 1) * int(steps.max())
        for net in ("g", "d"):
            _close_bf16(got[net], getattr(ref, net), net, t, adam_steps,
                        np.asarray)
    assert fused_sweep.launches == launched
    assert all(x.dtype == torch.bfloat16 for x in tree_leaves(
        (state.g.params, state.g.bn, state.d.params, state.d.bn,
         state.g.opt.mu, state.d.opt.nu)))
    carried = from_jax_numpy(ref, cfg, "cpu")
    jz, tz = _pair(np.random.default_rng(1).normal(size=(4, 100)))
    out = run.gen(carried, tz)
    assert tuple(out.shape) == (4, 1, 32, 32)
    assert out.dtype == torch.bfloat16
    if algo == "flgan":
        assert _steps_apart(out, _jit(jrun.gen, jstate, jz)(jstate, jz)) \
            <= TOL_FWD_STEPS
    else:
        # the D's BatchNorm buffers per worker, carried over both ways
        back = to_numpy(from_jax_numpy(ref, cfg, "cpu"))
        for a, b in zip(tree_leaves(back["d"]["bn"]),
                        jax.tree.leaves(ref.d.bn)):
            assert a.shape[0] == NW and a.dtype.name == "bfloat16"
            np.testing.assert_array_equal(a.view(np.uint16),
                                          np.asarray(b).view(np.uint16))
        # the eval G runs on the float32 init BN, as the reference's; its
        # BatchNorm output is float32 and takes the bf16 conv's dtype
        # (the reference's conv refuses the mix: nn.group_conv2d)
        assert bool(torch.isfinite(out.float()).all())
    imgs = run.sample(carried, 4)
    assert tuple(imgs.shape) == (4, 1, 32, 32)
    assert imgs.dtype == torch.bfloat16
    assert bool(torch.isfinite(imgs.float()).all())

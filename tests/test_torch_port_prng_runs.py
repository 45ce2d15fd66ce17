"""Runs from a seed in the port against the reference's runs from the same
seed, on the CPU: no stream injected on either side.

Each family's runner is built from one config on both packages and runs
from its own ``init_state()`` (the reference's threefry split tree in the
port, ``cglgan_tpu_torch/core/prng.py``; ``tests/test_torch_port_prng_tree.py``
holds the draws themselves).  CAP-GAN and MD-GAN (shuffle D-swap with
dropout), FeGAN on 2DMG with dropout, and the conv CGL-GAN, each held at
the tolerances of its family's own round tests (``test_torch_port_mdgan.py``,
``test_torch_port_fedavg.py``, ``test_torch_port_conv.py``): the latents
differ by at most 3 ulps, below the reordered sums those tolerances
already allow.  Then ``train``'s ``on_tick`` against the reference's, called
with the same positional arguments.
"""
import jax
import numpy as np
import pytest
import torch

from cglgan_tpu.algos import registry as jregistry
from cglgan_tpu.algos import runner as jrunner
from cglgan_tpu.core.config import FedGANConfig as JaxConfig
from cglgan_tpu.data.partition import Partition as JaxPartition
from cglgan_tpu_torch.algos import registry, runner
from cglgan_tpu_torch.core.config import FedGANConfig
from cglgan_tpu_torch.data.partition import Partition
from cglgan_tpu_torch.models import zoo
from cglgan_tpu_torch.utils.transplant import to_numpy
from cglgan_tpu_torch.utils.tree import tree_leaves
from test_torch_port_threads import one_torch_thread  # noqa: F401



def _image_partition(nw=4, L=48, din=64, seed=0):
    rng = np.random.default_rng(seed)
    fields = (rng.integers(0, 256, (nw, L, din)).astype(np.uint8),
              np.zeros((nw, L), np.int32), np.full(nw, L, np.int32),
              np.ones((nw, 10), np.int64), np.zeros((10, din), np.uint8))
    return JaxPartition(*fields), Partition(*fields)



def _run_both(jcfg, cfg, jpart, part, rounds):
    """The reference's jitted rounds and the port's from their own
    ``init_state()``; returns (port state, JAX state as numpy, per-round
    metric pairs)."""
    jrun = jregistry.build_runner(jcfg, jpart)
    jstate = jrun.init_state()
    jround = jax.jit(jrun.round_fn)
    run = registry.build_runner(cfg, part, device="cpu")
    state = run.init_state()
    metrics = []
    for _ in range(rounds):
        jstate, jm = jround(jstate)
        state, m = run.round_fn(state)
        metrics.append(({k: float(v) for k, v in m.items()},
                        {k: float(v) for k, v in jm.items()}))
    return state, jax.tree.map(np.asarray, jstate), metrics


def _metrics_close(metrics, tol):
    for m, jm in metrics:
        assert set(m) == set(jm)
        for key in jm:
            assert abs(m[key] - jm[key]) < tol, (key, m[key], jm[key])


@pytest.mark.parametrize("case", ["capgan", "mdgan_shuffle_dropout"])
def test_mlp_run_from_seed_matches_reference(case):
    """CAP-GAN (2 servers, 8x8 images) and MD-GAN with the shuffle D-swap
    every round and dropout 0.5, 3 rounds each at epoch 1, at the
    MD-GAN family's round tolerances."""
    from test_torch_port_mdgan import (ROUNDS, TOL_METRIC, _close_net,
                                       _pre_bn_mask)
    kw = dict(dataset="synthetic-mnist", num_workers=4, img_size=8,
              batch_size=8, epoch=1)
    if case == "capgan":
        kw.update(algo="capgan", num_servers=2, num_communication=4)
    else:
        kw.update(algo="mdgan", num_servers=1, E=1, d_swap="shuffle",
                  dropout_rate=0.5)
    jpart, part = _image_partition()
    cfg = FedGANConfig(**kw)
    state, ref, metrics = _run_both(JaxConfig(**kw), cfg, jpart, part,
                                    ROUNDS)
    _metrics_close(metrics, TOL_METRIC)
    got = to_numpy(state)
    assert got["t"] == int(ref.t) == ROUNDS
    g_model = zoo.models_for_config(cfg)[0]
    _close_net(got["g"], ref.g, "g", tree_leaves(_pre_bn_mask(g_model.spec)))
    _close_net(got["d"], ref.d, "d",
               [False] * len(tree_leaves(got["d"]["params"])))


def test_fegan_2dmg_run_from_seed_matches_reference():
    """FeGAN on 2DMG (gather mode, 0.5 of the workers a round) with dropout
    0.5: 3 rounds from the seed on the reference's partition, at the
    FedAvg family's round tolerances."""
    from test_torch_port_fedavg import (ROUNDS, SHRUNK, TOL_METRIC,
                                        TOL_MOMENT, TOL_PARAMS, _jax_rounds)
    fields, _, _, jmetrics, ref, _ = _jax_rounds("fegan", 2, 0.5)
    cfg = FedGANConfig(algo="fegan", epoch=2, dropout_rate=0.5,
                       frac_workers=0.5, **SHRUNK)
    run = registry.build_runner(cfg, Partition(*fields), device="cpu")
    state = run.init_state()
    for t in range(ROUNDS):
        state, m = run.round_fn(state)
        _metrics_close([({k: float(v) for k, v in m.items()}, jmetrics[t])],
                       TOL_METRIC)
    got = to_numpy(state)
    for net, jnet in (("g", ref.g), ("d", ref.d)):
        jadam = jnet.opt[0]
        np.testing.assert_array_equal(
            got[net]["count"], np.asarray(jadam.count).astype(np.int64))
        for a, b in zip(tree_leaves(got[net]["params"]),
                        jax.tree.leaves(jnet.params), strict=True):
            np.testing.assert_allclose(a, b, rtol=TOL_PARAMS[0],
                                       atol=TOL_PARAMS[1])
        for moment in ("mu", "nu"):
            ref_l = jax.tree.leaves(getattr(jadam, moment))
            scale = max(float(np.abs(x).max()) for x in ref_l)
            for a, b in zip(tree_leaves(got[net][moment]), ref_l,
                            strict=True):
                np.testing.assert_allclose(a, b, rtol=0,
                                           atol=TOL_MOMENT * scale)


def test_conv_cglgan_run_from_seed_matches_reference():
    """The conv flagship's shape, shrunk (CGL-GAN, multipath conv G, 4
    clients / 2 servers, B=4, epoch 1, a cloud sync at round 2): 2 rounds
    from the seed, the conv D's dropout keys the port's own, at the conv
    round tests' tolerances (a share of flipped elements after each
    round)."""
    from test_torch_port_conv import (FLIP_SHARE, ROUNDS, TOL_METRIC,
                                      _close_net, _noisy_leaves, _partition)
    kw = dict(algo="cglgan", dataset="synthetic-mnist", conv=True,
              num_workers=4, num_servers=2, iid=1, batch_size=4, epoch=1,
              cloud_epoch=2, segema=0.1, num_communication=10)
    jpart, part = _partition()
    state, ref, metrics = _run_both(JaxConfig(**kw), FedGANConfig(**kw),
                                    jpart, part, ROUNDS)
    _metrics_close(metrics, TOL_METRIC)
    got = to_numpy(state)
    assert got["t"] == int(ref.t) == ROUNDS
    g_noisy, d_noisy = _noisy_leaves("cglgan")
    _close_net(got["g"], ref.g, "g", *g_noisy, steps=ROUNDS,
               share=FLIP_SHARE[-1])
    _close_net(got["d"], ref.d, "d", *d_noisy, steps=ROUNDS,
               share=FLIP_SHARE[-1])


# ---------------------------------------------------------------------------
# train's on_tick
# ---------------------------------------------------------------------------

def test_train_on_tick_matches_reference():
    """``train(runner, 2, 1, None, cb)`` positionally on both packages:
    ``cb(round, tick, state)`` after each tick, the same rounds, tick keys
    and losses (a 2DMG run from the seed)."""
    kw = dict(algo="flgan", dataset="2dmg", num_workers=4, num_class=4,
              num_sample=64, batch_size=16, iid=1, epoch=2, num_plt=1)
    jcfg, cfg = JaxConfig(**kw), FedGANConfig(**kw)
    jpart = jregistry.load_partition(jcfg)
    part = registry.load_partition(cfg)
    np.testing.assert_array_equal(part.labels, np.asarray(jpart.labels))
    calls, jcalls = [], []
    out = runner.train(registry.build_runner(cfg, part, device="cpu"), 2, 1,
                       None, lambda r, tick, s: calls.append((r, tick, s.t)))
    jrunner.train(jregistry.build_runner(jcfg, jpart), 2, 1, None,
                  lambda r, tick, s: jcalls.append((r, tick, int(s.t))))
    assert [(r, t) for r, _, t in calls] == [(1, 1), (2, 2)]
    assert [(r, t) for r, _, t in calls] == [(r, t) for r, _, t in jcalls]
    for (_, tick, _), (_, jtick, _) in zip(calls, jcalls):
        assert tick is not None and set(jtick) <= set(tick) | {"wall_s"}
        for key in ("d_loss", "g_loss", "round"):
            assert abs(tick[key] - jtick[key]) < 1e-4, key
    assert out["history"] == [c[1] for c in calls]

"""The MD-GAN family's chunked round loop (``algos/runner.py``
``RoundProgram``, the counterpart of the reference's ``scan_rounds``) on
the CPU.

On the card ``train`` replays one captured round of an MD-GAN or AC-GAN
MLP runner; here the same round body runs eagerly, one call a round, on
the same static buffers, device round counter and key / window-start
tables.  The round decides on the device what the per-round loop decides
on the host: the exchange (computed every round, kept where ``(t + 1) % E
== 0``), the delta gossip's anchors, the survival draw and MD-GAN's
shuffle permutation (both from the round's key row).  Held here, on
``tests/test_torch_port_mdgan.py``'s small hierarchy (4 clients: MD-GAN 1
server, AC-GAN 2 servers of 2; AC-GAN on 2DMG 8 clients, 2 servers of 4;
8x8 images or 2DMG rows, batch 8):

* bit for bit (``torch.equal``) to the port's per-round loop (``round_fn``
  once a round from its host counter), every state tensor and every
  round's metrics over 4 rounds: the MD-GAN ring and shuffle, the AC-GAN
  mean and delta gossips, each at E=1 and E=2, AC-GAN with dropout, the
  fused local-D phase's plain version at epoch 2 and a bf16 case;
* to the reference's ``train``, which runs ``scan_rounds(round_fn, n)``
  jitted, from the same seed on both sides, in pieces of ``scan_rounds=2``
  or auto, at ``tests/test_torch_port_mdgan.py``'s tolerances (the delta
  gossip at k=2 and 4: the jitted delta gossip differs in the last bit at
  k=3 and 5, ROADMAP queue 3);
* a piece reads no tensor on the host (``tests/test_torch_port_scan.py``'s
  check);
* the survival draw and the permutation from a key tensor, bit-equal to
  ``jax.random.bernoulli(fold_in(key, 7), ...)`` and
  ``jax.random.permutation(for_role(key, ROLE_SWAP), W)``.
"""
import jax
import numpy as np
import pytest
import torch

from cglgan_tpu.algos import registry as jregistry
from cglgan_tpu.algos import runner as jrunner
from cglgan_tpu.core import prng as jprng
from cglgan_tpu.core.config import FedGANConfig as JaxConfig
from cglgan_tpu_torch.algos import runner
from cglgan_tpu_torch.algos.registry import build_runner
from cglgan_tpu_torch.core import prng, threefry
from cglgan_tpu_torch.core.config import FedGANConfig
from cglgan_tpu_torch.models import zoo
from cglgan_tpu_torch.ops import fused_dstep
from cglgan_tpu_torch.utils.transplant import to_numpy
from cglgan_tpu_torch.utils.tree import tree_leaves
from test_torch_port_mdgan import (B, LR, TOL_BF16_METRIC, TOL_BF16_MOMENT,
                                   TOL_BF16_STEPS, TOL_METRIC, TOL_PARAMS,
                                   _close_net, _flat_d, _partition,
                                   _pre_bn_mask, _spacing)
from test_torch_port_mdgan import ROUNDS as REF_ROUNDS
from test_torch_port_scan import HOST_READS
from test_torch_port_threads import one_torch_thread  # noqa: F401

ROUNDS = 4

# id: (algo, dataset, epoch, config fields)
CASES = {
    "mdgan_ring_E1": ("mdgan", "synthetic-mnist", 1,
                      dict(E=1, d_swap="ring")),
    "mdgan_ring_E2": ("mdgan", "synthetic-mnist", 1,
                      dict(E=2, d_swap="ring")),
    "mdgan_shuffle_E1": ("mdgan", "2dmg", 1, dict(E=1, d_swap="shuffle")),
    "mdgan_shuffle_E2": ("mdgan", "2dmg", 1, dict(E=2, d_swap="shuffle")),
    "acgan_mean_E1": ("acgan", "synthetic-mnist", 1,
                      dict(E=1, gossip="mean")),
    "acgan_mean_E2": ("acgan", "synthetic-mnist", 1,
                      dict(E=2, gossip="mean")),
    "acgan_delta_E1": ("acgan", "synthetic-mnist", 1,
                       dict(E=1, gossip="delta")),
    "acgan_delta_E2": ("acgan", "synthetic-mnist", 1,
                       dict(E=2, gossip="delta")),
    "acgan_dropout": ("acgan", "synthetic-mnist", 1,
                      dict(dropout_rate=0.5)),
    # the fused local-D phase (its plain version here), k=4, E=2 mean
    "acgan_2dmg_e2_kernel": ("acgan", "2dmg", 2, dict(E=2, gossip="mean")),
    # the forced bf16-state kernel with the E=2 shuffle
    "mdgan_e2_bf16_kernel": ("mdgan", "synthetic-mnist", 2,
                             dict(E=2, d_swap="shuffle", dtype="bfloat16",
                                  pallas_dstep=True)),
}


def _config(case, **over):
    algo, dataset, epoch, extra = CASES[case]
    nw = 8 if algo == "acgan" and dataset == "2dmg" else 4
    kw = dict(algo=algo, dataset=dataset, num_workers=nw,
              num_servers=1 if algo == "mdgan" else 2, iid=1, img_size=8,
              batch_size=B, epoch=epoch, **extra)
    kw.update(over)
    return kw


def _runner(case, **over):
    kw = _config(case, **over)
    _, part = _partition(kw["dataset"], kw["num_workers"])
    return build_runner(FedGANConfig(**kw), part, device="cpu")


def _leaves(state):
    return runner.state_leaves(state)


# ---------------------------------------------------------------------------
# the round loop against the per-round loop, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", sorted(CASES))
def test_program_equals_per_round_loop(case):
    """``train`` through the runner's program against ``round_fn`` once a
    round from the same state: every state tensor (the delta anchors
    included) and every round's metrics equal (a tick a round), and the
    state's counter; at E=2 the delta anchors were replaced at an exchange,
    and the dropout case's draws drop someone."""
    run = _runner(case)
    cfg = run.cfg
    assert run.program is not None
    assert fused_dstep.eligible(cfg) == ("kernel" in case)
    state0 = run.init_state()
    state, eager = state0, []
    for _ in range(ROUNDS):
        state, m = run.round_fn(state)
        eager.append(m)
    out = runner.train(run, ROUNDS, eval_every=1, state=state0,
                       evaluator=False)
    got = out["state"]
    assert got.t == state.t == ROUNDS
    for a, b in zip(_leaves(got), _leaves(state), strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b)
    for tick, m in zip(out["history"], eager, strict=True):
        keys = sorted(m)
        assert keys == ["d_loss", "g_loss"]
        want = torch.stack([m[k] for k in keys]).float().tolist()
        assert [tick[k] for k in keys] == want
    if cfg.gossip == "delta" and cfg.E == 2:
        # replaced at the exchanges of rounds 1 and 3, zero before
        assert state.lam is not None
        assert any(bool(x.abs().max() > 0) for x in tree_leaves(state.lam))
    if cfg.dropout_rate:
        alive = [prng.survival(cfg, t, cfg.num_workers, "cpu")
                 for t in range(ROUNDS)]
        assert any(not bool(a.all()) for a in alive)


# ---------------------------------------------------------------------------
# against the reference's scan_rounds
# ---------------------------------------------------------------------------

def _both_trains(case, rounds, **over):
    """The reference's ``train`` (jitted ``scan_rounds`` pieces) and the
    port's, each from its own ``init_state()``; returns (port runner, port
    state, port tick, reference state as numpy, reference tick, reference
    pieces)."""
    kw = _config(case, **over)
    jpart, part = _partition(kw["dataset"], kw["num_workers"])
    pieces = []
    scan = jrunner.scan_rounds

    def recorded(round_fn, n, **a):
        pieces.append(n)
        return scan(round_fn, n, **a)

    jrunner.scan_rounds = recorded
    try:
        jout = jrunner.train(jregistry.build_runner(JaxConfig(**kw), jpart),
                             rounds, rounds, evaluator=False)
    finally:
        jrunner.scan_rounds = scan
    run = build_runner(FedGANConfig(**kw), part, device="cpu")
    assert run.program is not None
    out = runner.train(run, rounds, rounds, evaluator=False)
    return (run, out["state"], out["history"][0],
            jax.tree.map(np.asarray, jout["state"]), jout["history"][0],
            pieces)


@pytest.mark.parametrize("case,scan,pieces", [
    ("mdgan_shuffle_E2", 0, [REF_ROUNDS]),
    ("acgan_delta_E2", 2, [2, 1]),
    ("acgan_dropout", 0, [REF_ROUNDS]),
    ("acgan_2dmg_e2_kernel", 0, [REF_ROUNDS])])
def test_matches_reference_scan_rounds(case, scan, pieces):
    """Float32, 3 rounds from the seed on both sides, the reference's
    pieces as its rule cuts them (``scan_rounds=2``: 2 and 1; auto: one of
    3), held at ``tests/test_torch_port_mdgan.py``'s tolerances (its
    ``_close_net``; the delta anchors as params)."""
    run, state, tick, ref, jtick, got_pieces = _both_trains(
        case, REF_ROUNDS, scan_rounds=scan)
    assert got_pieces == pieces
    for key, value in jtick.items():
        if key not in ("wall_s", "rounds_per_s", "round"):
            assert abs(tick[key] - value) < TOL_METRIC, (key, tick[key],
                                                         value)
    assert tick["round"] == jtick["round"] == REF_ROUNDS
    got = to_numpy(state)
    assert got["t"] == int(ref.t) == REF_ROUNDS
    g_model = zoo.models_for_config(run.cfg)[0]
    _close_net(got["g"], ref.g, "g", tree_leaves(_pre_bn_mask(g_model.spec)))
    _close_net(got["d"], ref.d, "d",
               [False] * len(tree_leaves(got["d"]["params"])))
    if run.cfg.gossip == "delta" and run.cfg.E > 0:
        for a, b in zip(tree_leaves(got["lam"]), jax.tree.leaves(ref.lam),
                        strict=True):
            np.testing.assert_allclose(a, _flat_d(b), rtol=TOL_PARAMS[0],
                                       atol=TOL_PARAMS[1])
    else:
        assert got["lam"] is None and ref.lam is None


def test_matches_reference_scan_rounds_bf16():
    """bf16, MD-GAN with the forced bf16-state kernel (its plain version
    here) and the E=2 shuffle on both sides, 3 rounds from the seed in one
    auto piece, held at ``tests/test_torch_port_mdgan.py``'s bf16 limits
    after a later round (``TOL_BF16_*``)."""
    case = "mdgan_e2_bf16_kernel"
    run, state, tick, ref, jtick, pieces = _both_trains(case, REF_ROUNDS)
    assert pieces == [REF_ROUNDS]
    for key, value in jtick.items():
        if key not in ("wall_s", "rounds_per_s", "round"):
            assert abs(tick[key] - value) < TOL_BF16_METRIC, (key, tick[key],
                                                              value)
    got = to_numpy(state, bf16="float32")
    for net in ("g", "d"):
        jnet = getattr(ref, net)
        flat = _flat_d if net == "d" else \
            (lambda x: np.asarray(x, np.float32))
        jadam = jnet.opt[0]
        np.testing.assert_array_equal(got[net]["count"],
                                      flat(jadam.count).astype(np.int64))
        steps = REF_ROUNDS * (run.cfg.epoch if net == "d" else 1)
        for name, theirs in (("params", jnet.params), ("bn", jnet.bn)):
            for i, (a, b) in enumerate(zip(tree_leaves(got[net][name]),
                                           jax.tree.leaves(theirs))):
                b = flat(b)
                limit = TOL_BF16_STEPS[1] * _spacing(
                    float(np.abs(b).max())) + 3 * LR * steps
                assert float(np.abs(a - b).max()) <= limit, \
                    (net, name, i, float(np.abs(a - b).max()), limit)
        for name in ("mu", "nu"):
            mine = tree_leaves(got[net][name])
            theirs = [flat(x) for x in jax.tree.leaves(getattr(jadam, name))]
            scale = max(float(np.abs(x).max()) for x in theirs)
            worst = max(float(np.abs(a - b).max())
                        for a, b in zip(mine, theirs))
            assert worst <= TOL_BF16_MOMENT[1] * scale, (net, name,
                                                         worst / scale)
    for leaf in tree_leaves((state.g.params, state.d.params)):
        assert leaf.dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# the host, and the draws from a key tensor
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["mdgan_shuffle_E2", "acgan_delta_E2",
                                  "acgan_dropout", "acgan_2dmg_e2_kernel"])
def test_piece_reads_no_tensor_on_the_host(case, monkeypatch):
    """A piece (the tables filled, the counter set, its rounds) with every
    host read of a tensor raising: none happens."""
    run = _runner(case)
    program = run.program
    program.load(run.init_state())

    def refuse(name):
        def read(*args, **kwargs):
            raise AssertionError(f"a host read: Tensor.{name}")
        return read

    with monkeypatch.context() as patch:
        for name in HOST_READS:
            patch.setattr(torch.Tensor, name, refuse(name))
        with pytest.raises(AssertionError, match="host read"):
            bool(torch.ones(()))
        program.run(0, 3)
    assert int(program.t) == 3
    assert all(bool(torch.isfinite(x.float()).all())
               for x in _leaves(program.static))


@pytest.mark.parametrize("n,rate", [(4, 0.5), (10, 0.2), (20, 0.9)])
def test_draws_from_a_key_tensor_bit_equal(n, rate):
    """``prng.survival_of_key`` and ``permutation_of_key`` on a round's key
    row (the program's table, as a captured round reads it) against the
    reference's round draws from its round key, at rounds 0-5; each equals
    the host counter's form (``RoundKeys.survival``, ``permutation``)."""
    cfg = FedGANConfig(algo="acgan", dataset="2dmg", num_workers=n,
                       num_servers=1, dropout_rate=rate, seed=n)
    keys = prng.RoundKeys(cfg, 48, 1, "cpu", piece=6)
    keys.fill(0, 6)
    local = jprng.for_role(jprng.root_key(cfg.seed), jprng.ROLE_LOCAL)
    for t in range(6):
        jkey = jprng.for_round(local, t)
        row = keys.keys[t]
        alive = prng.survival_of_key(cfg, row, n)
        want = np.asarray(jax.random.bernoulli(jax.random.fold_in(jkey, 7),
                                               1.0 - rate, (n,)))
        assert alive.dtype == torch.bool
        np.testing.assert_array_equal(alive.numpy(), want)
        assert torch.equal(alive, keys.survival(t, n))
        perm = prng.permutation_of_key(row, n)
        want = np.asarray(jax.random.permutation(
            jprng.for_role(jkey, jprng.ROLE_SWAP), n))
        np.testing.assert_array_equal(perm.numpy(), want)
        assert torch.equal(perm, keys.permutation(t, n))
    assert torch.equal(keys.keys[2], threefry.fold_in(keys.local, 2))

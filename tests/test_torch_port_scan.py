"""The CGL family's chunked round loop (``algos/runner.py`` ``RoundProgram``,
the counterpart of the reference's ``scan_rounds``) on the CPU; the MD-GAN
family's is ``tests/test_torch_port_scan_mdgan.py``'s.

On the card ``train`` replays one captured round; here the same round body
runs eagerly, one call a round, on the same static buffers, device round
counter and key / window-start tables.  Held here:

* bit for bit (``torch.equal``) to the port's per-round loop (``round_fn``
  called once a round from its host counter) for CAP-GAN, CGL-GAN and Mix-G
  on MNIST shapes and 2DMG, float32 and bf16, autograd and the fused
  local-D phase (its plain version here), over rounds where the cloud sync
  fires and where it does not, with the E=2 neighbour share;
* to the reference's ``train``, which runs ``scan_rounds(round_fn, n)``
  jitted, from the same seed on both sides (``segema > 0``, as every
  jitted CGL round test: ROADMAP queue 3), at the round tests' stated
  tolerances (``tests/test_torch_port_cgl.py`` in float32,
  ``tests/test_torch_port_bf16.py`` in bf16), with the pieces the
  reference's rule cuts (``cfg.scan_rounds``, or auto);
* ``fused_dstep``'s plain version and the autograd D steps with their
  window starts in an int32 tensor against host ints, and a start out of
  range failing the run;
* ``train``'s state rules: the caller's state is not changed, the returned
  state is not changed by a later call;
* a piece of rounds reads no tensor on the host: ``Tensor.item``,
  ``tolist``, ``__int__``, ``__float__``, ``__bool__`` and ``__index__``
  raise while it runs.
"""
import jax
import numpy as np
import pytest
import torch

from cglgan_tpu.algos import registry as jregistry
from cglgan_tpu.algos import runner as jrunner
from cglgan_tpu.core.config import FedGANConfig as JaxConfig
from cglgan_tpu_torch.algos import common, runner
from cglgan_tpu_torch.algos.registry import build_runner
from cglgan_tpu_torch.core import prng
from cglgan_tpu_torch.core.config import FedGANConfig
from cglgan_tpu_torch.data.partition import Partition
from cglgan_tpu_torch.fed import topology
from cglgan_tpu_torch.models import zoo
from cglgan_tpu_torch.ops import fused_dstep
from cglgan_tpu_torch.utils.transplant import to_numpy
from cglgan_tpu_torch.utils.tree import tree_leaves
from test_torch_port_cgl import (LENGTHS, NW, S, _partition,
                                 _pre_bn_mask)
from test_torch_port_threads import one_torch_thread  # noqa: F401

ROUNDS = 4

# id: (dataset, config fields).  CAP-GAN's cloud sync period scales with a
# server's data (``topology.server_data_len``): 155 rows / B=8 -> 19 at
# S=1, so ``num_communication=21`` syncs at round 2 only; CGL-GAN and
# Mix-G sync every ``cloud_epoch`` rounds of the countdown.
CASES = {
    "capgan_e1": ("synthetic-mnist", dict(algo="capgan", num_servers=2,
                                          epoch=1, num_communication=10)),
    "capgan_e2_kernel": ("synthetic-mnist", dict(
        algo="capgan", num_servers=1, epoch=2, num_communication=21)),
    "cglgan_e2_kernel": ("synthetic-mnist", dict(
        algo="cglgan", num_servers=2, epoch=2, cloud_epoch=2, segema=0.5,
        num_communication=10)),
    "mixgan_e1": ("synthetic-mnist", dict(
        algo="mixgan", num_servers=2, epoch=1, cloud_epoch=3, segema=0.25,
        num_communication=10)),
    "cglgan_2dmg_e2_kernel": ("2dmg", dict(
        algo="cglgan", num_servers=2, epoch=2, cloud_epoch=2, segema=0.5,
        num_communication=10)),
    "capgan_e2_bf16_kernel": ("synthetic-mnist", dict(
        algo="capgan", num_servers=2, epoch=2, num_communication=10,
        dtype="bfloat16", pallas_dstep=True)),
    "mixgan_e1_bf16": ("synthetic-mnist", dict(
        algo="mixgan", num_servers=2, epoch=1, cloud_epoch=2, segema=0.25,
        num_communication=10, dtype="bfloat16")),
}


def _config(case, **over):
    dataset, kw = CASES[case]
    kw = dict(dataset=dataset, num_workers=NW, iid=1, img_size=8,
              batch_size=8, E=2, **kw)
    kw.update(over)
    return kw


def _runner(case, **over):
    kw = _config(case, **over)
    _, part = _partition(kw["dataset"])
    return build_runner(FedGANConfig(**kw), part, device="cpu")


def _leaves(state):
    return runner.state_leaves(state)


def _sync_rounds(cfg, rounds):
    """The rounds whose cloud sync moves a server (the reference's
    countdown rule, ``cglgan_tpu/algos/cgl_family.py:213``)."""
    if cfg.algo == "capgan":
        data_len = topology.server_data_len(LENGTHS, cfg.num_servers)
        periods = np.maximum(1, (data_len * cfg.cloud_epoch
                                 / cfg.batch_size).astype(np.int64))
    else:
        periods = np.full(cfg.num_servers, cfg.cloud_epoch)
    return [t for t in range(rounds)
            if (((cfg.num_communication - t) % periods) == 0).any()]


# ---------------------------------------------------------------------------
# the round loop against the per-round loop, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", sorted(CASES))
def test_program_equals_per_round_loop(case):
    """``train`` through the runner's program against ``round_fn`` once a
    round from the same state: every state tensor and every round's
    metrics equal (a tick a round), and the state's counter."""
    run = _runner(case)
    cfg = run.cfg
    assert run.program is not None
    syncs = _sync_rounds(cfg, ROUNDS)
    assert 0 < len(syncs) < ROUNDS, syncs       # fires, and does not
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
        want = torch.stack([m[k] for k in keys]).float().tolist()
        assert [tick[k] for k in keys] == want


def test_scan_rounds_sets_the_piece():
    """``cfg.scan_rounds=3``: a 7-round tick runs in pieces of 3, 3 and 1
    (auto: one piece of 7), the tables filled once a piece; the state is
    the auto run's, the tick's metrics within float rounding."""
    outs, pieces = {}, {}
    for scan in (0, 3):
        run = _runner("cglgan_e2_kernel", scan_rounds=scan)
        seen = []
        fill = run.program.keys.fill
        run.program.keys.fill = lambda t, n, _f=fill, _s=seen: (
            _s.append(n), _f(t, n))[1]
        outs[scan] = runner.train(run, 7, eval_every=7, evaluator=False)
        pieces[scan] = seen
    assert pieces == {0: [7], 3: [3, 3, 1]}
    for a, b in zip(_leaves(outs[0]["state"]), _leaves(outs[3]["state"]),
                    strict=True):
        assert torch.equal(a, b)
    t0, t3 = outs[0]["history"][0], outs[3]["history"][0]
    for key in ("d_loss", "g_loss", "f_max", "f_beta", "f_gamma", "lambda"):
        assert t3[key] == pytest.approx(t0[key], rel=1e-6, abs=1e-7)
    # the reference's auto rule: about 10 000 local steps a piece
    cfg = FedGANConfig(algo="capgan", epoch=5)
    assert prng.scan_piece(cfg, 60, 5000) == 2000
    assert prng.scan_piece(cfg, 60, 500) == 500
    assert prng.scan_piece(cfg.replace(scan_rounds=7), 60, 500) == 7


# ---------------------------------------------------------------------------
# against the reference's scan_rounds
# ---------------------------------------------------------------------------

def _both_trains(case, rounds, **over):
    """The reference's ``train`` (jitted ``scan_rounds`` pieces) and the
    port's, from their own ``init_state()``; returns (port state, port
    tick, reference state as numpy, reference tick, reference pieces)."""
    kw = _config(case, **over)
    jpart, part = _partition(kw["dataset"])
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
    out = runner.train(run, rounds, rounds, evaluator=False)
    return (run, out["state"], out["history"][0],
            jax.tree.map(np.asarray, jout["state"]), jout["history"][0],
            pieces)


def test_matches_reference_scan_rounds():
    """Float32, 5 rounds from the seed on both sides (CGL-GAN on 2DMG, the
    fused local-D phase, E=2, syncs at rounds 0, 2 and 4): the reference's
    ``scan_rounds`` piece (one of 5) against the port's program, held at
    ``tests/test_torch_port_cgl.py``'s 5-round tolerances (its
    ``_close_net``)."""
    from test_torch_port_cgl import ROUNDS as CGL_ROUNDS
    from test_torch_port_cgl import TOL_METRIC, _close_net
    run, state, tick, ref, jtick, pieces = _both_trains(
        "cglgan_2dmg_e2_kernel", CGL_ROUNDS)
    assert pieces == [CGL_ROUNDS]
    for key, value in jtick.items():
        if key not in ("wall_s", "rounds_per_s", "round"):
            assert abs(tick[key] - value) < TOL_METRIC, (key, tick[key],
                                                         value)
    assert tick["round"] == jtick["round"] == CGL_ROUNDS
    got = to_numpy(state)
    assert got["t"] == int(ref.t) == CGL_ROUNDS
    spec = zoo.models_for_config(run.cfg)[0].spec
    _close_net(got["g"], ref.g, "g", tree_leaves(_pre_bn_mask(spec)))
    _close_net(got["d"], ref.d, "d",
               [False] * len(tree_leaves(got["d"]["params"])))
    np.testing.assert_allclose(got["lam"], ref.lam, rtol=0, atol=TOL_METRIC)


def test_matches_reference_scan_rounds_bf16():
    """bf16, CAP-GAN with the forced bf16-state kernel (its plain version
    here) on both sides: 3 rounds from the seed in pieces of 2 and 1
    (``scan_rounds=2`` on both sides), held at
    ``tests/test_torch_port_bf16.py``'s tolerances after a later round:
    params and BN state within 4 bf16 steps at the leaf's largest entry
    plus 3 lr an Adam step, moments within 0.15 of their group's largest
    entry, metrics and Lambda 5e-3."""
    from test_torch_port_bf16 import (LR, TOL_METRIC, TOL_MOMENT, TOL_STEPS,
                                      _groups, _spacing)
    rounds = 3
    run, state, tick, ref, jtick, pieces = _both_trains(
        "capgan_e2_bf16_kernel", rounds, scan_rounds=2)
    assert pieces == [2, 1]
    for key, value in jtick.items():
        if key not in ("wall_s", "rounds_per_s", "round"):
            assert abs(tick[key] - value) < TOL_METRIC, (key, tick[key],
                                                         value)
    got = to_numpy(state, bf16="float32")
    for net in ("g", "d"):
        jnet = getattr(ref, net)
        flatten = net == "d" and np.ndim(jnet.opt[0].count) == 2
        np.testing.assert_array_equal(
            got[net]["count"],
            np.asarray(jnet.opt[0].count).reshape(-1).astype(np.int64))
        steps = rounds * (run.cfg.epoch if net == "d" else 1)
        for name, mine, theirs in _groups(got[net], jnet, flatten):
            assert len(mine) == len(theirs)
            if name in ("params", "bn"):
                for i, (a, b) in enumerate(zip(mine, theirs)):
                    limit = TOL_STEPS[1] * _spacing(float(np.abs(b).max())) \
                        + 3 * LR * steps
                    assert float(np.abs(a - b).max()) <= limit, \
                        (net, name, i, float(np.abs(a - b).max()), limit)
            else:
                scale = max(float(np.abs(x).max()) for x in theirs)
                worst = max(float(np.abs(a - b).max())
                            for a, b in zip(mine, theirs))
                assert worst <= TOL_MOMENT[1] * scale, (net, name,
                                                        worst / scale)
    np.testing.assert_allclose(got["lam"], ref.lam, rtol=0, atol=TOL_METRIC)
    for leaf in tree_leaves((state.g.params, state.d.params)):
        assert leaf.dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# window starts on the device
# ---------------------------------------------------------------------------

def test_dstep_plain_takes_device_starts():
    """The fused local-D phase's plain version and the autograd D steps:
    starts as an int32 tensor give what host ints give (the old slicing,
    a view of the shards), bit for bit; a start out of range fails the
    run, on the device, and is not clamped."""
    rng = np.random.default_rng(5)
    W, E, B, L, din, h1, h2, dout = 3, 3, 5, 17, 12, 8, 6, 2
    shards = torch.from_numpy(rng.integers(0, 256, (W, L, din))
                              .astype(np.uint8))
    shapes = [(W, din, h1), (W, h1), (W, h1, h2), (W, h2), (W, h2, dout),
              (W, dout)]
    six = [torch.from_numpy(rng.normal(0, 0.2, s).astype(np.float32))
           for s in shapes]
    mu = [torch.zeros_like(x) for x in six]
    nu = [torch.zeros_like(x) for x in six]
    count = torch.zeros((W,), dtype=torch.int64)
    fake = torch.from_numpy(rng.normal(size=(W, B, din)).astype(np.float32))
    starts = [0, 12, 7]
    kw = dict(head="logits2", d_loss_half=True, is_image=True)
    host = fused_dstep.fused_d_epoch_steps(six, mu, nu, count, shards,
                                           starts, fake, **kw)
    dev = fused_dstep.fused_d_epoch_steps(
        six, mu, nu, count, shards, torch.tensor(starts, dtype=torch.int32),
        fake, **kw)
    for a, b in zip(tree_leaves(host), tree_leaves(dev), strict=True):
        assert torch.equal(a, b)
    with pytest.raises(RuntimeError, match="window start"):
        fused_dstep.fused_d_epoch_steps(
            six, mu, nu, count, shards,
            torch.tensor([0, L - B + 1, 0], dtype=torch.int32), fake, **kw)
    # the autograd D steps: the window a view (host int) or a gather
    assert torch.equal(common.slice_batch(shards, 7, B),
                       common.slice_batch(shards, torch.tensor(7), B))
    run = _runner("capgan_e1", num_servers=1, epoch=E)
    cfg = run.cfg
    d_model = zoo.models_for_config(cfg)[1]
    steps = common.d_epoch_steps(common.d_step_fn(
        d_model, common.make_adv_loss(cfg.resolved_d_head), cfg.lr_d,
        cfg.b1, cfg.b2, cfg.batch_size, True, d_loss_half=True), E)
    d = run.init_state().d
    img = torch.from_numpy(_partition("synthetic-mnist")[1].data)
    z = torch.from_numpy(rng.normal(size=(cfg.batch_size, 64))
                         .astype(np.float32))
    flat = lambda net, loss: tree_leaves([net.params, net.bn, net.opt.count,
                                          net.opt.mu, net.opt.nu, loss])
    a = flat(*steps(d, img, [3, 40, 0], z))
    b = flat(*steps(d, img, torch.tensor([3, 40, 0], dtype=torch.int32), z))
    for x, y in zip(a, b, strict=True):
        assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# train's state rules, the host, and which runners have a program
# ---------------------------------------------------------------------------

def test_train_keeps_callers_state_and_returns_a_copy():
    """The caller's input state is not changed (the reference's
    ``donate=False``); the returned state shares no memory with the
    program's buffers, so a later ``train`` does not change it; the state
    handed to ``on_tick`` lies on those buffers (valid during the call)."""
    run = _runner("cglgan_e2_kernel")
    state0 = run.init_state()
    before = [x.clone() for x in _leaves(state0)]
    seen = []
    out1 = runner.train(run, 2, 1, state=state0, evaluator=False,
                        on_tick=lambda t, tick, s: seen.append(s))
    for a, b in zip(_leaves(state0), before, strict=True):
        assert torch.equal(a, b)
    static = {x.data_ptr() for x in _leaves(run.program.static)}
    assert {x.data_ptr() for x in _leaves(seen[-1])} == static
    first = [x.clone() for x in _leaves(out1["state"])]
    assert not static & {x.data_ptr() for x in _leaves(out1["state"])}
    out2 = runner.train(run, 2, 2, state=out1["state"], evaluator=False)
    for a, b in zip(_leaves(out1["state"]), first, strict=True):
        assert torch.equal(a, b)
    assert out1["state"].t == 2 and out2["state"].t == 4
    assert not all(torch.equal(a, b) for a, b in zip(
        _leaves(out2["state"]), first))
    # a state of another shape is refused, not copied in part
    other = _runner("cglgan_e2_kernel", num_servers=1).init_state()
    with pytest.raises(ValueError, match="differ"):
        runner.train(run, 1, 1, state=other, evaluator=False)


HOST_READS = ("item", "tolist", "__int__", "__float__", "__bool__",
              "__index__")


@pytest.mark.parametrize("case", ["capgan_e2_kernel", "mixgan_e1",
                                  "capgan_e2_bf16_kernel"])
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


def test_which_runners_have_a_program():
    """The rule in ``algos/runner.py``: the CGL and MD-GAN families' MLP
    runners without a mesh run as a program, in float32 and bf16; conv and
    the FedAvg family keep the per-round loop."""
    assert _runner("capgan_e1").program is not None
    assert _runner("mixgan_e1_bf16").program is not None
    _, part = _partition("synthetic-mnist")
    for kw, has in ((dict(algo="mdgan"), True),
                    (dict(algo="acgan", num_servers=2), True),
                    (dict(algo="acgan", num_servers=2, dtype="bfloat16"),
                     True),
                    (dict(algo="flgan"), False), (dict(algo="fegan"), False)):
        cfg = FedGANConfig(dataset="synthetic-mnist", num_workers=NW,
                           img_size=8, batch_size=8, **kw)
        program = build_runner(cfg, part, device="cpu").program
        assert (program is not None) == has, kw
    rng = np.random.default_rng(1)
    conv_part = Partition(
        rng.integers(0, 256, (NW, 48, 1024)).astype(np.uint8),
        np.zeros((NW, 48), np.int32), LENGTHS, np.zeros((NW, 10), np.int64),
        np.zeros((10, 1024), np.uint8))
    for algo in ("capgan", "acgan"):
        conv = FedGANConfig(algo=algo, dataset="synthetic-mnist",
                            conv=True, num_workers=NW, num_servers=S,
                            batch_size=4)
        assert build_runner(conv, conv_part, device="cpu").program is None
    assert runner.captures == runner.replays == 0      # no card here

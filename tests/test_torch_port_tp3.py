"""The conv G at 3 model shards in the port, on the CPU: the column rule
splits each conv weight ``(S, O, I, 3, 3)`` on its kW axis, and
``models/tp.py`` ``conv`` gathers the weight whole before the conv.

One module-scoped job spawns 3 gloo ranks on a ``(1, 3)`` mesh and runs
``utils/dryrun.py`` ``run_cases``; beside it, in threads: the port's
unsharded runs of the same configs, the reference's jitted CAP-GAN conv
round on ``fed_mesh(3, model_shards=3)`` of the conftest's CPU devices,
and ``run capgan --conv --devices 3 --model-shards 3`` through the CLI.

* Placement: every leaf's block is the reference's ``place_model_tp``
  shard for its model index, for the ``conv`` and ``conv-multipath`` G
  families (no jit).
* Forward and gradient: the TP G against the whole G at the reference's
  limits (``tests/test_tensor_parallel.py``: output rtol 1e-5 / atol
  1e-5, gradients rtol 1e-4 / atol 1e-5).
* Rounds against the port's unsharded run, 3 from the seed, bit for bit:
  CAP-GAN conv in float32 and in bf16, Mix-G and CGL-GAN conv, and CAP-GAN
  on MNIST shapes (whose MLP G has no leaf the rule splits at 3).  The only split
  leaves are the conv weights, and each is gathered whole before its conv,
  so the TP round computes what the unsharded one does.
* One round against the reference's, CAP-GAN conv: the metrics and G
  params at ``tests/test_torch_port_tp.py``'s reference limits (metrics
  rtol 1e-5 / atol 1e-6, params rtol 1e-4 / atol 1e-6), with the G's
  BN-fed biases within 2 lr, as that file holds them (their gradient is
  exactly zero, so Adam moves each side's by up to lr on rounding noise;
  ROADMAP queue 3).  GSPMD sums the kW columns' partial convolutions
  across devices, so the reference parts from the port at rounding level.
* Collectives: a CAP-GAN conv round all-gathers the three conv weights
  over ``model`` in each of its 2 G forwards, 6 all-gathers and 1 774 080
  B in float32 (half in bf16), and nothing over ``model`` in the backward.
* The CLI: a 2-round run on 3 ranks writes whole weights to its
  checkpoint, bit for bit the unsharded run of its config.
"""
import json
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

from cglgan_tpu.algos import registry as jregistry
from cglgan_tpu.core import meshes as jmeshes
from cglgan_tpu.core.config import FedGANConfig as JaxConfig
from cglgan_tpu_torch import cli
from cglgan_tpu_torch.core import meshes
from cglgan_tpu_torch.core.config import FedGANConfig
from cglgan_tpu_torch.utils import dryrun
from test_torch_port_tp import (TOL_GRAD, TOL_METRIC, TOL_OUT, TOL_PARAMS,
                                _bn_fed, _leaves, _ModelRank,
                                _reference_state)
from test_torch_port_threads import one_torch_thread  # noqa: F401

MS = 3
ROUNDS = 3
IMG = dict(dataset="synthetic-mnist", iid=1, batch_size=8, epoch=1,
           num_communication=3, model_shards=MS)
CONV = dict(IMG, algo="capgan", conv=True, num_workers=4, num_servers=1)
# held to the port's unsharded run, bit for bit
CASES = {
    "capgan conv": CONV,
    "mixgan conv": dict(IMG, algo="mixgan", conv=True, num_workers=4,
                        num_servers=2),
    "cglgan conv": dict(IMG, algo="cglgan", conv=True, num_workers=4,
                        num_servers=2),
    "capgan conv bf16": dict(CONV, dtype="bfloat16"),
    "capgan mnist": dict(IMG, algo="capgan", num_workers=4,
                         num_servers=1)}
# held to the reference's jitted round, one round from the seed
REF = "capgan conv, 1 round"
PROBES = {"conv": dict(IMG, algo="capgan", conv=True, num_workers=2,
                       num_servers=1),
          "conv-multipath": dict(IMG, algo="mixgan", conv=True,
                                 num_workers=2, num_servers=1)}
CLI_RUN = ["run", "capgan", "--conv", "--dataset", "synthetic-mnist",
           "--num-workers", "4", "--batch-size", "8", "--rounds", "2",
           "--num-plt", "2", "--device", "cpu", "--devices", "3",
           "--model-shards", "3", "--name", "tp3"]
CLI_CFG = dict(algo="capgan", conv=True, dataset="synthetic-mnist",
               num_workers=4, batch_size=8, num_communication=2, num_plt=2,
               model_shards=MS)


def _round_cases():
    cases = [{"name": n, "cfg": c, "rounds": ROUNDS}
             for n, c in CASES.items()]
    return cases + [{"name": REF, "cfg": CONV, "rounds": 1}]


def _reference_round():
    """The reference's jitted CAP-GAN conv round on ``fed_mesh(3,
    model_shards=3)`` from its seed, compiled at XLA's backend optimization
    level 0 (the same HLO, sooner): (metrics, state)."""
    jmesh = jmeshes.fed_mesh(3, model_shards=MS, devices=jax.devices()[:3])
    assert dict(jmesh.shape) == {"clients": 1, "model": MS}
    jrun = jregistry.build_runner(JaxConfig(**CONV), mesh=jmesh)
    jstate = jrun.init_state()
    round_fn = jax.jit(jrun.round_fn).lower(jstate).compile(
        {"xla_backend_optimization_level": 0})
    jstate, m = round_fn(jstate)
    return {k: float(v) for k, v in m.items()}, jstate


def _cli_run(root):
    assert cli.main(CLI_RUN + ["--out", str(root)]) == 0
    return root / "tp3"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"tp": rank 0's results of every case and probe on the (1, 3) mesh,
    "unsharded": the port's unsharded runs, "reference": the reference's
    round, "cli": the CLI's run dir}, made at once."""
    cases = _round_cases() + [{"name": f"probe {name}", "probe": True,
                               "cfg": cfg} for name, cfg in PROBES.items()]
    unsharded = _round_cases() + [{"name": "cli", "cfg": CLI_CFG,
                                   "rounds": 2}]
    # each job waited on by a thread of its own (XLA compiles, and the
    # ranks run, outside the interpreter's lock)
    with ThreadPoolExecutor(3) as pool:
        tp = pool.submit(meshes.spawn, dryrun.run_cases, 3, "cpu", cases,
                         model_shards=MS)
        run_dir = pool.submit(_cli_run, tmp_path_factory.mktemp("cli"))
        reference = pool.submit(_reference_round)
        whole = dryrun.run_cases(None, unsharded, "cpu")
        return {"tp": tp.result()[0], "unsharded": whole,
                "reference": reference.result(), "cli": run_dir.result()}


def _bit_equal(got, want, label):
    pairs = list(zip(_leaves(got), _leaves(want)))
    assert pairs and len(pairs) == len(list(_leaves(want))), label
    for (path, a), (rpath, b) in pairs:
        assert path == rpath, (label, path, rpath)
        np.testing.assert_array_equal(a, b, err_msg=f"{label} {path}")


# ---------------------------------------------------------------------------
# placement: the reference's shards
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", list(PROBES))
def test_blocks_are_the_reference_shards_at_3(family):
    """A stacked conv G (2 servers, 2 heads; the port's, drawn from a
    seed) placed by the reference's ``place_model_tp(lead=1)`` on
    ``fed_mesh(3, model_shards=3)``: each leaf's shard on model index m is
    the port's block for model rank m, the port's spec is the reference's,
    and the split leaves are the conv weights alone, on kW."""
    from cglgan_tpu_torch.core import threefry
    from cglgan_tpu_torch.models.zoo import build_generator
    jmesh = jmeshes.fed_mesh(3, model_shards=MS, devices=jax.devices()[:3])
    g = build_generator(family, num_heads=2, img_shape=(1, 28, 28))
    port = g.init(threefry.split(threefry.key(3), 2))
    whole = jax.tree.map(lambda x: jax.numpy.asarray(x.numpy()), port)
    placed = jmeshes.place_model_tp(whole, jmesh, lead=1)
    split = set()
    for m in range(MS):
        mine = jax.tree.leaves(meshes.place_model_tp(port, _ModelRank(m, MS),
                                                     lead=1))
        dev = jmesh.devices[0, m]
        for x, ref, got in zip(jax.tree.leaves(whole),
                               jax.tree.leaves(placed), mine):
            shard = next(s for s in ref.addressable_shards
                         if s.device == dev)
            np.testing.assert_array_equal(got.numpy(), np.asarray(shard.data))
            spec = jmeshes.model_tp_spec(x, jmesh, lead=1)
            assert meshes.model_tp_spec(x.shape, MS, lead=1) == tuple(spec)
            if spec != jax.sharding.PartitionSpec():
                split.add(x.shape)
                assert got.shape == x.shape[:-1] + (1,)
    want = {(2, 128, 128, 3, 3), (2, 64, 128, 3, 3)} | (
        {(2, 1, 64, 3, 3)} if family == "conv" else {(2, 2, 1, 64, 3, 3)})
    assert split == want


# ---------------------------------------------------------------------------
# the G forward and gradient
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", list(PROBES))
def test_tp3_forward_and_gradient_match_the_whole_g(runs, family):
    """The conv G with its weights split on kW over 3 ranks against the
    whole G on the same rank: output and new BN state within rtol 1e-5 /
    atol 1e-5, every gradient (gathered) within rtol 1e-4 / atol 1e-5."""
    got = runs["tp"][f"probe {family}"]
    for key, tol in (("out", TOL_OUT), ("bn", TOL_OUT), ("grads", TOL_GRAD)):
        pairs = list(zip(_leaves(got[key]), _leaves(got[f"whole_{key}"])))
        assert pairs
        for (path, a), (rpath, b) in pairs:
            assert path == rpath and a.shape == b.shape, (family, key, path)
            np.testing.assert_allclose(a, b, rtol=tol[0], atol=tol[1],
                                       err_msg=f"{family} {key} {path}")


# ---------------------------------------------------------------------------
# rounds against the port's unsharded run
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(CASES))
def test_tp3_round_is_the_unsharded_round(runs, name):
    """3 rounds from the seed on the (1, 3) mesh against the same config
    unsharded: the metrics and every leaf of the state (the G's blocks
    gathered on rank 0) bit for bit; the runner's TP init is the unsharded
    init placed, and placing and gathering it gives it back."""
    got, want = runs["tp"][name], runs["unsharded"][name]
    assert got["t"] == want["t"] == ROUNDS
    assert got["metrics"] == want["metrics"], name
    _bit_equal(got["state"], want["state"], name)
    assert got["placed_init"] and got["round_trip"], name


# ---------------------------------------------------------------------------
# one round against the reference's
# ---------------------------------------------------------------------------

def test_tp3_round_matches_the_reference_round(runs):
    """CAP-GAN conv on the (1, 3) gloo mesh against the reference's jitted
    round on ``fed_mesh(3, model_shards=3)``, one round from the seed: the
    metrics and every G leaf at the reference limits, the G's BN-fed
    biases within 2 lr; the round counter and Adam counts equal."""
    jmetrics, jstate = runs["reference"]
    got, ref = runs["tp"][REF], _reference_state(jstate)
    assert set(got["metrics"][0]) == set(jmetrics)
    for k, v in jmetrics.items():
        np.testing.assert_allclose(got["metrics"][0][k], v,
                                   rtol=TOL_METRIC[0], atol=TOL_METRIC[1],
                                   err_msg=k)
    assert got["state"]["t"] == ref["t"] == 1
    for net in ("g", "d"):
        np.testing.assert_array_equal(got["state"][net]["opt"]["count"],
                                      ref[net]["opt"]["count"])
    fed, lr = _bn_fed(CONV), FedGANConfig(**CONV).lr_g
    pairs = list(zip(_leaves(got["state"]["g"]["params"]),
                     _leaves(ref["g"]["params"])))
    assert len(pairs) == 12
    for (path, a), (rpath, b) in pairs:
        assert path == rpath and a.shape == b.shape, path
        if f".g.params{path}" in fed:
            assert np.abs(a - b).max() <= 2 * lr, path
        else:
            np.testing.assert_allclose(a, b, rtol=TOL_PARAMS[0],
                                       atol=TOL_PARAMS[1], err_msg=path)


# ---------------------------------------------------------------------------
# the collectives of a round
# ---------------------------------------------------------------------------

def test_tp3_conv_round_collectives_are_the_predicted(runs):
    """CAP-GAN conv (S=1, B=8, k=4 on one clients rank), a round: the
    three conv weights all-gathered whole over ``model`` in each of the
    2 G forwards (128x128x3x3, 64x128x3x3, 1x64x3x3: 887 040 B a forward
    in float32), the clients' gather of the losses and all-reduce of the
    output's cotangent, and no collective over ``model`` in the backward;
    in bf16 the same with half the bytes."""
    S, B, k = 1, 8, 4
    for name, size in (("capgan conv", 4), ("capgan conv bf16", 2)):
        weights = [("all_gather", "model", [size * S * o * i * 9])
                   for o, i in ((128, 128), (64, 128), (1, 64))]
        want = weights + weights + [
            ("all_gather", "clients", [4 * 2 * S * k]),
            ("all_reduce", "clients", [size * S * B * 32 * 32])]
        logs = runs["tp"][name]["collectives"]
        assert len(logs) == ROUNDS
        for log in logs:
            assert log == want, name
            model = [sum(b) for kind, axis, b in log if axis == "model"]
            assert len(model) == 6
            assert sum(model) == 1774080 * size // 4


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def test_cli_tp3_conv_run_writes_whole_weights(runs):
    """``run capgan --conv --devices 3 --model-shards 3 --device cpu``: 2
    rounds, one run dir, and its final checkpoint holds the whole G,
    bit for bit the unsharded run of the same config."""
    run_dir = runs["cli"]
    with open(run_dir / "config.json") as f:
        saved = json.load(f)
    assert {k: saved[k] for k in CLI_CFG} == CLI_CFG
    state = torch.load(run_dir / "ckpt_final", weights_only=True)
    assert state["t"] == 2
    assert state["g"]["params"]["c1"]["w"].shape == (1, 128, 128, 3, 3)
    assert state["g"]["params"]["c3"]["w"].shape == (1, 1, 64, 3, 3)
    _bit_equal(state, runs["unsharded"]["cli"]["state"], "cli")
    assert (run_dir / "2.png").exists()


# ---------------------------------------------------------------------------
# the all-reduce bucket
# ---------------------------------------------------------------------------

def test_all_reduce_bucket_keeps_each_tensor_layout():
    """A Mix-G's output cotangent is a permuted view; the bucket that
    ``all_reduce`` sums gives each tensor back with its strides, so the G's
    backward sums its head biases' gradients in the order it does without
    a mesh (contiguous, one 1-rank Mix-G conv mesh round parted from the
    unsharded one in those biases' Adam moments).  A tensor that is not
    dense comes back contiguous, with its values."""
    base = torch.arange(2 * 3 * 4 * 5, dtype=torch.float32)
    tensors = [base.reshape(4, 2, 3, 5).permute(1, 2, 0, 3),   # dense view
               base[:24].reshape(2, 12),                       # contiguous
               base.reshape(10, 12)[:, ::2],                   # not dense
               torch.ones(3, dtype=torch.float64)]
    plan = meshes._pack(tensors)
    back = meshes._unpack({dt: buf for dt, (buf, _) in plan.items()}, plan,
                          len(tensors))
    for t, b in zip(tensors, back):
        assert b.dtype == t.dtype and torch.equal(b, t)
    assert back[0].stride() == tensors[0].stride()
    assert back[1].stride() == tensors[1].stride()
    assert back[2].is_contiguous()

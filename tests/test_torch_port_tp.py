"""Tensor parallelism over a ``model`` mesh axis (``model_shards > 1``) in
the port, on the CPU: ``core/meshes.py``'s ``(clients, model)`` mesh and
``place_model_tp``, ``models/tp.py``'s column-parallel G forward, and the
CGL family's TP round, against the reference and against the port's own
unsharded run.

One module-scoped job spawns 4 gloo ranks on a ``(2, 2)`` mesh (rank r at
clients r // 2, model r % 2) and runs ``utils/dryrun.py`` ``run_cases`` (a
function of the port: the ranks import neither JAX nor this module): the
rounds below (one case on a ``(1, 4)`` mesh of the same ranks) and
``g_probe`` of every G family.  Beside it, in threads: the port's
unsharded runs of the same configs, and ``run capgan --devices 2
--model-shards 2`` through the CLI, cut at ``ckpt_2`` and resumed.

* Placement: every leaf's block is the reference's ``place_model_tp``
  shard for its model index (``NamedSharding`` on the conftest's 8-device
  CPU mesh), for the six G families.
* Forward and gradient: the TP G against the whole G, the reference's
  limits (``tests/test_tensor_parallel.py``: output rtol 1e-5 / atol 1e-5,
  gradients rtol 1e-4 / atol 1e-5).
* Rounds against the reference's jitted round on ``fed_mesh(4,
  model_shards=2)``: CGL-GAN 2DMG (``test_tensor_parallel.py``'s config)
  and the dryrun's "capgan dp x tp", one round from the seed on both
  sides, held as the reference's own TP test holds its round: metrics rtol
  1e-5 / atol 1e-6, G params rtol 1e-4 / atol 1e-6.  (The D is not split;
  its params are held to the unsharded run below.  Against the reference,
  one in 262 144 entries of the dryrun config's D parted by 2e-6 after
  one round, measured: an Adam first step on a near-zero gradient, whose
  size the G's summation order moves.)
* Rounds against the port's unsharded run, 3 from the seed: CAP-GAN on
  MNIST shapes, Mix-G 2DMG, CAP-GAN conv float32 and CAP-GAN 2DMG bf16 on
  ``(1, 4)`` at ``test_torch_port_mesh.py``'s sharded-round limits (the
  G's biases that feed a BatchNorm, and that BatchNorm's running mean,
  have an exactly-zero gradient, so Adam moves each side's by up to lr a
  round on rounding noise alone: 2 lr a round apart, as ``chip_smoke.py``'s
  mesh phase, ROADMAP queue 3); CGL-GAN MNIST bf16 on ``(2, 2)`` at the
  port's bf16 round limits (``test_torch_port_bf16.py``), because a bf16
  product of a block and a bf16 batched product of a clients block both
  round where the unsharded ones do not (a bf16 clients mesh alone parts
  from the unsharded run so, measured), while the bf16 ``(1, 4)`` case,
  with no clients axis and no split product after the first, is the
  unsharded run bit for bit.
* Collectives: a CAP-GAN MNIST round's recorder log, by kind, axis and
  bytes, is the one predicted.
* Checkpoints: ``gather_state(place_state(x)) == x`` in the TP layout, and
  the runner's own TP init is the unsharded init placed.
"""
import os
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

from cglgan_tpu.algos import registry as jregistry
from cglgan_tpu.core import meshes as jmeshes
from cglgan_tpu.core.config import FedGANConfig as JaxConfig
from cglgan_tpu_torch import cli
from cglgan_tpu_torch.algos.registry import build_runner, load_partition
from cglgan_tpu_torch.core import meshes
from cglgan_tpu_torch.core.config import FedGANConfig
from cglgan_tpu_torch.utils import dryrun
from cglgan_tpu_torch.utils.checkpoint import restore_checkpoint
from test_torch_port_threads import one_torch_thread  # noqa: F401

TOL_METRIC = (1e-5, 1e-6)
TOL_PARAMS = (1e-4, 1e-6)
TOL_MOMENT = 1e-4
TOL_OUT = (1e-5, 1e-5)
TOL_GRAD = (1e-4, 1e-5)
# the port's bf16 round limits (tests/test_torch_port_bf16.py): N bf16
# steps at a leaf's largest entry plus 3 lr an Adam step, moments within a
# share of their group's largest entry, metrics absolute
TOL_BF16_STEPS = 4
TOL_BF16_MOMENT = 0.25
TOL_BF16_METRIC = 5e-3
ROUNDS = 3
REF_ROUNDS = 1

TWO_D = dict(dataset="2dmg", num_class=4, num_sample=64, batch_size=16,
             iid=1, num_communication=2)
IMG = dict(dataset="synthetic-mnist", iid=1, batch_size=8, epoch=1,
           num_communication=3)
# held to the reference's jitted round on fed_mesh(4, model_shards=2)
REF_CASES = {
    "cglgan": dict(TWO_D, algo="cglgan", num_workers=8, num_servers=2),
    "capgan dp x tp": dict(TWO_D, algo="capgan", num_workers=8,
                           num_servers=1, epoch=1)}
# held to the port's unsharded run
PORT_CASES = {
    "capgan mnist": dict(IMG, algo="capgan", num_workers=4, num_servers=1),
    "mixgan 2dmg": dict(TWO_D, algo="mixgan", num_workers=8, num_servers=2,
                        num_communication=3),
    "capgan conv": dict(IMG, algo="capgan", conv=True, num_workers=4,
                        num_servers=1),
    "capgan 2dmg bf16 (1, 4)": dict(TWO_D, algo="capgan", num_workers=8,
                                    num_servers=1, num_communication=3,
                                    dtype="bfloat16", force_dtype=True,
                                    model_shards=4)}
BF16_CASES = {
    "cglgan mnist bf16": dict(IMG, algo="cglgan", num_workers=4,
                              num_servers=2, dtype="bfloat16", segema=0.5)}
# one config a G family: its generator's forward and gradient
PROBES = {
    "2dmg-small": dict(TWO_D, algo="capgan", num_workers=4, num_servers=2),
    "2dmg-multipath": dict(TWO_D, algo="cglgan", num_workers=4,
                           num_servers=2),
    "mnist-mlp": dict(IMG, algo="capgan", num_workers=4, num_servers=2),
    "mnist-multipath": dict(IMG, algo="cglgan", num_workers=4,
                            num_servers=2),
    "conv": dict(IMG, algo="capgan", conv=True, num_workers=2,
                 num_servers=1),
    "conv-multipath": dict(IMG, algo="mixgan", conv=True, num_workers=2,
                           num_servers=1)}
CLI_RUN = ["run", "capgan", "--dataset", "2dmg", "--num-workers", "4",
           "--num-servers", "2", "--num-class", "4", "--num-sample", "100",
           "--batch-size", "16", "--epoch", "2", "--lr-g", "0.01",
           "--lr-d", "0.01", "--rounds", "4", "--num-plt", "2",
           "--ckpt-every", "2", "--device", "cpu", "--devices", "2",
           "--model-shards", "2"]


def _tp(cfg):
    return {"model_shards": 2, **cfg}


def _round_cases():
    table = {**REF_CASES, **PORT_CASES, **BF16_CASES}
    return [{"name": name, "cfg": _tp(cfg),
             "rounds": REF_ROUNDS if name in REF_CASES else ROUNDS}
            for name, cfg in table.items()]


def _cli_runs(root):
    """The CLI run cut at ``ckpt_2`` and resumed, on 2 gloo ranks."""
    argv = CLI_RUN + ["--out", str(root)]
    assert cli.main(argv + ["--name", "tp"]) == 0
    assert cli.main(argv + ["--name", "resumed", "--resume",
                            str(root / "tp" / "ckpt_2")]) == 0
    return root


def _reference_run(name):
    """The reference's jitted TP round on ``fed_mesh(4, model_shards=2)``
    of the conftest's CPU devices from its seed: (per-round metrics, the
    state)."""
    jmesh = jmeshes.fed_mesh(4, model_shards=2, devices=jax.devices()[:4])
    assert dict(jmesh.shape) == {"clients": 2, "model": 2}
    jrun = jregistry.build_runner(JaxConfig(**_tp(REF_CASES[name])),
                                  mesh=jmesh)
    jstate = jrun.init_state()
    # compiled at XLA's backend optimization level 0: the same HLO, sooner
    round_fn = jax.jit(jrun.round_fn).lower(jstate).compile(
        {"xla_backend_optimization_level": 0})
    jmetrics = []
    for _ in range(REF_ROUNDS):
        jstate, m = round_fn(jstate)
        jmetrics.append({k: float(v) for k, v in m.items()})
    return jmetrics, jstate


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"tp": rank 0's results of every case and probe on the (2, 2)
    mesh, "unsharded": the port's unsharded runs, "reference": the
    reference's TP rounds, "cli": the CLI's run root}, made at once."""
    cases = _round_cases() + [{"name": f"probe {name}", "probe": True,
                               "cfg": _tp(cfg)}
                              for name, cfg in PROBES.items()]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        # each job waited on by a thread of its own (XLA compiles, and the
        # ranks run, outside the interpreter's lock)
        with ThreadPoolExecutor(4) as pool:
            tp = pool.submit(meshes.spawn, dryrun.run_cases, 4, "cpu",
                             cases, model_shards=2)
            root = pool.submit(_cli_runs, tmp_path_factory.mktemp("cli"))
            reference = {name: pool.submit(_reference_run, name)
                         for name in REF_CASES}
            unsharded = dryrun.run_cases(None, _round_cases(), "cpu")
            return {"tp": tp.result()[0], "unsharded": unsharded,
                    "reference": {k: v.result()
                                  for k, v in reference.items()},
                    "cli": root.result()}
    finally:
        torch.set_num_threads(threads)


def _leaves(tree, path=""):
    """(path, array) of every tensor of a plain state, dict keys sorted."""
    if isinstance(tree, torch.Tensor):
        yield path, tree.float().numpy()
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}.{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")


def _bn_fed(cfg):
    """The plain-state paths of the G's biases that feed a BatchNorm, and
    of that BatchNorm's running mean (a single-path G)."""
    from cglgan_tpu_torch.models.zoo import models_for_config
    g_model = models_for_config(FedGANConfig(**cfg))[0]
    if g_model.multipath:
        return set()
    if g_model.spec == "conv":
        return {".g.params.c1.b", ".g.params.c2.b", ".g.bn.bn1.mean",
                ".g.bn.bn2.mean"}
    spec = g_model.spec
    return {p for i, entry in enumerate(spec[:-1])
            if entry[0] == "linear" and spec[i + 1][0] == "bn"
            for p in (f".g.params[{i}].b", f".g.bn[{i + 1}].mean")}


def _close_metrics(got, ref, label):
    assert len(got) == len(ref)
    for m, r in zip(got, ref):
        assert set(m) == set(r), label
        for k in r:
            np.testing.assert_allclose(m[k], r[k], rtol=TOL_METRIC[0],
                                       atol=TOL_METRIC[1],
                                       err_msg=f"{label} {k}")


def _moment_scales(pairs):
    scale = {}
    for _, (path, b) in pairs:
        for moment in (".mu", ".nu"):
            if moment in path:
                group = path.split(moment)[0] + moment
                scale[group] = max(scale.get(group, 0.0),
                                   float(np.abs(b).max()) if b.size else 0)
    return scale


def _close_states(got, ref, rounds, label, fed=(), lr=0.0):
    """Params and BN buffers elementwise (the BN-fed paths ``fed`` within
    2 lr a round), moments against their group's scale, counts and the
    round counter exactly."""
    assert got["t"] == ref["t"] == rounds
    pairs = list(zip(_leaves(got), _leaves(ref)))
    scale = _moment_scales(pairs)
    for (path, a), (rpath, b) in pairs:
        assert path == rpath and a.shape == b.shape, (label, path)
        moment = next((m for m in (".mu", ".nu") if m in path), None)
        if ".count" in path:
            np.testing.assert_array_equal(a, b, err_msg=f"{label} {path}")
        elif moment:
            group = path.split(moment)[0] + moment
            assert np.abs(a - b).max(initial=0) <= \
                TOL_MOMENT * scale[group], (label, path)
        elif path in fed:
            assert np.abs(a - b).max() <= 2 * lr * rounds, (label, path)
        else:
            np.testing.assert_allclose(a, b, rtol=TOL_PARAMS[0],
                                       atol=TOL_PARAMS[1],
                                       err_msg=f"{label} {path}")


# ---------------------------------------------------------------------------
# placement: the reference's shards
# ---------------------------------------------------------------------------

class _ModelRank:
    """A mesh's model axis without a process group: what
    ``place_model_tp`` reads."""

    def __init__(self, rank, size):
        self.tp = meshes.ModelAxis(None, None, rank, size)


@pytest.mark.parametrize("family", list(PROBES))
def test_blocks_are_the_reference_shards(family):
    """A stacked G of the family (2 servers, 2 heads; the port's, drawn
    from a seed) placed by the reference's ``place_model_tp(lead=1)`` on
    ``fed_mesh(8, model_shards=2)``: each leaf's shard on the devices of
    model index m is the port's block for model rank m, and the port's
    spec is the reference's."""
    from cglgan_tpu_torch.core import threefry
    from cglgan_tpu_torch.models.zoo import build_generator
    jmesh = jmeshes.fed_mesh(8, model_shards=2)
    g = build_generator(family, num_heads=2, img_shape=(1, 28, 28))
    port = g.init(threefry.split(threefry.key(3), 2))
    whole = jax.tree.map(lambda x: jax.numpy.asarray(x.numpy()), port)
    placed = jmeshes.place_model_tp(whole, jmesh, lead=1)
    n_split = 0
    for m in range(2):
        mine = jax.tree.leaves(meshes.place_model_tp(port, _ModelRank(m, 2),
                                                     lead=1))
        dev = jmesh.devices[0, m]
        for x, ref, got in zip(jax.tree.leaves(whole),
                               jax.tree.leaves(placed), mine):
            shard = next(s for s in ref.addressable_shards
                         if s.device == dev)
            np.testing.assert_array_equal(got.numpy(), np.asarray(shard.data))
            spec = jmeshes.model_tp_spec(x, jmesh, lead=1)
            assert meshes.model_tp_spec(x.shape, 2, lead=1) == tuple(spec)
            n_split += spec != jax.sharding.PartitionSpec()
    assert n_split > 0


# ---------------------------------------------------------------------------
# the G forward and gradient
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", list(PROBES))
def test_tp_forward_and_gradient_match_the_whole_g(runs, family):
    """The column-parallel G on the (2, 2) mesh against the whole G on the
    same rank: output and new BN state within rtol 1e-5 / atol 1e-5, every
    gradient (gathered) within rtol 1e-4 / atol 1e-5."""
    got = runs["tp"][f"probe {family}"]
    for key, tol in (("out", TOL_OUT), ("bn", TOL_OUT), ("grads", TOL_GRAD)):
        pairs = list(zip(_leaves(got[key]), _leaves(got[f"whole_{key}"])))
        assert pairs or key == "bn"                 # 2DMG Gs have no BN
        for (path, a), (rpath, b) in pairs:
            assert path == rpath and a.shape == b.shape, (family, key, path)
            np.testing.assert_allclose(a, b, rtol=tol[0], atol=tol[1],
                                       err_msg=f"{family} {key} {path}")


# ---------------------------------------------------------------------------
# rounds against the reference's jitted TP round
# ---------------------------------------------------------------------------

def _reference_state(jstate):
    """The reference's state in the port's checkpoint layout."""
    np_ = lambda x: torch.from_numpy(np.array(x))

    def net(n, flat):
        f = (lambda x: np_(x).reshape((-1,) + np.shape(x)[2:])) if flat \
            else np_
        adam = n.opt[0]
        tmap = lambda tree: jax.tree.map(f, tree)
        return {"bn": tmap(n.bn), "opt": {"count": f(adam.count),
                                          "mu": tmap(adam.mu),
                                          "nu": tmap(adam.nu)},
                "params": tmap(n.params)}
    return {"d": net(jstate.d, True), "g": net(jstate.g, False),
            "lam": np_(jstate.lam), "t": int(jstate.t)}


@pytest.mark.parametrize("name", list(REF_CASES))
def test_tp_round_matches_the_reference_tp_round(runs, name):
    """The port on the (2, 2) gloo mesh against the reference's jitted
    round on ``fed_mesh(4, model_shards=2)`` of the conftest's CPU
    devices, one round from the seed on both sides, as the reference's own
    test runs it: the metrics and every G leaf (the blocks gathered on
    rank 0) at its limits; the round counters and Adam counts equal."""
    jmetrics, jstate = runs["reference"][name]
    got, ref = runs["tp"][name], _reference_state(jstate)
    _close_metrics(got["metrics"], jmetrics, name)
    assert got["state"]["t"] == ref["t"] == REF_ROUNDS
    for net in ("g", "d"):
        np.testing.assert_array_equal(got["state"][net]["opt"]["count"],
                                      ref[net]["opt"]["count"])
    pairs = list(zip(_leaves(got["state"]["g"]["params"]),
                     _leaves(ref["g"]["params"])))
    assert pairs
    for (path, a), (rpath, b) in pairs:
        assert path == rpath and a.shape == b.shape, (name, path)
        np.testing.assert_allclose(a, b, rtol=TOL_PARAMS[0],
                                   atol=TOL_PARAMS[1],
                                   err_msg=f"{name} {path}")


# ---------------------------------------------------------------------------
# rounds against the port's unsharded run
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(PORT_CASES))
def test_tp_round_matches_the_unsharded_run(runs, name):
    """3 rounds from the seed on the (2, 2) mesh (the bf16 case on (1, 4))
    against the same config unsharded; the sharded-round limits."""
    got, ref = runs["tp"][name], runs["unsharded"][name]
    cfg = _tp(PORT_CASES[name])
    _close_metrics(got["metrics"], ref["metrics"], name)
    _close_states(got["state"], ref["state"], ROUNDS, name, _bn_fed(cfg),
                  FedGANConfig(**cfg).lr_g)
    if name.endswith("(1, 4)"):
        assert got["metrics"] == ref["metrics"]
        for (path, a), (_, b) in zip(_leaves(got["state"]),
                                     _leaves(ref["state"])):
            np.testing.assert_array_equal(a, b, err_msg=path)


def _bf16_spacing(x: float) -> float:
    return 2.0 ** (np.floor(np.log2(max(abs(x), 2.0 ** -126))) - 7)


@pytest.mark.parametrize("name", list(BF16_CASES))
def test_bf16_tp_round_within_bf16_limits(runs, name):
    """CGL-GAN MNIST in bf16 on the (2, 2) mesh against its unsharded run,
    3 rounds, at the port's bf16 round limits; the state stays bf16."""
    got, ref = runs["tp"][name], runs["unsharded"][name]
    lr = FedGANConfig(**_tp(BF16_CASES[name])).lr_g
    for m, r in zip(got["metrics"], ref["metrics"]):
        for k in r:
            assert abs(m[k] - r[k]) < TOL_BF16_METRIC, (name, k)
    pairs = list(zip(_leaves(got["state"]), _leaves(ref["state"])))
    scale = _moment_scales(pairs)
    for (path, a), (_, b) in pairs:
        if ".count" in path:
            np.testing.assert_array_equal(a, b)
            continue
        moment = next((m for m in (".mu", ".nu") if m in path), None)
        if moment:
            group = path.split(moment)[0] + moment
            assert np.abs(a - b).max() <= TOL_BF16_MOMENT * scale[group], \
                (name, path)
        elif path != ".lam":
            limit = TOL_BF16_STEPS * _bf16_spacing(float(np.abs(b).max())) \
                + 3 * lr * ROUNDS
            assert np.abs(a - b).max() <= limit, (name, path)
    assert all(x.dtype == torch.bfloat16
               for x in jax.tree.leaves(got["state"]["g"]["params"]))


def test_placement_round_trip_and_init(runs):
    """On every TP case: the runner's own TP ``init_state()`` is the
    unsharded init placed by its layout, and ``gather_state`` of that
    placement is the unsharded init, bit for bit."""
    for name in [c["name"] for c in _round_cases()]:
        got = runs["tp"][name]
        assert got["placed_init"] and got["round_trip"], name


# ---------------------------------------------------------------------------
# the collectives of a round
# ---------------------------------------------------------------------------

def test_capgan_round_collectives_are_the_predicted(runs):
    """CAP-GAN on MNIST shapes (S=1, B=8, k=4 over 2 clients ranks), a
    round: the G's 5 activation all-gathers over ``model`` in each of its 2
    forwards (100-128-256-512-1024-784), the clients' gather of the losses
    and all-reduce of the output's cotangent, then the backward's 4
    all-reduces over ``model`` of the split linears' inputs."""
    S, B, k_loc, widths = 1, 8, 2, (128, 256, 512, 1024, 784)
    f32 = lambda *dims: [4 * int(np.prod(dims))]
    forward = [("all_gather", "model", f32(S, B, w)) for w in widths]
    want = forward + forward + [
        ("all_gather", "clients", f32(2, S * k_loc, 2)),
        ("all_reduce", "clients", f32(S, B, 784))] + [
        ("all_reduce", "model", f32(S, B, w)) for w in (1024, 512, 256, 128)]
    for log in runs["tp"]["capgan mnist"]["collectives"]:
        assert log == want


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def test_cli_tp_run_resumes_bit_exact(runs):
    """``run capgan --device cpu --devices 2 --model-shards 2`` on 2DMG:
    one run dir (rank 0's); its checkpoints hold the whole G, so ``ckpt_2``
    restores into an unsharded runner; the run cut at ``ckpt_2`` and
    resumed on the same mesh ends bit for bit where the uninterrupted run
    ends."""
    root = runs["cli"]
    assert sorted(os.listdir(root)) == ["resumed", "tp"]
    load = lambda name, ckpt: torch.load(root / name / ckpt,
                                         weights_only=True)
    whole, resumed = load("tp", "ckpt_final"), load("resumed", "ckpt_final")
    assert whole["t"] == resumed["t"] == 4
    pairs = list(zip(_leaves(whole), _leaves(resumed)))
    assert pairs and all(np.array_equal(a, b) for (_, a), (_, b) in pairs)
    cfg = FedGANConfig(algo="capgan", dataset="2dmg", num_workers=4,
                       num_servers=2, num_class=4, num_sample=100,
                       batch_size=16, epoch=2, lr_g=0.01, lr_d=0.01,
                       num_communication=4, num_plt=2)
    runner = build_runner(cfg, load_partition(cfg), device="cpu")
    state = restore_checkpoint(str(root / "tp" / "ckpt_2"),
                               runner.init_state())
    assert state.t == 2 and state.g.params[0]["w"].shape == (2, 100, 32)
    assert (root / "tp" / "4.png").exists()

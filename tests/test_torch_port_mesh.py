"""The clients mesh (``cglgan_tpu_torch/core/meshes.py``) on the CPU: the
port sharded over gloo ranks against the reference's jitted mesh round
and against the port's own unsharded run.

One module-scoped job spawns the ranks once a world size (1, 2 and 4; the
world-2 job is ``utils/dryrun.py`` ``dryrun_multichip(2)`` with this
file's cases beside the dryrun's) and returns every case's whole state
(rank 0 gathers it), per-round metrics and per-round collectives to this
process.  The ranks run ``dryrun.run_cases``, a function of the port, so
they import neither JAX nor this module.

* CAP-GAN 2DMG (W=4, S=1) and MD-GAN with the ring D-swap every round
  (W=4) over 2 ranks against the reference's jitted round on a 2-device
  ``Mesh(..., ("clients",))`` of the 8-device CPU mesh, 2 rounds from the
  seed on both sides.
* CGL-GAN (S=2, E=1, ``cloud_epoch=1``), Mix-G, AC-GAN with the delta
  gossip, FL-GAN with the ragged "epochs" sweep and FeGAN at
  ``frac_workers=0.5`` (W=8) over 2 and 4 ranks against the port's
  unsharded run, which the other port files hold to the reference.
* At world 1 every case is the unsharded run bit for bit.
* The recorder's log a round mirrors ``tests/test_hlo_comm.py``.

Tolerances: the reference's own for its sharded rounds
(``tests/test_tensor_parallel.py:62-68``): metrics rtol 1e-5 / atol 1e-6,
params rtol 1e-4 / atol 1e-6 (the 2DMG Gs here have no BatchNorm, so no
bias with the exactly-zero gradient of ROADMAP queue 3's BN-fed biases);
Adam moments within 1e-4 of their group's largest entry, as the round
tests (``test_torch_port_mdgan.py``).  The sharded sums (the G's output
cotangent, FedAvg, the group means) add the ranks' partials in another
order than the unsharded sums, so the two part by float32 rounding.
"""
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from cglgan_tpu.algos import registry as jregistry
from cglgan_tpu.core.config import FedGANConfig as JaxConfig
from cglgan_tpu_torch.algos import common
from cglgan_tpu_torch.algos.registry import build_runner, load_partition
from cglgan_tpu_torch.core import meshes
from cglgan_tpu_torch.core.config import FedGANConfig
from cglgan_tpu_torch.utils import dryrun
from test_torch_port_threads import one_torch_thread  # noqa: F401

TOL_METRIC = (1e-5, 1e-6)
TOL_PARAMS = (1e-4, 1e-6)
TOL_MOMENT = 1e-4
ROUNDS = 3
REF_ROUNDS = 2

BASE = dict(dataset="2dmg", num_class=4, num_sample=64, batch_size=16,
            iid=1, num_communication=3, epoch=1)
# held to the reference's jitted mesh round over 2 ranks
REF_CASES = {
    "capgan": dict(algo="capgan", num_workers=4, num_servers=1),
    "mdgan ring": dict(algo="mdgan", num_workers=4, num_servers=1, E=1)}
# held to the port's unsharded run over 2 and 4 ranks
PORT_CASES = {
    "cglgan": dict(algo="cglgan", num_servers=2, E=1, cloud_epoch=1),
    "mixgan": dict(algo="mixgan", num_servers=2, cloud_epoch=1),
    "acgan delta": dict(algo="acgan", num_servers=2, E=1, gossip="delta"),
    "flgan ragged": dict(algo="flgan", num_servers=1,
                         local_sweep="epochs"),
    "fegan": dict(algo="fegan", num_servers=1, frac_workers=0.5)}
# the communication contract (tests/test_hlo_comm.py), over 2 ranks
COMM_CASES = {
    "flgan": dict(algo="flgan", num_servers=1),
    "mdgan E=0": dict(algo="mdgan", num_servers=1),
    "acgan E=1": dict(algo="acgan", num_servers=2, E=1),
    "capgan E=1": dict(algo="capgan", num_servers=2, E=1, cloud_epoch=1),
    "mdgan E=1 dropout": dict(algo="mdgan", num_servers=1, E=1,
                              dropout_rate=0.25),
    "mdgan shuffle": dict(algo="mdgan", num_servers=1, E=1,
                          d_swap="shuffle")}


def _cases(table, workers=8, rounds=ROUNDS):
    """Run cases; their names marked apart from the dryrun's own."""
    return [{"name": "case " + name, "rounds": rounds,
             "cfg": {**BASE, "num_workers": workers, **kw}}
            for name, kw in table.items()]


def _ours(results):
    """This file's cases of a job's results, by their table names."""
    return {k[5:]: v for k, v in results.items() if k.startswith("case ")}


CASES = (_cases(REF_CASES, 4, REF_ROUNDS) + _cases(PORT_CASES)
         + _cases(COMM_CASES, rounds=1))


@pytest.fixture(scope="module")
def runs():
    """{world: rank 0's results of every case}, "unsharded": the port's
    own runs of the same cases on one device, and "dryrun": the results of
    ``dryrun_multichip(2)``'s own cases."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        # the three jobs at once, each waited on by a thread of its own
        with ThreadPoolExecutor(3) as pool:
            two = pool.submit(dryrun.dryrun_multichip, 2, "cpu", CASES)
            one = pool.submit(meshes.spawn, dryrun.run_cases, 1, "cpu",
                              CASES)
            four = pool.submit(meshes.spawn, dryrun.run_cases, 4, "cpu",
                               _cases(PORT_CASES))
            unsharded = dryrun.run_cases(None, CASES, "cpu")
            two, one, four = two.result(), one.result(), four.result()
        return {"unsharded": _ours(unsharded), 1: _ours(one[0]),
                2: _ours(two), 4: _ours(four[0]),
                "dryrun": {k: v for k, v in two.items()
                           if not k.startswith("case ")}}
    finally:
        torch.set_num_threads(threads)


def _leaves(tree, path=""):
    """(path, array) of every tensor of a plain state, dict keys sorted."""
    if isinstance(tree, torch.Tensor):
        yield path, tree.numpy()
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}.{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")


def _close_states(got, ref, rounds, label):
    """Params and BN buffers elementwise, moments against their group's
    scale, counts and the round counter exactly."""
    assert got["t"] == ref["t"] == rounds
    pairs = list(zip(_leaves(got), _leaves(ref)))
    scale = {}
    for _, (path, b) in pairs:
        for moment in (".mu", ".nu"):
            if moment in path:
                group = path.split(moment)[0] + moment
                scale[group] = max(scale.get(group, 0.0),
                                   float(np.abs(b).max()) if b.size else 0)
    for (path, a), (rpath, b) in pairs:
        assert path == rpath and a.shape == b.shape, (label, path)
        if not np.issubdtype(a.dtype, np.floating):
            np.testing.assert_array_equal(a, b, err_msg=f"{label} {path}")
            continue
        moment = next((m for m in (".mu", ".nu") if m in path), None)
        if moment:
            group = path.split(moment)[0] + moment
            assert np.abs(a - b).max(initial=0) <= \
                TOL_MOMENT * scale[group], (label, path)
        else:
            np.testing.assert_allclose(a, b, rtol=TOL_PARAMS[0],
                                       atol=TOL_PARAMS[1],
                                       err_msg=f"{label} {path}")


def _close_metrics(got, ref, label):
    assert len(got) == len(ref)
    for m, r in zip(got, ref):
        assert set(m) == set(r), label
        for k in r:
            np.testing.assert_allclose(m[k], r[k], rtol=TOL_METRIC[0],
                                       atol=TOL_METRIC[1],
                                       err_msg=f"{label} {k}")


# ---------------------------------------------------------------------------
# against the reference's jitted mesh round
# ---------------------------------------------------------------------------

def _reference_state(jstate):
    """The reference's state in the port's checkpoint layout: D stacks
    ``(S, k, ...)`` flat, the Adam state ``{count, mu, nu}``."""
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
            "lam": None if jstate.lam is None else np_(jstate.lam),
            "t": int(jstate.t)}


@pytest.mark.parametrize("name", list(REF_CASES))
def test_two_ranks_match_the_reference_mesh_round(runs, name):
    """The port over 2 gloo ranks against the reference's jitted round on
    a 2-device clients mesh, 2 rounds from the seed on both sides."""
    kw = {**BASE, "num_workers": 4, **REF_CASES[name]}
    mesh = JaxMesh(np.asarray(jax.devices()[:2]), ("clients",))
    jrun = jregistry.build_runner(JaxConfig(**kw), mesh=mesh)
    jstate = jrun.init_state()
    # compiled at XLA's backend optimization level 0: the same HLO, sooner
    round_fn = jax.jit(jrun.round_fn).lower(jstate).compile(
        {"xla_backend_optimization_level": 0})
    jmetrics = []
    for _ in range(REF_ROUNDS):
        jstate, m = round_fn(jstate)
        jmetrics.append({k: float(v) for k, v in m.items()})
    got = runs[2][name]
    _close_metrics(got["metrics"], jmetrics, name)
    _close_states(got["state"], _reference_state(jstate), REF_ROUNDS, name)


# ---------------------------------------------------------------------------
# against the port's unsharded run
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", list(PORT_CASES))
def test_sharded_matches_unsharded(runs, name, world):
    """Each algorithm over 2 and 4 ranks against the same run on one
    device, 3 rounds from the seed."""
    got, ref = runs[world][name], runs["unsharded"][name]
    _close_metrics(got["metrics"], ref["metrics"], f"{name} x{world}")
    _close_states(got["state"], ref["state"], ROUNDS, f"{name} x{world}")


def test_one_rank_is_the_unsharded_run(runs):
    """At world 1 every case, its collectives made on a one-rank gloo
    group, is the unsharded run bit for bit: state and metrics."""
    assert set(runs[1]) == set(runs["unsharded"]) and len(runs[1]) == 13
    for name, got in runs[1].items():
        ref = runs["unsharded"][name]
        assert got["metrics"] == ref["metrics"], name
        for (path, a), (_, b) in zip(_leaves(got["state"]),
                                     _leaves(ref["state"])):
            np.testing.assert_array_equal(a, b, err_msg=f"{name} {path}")
        assert got["t"] == ref["t"] == len(got["metrics"])


def test_dryrun_multichip_two_ranks(runs):
    """``dryrun_multichip(2)``: the reference's dryrun configs, its DP x TP
    one (CAP-GAN on a ``(1, 2)`` clients x model mesh of the two ranks)
    included, every one at its round count with finite metrics."""
    assert set(runs["dryrun"]) == {c["name"]
                                   for c in dryrun.multichip_cases(2)}
    for case in dryrun.multichip_cases(2):
        got = runs["dryrun"][case["name"]]
        assert got["t"] == case["rounds"]
        assert all(np.isfinite(v) for m in got["metrics"]
                   for v in m.values())
    assert len(dryrun.multichip_cases(2)) == 9
    assert dryrun.multichip_cases(2)[-1]["cfg"]["model_shards"] == 2


# ---------------------------------------------------------------------------
# the communication contract: tests/test_hlo_comm.py's, from the recorder
# ---------------------------------------------------------------------------

def _stack_leaf_bytes(state):
    """Bytes of the largest D param leaf (a stacked-per-client leaf in
    the CGL and MD-GAN families)."""
    return max(a.nbytes for _, a in _leaves(state["d"]["params"]))


def _kinds(round_log):
    return [kind for kind, _, _ in round_log]


def test_flgan_fedavg_is_one_all_reduce(runs):
    """FedAvg of G and D, BN buffers and the loss means: exactly one
    all-reduce a round, nothing gathered, nothing sent."""
    for log in runs[2]["flgan"]["collectives"] + \
            runs[2]["flgan ragged"]["collectives"]:
        assert _kinds(log) == ["all_reduce"], log


def test_mdgan_ring_swap_is_point_to_point(runs):
    """The ring D-swap: one send and one receive a round, at most the D's
    leaf count; E=0: none."""
    for name in ("mdgan ring", "mdgan E=1 dropout", "mdgan shuffle"):
        state = runs[2][name]["state"]
        n_leaves = len(list(_leaves(state["d"]["params"])))
        for log in runs[2][name]["collectives"]:
            kinds = _kinds(log)
            assert 1 <= kinds.count("send") <= n_leaves, (name, log)
            assert 1 <= kinds.count("recv") <= n_leaves, (name, log)
    for log in runs[2]["mdgan E=0"]["collectives"]:
        assert "send" not in _kinds(log) and "recv" not in _kinds(log)


def test_block_share_all_reduces_segment_partials(runs):
    """The AC-GAN / CAP-GAN E-round share and the delta gossip: every
    array an all-reduce moves is smaller than one stacked D leaf (the
    (S, ...) partials, never the (W, ...) stack)."""
    for name in ("acgan E=1", "capgan E=1", "acgan delta", "cglgan"):
        cap = _stack_leaf_bytes(runs[2][name]["state"])
        for log in runs[2][name]["collectives"]:
            assert "all_reduce" in _kinds(log)
            for kind, _, sizes in log:
                if kind == "all_reduce":
                    assert max(sizes) < cap, (name, sizes, cap)


def test_no_round_gathers_a_stack_leaf(runs):
    """No round of any case all-gathers anything as large as a stacked D
    leaf: the G step gathers per-client loss scalars only."""
    for world in (2, 4):
        for name, got in runs[world].items():
            if "state" not in got:
                continue
            cap = _stack_leaf_bytes(got["state"])
            for log in got["collectives"]:
                for kind, _, sizes in log:
                    if kind == "all_gather":
                        assert max(sizes) < cap, (world, name, sizes, cap)
                assert "gather" not in _kinds(log), (world, name)


# ---------------------------------------------------------------------------
# what a mesh refuses, and the module's imports
# ---------------------------------------------------------------------------

class _FakeMesh(meshes.Mesh):
    """A mesh's block arithmetic without a process group."""

    def __init__(self, size, rank=0):
        self.size, self.rank, self.device = size, rank, torch.device("cpu")


def test_a_clients_axis_the_mesh_does_not_divide_raises():
    """3 clients over 2 ranks: the port raises ValueError naming both
    sizes when it builds; the reference refuses the same placement."""
    for kw in (dict(algo="flgan", num_servers=1, num_workers=3),
               dict(algo="capgan", num_servers=1, num_workers=3),
               dict(algo="acgan", num_servers=2, num_workers=6)):
        cfg = FedGANConfig(**{**BASE, **kw})
        with pytest.raises(ValueError, match=r"of 3 does not divide over "
                                             r"a mesh of 2 ranks"):
            build_runner(cfg, load_partition(cfg), device="cpu",
                         mesh=_FakeMesh(2))
        jmesh = JaxMesh(np.asarray(jax.devices()[:2]), ("clients",))
        with pytest.raises(ValueError):
            jregistry.build_runner(JaxConfig(**{**BASE, **kw}),
                                   mesh=jmesh).init_state()


def test_tensor_parallelism_names_its_roadmap_item():
    """The counterpart of the reference's ``test_fed_mesh_validation``
    (``tests/test_tensor_parallel.py``): ``fed_mesh(4, model_shards=3)``
    raises "divisible" before it joins any process group, and ``spawn``
    before it starts one; ``model_shards=0`` raises ValueError there and in
    the config, and ``model_shards=2`` on flgan in the config, on both
    packages; without a mesh there is one model shard."""
    with pytest.raises(ValueError, match="divisible"):
        meshes.fed_mesh(4, model_shards=3)
    with pytest.raises(ValueError, match="model_shards"):
        meshes.fed_mesh(4, model_shards=0)
    with pytest.raises(ValueError, match="divisible"):
        meshes.spawn(dryrun.run_cases, 3, "cpu", [], model_shards=2)
    for kw in (dict(model_shards=0), dict(algo="flgan", model_shards=2)):
        for config in (FedGANConfig, JaxConfig):
            with pytest.raises(ValueError, match="model_shards"):
                config(**{**BASE, "num_workers": 4, **kw})
    assert meshes.model_shards_of(None) == 1


def test_place_and_gather_are_inverse():
    """``place`` takes a rank's block (``P(CLIENTS)``: axis 0; ``P(None,
    CLIENTS)``: axis 1 of (S, k, ...), or of a flat leaf with ``groups``);
    putting every rank's block back in the unsharded order gives the
    whole."""
    x = torch.arange(2 * 6 * 3).reshape(12, 3)
    sk = x.reshape(2, 6, 3)
    for size in (1, 2, 3):
        ranks = [_FakeMesh(size, r) for r in range(size)]
        rows = [meshes.place(x, m, meshes.P(meshes.CLIENTS)) for m in ranks]
        torch.testing.assert_close(torch.cat(rows), x)
        blocks = [meshes.place(sk, m, meshes.P(None, meshes.CLIENTS))
                  for m in ranks]
        torch.testing.assert_close(torch.cat(blocks, 1), sk)
        flat = [meshes.place(x, m, meshes.P(None, meshes.CLIENTS), 2)
                for m in ranks]
        for b, f in zip(blocks, flat):
            torch.testing.assert_close(f, b.reshape(-1, 3))
    assert meshes.place(x, None, meshes.P(meshes.CLIENTS)) is x
    assert meshes.commit_tree(x, None) is x


def test_spawn_refuses_missing_cards():
    """A NCCL mesh of more ranks than cards raises before any process
    starts: never fewer ranks, never the host."""
    if torch.cuda.device_count() >= 2:
        pytest.skip("two cards are present")
    with pytest.raises(RuntimeError, match="needs 2 CUDA devices"):
        meshes.spawn(dryrun.run_cases, 2, None, [])

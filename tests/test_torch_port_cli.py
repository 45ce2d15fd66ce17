"""The port's CLI (``cglgan_tpu_torch/cli.py``, ``tpufed-torch``) against the
reference's (``cglgan_tpu/cli.py``, ``tpufed``) on the CPU, both called in
process (the reference with ``--compile-cache off`` and its cache
variable off).

Tolerances.  ``run`` from the same knobs: the round metrics (losses, the
Lambda game) within ``TOL_METRIC`` = 1e-5 absolute, as the round tests
(``test_torch_port_capgan.py``); the 2DMG evaluator's KL Score,
Distribution Score and mode coverage within 1e-5 relative, as
``test_torch_port_mdgan.py::test_evaluator_matches_jax``; ``wall_s`` and
``rounds_per_s`` are left out.  ``fid-stats``: mu and sigma within
``TOL_STATS`` = 1e-5 of their largest entry, as
``test_torch_port_fid.py``'s ``activation_stats`` (the extractors' weights
are within 4 ulps).  ``import-torch --samples``: within ``TOL_SAMPLES`` =
1e-5 absolute (the latents are the reference's threefry normals within 3
ulps, through a 100-32-2 G).  ``run --init-from-torch``: as ``run``.
Parser, config, ``compare``, ``eval`` and ``export``: exact.
"""
import argparse
import csv
import dataclasses
import json
import os
import sys

import numpy as np
import pytest
import torch

from cglgan_tpu import cli as jcli
from cglgan_tpu_torch import cli
from cglgan_tpu_torch.algos.registry import build_runner, load_partition
from cglgan_tpu_torch.core.config import FedGANConfig
from cglgan_tpu_torch.evalx.evaluator import make_evaluator
from cglgan_tpu_torch.ops import _build
from cglgan_tpu_torch.utils.checkpoint import restore_checkpoint
from test_torch_port_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL_METRIC = 1e-5
TOL_EVAL = 1e-5
TOL_STATS = 1e-5
TOL_SAMPLES = 1e-5
EVAL_KEYS = ("kl_score", "distribution_score", "mode_coverage")
# CAP-GAN on 2DMG, 2 servers, epoch 2 (the fused_dstep path's plain
# version), lr 0.01 so that the generated points reach the real modes in
# 4 rounds and the evaluator's metrics are not 0
RUN = ["run", "capgan", "--dataset", "2dmg", "--num-workers", "4",
       "--num-servers", "2", "--num-class", "4", "--num-sample", "100",
       "--batch-size", "16", "--epoch", "2", "--lr-g", "0.01",
       "--lr-d", "0.01", "--rounds", "4", "--num-plt", "2",
       "--ckpt-every", "2"]



@pytest.fixture(autouse=True)
def _no_xla_cache(monkeypatch):
    """The reference's commands enable a persistent XLA cache unless told
    otherwise: keep it off, as tests/test_cli.py does."""
    monkeypatch.setenv("CGLGAN_TPU_COMPILE_CACHE", "off")


@pytest.fixture(scope="module")
def run_dirs(tmp_path_factory):
    """``RUN`` through both CLIs: {"ref": dir, "port": dir}."""
    out = tmp_path_factory.mktemp("runs")
    assert jcli.main(RUN + ["--out", str(out), "--name", "ref",
                            "--compile-cache", "off",
                            "--platform", "cpu"]) == 0
    assert cli.main(RUN + ["--out", str(out), "--name", "port",
                           "--device", "cpu"]) == 0
    return {k: str(out / k) for k in ("ref", "port")}


def _jsonl(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f if line.strip()]


# ---------------------------------------------------------------------------
# the parser and the config
# ---------------------------------------------------------------------------

def _parser_options(p):
    return {a.option_strings[0] if a.option_strings else a.dest:
            (a.dest, a.default, a.choices, a.type, a.nargs, type(a).__name__,
             a.option_strings)
            for a in p._actions if a.dest != "help"}


def _options(add):
    p = argparse.ArgumentParser()
    add(p)
    return _parser_options(p)


class _Parsed(Exception):
    """Raised in place of parsing, with the parser ``main`` built."""


def _command_options(main, cmd, monkeypatch):
    """The options of ``main``'s subcommand ``cmd``, as ``_options``."""
    def grab(self, args=None, namespace=None):
        raise _Parsed(self)

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", grab)
        with pytest.raises(_Parsed) as e:
            main([cmd])
    sub, = [a for a in e.value.args[0]._actions
            if isinstance(a, argparse._SubParsersAction)]
    return _parser_options(sub.choices[cmd])


def test_run_options_match_reference():
    """Every ``run`` option of the reference with its name, default,
    choices, type and action, but ``--platform`` (``--device`` here)."""
    ref, mine = _options(jcli._add_run_args), _options(cli._add_run_args)
    assert set(ref) - set(mine) == {"--platform"}
    assert set(mine) - set(ref) == {"--device"}
    for name in set(ref) & set(mine):
        assert mine[name] == ref[name], name
    assert mine["--device"][1] is None and ref["--platform"][1] is None


def test_doctor_options_match_reference(monkeypatch):
    """``doctor``'s options are the reference's, but ``--platform``
    (``--device`` here, handed to the probe) and ``--compile-cache`` (the
    kernel build directory that doctor reports)."""
    ref = _command_options(jcli.main, "doctor", monkeypatch)
    mine = _command_options(cli.main, "doctor", monkeypatch)
    assert set(ref) - set(mine) == {"--platform"}
    assert set(mine) - set(ref) == {"--device", "--compile-cache"}
    for name in set(ref) & set(mine):
        assert mine[name] == ref[name], name
    assert mine["--device"][1] is None and ref["--platform"][1] is None


ARGV_SETS = [
    ["capgan"],
    ["cglgan", "--dataset", "synthetic-mnist", "--num-workers", "20",
     "--num-servers", "5", "--epoch", "5", "-E", "2", "-c", "3", "-s",
     "0.1", "--conv", "--dtype", "bfloat16", "--pallas-dstep", "on"],
    ["flgan", "--rounds", "50", "--num-plt", "5", "--pallas-sweep", "on",
     "--dropout-rate", "0.2", "--weighting", "mean", "--lr-g", "1e-3"],
    ["acgan", "--gossip", "delta", "--d-swap", "shuffle", "--iid", "2",
     "--frac-workers", "0.5", "--b1", "0.9", "--b2", "0.99",
     "--seed", "7", "--data-dir", "/nowhere", "--img-size", "32"],
]


@pytest.mark.parametrize("argv", ARGV_SETS, ids=lambda a: a[0])
def test_cfg_from_args_matches_reference(tmp_path, argv):
    """The same argv gives the same config dict, and ``--from-config`` of
    the reference's config.json gives it back on both sides."""
    jp, p = argparse.ArgumentParser(), argparse.ArgumentParser()
    jcli._add_run_args(jp)
    cli._add_run_args(p)
    ref = dataclasses.asdict(jcli.cfg_from_args(jp.parse_args(argv)))
    assert dataclasses.asdict(cli.cfg_from_args(p.parse_args(argv))) == ref
    path = tmp_path / "config.json"
    path.write_text(json.dumps(ref))
    again = [argv[0], "--from-config", str(path), "--num-workers", "99"]
    assert dataclasses.asdict(cli.cfg_from_args(p.parse_args(again))) == ref
    assert dataclasses.asdict(jcli.cfg_from_args(jp.parse_args(again))) \
        == ref
    with pytest.raises(SystemExit):
        other = "mdgan" if argv[0] != "mdgan" else "capgan"
        cli.cfg_from_args(p.parse_args([other, "--from-config", str(path)]))


# ---------------------------------------------------------------------------
# run, eval, compare, sweep
# ---------------------------------------------------------------------------

def test_run_matches_reference(run_dirs):
    """The same file names and config.json; each tick the same keys and
    round, the round metrics within TOL_METRIC and the evaluator's within
    TOL_EVAL relative, not all zero."""
    ref, port = run_dirs["ref"], run_dirs["port"]
    assert sorted(os.listdir(port)) == sorted(os.listdir(ref))
    with open(os.path.join(ref, "config.json")) as f, \
            open(os.path.join(port, "config.json")) as g:
        assert json.load(g) == json.load(f)
    jticks, ticks = _jsonl(ref), _jsonl(port)
    assert [t["round"] for t in ticks] == [t["round"] for t in jticks] \
        == [2, 4]
    for tick, jtick in zip(ticks, jticks):
        assert list(tick) == list(jtick)
        for key, v in jtick.items():
            if key in ("wall_s", "rounds_per_s", "round"):
                continue
            tol = TOL_EVAL * max(1.0, abs(v)) if key in EVAL_KEYS \
                else TOL_METRIC
            assert abs(tick[key] - v) <= tol, (key, tick[key], v)
    assert ticks[-1]["kl_score"] > 0 and ticks[-1]["mode_coverage"] > 0


def test_eval_reports_the_evaluator(run_dirs, capsys):
    """``eval`` of the port's ckpt_final prints the round, n and what the
    evaluator gives on the restored state's samples, and paints them."""
    ckpt = os.path.join(run_dirs["port"], "ckpt_final")
    capsys.readouterr()
    assert cli.main(["eval", ckpt, "--n", "200", "--device", "cpu"]) == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    with open(os.path.join(run_dirs["port"], "config.json")) as f:
        cfg = FedGANConfig(**json.load(f))
    part = load_partition(cfg)
    runner = build_runner(cfg, part, device="cpu")
    state = restore_checkpoint(ckpt, runner.init_state())
    want = make_evaluator(cfg, part, eval_n=200, device="cpu")(
        runner, state, samples=runner.sample(state, 200))
    assert report == {"round": 4, "n": 200, **want}
    assert os.path.exists(os.path.join(run_dirs["port"], "eval_4.png"))


def test_reference_compare_reads_port_run_dirs(run_dirs, tmp_path):
    """The reference's ``cmd_compare`` over the port's run dirs (and the
    reference's own) writes the rows the port's ``compare`` writes."""
    dirs = [run_dirs["port"], run_dirs["ref"]]
    mine, ref = str(tmp_path / "port"), str(tmp_path / "ref")
    assert cli.main(["compare", *dirs, "--out", mine]) == 0
    assert jcli.main(["compare", *dirs, "--out", ref]) == 0
    with open(mine + ".csv") as f, open(ref + ".csv") as g:
        rows, jrows = list(csv.DictReader(f)), list(csv.DictReader(g))
    assert rows == jrows and len(rows) == 2
    assert {r["run_dir"] for r in rows} == set(dirs)
    assert rows[0]["data"] == "gmm" and rows[0]["round"] == "4"
    assert os.path.getsize(mine + ".xlsx") > 0


def test_sweep_writes_its_summary(tmp_path):
    """A two-run ``sweep`` (CAP-GAN and FL-GAN on 2DMG) writes a run dir a
    run and sweep_summary.csv / .xlsx with a row a run."""
    assert cli.main(["sweep", "--algos", "capgan,flgan", "--datasets",
                     "2dmg", "--iids", "1", "--num-workers", "4",
                     "--num-class", "4", "--num-sample", "64",
                     "--batch-size", "16", "--rounds", "2", "--num-plt",
                     "2", "--ckpt-every", "0", "--device", "cpu",
                     "--out", str(tmp_path)]) == 0
    (root,) = [p for p in tmp_path.iterdir() if p.name.endswith("-sweep")]
    with open(root / "sweep_summary.csv") as f:
        rows = list(csv.DictReader(f))
    assert [(r["algo"], r["dataset"], r["iid"]) for r in rows] == \
        [("capgan", "2dmg", "1"), ("flgan", "2dmg", "1")]
    for r in rows:
        assert r["round"] == "2" and float(r["kl_score"]) >= 0
        assert os.path.exists(os.path.join(r["run_dir"], "ckpt_final"))
    assert (root / "sweep_summary.xlsx").exists()


def test_run_options_that_route_elsewhere(tmp_path, monkeypatch):
    """Without a card ``run`` raises rather than train on the host, also
    with ``--devices`` (never fewer ranks, never the host);
    ``--model-shards`` on the host needs ``--devices`` (without it the
    world is every card); ``--profile`` writes one tick's
    trace; ``--compile-cache DIR`` moves the kernel build directory."""
    base = ["run", "flgan", "--num-workers", "4", "--num-class", "4",
            "--num-sample", "64", "--batch-size", "16", "--rounds", "2",
            "--num-plt", "2", "--out", str(tmp_path)]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(base + ["--name", "nocard"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(base + ["--name", "nocards", "--devices", "2"])
        assert not (tmp_path / "nocards").exists()
    with pytest.raises(ValueError, match="needs --devices"):
        cli.main([{"flgan": "capgan"}.get(a, a) for a in base]
                 + ["--device", "cpu", "--model-shards", "2", "--name",
                    "tp"])
    assert not (tmp_path / "tp").exists()
    assert cli.main(base + ["--device", "cpu", "--profile",
                            "--name", "prof"]) == 0
    with open(tmp_path / "prof" / "profile" / "trace.json") as f:
        assert json.load(f)["traceEvents"]
    assert not (tmp_path / "prof" / "ckpt_final").exists()
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
    cli._enable_compile_cache(argparse.Namespace(
        compile_cache=str(tmp_path / "kb")))
    assert _build.BUILD_DIR == str(tmp_path / "kb")
    assert _build.target("threefry").startswith(str(tmp_path / "kb"))


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)


def test_run_on_a_mesh_resumes_bit_exact(tmp_path):
    """``run capgan --dataset 2dmg --devices 2 --device cpu``: two gloo
    ranks and one run dir, rank 0's; its checkpoints hold the whole state
    in the unsharded layout, so ``ckpt_2`` restores into an unsharded
    runner; the run cut at its ``ckpt_2`` and resumed on the same mesh
    ends bit for bit where the uninterrupted run ends."""
    argv = RUN + ["--device", "cpu", "--devices", "2", "--out",
                  str(tmp_path)]
    assert cli.main(argv + ["--name", "mesh"]) == 0
    assert cli.main(argv + ["--name", "resumed", "--resume",
                            str(tmp_path / "mesh" / "ckpt_2")]) == 0
    assert sorted(os.listdir(tmp_path)) == ["mesh", "resumed"]
    assert [t["round"] for t in _jsonl(tmp_path / "mesh")] == [2, 4]
    load = lambda name, ckpt: torch.load(tmp_path / name / ckpt,
                                         weights_only=True)
    whole, resumed = load("mesh", "ckpt_final"), load("resumed",
                                                      "ckpt_final")
    assert whole["t"] == resumed["t"] == 4
    pairs = list(zip(_leaves(whole), _leaves(resumed)))
    assert pairs and all(torch.equal(a, b) for a, b in pairs)
    cfg = FedGANConfig(algo="capgan", dataset="2dmg", num_workers=4,
                       num_servers=2, num_class=4, num_sample=100,
                       batch_size=16, epoch=2, lr_g=0.01, lr_d=0.01,
                       num_communication=4, num_plt=2)
    runner = build_runner(cfg, load_partition(cfg), device="cpu")
    state = restore_checkpoint(str(tmp_path / "mesh" / "ckpt_2"),
                               runner.init_state())
    assert state.t == 2
    assert all(torch.equal(a, b) for a, b in zip(
        _leaves(state.d.params), _leaves(load("mesh", "ckpt_2")["d"][
            "params"])))


# ---------------------------------------------------------------------------
# doctor and fid-stats
# ---------------------------------------------------------------------------

def test_doctor_without_a_card(capsys):
    """``doctor`` prints one JSON report (versions, the probe's error, the
    kernel build directory, the dataplane) and exits 1 with no card."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: doctor exits 0 there")
    capsys.readouterr()
    assert cli.main(["doctor", "--probe-timeout", "120"]) == 1
    report = json.loads(capsys.readouterr().out)
    assert report["torch"] == torch.__version__
    assert "cuda" in report["backend"]["error"].lower()
    assert report["kernel_build"]["dir"] == _build.BUILD_DIR
    assert isinstance(report["native_dataplane"], bool)


def test_doctor_probes_the_device_asked(capsys):
    """``doctor --device cpu`` hands the device to the probe: the host
    answers, and doctor exits 0 reporting it and the count of cards a
    mesh can take."""
    capsys.readouterr()
    assert cli.main(["doctor", "--device", "cpu",
                     "--probe-timeout", "120"]) == 0
    report = json.loads(capsys.readouterr().out)
    assert report["cuda_devices"] == torch.cuda.device_count()
    backend = report["backend"]
    assert backend["platform"] == "cpu" and backend["device_kind"] == "cpu"
    assert backend["torch"] == torch.__version__


def test_fid_stats_matches_reference(tmp_path):
    """``fid-stats`` at n=64 on the glyph bank, proxy features: the port's
    .npz against the reference's, mu and sigma within TOL_STATS of their
    largest entry, the same recorded side (also with ``--conv``, 32)."""
    for extra, side in (([], 28), (["--conv"], 32)):
        argv = ["fid-stats", "--dataset", "synthetic-mnist", "--n", "64",
                *extra]
        mine, ref = tmp_path / f"p{side}.npz", tmp_path / f"r{side}.npz"
        assert cli.main(argv + ["--out", str(mine), "--device", "cpu"]) == 0
        assert jcli.main(argv + ["--out", str(ref)]) == 0
        got, want = np.load(mine), np.load(ref)
        assert int(got["side"]) == int(want["side"]) == side
        for key in ("mu", "sigma"):
            scale = np.abs(want[key]).max()
            assert np.abs(got[key] - want[key]).max() <= TOL_STATS * scale


def test_pyproject_names_the_script():
    with open(os.path.join(REPO, "pyproject.toml")) as f:
        text = f.read()
    assert 'tpufed-torch = "cglgan_tpu_torch.cli:main"' in text


# ---------------------------------------------------------------------------
# export, import-torch, run --init-from-torch, plot
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cmd,ref_only,mine_only", [
    ("export", {"--platform", "--platforms"}, {"--device"}),
    ("import-torch", {"--platform", "--platforms"}, {"--device"}),
    ("plot", set(), set())])
def test_serving_options_match_reference(cmd, ref_only, mine_only,
                                         monkeypatch):
    """``export``, ``import-torch`` and ``plot`` take the reference's
    options with their defaults, choices, types and actions; its
    ``--platform`` / ``--platforms`` are ``--device`` here (a
    ``torch.export`` program is traced for one device)."""
    ref = _command_options(jcli.main, cmd, monkeypatch)
    mine = _command_options(cli.main, cmd, monkeypatch)
    assert set(ref) - set(mine) == ref_only
    assert set(mine) - set(ref) == mine_only
    for name in set(ref) & set(mine):
        assert mine[name] == ref[name], name


def test_gen_specs_mirror_the_zoo():
    from cglgan_tpu.models import zoo as jzoo
    from cglgan_tpu_torch.models import zoo
    assert cli.GEN_SPECS == zoo.GEN_SPECS == jzoo.GEN_SPECS \
        == jcli.GEN_SPECS


class _TwinG(torch.nn.Module):
    """A reference 2DMG generator's layout: ``model`` (the 100-32 trunk, or
    the whole 100-32-2 net) and, multipath, ``paths``."""

    def __init__(self, heads=0):
        super().__init__()
        tnn = torch.nn
        if heads:
            self.model = tnn.Sequential(tnn.Linear(100, 32),
                                        tnn.LeakyReLU(0.2))
            self.paths = tnn.ModuleList([
                tnn.Sequential(tnn.Linear(32, 2), tnn.Tanh())
                for _ in range(heads)])
        else:
            self.model = tnn.Sequential(tnn.Linear(100, 32),
                                        tnn.LeakyReLU(0.2),
                                        tnn.Linear(32, 2), tnn.Tanh())


def _save_twin(path, seed, heads=0):
    torch.manual_seed(seed)
    torch.save(_TwinG(heads).state_dict(), str(path))
    return str(path)


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _assert_ticks_match(ticks, jticks):
    for tick, jtick in zip(ticks, jticks, strict=True):
        assert list(tick) == list(jtick)
        for key, v in jtick.items():
            if key in ("wall_s", "rounds_per_s", "round"):
                continue
            tol = TOL_EVAL * max(1.0, abs(v)) if key in EVAL_KEYS \
                else TOL_METRIC
            assert abs(tick[key] - v) <= tol, (key, tick[key], v)


def test_run_init_from_torch_matches_reference(run_dirs, tmp_path):
    """``run --init-from-torch`` with one reference ``.pt`` a server: the
    port's ticks are the reference CLI's within TOL_METRIC / TOL_EVAL, and
    the warm start moved them off the run from the seed's own init."""
    pts = [_save_twin(tmp_path / f"g{i}.pt", seed=i) for i in range(2)]
    out = str(tmp_path / "runs")
    init = ["--init-from-torch", ",".join(pts), "--out", out]
    assert jcli.main(RUN + init + ["--name", "ref", "--compile-cache",
                                   "off", "--platform", "cpu"]) == 0
    assert cli.main(RUN + init + ["--name", "port", "--device", "cpu"]) == 0
    ticks = _jsonl(os.path.join(out, "port"))
    _assert_ticks_match(ticks, _jsonl(os.path.join(out, "ref")))
    cold = _jsonl(run_dirs["port"])
    assert [t["round"] for t in ticks] == [2, 4]
    assert any(ticks[0][k] != cold[0][k] for k in ticks[0]
               if k not in ("wall_s", "rounds_per_s", "round"))
    with pytest.raises(SystemExit, match="mutually exclusive"):
        cli.main(RUN + init + ["--resume", os.path.join(out, "port",
                                                        "ckpt_2"),
                               "--name", "both", "--device", "cpu"])


@pytest.mark.parametrize("heads", [0, 3])
def test_import_torch_samples_match_reference(heads, tmp_path, capsys):
    """``import-torch --samples`` on one ``.pt`` and seed: the port's .npy
    is the reference CLI's within TOL_SAMPLES (its latents are the
    reference's threefry normals, within 3 ulps), heads interleaved
    sample-major; the same report, and with ``--eval-dataset 2dmg`` the
    same KL / DS / coverage within TOL_EVAL."""
    pt = _save_twin(tmp_path / "g.pt", seed=5, heads=heads)
    argv = ["import-torch", pt, "--n", "50", "--seed", "3"]
    if heads:
        argv += ["--eval-dataset", "2dmg"]
    capsys.readouterr()
    assert jcli.main(argv + ["--samples", str(tmp_path / "ref")]) == 0
    jreport = _last_json(capsys)
    assert cli.main(argv + ["--samples", str(tmp_path / "port"),
                            "--device", "cpu"]) == 0
    report = _last_json(capsys)
    assert report["samples"] == str(tmp_path / "port.npy")
    for key, v in jreport.items():
        if key in EVAL_KEYS:
            assert abs(report[key] - v) <= TOL_EVAL * max(1.0, abs(v)), key
        elif key != "samples":
            assert report[key] == v, key
    assert set(report) == set(jreport)
    got, want = np.load(tmp_path / "port.npy"), np.load(tmp_path / "ref.npy")
    assert got.shape == want.shape == (max(heads, 1) * 50, 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL_SAMPLES)


def test_import_torch_export(tmp_path, capsys):
    """``import-torch --export`` writes a polymorphic artifact (from n = 1)
    of the imported Mix-G, heads onto the batch head-major, equal to the
    imported model's eager forward; its report carries the manifest."""
    from cglgan_tpu_torch.utils.export import load_generator
    from cglgan_tpu_torch.utils.torch_import import import_generator_file
    from cglgan_tpu_torch.utils.tree import tree_map

    pt = _save_twin(tmp_path / "g.pt", seed=6, heads=3)
    art = str(tmp_path / "g.pt2")
    capsys.readouterr()
    assert cli.main(["import-torch", pt, "--export", art,
                     "--device", "cpu"]) == 0
    report = _last_json(capsys)
    assert report["family"] == "2dmg-multipath" and report["num_heads"] == 3
    assert report["export"]["out"] == art
    assert report["export"]["family"] == "2dmg-multipath"
    assert report["export"]["imported_from"] == pt
    assert report["export"]["in_shape"] == ["b", 100]
    assert report["export"]["out_shape"] == ["3*b", 2]
    serve, manifest = load_generator(art)
    assert manifest["min_batch"] == 1
    model, params, state, _ = import_generator_file(pt, device="cpu")
    up = lambda tree: tree_map(lambda x: x.unsqueeze(0), tree)
    for n in (1, 9):
        z = torch.from_numpy(np.random.default_rng(n).normal(
            size=(n, 100)).astype(np.float32))
        with torch.no_grad():
            y, _ = model.apply(up(params), up(state), z[None], train=False)
        assert torch.equal(serve(z), y[0].reshape(3 * n, 2))


def test_export_serves_the_checkpoint(run_dirs, tmp_path, capsys):
    """``export`` of the port's CAP-GAN ``ckpt_final`` (2 servers): the
    default name in its run dir, a polymorphic ``2*b`` program serving
    n = 2 and 10 as the restored state's ``gen``; ``--client 1 --n 10``
    serves ``gen_client``; without a card it raises."""
    import shutil

    from cglgan_tpu_torch.utils.export import load_generator

    run = tmp_path / "run"
    run.mkdir()
    for name in ("config.json", "ckpt_final"):
        shutil.copy(os.path.join(run_dirs["port"], name), run / name)
    ckpt = str(run / "ckpt_final")
    capsys.readouterr()
    assert cli.main(["export", ckpt, "--device", "cpu"]) == 0
    line = _last_json(capsys)
    assert line["out"] == str(run / "generator_4.pt2")
    assert line["in_shape"] == ["2*b", 100] and line["min_batch"] == 2
    assert (line["algo"], line["dataset"], line["round"]) == \
        ("capgan", "2dmg", 4)
    client = str(tmp_path / "c1.pt2")
    assert cli.main(["export", ckpt, "--n", "10", "--client", "1",
                     "--out", client, "--device", "cpu"]) == 0
    assert _last_json(capsys)["client"] == 1
    with open(run / "config.json") as f:
        cfg = FedGANConfig(**json.load(f))
    runner = build_runner(cfg, device="cpu")
    state = restore_checkpoint(ckpt, runner.init_state())
    serve, _ = load_generator(line["out"])
    serve_c, _ = load_generator(client)
    for n in (2, 10):
        z = torch.from_numpy(np.random.default_rng(n).normal(
            size=(n, 100)).astype(np.float32))
        assert torch.equal(serve(z), runner.gen(state, z))
    assert torch.equal(serve_c(z), runner.gen_client(state, z, 1))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(["export", ckpt])


def test_plot_renders_and_refuses(run_dirs, tmp_path):
    """``plot`` of the port's and the reference's run dirs writes a PNG
    (as the reference's own ``plot`` does over the same dirs); it refuses
    a metric no run carries, nine runs ("facet") and dirs without
    metrics."""
    dirs = [run_dirs["port"], run_dirs["ref"]]
    out = tmp_path / "plots" / "fig.png"
    assert cli.main(["plot", *dirs, "--out", str(out), "--logy",
                     "--title", "capgan"]) == 0
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    assert jcli.main(["plot", *dirs, "--out", str(tmp_path / "r.png")]) == 0
    other = str(tmp_path / "x.png")
    with pytest.raises(SystemExit, match="no run carries"):
        cli.main(["plot", *dirs, "--metrics", "fid", "--out", other])
    with pytest.raises(SystemExit, match="facet"):
        cli.main(["plot", *([run_dirs["port"]] * 9), "--out", other])
    with pytest.raises(SystemExit, match="no usable"):
        cli.main(["plot", str(tmp_path), "--out", other])
    assert not os.path.exists(other)


def test_plot_names_matplotlib_when_missing(run_dirs, tmp_path,
                                            monkeypatch):
    """Where matplotlib cannot be imported, ``plot`` exits non-zero with a
    message that names it."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(SystemExit, match="matplotlib") as e:
        cli.main(["plot", run_dirs["port"], "--out",
                  str(tmp_path / "x.png")])
    assert e.value.code not in (0, None)

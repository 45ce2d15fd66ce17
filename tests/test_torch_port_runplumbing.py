"""The port's run plumbing (``cglgan_tpu_torch/utils/{checkpoint,logging,
xlsx,imaging,backend_probe}.py``) on the CPU, against the JAX package's
where it has a counterpart.

Checkpoints: a restored state is the saved one bit for bit (float32 and
bfloat16 leaves, the delta gossip's anchors in ``lam``), and a resumed
``tpufed-torch run`` ends bit-equal to the uninterrupted run for each of
the seven algorithms, its run dir holding every tick with ``wall_s``
running on across the resume (the same command, cut after its
checkpoint at round 2: a CGL round's cloud sync counts down from
``num_communication``, so a run to another ``--rounds`` is another run).
``write_xlsx`` writes the reference's zip
members byte for byte; ``save_image_grid`` decodes to the reference's
pixels.  Nothing here has a tolerance: every comparison is exact.
"""
import csv
import json
import os
import subprocess
import sys
import zipfile

import numpy as np
import pytest
import torch
from PIL import Image

from cglgan_tpu.core.config import FedGANConfig as JaxConfig
from cglgan_tpu.utils import imaging as jimaging
from cglgan_tpu.utils.logging import RunDir as JaxRunDir
from cglgan_tpu.utils.xlsx import write_xlsx as jax_write_xlsx
from cglgan_tpu_torch import cli
from cglgan_tpu_torch.algos.registry import build_runner, load_partition
from cglgan_tpu_torch.core.config import FedGANConfig
from cglgan_tpu_torch.utils import backend_probe, imaging
from cglgan_tpu_torch.utils.checkpoint import (restore_checkpoint,
                                               save_checkpoint)
from cglgan_tpu_torch.utils.logging import RunDir
from cglgan_tpu_torch.utils.xlsx import write_xlsx
from test_torch_port_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))



def _leaves(x):
    """Every tensor and int of a state, NamedTuples by field."""
    if isinstance(x, torch.Tensor) or isinstance(x, int):
        return [x]
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return [y for f in x._fields for y in _leaves(getattr(x, f))]
    if isinstance(x, dict):
        return [y for k in sorted(x) for y in _leaves(x[k])]
    if isinstance(x, (list, tuple)):
        return [y for v in x for y in _leaves(v)]
    return []


def _bit_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        if isinstance(x, int):
            assert x == y
        else:
            assert x.dtype == y.dtype and x.shape == y.shape
            assert torch.equal(x.view(torch.int16) if x.dtype ==
                               torch.bfloat16 else x,
                               y.view(torch.int16) if y.dtype ==
                               torch.bfloat16 else y)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

TINY = dict(dataset="2dmg", num_workers=4, num_class=4, num_sample=64,
            batch_size=16)


@pytest.mark.parametrize("case", ["capgan_f32", "acgan_delta_bf16"])
def test_checkpoint_round_trip(tmp_path, case):
    """A state after two rounds restores against ``init_state()`` bit for
    bit, NamedTuples and the host round counter included: CAP-GAN in
    float32 (``lam`` the Lambda game), AC-GAN in bfloat16 with the delta
    gossip (``lam`` the anchors, a (params, bn) pair)."""
    if case == "capgan_f32":
        cfg = FedGANConfig(algo="capgan", num_servers=2, epoch=2, **TINY)
    else:
        cfg = FedGANConfig(algo="acgan", num_servers=2, E=1, gossip="delta",
                           dtype="bfloat16", force_dtype=True, **TINY)
    run = build_runner(cfg, device="cpu")
    state = run.init_state()
    for _ in range(2):
        state, _ = run.round_fn(state)
    path = str(tmp_path / "ckpt_2")
    save_checkpoint(path, state)
    got = restore_checkpoint(path, run.init_state())
    assert type(got) is type(state) and got.t == 2
    assert type(got.g.opt) is type(state.g.opt)
    _bit_equal(got, state)
    if case == "acgan_delta_bf16":
        assert isinstance(got.lam, tuple) and len(got.lam) == 2
        assert got.d.params[0]["w"].dtype == torch.bfloat16
    # the file holds plain containers: torch.load's weights_only reads it
    raw = torch.load(path, weights_only=True)
    assert set(raw) == {"g", "d", "lam", "t"} and raw["t"] == 2


def test_restore_checkpoint_raises_on_mismatch(tmp_path):
    """A template of another shape (8 clients against 4), dtype (bfloat16
    against float32) or structure (FL-GAN's against CAP-GAN's) is refused,
    naming the leaf."""
    cfg = FedGANConfig(algo="capgan", num_servers=2, **TINY)
    run = build_runner(cfg, device="cpu")
    path = str(tmp_path / "ckpt")
    save_checkpoint(path, run.init_state())
    wide = build_runner(cfg.replace(num_workers=8), device="cpu")
    with pytest.raises(ValueError, match=r"at \.d\.params\[0\].*expected"):
        restore_checkpoint(path, wide.init_state())
    bf16 = build_runner(cfg.replace(dtype="bfloat16", force_dtype=True),
                        device="cpu")
    with pytest.raises(ValueError, match="torch.bfloat16"):
        restore_checkpoint(path, bf16.init_state())
    other = build_runner(FedGANConfig(algo="flgan", **TINY), device="cpu")
    with pytest.raises(ValueError, match="does not match the template"):
        restore_checkpoint(path, other.init_state())


# ---------------------------------------------------------------------------
# resume through the CLI, every algorithm
# ---------------------------------------------------------------------------

RESUME_KNOBS = {
    "capgan": ["--num-servers", "2", "--epoch", "2"],
    "cglgan": ["--num-servers", "2", "--epoch", "2", "-E", "2",
               "--cloud-epoch", "3", "--segema", "0.1"],
    "mixgan": ["--num-servers", "2", "--epoch", "2", "-E", "2",
               "--cloud-epoch", "3", "--segema", "0.1"],
    "acgan": ["--num-servers", "2", "-E", "1", "--gossip", "delta",
              "--dropout-rate", "0.3"],
    "mdgan": ["-E", "1", "--d-swap", "shuffle", "--dropout-rate", "0.3"],
    "flgan": ["--epoch", "2", "--dropout-rate", "0.3"],
    "fegan": ["--epoch", "2", "--frac-workers", "0.5",
              "--dropout-rate", "0.3"],
}


def _argv(algo, out, name, rounds):
    return ["run", algo, "--dataset", "2dmg", "--num-workers", "4",
            "--num-class", "4", "--num-sample", "64", "--batch-size", "16",
            "--rounds", str(rounds), "--num-plt", "2", "--ckpt-every", "2",
            "--device", "cpu", "--out", str(out), "--name", name,
            *RESUME_KNOBS[algo]]


def _ticks(run_dir):
    with open(os.path.join(run_dir, "metrics.csv"), newline="") as f:
        return list(csv.DictReader(f))


class _Cut(Exception):
    """A run cut short, as a time limit cuts it."""


@pytest.mark.parametrize("algo", sorted(RESUME_KNOBS))
def test_resume_is_bit_exact(tmp_path, monkeypatch, algo):
    """A 6-round run against the same command cut after its checkpoint at
    round 2 and resumed with ``--resume ckpt_2`` in its run dir: the two
    ``ckpt_final`` are bit-equal, and the resumed run dir's metrics.csv
    holds the ticks at 2, 4 and 6 with the uninterrupted run's losses and
    ``wall_s`` running on across the resume.  Each algorithm with what a
    round reads of the host: the exchanges every round, dropout's survival
    draws, MD-GAN's shuffle, FeGAN's group schedule, CGL's cloud sync
    (counted down from ``num_communication``) at round 3."""
    assert cli.main(_argv(algo, tmp_path, "full", 6)) == 0
    log = RunDir.log

    def cut_after_round_2(self, record):
        if record["round"] > 2:
            raise _Cut()
        log(self, record)

    monkeypatch.setattr(RunDir, "log", cut_after_round_2)
    with pytest.raises(_Cut):
        cli.main(_argv(algo, tmp_path, "split", 6))
    monkeypatch.setattr(RunDir, "log", log)
    split = tmp_path / "split"
    assert (split / "ckpt_2").exists() and not (split / "ckpt_4").exists()
    assert cli.main(_argv(algo, tmp_path, "split", 6)
                    + ["--resume", str(split / "ckpt_2")]) == 0
    cfg = FedGANConfig(**json.loads((split / "config.json").read_text()))
    template = build_runner(cfg, load_partition(cfg), device="cpu") \
        .init_state()
    full = restore_checkpoint(str(tmp_path / "full" / "ckpt_final"),
                              template)
    resumed = restore_checkpoint(str(split / "ckpt_final"), template)
    assert full.t == resumed.t == 6
    _bit_equal(resumed, full)
    ticks, ref = _ticks(split), _ticks(tmp_path / "full")
    assert [t["round"] for t in ticks] == ["2", "4", "6"]
    for t, r in zip(ticks, ref):
        assert t["d_loss"] == r["d_loss"] and t["g_loss"] == r["g_loss"]
    walls = [float(t["wall_s"]) for t in ticks]
    assert walls[0] < walls[1] < walls[2]
    # metrics.jsonl logs the same continued clock
    jsonl = [json.loads(line) for line in
             (split / "metrics.jsonl").read_text().splitlines()]
    assert [float(t["wall_s"]) for t in jsonl] == walls


def test_resume_into_its_run_dir_logs_each_round_once(tmp_path):
    """A run that went past its checkpoint (to round 6, against
    ``ckpt_2``), resumed from it into the same run dir: the ticks after
    round 2 are logged once, from the resumed run, with the uninterrupted
    losses and ``wall_s`` running on from round 2's tick; ``ckpt_final``
    is the uninterrupted one's, bit for bit."""
    argv = _argv("capgan", tmp_path, "run", 6)
    assert cli.main(argv) == 0
    run = tmp_path / "run"
    cfg = FedGANConfig(**json.loads((run / "config.json").read_text()))
    template = build_runner(cfg, load_partition(cfg), device="cpu") \
        .init_state()
    first = restore_checkpoint(str(run / "ckpt_final"), template)
    ref = _ticks(run)
    assert cli.main(argv + ["--resume", str(run / "ckpt_2")]) == 0
    _bit_equal(restore_checkpoint(str(run / "ckpt_final"), template), first)
    ticks = _ticks(run)
    assert [t["round"] for t in ticks] == ["2", "4", "6"]
    assert ticks[0] == ref[0]
    for t, r in zip(ticks, ref):
        assert t["d_loss"] == r["d_loss"] and t["g_loss"] == r["g_loss"]
    walls = [float(t["wall_s"]) for t in ticks]
    assert walls[0] < walls[1] < walls[2]
    jsonl = [json.loads(line) for line in
             (run / "metrics.jsonl").read_text().splitlines()]
    assert [t["round"] for t in jsonl] == [2, 4, 6]
    assert [float(t["wall_s"]) for t in jsonl] == walls


# ---------------------------------------------------------------------------
# the run dir
# ---------------------------------------------------------------------------

def test_rundir_matches_reference_and_carries_the_clock(tmp_path):
    """config.json equals the reference's for the same config; reopening
    a run dir carries its ticks into metrics.csv / .xlsx, and a tick
    logged after the reopen continues ``wall_s`` and ``rounds_per_s``
    from the carried ticks (the reference restarts them)."""
    kw = dict(algo="flgan", dataset="2dmg", num_workers=4)
    rd = RunDir(str(tmp_path), "port", FedGANConfig(**kw))
    jrd = JaxRunDir(str(tmp_path), "ref", JaxConfig(**kw))
    assert json.loads((tmp_path / "port" / "config.json").read_text()) == \
        json.loads((tmp_path / "ref" / "config.json").read_text())
    jrd.close()
    rd.log({"round": 10, "kl": 0.5, "wall_s": 2.0, "rounds_per_s": 5.0})
    rd.log({"round": 20, "kl": 0.4, "wall_s": 4.0, "rounds_per_s": 5.0})
    rd.close()
    rd2 = RunDir(str(tmp_path), "port", FedGANConfig(**kw))
    # the resumed train call: 10 rounds in 1 s on its own clock
    rd2.log({"round": 30, "kl": 0.3, "wall_s": 1.0, "rounds_per_s": 10.0})
    rd2.close()
    rows = _ticks(tmp_path / "port")
    assert [r["round"] for r in rows] == ["10", "20", "30"]
    assert float(rows[2]["wall_s"]) == 5.0
    assert float(rows[2]["rounds_per_s"]) == 30 / 5.0
    sheet = zipfile.ZipFile(tmp_path / "port" / "metrics.xlsx").read(
        "xl/worksheets/sheet1.xml").decode()
    for v in ("0.5", "0.4", "0.3"):
        assert f"<v>{v}</v>" in sheet


@pytest.mark.parametrize("resume_round", [20, 0])
def test_rundir_drops_ticks_past_the_resumed_round(tmp_path, resume_round):
    """Reopened with ``resume_round``, a run dir drops the carried ticks
    past it from metrics.jsonl / .csv / .xlsx, and the next tick's clock
    continues from the last tick kept (from 0 where none is kept)."""
    rd = RunDir(str(tmp_path), "r")
    for t in (10, 20, 30):
        rd.log({"round": t, "kl": t / 100, "wall_s": t / 5,
                "rounds_per_s": 5.0})
    rd.close()
    rd = RunDir(str(tmp_path), "r", resume_round=resume_round)
    kept = [10, 20][:resume_round // 10]
    csv_path = tmp_path / "r" / "metrics.csv"
    assert ([int(r["round"]) for r in _ticks(tmp_path / "r")]
            if csv_path.exists() else []) == kept
    rd.log({"round": 30, "kl": 0.25, "wall_s": 1.0, "rounds_per_s": 10.0})
    rd.close()
    rows = _ticks(tmp_path / "r")
    assert [int(r["round"]) for r in rows] == kept + [30]
    wall = resume_round / 5 + 1.0
    assert float(rows[-1]["wall_s"]) == wall
    assert float(rows[-1]["rounds_per_s"]) == (resume_round + 10) / wall
    jsonl = [json.loads(line) for line in
             (tmp_path / "r" / "metrics.jsonl").read_text().splitlines()]
    assert [r["round"] for r in jsonl] == kept + [30]
    sheet = zipfile.ZipFile(tmp_path / "r" / "metrics.xlsx").read(
        "xl/worksheets/sheet1.xml").decode()
    assert "<v>0.3</v>" not in sheet and "<v>0.25</v>" in sheet


def test_rundir_tensorboard_scalars(tmp_path):
    """``tensorboard=True`` streams the numeric tick fields as scalars
    under <run>/tb/ where ``torch.utils.tensorboard`` imports."""
    pytest.importorskip("torch.utils.tensorboard")
    from tensorboard.backend.event_processing.event_accumulator import \
        EventAccumulator
    rd = RunDir(str(tmp_path), "tb", FedGANConfig(algo="flgan"),
                tensorboard=True)
    rd.log({"round": 10, "kl": 0.5, "note": "skipped"})
    rd.close()
    acc = EventAccumulator(rd.file("tb"))
    acc.Reload()
    (ev,) = acc.Scalars("kl")
    assert ev.step == 10 and abs(ev.value - 0.5) < 1e-6


# ---------------------------------------------------------------------------
# xlsx and images against the reference
# ---------------------------------------------------------------------------

def test_write_xlsx_members_equal_reference(tmp_path):
    records = [{"round": 1, "kl": 0.5, "name": "a<b>&c", "ok": True},
               {"round": 2, "kl": float("nan"), "extra": float("inf")},
               {"round": 3, "kl": -1e-30, "name": "ü"}]
    mine, ref = tmp_path / "port.xlsx", tmp_path / "ref.xlsx"
    write_xlsx(str(mine), records)
    jax_write_xlsx(str(ref), records)
    with zipfile.ZipFile(mine) as a, zipfile.ZipFile(ref) as b:
        assert a.namelist() == b.namelist()
        for name in b.namelist():
            assert a.read(name) == b.read(name), name


@pytest.mark.parametrize("shape,normalize", [((30, 1, 28, 28), True),
                                             ((7, 12, 9), False),
                                             ((100, 1, 32, 32), True)])
def test_save_image_grid_pixels_equal_reference(tmp_path, shape, normalize):
    rng = np.random.default_rng(0)
    lo = -1.0 if normalize else 0.0
    imgs = rng.uniform(lo, 1.0, shape).astype(np.float32)
    imaging.save_image_grid(imgs, str(tmp_path / "p.png"),
                            normalize=normalize)
    jimaging.save_image_grid(imgs, str(tmp_path / "r.png"),
                             normalize=normalize)
    got = Image.open(tmp_path / "p.png")
    ref = Image.open(tmp_path / "r.png")
    assert got.mode == ref.mode == "L" and got.size == ref.size
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


def test_save_scatter_2d_png(tmp_path):
    """A valid RGB PNG of the stated size; real points faint, generated
    points solid, points outside the [-1.1, 1.1] frame left out."""
    real = np.array([[0.0, 0.0], [5.0, 5.0]])
    gen = np.array([[-1.0, 1.0]])
    path = str(tmp_path / "s.png")
    imaging.save_scatter_2d(path, real, gen)
    im = Image.open(path)
    side = imaging.SCATTER_SIDE
    assert im.format == "PNG" and im.mode == "RGB" and im.size == (side,
                                                                   side)
    px = np.asarray(im).astype(int)
    at = lambda x, y: px[int((1.1 - y) / 2.2 * side),
                         int((x + 1.1) / 2.2 * side)]
    assert (255 - at(0.0, 0.0)).max() < 60            # faint: alpha 0.2
    assert abs(at(-1.0, 1.0) - np.array([255, 127, 14])).max() < 60
    assert (px == 255).all(axis=2).sum() == side * side - 8
    imaging.save_scatter_2d(str(tmp_path / "r.png"), real)
    assert Image.open(tmp_path / "r.png").size == (side, side)


# ---------------------------------------------------------------------------
# the probe and the imports
# ---------------------------------------------------------------------------

def test_probe_error_timeout_and_cpu():
    """Without a card the probe reports an error, without hanging; a tiny
    timeout reports ``timeout``; the host answers when asked."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the no-card error cannot show")
    status, info = backend_probe.probe(timeout=120)
    assert status == "error" and "cuda" in info.lower()
    assert backend_probe.probe(timeout=0.05) == ("timeout", None)
    status, info = backend_probe.probe(timeout=120, device="cpu")
    assert status == "ok" and info["device_kind"] == "cpu"


def test_cli_and_utils_import_no_jax():
    """In a fresh interpreter: the CLI loads no torch at import, and the
    CLI and the utils (serving and migration too) load no ``jax`` and
    nothing of ``cglgan_tpu``."""
    code = (
        "import sys\n"
        "import cglgan_tpu_torch.cli\n"
        "assert 'torch' not in sys.modules, 'cli imports torch'\n"
        "import cglgan_tpu_torch.utils.checkpoint, "
        "cglgan_tpu_torch.utils.logging, cglgan_tpu_torch.utils.xlsx, "
        "cglgan_tpu_torch.utils.imaging, "
        "cglgan_tpu_torch.utils.backend_probe, "
        "cglgan_tpu_torch.utils.profiling, cglgan_tpu_torch.utils.export, "
        "cglgan_tpu_torch.utils.torch_import\n"
        "bad = [m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'cglgan_tpu' or "
        "m.startswith('cglgan_tpu.')]\n"
        "assert not bad, bad\n"
        "print('CLEAN')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert "CLEAN" in out.stdout, out.stderr[-2000:]

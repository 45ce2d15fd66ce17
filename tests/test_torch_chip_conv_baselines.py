"""``chip_smoke.py``'s ``conv_baselines`` and ``conv_bf16`` phases on the
card.

The conv LSGAN pair on MD-GAN, AC-GAN, FL-GAN and FeGAN at full width, run
as ``python3 chip_smoke.py --phases conv_baselines``, and the conv pair in
bfloat16 on the three families, ``--phases conv_bf16``.  Needs a CUDA card
and skips without one; this file imports no JAX (the phases import none
either).
"""
import json
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.cuda
def test_chip_smoke_conv_baselines():
    """``chip_smoke.py --phases conv_baselines`` on the card: it exits 0,
    runs the four algorithms at full width and no kernel launches on a
    conv path."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: chip_smoke.py drives the port on one")
    out = subprocess.run([sys.executable, "chip_smoke.py", "--phases",
                          "conv_baselines"], cwd=ROOT, capture_output=True,
                         text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    lines = [json.loads(x) for x in out.stdout.splitlines()
             if x.startswith("{")]
    runs = [x for x in lines
            if x.get("phase") == "conv_baselines" and "config" in x]
    assert {r["config"]["algo"] for r in runs} == {"mdgan", "acgan",
                                                   "flgan", "fegan"}
    assert all(r["config"]["num_workers"] == 16 and r["config"]["conv"]
               for r in runs)
    summary = [x for x in lines if "launches" in x and "seconds" in x
               and x.get("phase") == "conv_baselines"]
    assert len(summary) == 1
    assert not any(n for run in summary[0]["launches"].values()
                   for n in run.values())


@pytest.mark.cuda
def test_chip_smoke_conv_bf16():
    """``chip_smoke.py --phases conv_bf16`` on the card: it exits 0, holds
    the bf16 conv rounds card against CPU, runs the flagship in float32
    and bf16 and the other families in bf16 at full width, and no kernel
    launches on a conv path."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: chip_smoke.py drives the port on one")
    out = subprocess.run([sys.executable, "chip_smoke.py", "--phases",
                          "conv_bf16"], cwd=ROOT, capture_output=True,
                         text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    lines = [json.loads(x) for x in out.stdout.splitlines()
             if x.startswith("{")]
    refs = [x for x in lines if x.get("phase") == "reference"
            and x.get("dtype") == "bfloat16"]
    assert len(refs) == 4
    summary = [x for x in lines if x.get("phase") == "conv_bf16"
               and "runs" in x]
    assert len(summary) == 1
    runs = summary[0]["runs"]
    assert [r["config"].get("dtype", "float32") for r in runs[:2]] == \
        ["float32", "bfloat16"]
    assert {r["config"]["algo"] for r in runs} == {"cglgan", "capgan",
                                                   "mdgan", "acgan", "flgan"}
    assert not any(n for run in summary[0]["launches"].values()
                   for n in run.values())

"""Bounded device probe.

Port of ``cglgan_tpu/utils/backend_probe.py``.  A device whose
initialisation hangs would hang any in-process call that touches it, so
the probe initialises the device in a killable subprocess instead: the
child imports torch, makes and synchronises one tensor on the device and
prints what it found as one JSON line.  Used by ``tpufed-torch doctor``.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from typing import Any, Optional, Tuple

_PROBE_CODE = r"""
import json, os, subprocess
import torch
dev = os.environ.get("CGLGAN_PROBE_DEVICE") or "cuda"
info = {"platform": dev, "torch": torch.__version__}
if dev == "cuda":
    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is False: no CUDA "
                         "device or driver")
    torch.zeros(1, device="cuda").add_(1)
    torch.cuda.synchronize()
    info.update(device_kind=torch.cuda.get_device_name(0),
                count=torch.cuda.device_count(), cuda=torch.version.cuda)
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        if smi.returncode == 0:
            info["nvidia_smi"] = smi.stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        pass
elif dev == "cpu":
    torch.zeros(1).add_(1)
    info.update(device_kind="cpu", count=1)
else:
    raise SystemExit(f"unsupported device {dev!r}")
# the cards a mesh can take (``--devices``), whichever device was probed
info["cuda_devices"] = (torch.cuda.device_count()
                        if torch.cuda.is_available() else 0)
print(json.dumps(info))
"""


def probe(timeout: float = 60,
          device: Optional[str] = None) -> Tuple[str, Any]:
    """Initialise ``device`` (default ``cuda``) in a killable subprocess.

    Returns ``(status, info)``: ``("ok", {platform, device_kind, count,
    torch, cuda_devices[, cuda, nvidia_smi]})`` (``cuda_devices``: the
    CUDA devices present, 0 without any) (``nvidia_smi``: the lines of
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``,
    where it answers), ``("error", message)`` for a fast failure (no
    device, no driver, an import error), or ``("timeout", None)`` when
    initialisation took longer than ``timeout`` seconds.
    """
    env = dict(os.environ)
    if device:
        env["CGLGAN_PROBE_DEVICE"] = device
    try:
        out = subprocess.run([sys.executable, "-c", _PROBE_CODE],
                             capture_output=True, text=True,
                             timeout=timeout, env=env)
    except subprocess.TimeoutExpired:
        return "timeout", None
    if out.returncode == 0:
        for line in reversed(out.stdout.strip().splitlines()):
            try:
                return "ok", json.loads(line)
            except json.JSONDecodeError:
                continue
        return "error", "probe printed no parseable device report"
    tail = out.stderr.strip().splitlines()
    return "error", (tail[-1][:200] if tail
                     else f"probe exited {out.returncode} with no stderr")

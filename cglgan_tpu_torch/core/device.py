"""Device selection for the port's entry points.

Every entry point runs on the card unless the caller asks for the CPU: the
default is ``cuda`` and a missing card is an error, never a silent CPU run.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``.  Raises if a CUDA device is asked for and none
    is present; only an explicit ``"cpu"`` runs on the host."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "cglgan_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the host explicitly")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev

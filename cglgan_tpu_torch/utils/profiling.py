"""Where a round's time goes on the card: ``torch.profiler`` over a few
rounds, summed by device kernel.

Device time is the sum of every kernel's own time (one stream, so kernels do
not overlap); the busy share is that sum over the wall time of the profiled
window, which the profiler itself lengthens on the host, so the share is a
lower bound.  The sums read the profiler's raw device events, not
``key_averages()``: building its event tree takes minutes for a round of
~250 000 launches (the ragged FedAvg sweep on MNIST shapes).
``chip_smoke.py`` holds the two to the same names, counts and times on one
round.  Used by ``chip_smoke.py``.  ``trace`` writes a block's trace for
the CLI's ``run --profile`` (the reference's ``jax.profiler`` trace,
``cglgan_tpu/utils/profiling.py``).
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Dict, Tuple

import torch


@contextlib.contextmanager
def trace(logdir: str, device: torch.device):
    """``torch.profiler`` over the block (host and, on the card, device
    activity), written as a Chrome trace to ``<logdir>/trace.json``."""
    from torch.profiler import ProfilerActivity, profile

    cuda = device.type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
        if cuda:
            torch.cuda.synchronize(device)
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def device_kernel_sums(prof) -> Dict[str, Tuple[float, int]]:
    """Per device kernel name: (µs, launches), from a finished profiler's
    raw device events."""
    sums: Dict[str, list] = {}
    for ev in prof.profiler.kineto_results.events():
        hidden = getattr(ev, "is_hidden_event", lambda: False)()
        if ev.device_type() != torch.autograd.DeviceType.CUDA or hidden:
            continue
        acc = sums.setdefault(ev.name(), [0.0, 0])
        acc[0] += ev.duration_ns() / 1e3
        acc[1] += 1
    return {name: (us, n) for name, (us, n) in sums.items() if us > 0}


def profile_rounds(runner, state, rounds: int, top: int = 8
                   ) -> Dict[str, Any]:
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(rounds):
            state, _ = runner.round_fn(state)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [(name, us, n)
               for name, (us, n) in device_kernel_sums(prof).items()]
    kernels.sort(key=lambda k: -k[1])
    device_us = sum(k[1] for k in kernels)
    return {"rounds": rounds, "wall_ms_per_round": wall * 1e3 / rounds,
            "device_ms_per_round": device_us / 1e3 / rounds,
            "device_busy_share": device_us / 1e6 / wall,
            "kernel_launches_per_round": sum(k[2] for k in kernels) / rounds,
            "top": [{"kernel": k[0][:80], "ms_per_round": k[1] / 1e3 / rounds,
                     "calls_per_round": k[2] / rounds}
                    for k in kernels[:top]]}

"""Runner: the contract every algorithm implements, and the training loop.

Port of ``cglgan_tpu/algos/runner.py``.  A round is one Python call
``round_fn(state) -> (state, metrics)`` whose work is queued on the device;
``train`` loops rounds and keeps each tick's metric sums on the device, so
the host waits for the device once per tick (the counterpart of the
reference's ``scan_rounds`` chunk means), and then for the evaluator's
metrics, if any.  On a clients mesh every rank runs the rounds (the
metrics are already the means over every client) and rank 0 alone
evaluates, on its replicated G; with the G split over a ``model`` axis,
every rank joins one gather of the G to rank 0 a tick first.  Capturing
rounds into CUDA graphs is a later ROADMAP item (queue 1 item 7).
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, NamedTuple, Optional

import torch

from cglgan_tpu_torch.core import meshes


class Runner(NamedTuple):
    cfg: Any
    part: Any
    init_state: Callable[[], Any]                    # () -> FedState
    round_fn: Callable[..., Any]                     # state -> (state, metrics)
    sample: Callable[[Any, int], torch.Tensor]       # (state, n) -> samples
    gen: Optional[Callable[[Any, torch.Tensor], torch.Tensor]] = None
    gen_batch_multiple: int = 1
    gen_client: Optional[Callable[[Any, torch.Tensor, int],
                                  torch.Tensor]] = None
    device: Optional[torch.device] = None
    extras: Optional[Dict[str, Any]] = None          # e.g. fegan sk, schedule
    mesh: Any = None                                 # core.meshes.Mesh
    # the sharded fields of the state: {dotted path: (spec, groups)}
    # (core.meshes.place_state)
    layout: Optional[Dict[str, tuple]] = None


def train(runner: Runner,
          rounds: Optional[int] = None,
          eval_every: Optional[int] = None,
          eval_n: Optional[int] = None,
          on_tick: Optional[Callable[..., None]] = None,
          state=None,
          evaluator=None) -> Dict[str, Any]:
    """Run ``rounds`` rounds with a metrics tick every ``eval_every``.

    Returns {"state": final_state, "history": [tick dicts]}; each tick
    carries the round metrics averaged over its interval, the absolute
    ``round``, ``wall_s`` and ``rounds_per_s``, and the workload's eval
    metrics.  ``evaluator``: None (the default, as in the reference) builds
    ``evalx.evaluator.make_evaluator`` on the runner's device with
    ``eval_n`` samples a tick: KL / DS / mode coverage on 2DMG, FID /
    Inception Score on images (the probe trains here); False skips
    evaluation; a callable ``(runner, state) -> dict`` adds its metrics.
    ``on_tick`` is called as ``on_tick(round, tick, state)`` after each
    tick, ``round`` the absolute round counter, as the reference's
    (``cglgan_tpu/algos/runner.py:147-148``).  On a mesh every rank calls
    ``train``, and with the same kind of ``evaluator`` (False, or not);
    the evaluator runs on rank 0 only, so only its ticks carry the eval
    metrics.  With the G split over a ``model`` axis (``layout["g"]``) the
    evaluator takes the state with the whole G."""
    cfg = runner.cfg
    rounds = rounds if rounds is not None else cfg.num_communication
    eval_every = eval_every if eval_every is not None else cfg.num_plt
    eval_every = max(1, min(eval_every, rounds))
    if state is None:
        state = runner.init_state()
    # a G split over a model axis (``layout["g"]``, set by init_state)
    layout = runner.layout or {}
    split_g = {"g": layout["g"]} if "g" in layout else {}
    gather_g = bool(split_g) and evaluator is not False
    if runner.mesh is not None and not runner.mesh.lead:
        evaluator = False
    if evaluator is None:
        from cglgan_tpu_torch.evalx.evaluator import make_evaluator
        evaluator = make_evaluator(cfg, runner.part, eval_n=eval_n,
                                   device=runner.device)

    history: List[Dict[str, Any]] = []
    t0 = time.perf_counter()
    done = 0
    while done < rounds:
        interval = min(eval_every, rounds - done)     # never overshoot
        acc: Optional[Dict[str, torch.Tensor]] = None
        for _ in range(interval):
            state, m = runner.round_fn(state)
            acc = dict(m) if acc is None else \
                {key: acc[key] + m[key] for key in acc}
        keys = sorted(acc)      # the reference's order (jax.tree sorts keys)
        means = (torch.stack([acc[key] for key in keys]) / interval).tolist()
        done += interval
        tick: Dict[str, Any] = dict(zip(keys, means))
        tick["round"] = int(state.t)
        # every rank joins the gather; the lead alone evaluates
        seen = meshes.gather_state(state, runner.mesh, split_g) \
            if gather_g else state
        if evaluator:
            tick.update(evaluator(runner, seen))
        tick["wall_s"] = time.perf_counter() - t0
        tick["rounds_per_s"] = done / tick["wall_s"]
        history.append(tick)
        if on_tick is not None:
            on_tick(tick["round"], tick, state)
    return {"state": state, "history": history}

"""Runner: the contract every algorithm implements, and the training loop.

Port of ``cglgan_tpu/algos/runner.py``.  A round is one Python call
``round_fn(state) -> (state, metrics)`` whose work is queued on the device.

``train`` runs a runner's rounds one of two ways, by a fixed rule: where
the runner has a ``program`` (the MLP runners without a mesh of the CGL
family, CAP-GAN, CGL-GAN and Mix-G, and of the MD-GAN family, MD-GAN and
AC-GAN; float32 and bf16, every epoch), through it, the counterpart of the
reference's ``scan_rounds``; every other runner (conv models, the FedAvg
family, any runner on a mesh) by calling ``round_fn`` once a round.
Either way a tick's metric sums stay on the device and the host waits for
the device once a tick, and then for the evaluator's metrics, if any.

``RoundProgram``: a round on static buffers (the state, a device round
counter, the metric sums) that reads its key and window starts from the
``RoundKeys`` tables at the device counter.  On a card it is captured once
into a CUDA graph, after ``WARMUP_ROUNDS`` eager rounds on the capture
stream, and replayed once a round; one capture serves every piece length,
since the graph is one round.  On the CPU the same round body runs
eagerly, a call a round.  A tick is cut into pieces by the reference's rule
(``core/prng.py`` ``scan_piece``: ``cfg.scan_rounds``, or about 10 000
local steps): a piece fills the tables for its rounds and sets the counter,
then runs its rounds.  A capture or replay that fails raises: such a
runner has no other loop.

State semantics, the reference's (``donate=False``): ``train`` copies the
caller's state into the static buffers and never changes it; the state it
returns is a copy that no later call changes.  The state handed to
``on_tick`` and the evaluator lies on the static buffers and is valid only
during that call (the CLI saves its checkpoint at once).

On a clients mesh every rank runs the rounds (the metrics are already the
means over every client) and rank 0 alone evaluates, on its replicated G;
with the G split over a ``model`` axis, every rank joins one gather of the
G to rank 0 a tick first.
"""
from __future__ import annotations

import gc
import time
from typing import Any, Callable, Dict, List, NamedTuple, Optional

import torch

from cglgan_tpu_torch.core import meshes, prng
from cglgan_tpu_torch.utils.tree import tree_leaves, tree_unflatten

WARMUP_ROUNDS = 2     # eager rounds on the capture stream before a capture
captures = 0          # CUDA graphs captured by RoundProgram
replays = 0           # their replays (rounds run as a graph)


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
    # the round as a RoundProgram, where ``train`` runs it so (module
    # docstring: the CGL and MD-GAN families' MLP runners without a mesh);
    # None: ``train`` calls ``round_fn`` once a round
    program: Any = None


def _parts(state) -> list:
    """A FedState's tensors as one tree: the G's and the D's params, BN
    state and Adam state, then Lambda."""
    return [[n.params, n.bn, n.opt.count, n.opt.mu, n.opt.nu]
            for n in (state.g, state.d)] + [state.lam]


def state_leaves(state) -> List[torch.Tensor]:
    return tree_leaves(_parts(state))


def state_from_leaves(like, leaves):
    """``like`` (a FedState) with its tensors replaced by ``leaves``, in
    ``state_leaves`` order."""
    g, d, lam = tree_unflatten(_parts(like), list(leaves))
    net = lambda old, p: old._replace(
        params=p[0], bn=p[1],
        opt=old.opt._replace(count=p[2], mu=p[3], nu=p[4]))
    return like._replace(g=net(like.g, g), d=net(like.d, d), lam=lam)


def _launch_counters() -> list:
    """The kernel wrappers whose ``launches`` a replay adds to."""
    from cglgan_tpu_torch.ops import (fused_adam, fused_dstep, fused_sweep,
                                      threefry)
    return [fused_dstep, threefry, fused_sweep, fused_adam]


class RoundProgram:
    """A round on static buffers (module docstring).  ``round_at(state, t,
    key, starts) -> (state, metrics)``: one round from the device round
    counter ``t`` (int64, 0-dim), its key ``(2,)`` and its window starts
    (int32 ``(steps,)``), reading no tensor on the host; ``keys``: a
    ``RoundKeys`` whose tables hold the longest piece ``train`` asks for.

    ``capture_s`` (warm-up included) and ``pool_bytes`` (device memory
    reserved during the capture: the graph's pool) are set by the capture;
    ``per_replay`` maps each kernel wrapper to the launches one replay
    makes, which the replay adds to its ``launches`` (the warm-up and the
    capture count none)."""

    def __init__(self, round_at: Callable, keys: prng.RoundKeys, device):
        self.round_at, self.keys = round_at, keys
        self.device = torch.device(device)
        self.static = self.t = self.slot = self.sums = None
        self.metric_keys: Optional[List[str]] = None
        self.graph = self.stream = None
        self.per_replay: Dict[Any, int] = {}
        self.capture_s = self.pool_bytes = None

    def load(self, state) -> None:
        """Copy ``state``'s tensors into the static buffers (made from it
        at the first call); the metric sums to 0."""
        leaves = [x.detach() for x in state_leaves(state)]
        if self.static is None:
            self.static = state_from_leaves(state,
                                            [x.clone() for x in leaves])
            self.t = torch.zeros((), dtype=torch.int64, device=self.device)
            self.slot = torch.zeros((1,), dtype=torch.int64,
                                    device=self.device)
        static = state_leaves(self.static)
        if [(x.shape, x.dtype) for x in static] != \
                [(x.shape, x.dtype) for x in leaves]:
            raise ValueError("train: the state's tensors differ from the "
                             "runner's captured round's")
        pairs = [(a, b) for a, b in zip(static, leaves) if a is not b]
        if pairs:
            torch._foreach_copy_(*map(list, zip(*pairs)))
        if self.sums is not None:
            self.sums.zero_()

    def view(self, t: int):
        """The state on the static buffers, at round ``t``: valid until
        the next round or ``load``."""
        return self.static._replace(t=t)

    def copy(self, t: int):
        """A copy of the static state, at round ``t``."""
        return state_from_leaves(self.static, [
            x.clone() for x in state_leaves(self.static)])._replace(t=t)

    def take_sums(self) -> torch.Tensor:
        """The metric sums since the last take, in ``metric_keys`` order;
        the buffer back to 0."""
        sums = self.sums.clone()
        self.sums.zero_()
        return sums

    def _outputs(self):
        """The round at the device counter: its new state and metrics."""
        key = self.keys.keys.index_select(0, self.slot)[0]
        starts = self.keys.starts_of.index_select(0, self.slot)[0]
        new, m = self.round_at(self.static, self.t, key, starts)
        if self.sums is None:
            # the reference's metric order (jax.tree sorts keys)
            self.metric_keys = sorted(m)
            self.sums = torch.zeros((len(m),), dtype=torch.float32,
                                    device=self.device)
        return new, m

    def _step(self) -> None:
        """One round: the outputs copied into the static buffers, the
        metrics added to the sums, the counters advanced.  What the graph
        holds, and on the CPU what runs."""
        new, m = self._outputs()
        static = state_leaves(self.static)
        held = {x.untyped_storage().data_ptr() for x in static}
        pairs = []
        for a, b in zip(static, state_leaves(new)):
            if b is a:
                continue                          # a leaf the round kept
            if b.untyped_storage().data_ptr() in held:
                raise RuntimeError("a round output is a view of the state "
                                   "it read")
            pairs.append((a, b))
        torch._foreach_copy_(*map(list, zip(*pairs)))
        self.sums.add_(torch.stack([m[k].float() for k in self.metric_keys]))
        self.t.add_(1)
        self.slot.add_(1)

    def _capture(self) -> None:
        """``_step`` captured once into a CUDA graph on a side stream,
        after ``WARMUP_ROUNDS`` rounds' outputs computed on it (they make
        the kernels' work space and the libraries' handles of that stream
        before the capture records them)."""
        global captures
        counters = _launch_counters()
        before = [mod.launches for mod in counters]
        t0 = time.perf_counter()
        side = torch.cuda.Stream(self.device)
        try:
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):
                for _ in range(WARMUP_ROUNDS):
                    self._outputs()
            torch.cuda.current_stream(self.device).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            # a graph freed while this one records ends the capture (an
            # earlier runner's, left in a reference cycle, goes whenever
            # the collector runs): collect now, and not during the capture
            gc.collect()
            # the capture empties the allocator's cache first; so does this,
            # so that what it reserves after is the graph's pool
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved(self.device)
            at_capture = [mod.launches for mod in counters]
            collecting = gc.isenabled()
            gc.disable()
            try:
                with torch.cuda.graph(graph, stream=side):
                    self._step()
            finally:
                if collecting:
                    gc.enable()
            self.per_replay = {
                mod: mod.launches - n
                for mod, n in zip(counters, at_capture)
                if mod.launches != n}
            self.pool_bytes = torch.cuda.memory_reserved(self.device) \
                - reserved
        finally:
            # the warm-up and the capture ran no round of the run
            for mod, n in zip(counters, before):
                mod.launches = n
        # the stream is kept with the graph: the kernels' work space is
        # keyed by it (``ops/fused_dstep.py`` ``_scratch``)
        self.graph, self.stream = graph, side
        self.capture_s = time.perf_counter() - t0
        captures += 1

    def run(self, t: int, n: int) -> None:
        """Rounds ``t .. t + n - 1`` (a piece): the tables filled for them,
        the counter set, then one replay (CUDA) or one eager round (CPU) a
        round.  Nothing here reads a tensor on the host."""
        global replays
        self.keys.fill(t, n)
        self.t.fill_(t)
        self.slot.zero_()
        if self.device.type != "cuda":
            for _ in range(n):
                self._step()
            return
        if self.graph is None:
            self._capture()
        for _ in range(n):
            self.graph.replay()
            for mod, k in self.per_replay.items():
                mod.launches += k
        replays += n


def _eager_rounds(runner: Runner, state, n: int):
    """``n`` rounds of ``round_fn``, one call a round: the new state and
    the metric sums (sorted keys, the reference's order)."""
    acc: Optional[Dict[str, torch.Tensor]] = None
    for _ in range(n):
        state, m = runner.round_fn(state)
        acc = dict(m) if acc is None else \
            {key: acc[key] + m[key] for key in acc}
    keys = sorted(acc)          # the reference's order (jax.tree sorts keys)
    return state, keys, torch.stack([acc[key] for key in keys])


def _program_rounds(program: RoundProgram, t: int, n: int, piece: int):
    """``n`` rounds from round ``t`` through ``program``, in pieces of at
    most ``piece``: the state on its buffers and the metric sums."""
    left = n
    while left > 0:
        step = min(piece, left)
        program.run(t, step)
        t, left = t + step, left - step
    return program.view(t), program.metric_keys, program.take_sums()


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
    evaluator takes the state with the whole G.

    Through a ``program`` (module docstring) the caller's ``state`` is
    copied in and never changed, the returned state is a copy that no
    later call changes, and the state handed to ``on_tick`` and the
    evaluator is valid only during that call."""
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
    program = runner.program
    if program is not None:
        program.load(state)
        piece = prng.scan_piece(cfg, program.keys.max_len, eval_every)

    history: List[Dict[str, Any]] = []
    t0 = time.perf_counter()
    done = 0
    while done < rounds:
        interval = min(eval_every, rounds - done)     # never overshoot
        if program is None:
            state, keys, sums = _eager_rounds(runner, state, interval)
        else:
            state, keys, sums = _program_rounds(program, state.t, interval,
                                                piece)
        means = (sums / interval).tolist()
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
    if program is not None:
        state = program.copy(state.t)
    return {"state": state, "history": history}

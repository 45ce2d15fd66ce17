"""Every algorithm a few rounds on a clients mesh.

``dryrun_multichip(n, device="cpu")`` is the counterpart of the
reference's ``dryrun_multichip`` (``__graft_entry__.py:137-231``): its
configs on an n-rank clients mesh (``core/meshes.py``), 2 clients a rank,
and at even n its composed DP x TP config, CAP-GAN on an ``(n / 2, 2)``
``(clients, model)`` mesh of the same ranks, each checked for ``state.t ==
rounds`` and finite metrics.  ``run_cases`` is the function every rank
runs; the mesh tests and ``chip_smoke.py`` spawn it with cases of their
own.

    python -m cglgan_tpu_torch.utils.dryrun 4 --device cpu
"""
from __future__ import annotations

import math
import time
from typing import Dict, List, Optional

import torch

from cglgan_tpu_torch.core import meshes


def multichip_cases(n: int) -> List[dict]:
    """The reference's dryrun configs at ``n`` ranks (its 2-server ones
    where ``n`` is even), 2DMG at tiny shapes, 2 clients a rank."""
    base = dict(dataset="2dmg", num_workers=2 * n, num_class=4,
                num_sample=64, batch_size=16, iid=1, num_communication=2)
    case = lambda name, rounds, **kw: {"name": name, "rounds": rounds,
                                       "cfg": {**base, **kw}}
    cases = [
        case("capgan", 2, algo="capgan", num_servers=1, epoch=1),
        case("mdgan E=1", 2, algo="mdgan", num_servers=1, epoch=1, E=1,
             dropout_rate=0.25),
        case("fegan", 2, algo="fegan", num_servers=1, epoch=1,
             frac_workers=0.5),
        case("flgan ragged", 1, algo="flgan", num_servers=1, epoch=1,
             local_sweep="epochs")]
    if n % 2 == 0:
        cases += [
            case("cglgan", 1, algo="cglgan", num_servers=2, cloud_epoch=1),
            case("acgan E=1", 2, algo="acgan", num_servers=2, epoch=1, E=1),
            case("acgan E=1 delta", 2, algo="acgan", num_servers=2,
                 epoch=1, E=1, gossip="delta"),
            case("mixgan", 1, algo="mixgan", num_servers=2,
                 cloud_epoch=1),
            # D state over `clients`, the G's columns over `model`
            case("capgan dp x tp", 2, algo="capgan", num_servers=1,
                 epoch=1, model_shards=2)]
    return cases


def run_cases(mesh: Optional[meshes.Mesh], cases: List[dict],
              device=None) -> Dict[str, dict]:
    """Each case ``{"name", "cfg": FedGANConfig fields, "rounds"[,
    "warmup", "unsharded", "probe"]}``: its partition from the config, its
    runner on ``mesh`` (with a ``model`` axis of the config's
    ``model_shards``: ``Mesh.with_model_shards``), or unsharded on
    ``device``, ``warmup`` then ``rounds`` rounds from ``init_state()``.
    A case marked ``"unsharded"`` runs without the mesh on rank 0's
    device, and on no other rank: a mesh run and the unsharded run then
    time in one process, in turns.  A ``"probe"`` case runs no round:
    ``g_probe`` of its config on the mesh.
    Returns {name: {"metrics": per-round floats,
    "collectives": per-round recorder logs, "seconds": the timed rounds'
    wall time, "threefry_launches": in the timed rounds, "t", and on rank
    0 (or unsharded) "state": the whole state, on the host, and with
    ``model_shards > 1`` "placed_init": whether the runner's own
    ``init_state()`` is the unsharded one's placed, and "round_trip":
    whether ``gather_state(place_state(x))`` is ``x``, bit for bit}}."""
    from cglgan_tpu_torch.algos.registry import build_runner, load_partition
    from cglgan_tpu_torch.core.config import FedGANConfig
    from cglgan_tpu_torch.ops import threefry as tk
    from cglgan_tpu_torch.utils.checkpoint import _plain

    out, parts = {}, {}
    for case in cases:
        on, where = mesh, device
        cfg = FedGANConfig(**case["cfg"])
        if case.get("unsharded") and mesh is not None:
            if not mesh.lead:
                continue
            on, where = None, mesh.device
        elif mesh is not None:
            on = mesh.with_model_shards(cfg.model_shards)
        if case.get("probe"):
            out[case["name"]] = g_probe(cfg, on)
            continue
        key = repr(sorted(case["cfg"].items()))       # a case run again
        if key not in parts:
            parts[key] = load_partition(cfg)
        runner = build_runner(cfg, parts[key], device=where, mesh=on)
        dev = runner.device
        sync = (lambda: torch.cuda.synchronize(dev)) \
            if dev.type == "cuda" else (lambda: None)
        state = runner.init_state()
        checks = _tp_checks(cfg, parts[key], runner, state) \
            if meshes.model_shards_of(on) > 1 else {}
        for _ in range(case.get("warmup", 0)):
            state, _ = runner.round_fn(state)
        logs, metrics = [], []
        if on is not None:
            on.recorder.take()
        sync()
        launched = tk.launches
        t0 = time.perf_counter()
        for _ in range(case["rounds"]):
            state, m = runner.round_fn(state)
            metrics.append(m)
            if on is not None:
                logs.append(on.recorder.take())
        sync()
        res = {"seconds": time.perf_counter() - t0,
               "threefry_launches": tk.launches - launched, "t": state.t,
               "metrics": [{k: float(v) for k, v in m.items()}
                           for m in metrics],
               "collectives": logs}
        whole = meshes.gather_state(state, on, runner.layout or {})
        if whole is not None:
            res["state"] = _plain(whole)
            res.update(checks)
        out[case["name"]] = res
    return out


def _pairs(tree) -> list:
    """(path, tensor) of every tensor of a state, on the host, in path
    order."""
    from cglgan_tpu_torch.utils.checkpoint import _plain
    out = []
    meshes.map_paths(_plain(tree), lambda p, x: out.append((p, x)))
    return sorted(out, key=lambda px: px[0])


def _equal(a, b) -> bool:
    """Two states bit for bit."""
    fa, fb = _pairs(a), _pairs(b)
    return len(fa) == len(fb) and all(
        pa == pb and x.dtype == y.dtype and torch.equal(x, y)
        for (pa, x), (pb, y) in zip(fa, fb))


def _tp_checks(cfg, part, runner, state) -> dict:
    """On a ``model`` axis: the runner's own init against the unsharded
    runner's init placed by the runner's layout, and that init placed and
    gathered back (a collective: every rank calls it)."""
    from cglgan_tpu_torch.algos.registry import build_runner
    whole = build_runner(cfg, part, device=runner.device).init_state()
    placed = meshes.place_state(whole, runner.mesh, runner.layout)
    back = meshes.gather_state(placed, runner.mesh, runner.layout)
    return {"placed_init": _equal(placed, state),
            "round_trip": back is not None and _equal(back, whole)}


def g_probe(cfg, mesh: meshes.Mesh, batch: int = 8) -> Optional[dict]:
    """The config's G, drawn whole from its seed, forward (train mode) and
    the gradient of ``mean(y ** 2)`` on latents ``(S, batch, zdim)`` from
    the seed: whole on this rank, and column-parallel on ``mesh``'s
    ``model`` axis (``models/tp.py``), its new BN state and gradient
    blocks gathered.  On the lead rank {"out", "bn", "grads"} of the
    parallel run and the same of the whole one under "whole_*", on the
    host; None elsewhere (``tests/test_tensor_parallel.py``'s check)."""
    from cglgan_tpu_torch.algos import common
    from cglgan_tpu_torch.core import prng, threefry
    from cglgan_tpu_torch.core.dtypes import torch_dtype
    from cglgan_tpu_torch.models.zoo import models_for_config
    from cglgan_tpu_torch.utils.checkpoint import _plain
    from cglgan_tpu_torch.utils.tree import tree_unflatten
    dev, tp, dtype = mesh.device, mesh.tp, torch_dtype(cfg)
    g_model = models_for_config(cfg)[0]
    S = cfg.num_servers
    keys = threefry.split(prng.role_key(cfg.seed, prng.ROLE_INIT_G, dev), S)
    params, bn = g_model.init(keys, dtype)
    z = threefry.normal(prng.role_key(cfg.seed, prng.ROLE_NOISE_G, dev),
                        (S, batch, cfg.latent_dim)).to(dtype)

    def run(p, b, axis):
        p, leaves = common.with_grad(p)
        with torch.enable_grad():
            y, new_bn = g_model.apply(p, b, z, train=True, tp=axis)
            grads = torch.autograd.grad(torch.mean(y.float() ** 2), leaves)
        return {"out": y.detach(), "bn": new_bn,
                "grads": tree_unflatten(p, list(grads))}

    ref = run(params, bn, None)
    got = run(meshes.place_model_tp(params, mesh),
              meshes.place_model_tp(bn, mesh), tp)
    got = meshes.gather_state(got, mesh, {
        "bn": (meshes.TP, meshes.tp_plan(bn, tp.size)),
        "grads": (meshes.TP, meshes.tp_plan(params, tp.size))})
    if got is None:
        return None
    return _plain({**got, **{f"whole_{k}": v for k, v in ref.items()}})


def dryrun_multichip(n: int, device="cpu", extra=()) -> Dict[str, dict]:
    """``multichip_cases(n)`` on ``n`` ranks (gloo on the host by
    default; ``device="cuda"``: NCCL, one rank a card); raises unless
    every case reached its round count with finite metrics.  ``extra``:
    further cases run by the same ranks after them.  Returns rank 0's
    results of all."""
    cases = multichip_cases(n)
    clash = {c["name"] for c in cases} & {c["name"] for c in extra}
    if clash:
        raise ValueError(f"extra cases named as the dryrun's: {clash}")
    res = meshes.spawn(run_cases, n, device, cases + list(extra))[0]
    for case in cases:
        got = res[case["name"]]
        if got["t"] != case["rounds"]:
            raise AssertionError(f"{case['name']}: t={got['t']}, expected "
                                 f"{case['rounds']}")
        for m in got["metrics"]:
            if not all(math.isfinite(v) for v in m.values()):
                raise AssertionError(f"{case['name']}: metrics {m}")
        print(f"dryrun_multichip: {case['name']} ok — " + ", ".join(
            f"{k}={v:.4f}" for k, v in got["metrics"][-1].items()))
    print(f"dryrun_multichip({n}): all ok")
    return res


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", type=int, nargs="?", default=2)
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args()
    # by the module's name, so that the ranks unpickle ``run_cases`` from
    # it and not from ``__main__``
    from cglgan_tpu_torch.utils import dryrun
    dryrun.dryrun_multichip(args.n, args.device)

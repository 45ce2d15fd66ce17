"""Serving export: package a trained generator as a ``torch.export``
artifact.

Port of ``cglgan_tpu/utils/export.py``, with ``torch.export`` in place of
``jax.export`` / StableHLO.  The trained generator becomes a
**self-contained program**: the eval-mode generator forward with the
checkpoint's weights held as the program's buffers, saved with
``torch.export.save``.  A consumer needs torch and the file
(``torch.export.load(path).module()``); no model code, no config, no
checkpoint tree.  The program is traced for one device, the one its
weights live on.

Contract: the exported function maps caller-supplied latents
``z: float32[n, latent_dim]`` to eval-mode samples, with the painter's
per-server routing baked in (multi-path heads strided to the per-server
quota, capgan.py:79-83).  ``n`` is fixed at export time, or symbolic
(``n=None``): any multiple of ``runner.gen_batch_multiple``, the
manifest's ``batch_multiple`` and ``min_batch``.  Callers bring their own
randomness — the standard GAN serving interface.

CLI: ``tpufed-torch export <checkpoint> --n 100 --out g.pt2``.
"""
from __future__ import annotations

import json
import os
from typing import Any, Callable, Dict, Optional

import torch

from cglgan_tpu_torch.algos.common import FedState, NetState
from cglgan_tpu_torch.core import device as device_mod
from cglgan_tpu_torch.utils.tree import tree_leaves, tree_map, tree_unflatten

MANIFEST_SUFFIX = ".json"
FORMAT = "torch.export"


class _Serve(torch.nn.Module):
    """``fn(tree, z)`` as a module whose buffers are ``tree``'s leaves, so
    that the exported program carries the weights and no model code."""

    def __init__(self, fn: Callable, tree: Any, device: torch.device):
        super().__init__()
        self._fn = fn
        self._skeleton = tree_map(lambda _: 0, tree)
        leaves = tree_leaves(tree)
        self._n = len(leaves)
        for i, x in enumerate(leaves):
            self.register_buffer(f"leaf{i}", x.to(device))

    def forward(self, z):
        tree = tree_unflatten(self._skeleton, [getattr(self, f"leaf{i}")
                                               for i in range(self._n)])
        return self._fn(tree, z)


def _export(module: _Serve, n: Optional[int], multiple: int,
            latent_dim: int, device: torch.device):
    """``torch.export`` of ``module`` on ``z: float32[n, latent_dim]``; a
    symbolic ``multiple*b`` batch, b >= 1, when ``n`` is None.  Sizes are
    traced obliviously, so that the symbolic batch is not specialised
    away at 1; a forward that still branches on b = 1 raises here: the
    trace refuses the range, or (a derived ``multiple*b``) the program's
    guard refuses its one-row-a-server call."""
    from torch.fx.experimental import _config
    if n is not None and n < 1:
        raise ValueError(f"n={n}: a serving batch has at least 1 row")
    dynamic = None
    if n is None:
        b = torch.export.Dim("b", min=1)
        dynamic = {"z": {0: b * multiple if multiple > 1 else b}}
    z = torch.zeros(2 * multiple if n is None else n, latent_dim,
                    device=device)
    with _config.patch(backed_size_oblivious=True):
        # strict=False: trace the Python as it runs (the default differs
        # between torch releases)
        ep = torch.export.export(module, (z,), dynamic_shapes=dynamic,
                                 strict=False)
    if n is None:
        try:
            ep.module()(z[:multiple])
        except AssertionError as e:       # "Guard failed: ..."
            raise ValueError(f"the traced forward does not serve one row a "
                             f"server (n = {multiple}): {e}") from e
    return ep


def _runner_device(runner, device) -> torch.device:
    """The device to trace for: the runner's, where its ``gen`` keeps
    what it closes over."""
    dev = device_mod.resolve(runner.device if device is None else device)
    if dev != device_mod.resolve(runner.device):
        raise ValueError(f"the runner lives on {runner.device}: build it on "
                         f"{dev} to export for {dev}")
    return dev


def export_generator(runner, state, n: Optional[int] = None, device=None):
    """Export ``runner.gen`` closed over ``state``'s generator as a
    ``torch.export.ExportedProgram`` taking ``z: float32[n, latent_dim]``.

    ``n``: the serving batch.  An int bakes a fixed batch; ``None``
    exports a **batch-polymorphic** program: the symbolic batch is ``m*b``
    with ``m = runner.gen_batch_multiple`` (num_servers for the
    per-server-quota families; 1 = any batch).  ``device``: where the
    program runs (default the runner's)."""
    if runner.gen is None:
        raise ValueError(f"{runner.cfg.algo} runner exposes no gen()")
    m = runner.gen_batch_multiple
    if n is not None and n % m:
        raise ValueError(
            f"n={n} not divisible by the runner's serving batch "
            f"multiple {m} (num_servers)")
    dev = _runner_device(runner, device)

    def serve(g, z):
        return runner.gen(FedState(NetState(g["params"], g["bn"], None),
                                   None, None, state.t), z)

    module = _Serve(serve, {"params": state.g.params, "bn": state.g.bn}, dev)
    return _export(module, n, m, runner.cfg.latent_dim, dev)


def export_client_generator(runner, state, client: int,
                            n: Optional[int] = None, device=None):
    """Export client ``client``'s PERSONALIZED generator
    (``runner.gen_client``): head ``c % k`` of server ``c // k``'s G for
    the multi-path families (mixed-gan.py:242-252 routing), the server's
    G for single-path CAP-GAN.  The batch has no per-server multiple:
    ``z[n, latent] -> samples[n]``.  ``n=None`` exports batch-polymorphic.
    """
    if runner.gen_client is None:
        raise ValueError(
            f"{runner.cfg.algo} has no per-client personalized generator "
            "(gen_client is CGL-family only)")
    if not 0 <= client < runner.cfg.num_workers:
        raise ValueError(f"client {client} out of range "
                         f"[0, {runner.cfg.num_workers})")
    dev = _runner_device(runner, device)

    def serve(g, z):
        return runner.gen_client(
            FedState(NetState(g["params"], g["bn"], None), None, None,
                     state.t), z, client)

    module = _Serve(serve, {"params": state.g.params, "bn": state.g.bn}, dev)
    return _export(module, n, 1, runner.cfg.latent_dim, dev)


def export_imported(model, params, state, n: Optional[int] = None,
                    latent_dim: int = 100):
    """Export an **imported reference generator** (utils/torch_import.py)
    with the same serving contract as :func:`export_generator`:
    eval-mode forward, weights held, ``z[n, latent] -> samples``.
    Multi-path heads are flattened onto the batch axis, head-major,
    matching the reference's ``torch.cat(img, dim=0)`` forward
    (model/mnist_model.py:66) — callers get ``(num_heads * n, *img)``.
    The program runs where the params live."""
    dev = tree_leaves(params)[0].device
    up = lambda tree: tree_map(lambda x: x.unsqueeze(0), tree)

    @torch.no_grad()
    def serve(tree, z):
        y, _ = model.apply(up(tree["params"]), up(tree["bn"]),
                           z.unsqueeze(0), train=False)
        y = y[0]
        if model.multipath:      # heads onto the batch, by a copy (as gen)
            y = torch.cat(y.unbind(0))
        return y

    module = _Serve(serve, {"params": params, "bn": state}, dev)
    return _export(module, n, 1, latent_dim, dev)


def _io(ep) -> tuple:
    """The program's user input and output nodes' values."""
    nodes = {node.name: node for node in ep.graph.nodes}
    spec = ep.graph_signature
    z = nodes[spec.user_inputs[0]].meta["val"]
    out_node = [node for node in ep.graph.nodes if node.op == "output"][0]
    y = out_node.args[0][0].meta["val"]
    return z, y


def _dims(shape) -> list:
    """Static dims as ints, symbolic ones as strings in ``b`` (``"2*b"``,
    as the reference's manifest writes them)."""
    import sympy
    b = sympy.Symbol("b")
    return [d if isinstance(d, int) else
            str(d.node.expr.subs({s: b for s in d.node.expr.free_symbols}))
            for d in shape]


def _batch_multiple(shape) -> Optional[int]:
    """``m`` of a symbolic ``m*b`` batch, None for a fixed batch."""
    d = shape[0]
    if isinstance(d, int):
        return None
    return int(d.node.expr.as_coeff_Mul()[0])


def save_generator(ep, path: str,
                   manifest_extra: Optional[Dict[str, Any]] = None) -> Dict:
    """``torch.export.save`` ``ep`` to ``path`` plus a ``path.json``
    manifest (the reference's keys, ``device`` for its ``platforms``).  A
    batch-polymorphic program also states ``batch_multiple`` and
    ``min_batch``, the least batch it serves: one row a server."""
    z, y = _io(ep)
    multiple = _batch_multiple(z.shape)
    manifest = {
        "format": FORMAT,
        "calling_convention_version": None,
        "device": str(z.device),
        "in_shape": _dims(z.shape),
        "in_dtype": str(z.dtype).removeprefix("torch."),
        "out_shape": _dims(y.shape),
        "out_dtype": str(y.dtype).removeprefix("torch."),
    }
    if multiple is not None:
        manifest["batch_multiple"] = manifest["min_batch"] = multiple
    torch.export.save(ep, path)
    manifest["bytes"] = os.path.getsize(path)
    manifest.update(manifest_extra or {})
    with open(path + MANIFEST_SUFFIX, "w") as f:
        json.dump(manifest, f, indent=1)
    return manifest


def load_generator(path: str):
    """Load a saved artifact; returns ``(callable z -> samples, manifest
    dict)``.  The callable runs the held weights on the device the program
    was traced for, and refuses a batch the program does not serve."""
    program = torch.export.load(path).module()
    manifest = {}
    if os.path.exists(path + MANIFEST_SUFFIX):
        with open(path + MANIFEST_SUFFIX) as f:
            manifest = json.load(f)
    fixed = manifest.get("in_shape", [None])[0]
    multiple = manifest.get("batch_multiple")

    def serve(z: torch.Tensor) -> torch.Tensor:
        n = z.shape[0]
        if isinstance(fixed, int) and n != fixed:
            raise ValueError(f"{path} serves a batch of {fixed}, got {n}")
        if multiple is not None and (n % multiple or n < multiple):
            raise ValueError(
                f"{path} serves batches that are multiples of {multiple} "
                f"from {multiple} on, got {n}")
        return program(z)

    return serve, manifest

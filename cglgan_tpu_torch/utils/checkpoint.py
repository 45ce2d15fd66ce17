"""Checkpoint and resume of a whole ``FedState``.

Port of ``cglgan_tpu/utils/checkpoint.py``, which saves the state pytree
with Orbax.  Here a checkpoint is one ``torch.save`` file of plain dicts,
lists and tensors: the G and D params, their BN buffers, the Adam counts
and moments, ``lam`` (the Lambda game variables, the delta gossip's
anchors, or None) and the host round counter ``t``.  ``torch.load`` reads
it with ``weights_only=True``, which rebuilds no NamedTuple, so
``restore_checkpoint`` rebuilds the state against a template
(``runner.init_state()``), checks every leaf's shape and dtype against it
and loads onto the template's device.  Tensors are saved as they are, so
bfloat16 leaves keep their bits and a resumed run is the uninterrupted
one, bit for bit.

On a clients mesh (``core/meshes.py``) rank 0 gathers the client stacks
(``meshes.gather_state`` with the runner's ``layout``) and writes the file
an unsharded run writes; a restore reads it on every rank and keeps each
rank's block.  So a mesh checkpoint restores unsharded, an unsharded one
on a mesh, and a run resumed on the same mesh continues bit for bit.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Optional

import torch

from cglgan_tpu_torch.core import meshes


def _plain(x: Any) -> Any:
    """NamedTuples as dicts by field, tuples as lists, tensors on the
    host."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return {f: _plain(getattr(x, f)) for f in x._fields}
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    return x


def _rebuild(like: Any, saved: Any, where: str) -> Any:
    """``saved`` in ``like``'s structure, types and device; raises
    ValueError naming the first leaf that does not match."""
    def fail(what):
        raise ValueError(f"checkpoint does not match the template at "
                         f"{where or 'the root'}: {what}")

    if like is None:
        if saved is not None:
            fail(f"expected None, found {type(saved).__name__}")
        return None
    if isinstance(like, torch.Tensor):
        if not isinstance(saved, torch.Tensor):
            fail(f"expected a tensor, found {type(saved).__name__}")
        if saved.shape != like.shape or saved.dtype != like.dtype:
            fail(f"expected {like.dtype} {tuple(like.shape)}, found "
                 f"{saved.dtype} {tuple(saved.shape)}")
        return saved.to(like.device)
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        if not isinstance(saved, dict) or set(saved) != set(like._fields):
            fail(f"expected the fields {like._fields}")
        return type(like)(*(_rebuild(getattr(like, f), saved[f],
                                     f"{where}.{f}") for f in like._fields))
    if isinstance(like, dict):
        if not isinstance(saved, dict) or set(saved) != set(like):
            fail(f"expected the keys {sorted(like)}")
        return {k: _rebuild(like[k], saved[k], f"{where}[{k!r}]")
                for k in like}
    if isinstance(like, (list, tuple)):
        if not isinstance(saved, list) or len(saved) != len(like):
            fail(f"expected a sequence of {len(like)}")
        out = [_rebuild(a, b, f"{where}[{i}]")
               for i, (a, b) in enumerate(zip(like, saved))]
        return out if isinstance(like, list) else tuple(out)
    if isinstance(like, int):
        if not isinstance(saved, int):
            fail(f"expected an int, found {type(saved).__name__}")
        return saved
    fail(f"unsupported template leaf {type(like).__name__}")


def save_checkpoint(path: str, state: Any, mesh=None,
                    layout: Optional[Dict[str, tuple]] = None) -> None:
    """Write ``state`` to ``path`` (one file), replacing it whole.  On a
    mesh every rank calls it (a collective) and rank 0 writes the whole
    state."""
    state = meshes.gather_state(state, mesh, layout or {})
    if state is None:
        return
    path = os.path.abspath(path)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(_plain(state), tmp)
    os.replace(tmp, path)


def restore_checkpoint(path: str, template: Any, mesh=None,
                       layout: Optional[Dict[str, tuple]] = None) -> Any:
    """The state saved at ``path``, rebuilt against ``template`` (a
    FedState of the right structure, shapes and dtypes, e.g. from
    ``runner.init_state()``) on the template's device; on a mesh, this
    rank's block of it."""
    saved = torch.load(os.path.abspath(path), map_location="cpu",
                       weights_only=True)
    saved = meshes.place_state(saved, mesh, layout or {})
    return _rebuild(template, saved, "")

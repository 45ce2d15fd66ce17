"""Carry a federated state across between the JAX package and the port.

``from_jax_numpy`` takes the reference's ``FedState`` after
``jax.tree.map(np.asarray, state)`` — NamedTuples of numpy arrays, read by
attribute and list position (``.params``, ``.bn``, ``.opt[0].count/.mu/.nu``),
so this module imports neither jax nor optax.  CAP-GAN: the reference stacks
D state ``(S, k, ...)``; the port keeps it flat ``(W, ...)``.  FedAvg family
(flgan, fegan): both packages keep G and D params unstacked and the Adam
state (fegan: the BN state too) stacked ``(W, ...)``, and ``lam`` is None,
so every array carries over as it is.  AC-GAN and MD-GAN: D state as for
CAP-GAN, and the ``lam`` slot holds the delta gossip's anchors, a
``(params, bn)`` pair shaped like the D's (flattened the same way), or
None.  A multipath G's trees are dicts
``{"trunk": [...], "heads": [...]}`` in both packages (heads ``(S, k, ...)``)
and carry over as dicts; so do the conv family's trees (``conv=True``:
G ``{"l1", "c1", "c2", "c3", "bn1", "bn2"}``, Mix-G ``{"trunk": {...},
"heads": {"bn", "c"}}``, D ``{"c1".."c4", "adv", "bn2".."bn4"}``, conv
weights OIHW behind the stacked axes), leaf for leaf in sorted-key order.
``to_numpy`` is the inverse view used by the tests: plain dicts of numpy
arrays in the port's layout.
``fid_params_from_numpy`` carries the proxy evaluator's params (the
random-conv extractor's or the probe's, ``cglgan_tpu/evalx/fid.py``),
dicts of arrays that both packages lay out alike.

Every leaf keeps its dtype both ways.  A bfloat16 leaf (``--dtype
bfloat16``) crosses bit for bit through a 16-bit integer view: numpy has no
bfloat16 of its own (JAX's is ``ml_dtypes.bfloat16``, which
``torch.from_numpy`` refuses), so ``from_jax_numpy`` reads it as
``np.uint16`` and reinterprets it as ``torch.bfloat16``, and ``to_numpy``
returns a bfloat16 leaf as float32 (exact) unless ``bf16_bits=True`` asks
for its ``np.uint16`` bits.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from cglgan_tpu_torch.algos.common import AdamState, FedState, NetState
from cglgan_tpu_torch.utils.tree import tree_map


def tensor_from_numpy(x, device) -> torch.Tensor:
    """A numpy array (float32, integer, or ``ml_dtypes.bfloat16``) as a
    tensor of the same dtype on ``device``, bit for bit."""
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(x).view(np.uint16).astype(np.int16)
        return torch.from_numpy(bits).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(x)).to(device)


def tensor_to_numpy(x: torch.Tensor, bf16: str = "keep") -> np.ndarray:
    """A tensor as numpy in its own dtype; a bfloat16 one as
    ``ml_dtypes.bfloat16`` (``bf16="keep"``) or upcast to float32
    (``bf16="float32"``), both exact."""
    x = x.detach().cpu()
    if x.dtype != torch.bfloat16:
        return x.numpy()
    if bf16 == "float32":
        return x.float().numpy()
    if bf16 != "keep":
        raise ValueError(f"bf16={bf16!r}: expected 'keep' or 'float32'")
    import ml_dtypes
    return x.view(torch.int16).numpy().view(ml_dtypes.bfloat16)


def from_jax_numpy(tree, cfg, device) -> FedState:
    dev = torch.device(device)
    W = cfg.num_workers

    def net(ns, flatten_clients: bool) -> NetState:
        def conv(x):
            x = np.asarray(x)
            if flatten_clients:
                x = x.reshape((W,) + x.shape[2:])
            return tensor_from_numpy(x, dev)
        # a list (an MLP's layers) or a dict (a multipath G's trunk and
        # heads); tuples become lists, as the port builds them
        walk = lambda tree: tree_map(conv, tree if isinstance(tree, dict)
                                     else list(tree))
        adam = ns.opt[0]
        count = conv(adam.count).to(torch.int64)
        return NetState(walk(ns.params), walk(ns.bn),
                        AdamState(count, walk(adam.mu), walk(adam.nu)))

    if cfg.algo in ("flgan", "fegan"):
        return FedState(net(tree.g, False), net(tree.d, False), None,
                        int(tree.t))
    if cfg.algo in ("acgan", "mdgan"):
        lam = None
        if tree.lam is not None:           # the delta anchors (params, bn)
            flat = lambda x: tensor_from_numpy(
                np.asarray(x).reshape((W,) + np.shape(x)[2:]), dev)
            lam = tuple(tree_map(flat, list(sub)) for sub in tree.lam)
        return FedState(net(tree.g, False), net(tree.d, True), lam,
                        int(tree.t))
    return FedState(net(tree.g, False), net(tree.d, True),
                    torch.from_numpy(np.array(tree.lam, np.float32)).to(dev),
                    int(tree.t))


def fid_params_from_numpy(tree, device) -> Dict[str, Any]:
    """The reference's extractor or probe params (after
    ``jax.tree.map(np.asarray, extractor.params)``) as the port's: the same
    dicts, each array a tensor on ``device``, bit for bit."""
    dev = torch.device(device)
    return tree_map(lambda x: tensor_from_numpy(x, dev), dict(tree))


def to_numpy(state: FedState, bf16: str = "keep") -> Dict[str, Any]:
    npy = lambda x: tensor_to_numpy(x, bf16)

    def net(n: NetState):
        return {"params": tree_map(npy, n.params), "bn": tree_map(npy, n.bn),
                "count": npy(n.opt.count), "mu": tree_map(npy, n.opt.mu),
                "nu": tree_map(npy, n.opt.nu)}

    lam = None if state.lam is None else tree_map(npy, state.lam)
    return {"g": net(state.g), "d": net(state.d), "lam": lam,
            "t": int(state.t)}

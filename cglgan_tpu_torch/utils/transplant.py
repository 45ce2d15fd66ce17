"""Carry a federated state across between the JAX package and the port.

``from_jax_numpy`` takes the reference's ``FedState`` after
``jax.tree.map(np.asarray, state)`` — NamedTuples of numpy arrays, read by
attribute and list position (``.params``, ``.bn``, ``.opt[0].count/.mu/.nu``),
so this module imports neither jax nor optax.  CAP-GAN: the reference stacks
D state ``(S, k, ...)``; the port keeps it flat ``(W, ...)``.  FedAvg family
(flgan, fegan): both packages keep G and D params unstacked and the Adam
state (fegan: the BN state too) stacked ``(W, ...)``, and ``lam`` is None,
so every array carries over as it is.  A multipath G's trees are dicts
``{"trunk": [...], "heads": [...]}`` in both packages (heads ``(S, k, ...)``)
and carry over as dicts.  ``to_numpy`` is the inverse view used by the
tests: plain dicts of numpy arrays in the port's layout.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from cglgan_tpu_torch.algos.common import AdamState, FedState, NetState
from cglgan_tpu_torch.utils.tree import tree_map


def from_jax_numpy(tree, cfg, device) -> FedState:
    dev = torch.device(device)
    W = cfg.num_workers

    def net(ns, flatten_clients: bool) -> NetState:
        def conv(x):
            x = np.asarray(x)
            if flatten_clients:
                x = x.reshape((W,) + x.shape[2:])
            return torch.from_numpy(np.array(x)).to(dev)
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
    return FedState(net(tree.g, False), net(tree.d, True),
                    torch.from_numpy(np.array(tree.lam, np.float32)).to(dev),
                    int(tree.t))


def to_numpy(state: FedState) -> Dict[str, Any]:
    npy = lambda x: x.detach().cpu().numpy()

    def net(n: NetState):
        return {"params": tree_map(npy, n.params), "bn": tree_map(npy, n.bn),
                "count": npy(n.opt.count), "mu": tree_map(npy, n.opt.mu),
                "nu": tree_map(npy, n.opt.nu)}

    lam = None if state.lam is None else npy(state.lam)
    return {"g": net(state.g), "d": net(state.d), "lam": lam,
            "t": int(state.t)}

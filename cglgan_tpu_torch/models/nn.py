"""Functional NN core on STACKED parameters (leading member axis).

Port of ``cglgan_tpu/models/nn.py``.  Every parameter carries a leading
member axis (servers for G, clients for D) and every activation is
``(N, B, features)``, so W per-client layers are one batched matmul.
Weights stay ``(din, dout)`` as in the reference.

* ``linear_init``: weight & bias ~ U(-1/sqrt(din), +1/sqrt(din)) (torch
  ``nn.Linear``'s default).
* ``batchnorm``: the reference's ``BatchNorm1d(out, 0.8)`` — eps 0.8,
  momentum 0.1, running variance unbiased, normalisation by the biased
  batch variance.
* ``leaky_relu``: ``where(x >= 0, x, 0.2x)`` — gradient 1 at 0, as in JAX
  (``F.leaky_relu`` gives 0.2 there).
* ``dcgan_reinit``: the reference ``weights_init`` DCGAN re-draw (Mix-G's G
  and D, mixed-gan.py:181,348).
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

BN_MOMENTUM = 0.1


def linear_init(gen: torch.Generator, n: int, din: int, dout: int,
                dtype=torch.float32) -> Dict[str, torch.Tensor]:
    bound = 1.0 / math.sqrt(din)

    def u(shape):
        return (torch.rand(shape, generator=gen, dtype=dtype) * 2.0 - 1.0) \
            * bound
    return {"w": u((n, din, dout)), "b": u((n, dout))}


def bn_init(n: int, dim: int, dtype=torch.float32
            ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    params = {"scale": torch.ones((n, dim), dtype=dtype),
              "bias": torch.zeros((n, dim), dtype=dtype)}
    state = {"mean": torch.zeros((n, dim), dtype=dtype),
             "var": torch.ones((n, dim), dtype=dtype)}
    return params, state


def dcgan_reinit(gen: torch.Generator, params):
    """Re-draw a stacked param tree DCGAN-style (capgan.py:63-72): weights
    ``w`` ~ N(0, 0.02); BatchNorm ``scale`` ~ N(1, 0.02); linear biases and
    BatchNorm biases 0; conv biases left as they are.  A bias is a conv bias
    when its sibling ``w`` has rank 4 per member (OIHW); the bias's own rank
    minus 1 gives the number of leading member axes, so the rule holds for
    ``(N, ...)`` and multipath ``(S, k, ...)`` leaves alike.  Leaves are
    drawn in ``tree_leaves`` order; the draws cannot equal JAX's (threefry is
    ROADMAP queue 1 item 2)."""
    def walk(tree):
        if isinstance(tree, dict):
            w = tree.get("w")
            out = {}
            for key in sorted(tree):
                x = tree[key]
                if not isinstance(x, torch.Tensor):
                    out[key] = walk(x)
                elif key in ("w", "scale"):
                    draw = torch.randn(x.shape, generator=gen,
                                       dtype=x.dtype).to(x.device)
                    out[key] = 0.02 * draw + (1.0 if key == "scale" else 0.0)
                elif key == "b" and w is not None \
                        and w.ndim - (x.ndim - 1) == 4:
                    out[key] = x                     # conv bias: untouched
                else:                                # linear / BN bias
                    out[key] = torch.zeros_like(x)
            return out
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(x) for x in tree)
        return tree
    return walk(params)


def linear(p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """x (N, B, din) @ w (N, din, dout) + b (N, dout)."""
    return torch.matmul(x, p["w"]) + p["b"].unsqueeze(-2)


def leaky_relu(x: torch.Tensor, slope: float = 0.2) -> torch.Tensor:
    return torch.where(x >= 0, x, slope * x)


def batchnorm(p, s, x: torch.Tensor, train: bool, eps: float = 0.8,
              momentum: float = BN_MOMENTUM):
    """BatchNorm1d over the batch axis of stacked ``x`` (N, B, C)."""
    if train:
        mean = x.mean(dim=1)
        var = ((x - mean.unsqueeze(1)) ** 2).mean(dim=1)
        count = x.shape[1]
        unbiased = var.detach() * count / max(count - 1, 1)
        # running stats are buffers: no gradient flows through them
        new_s = {"mean": (1 - momentum) * s["mean"] + momentum * mean.detach(),
                 "var": (1 - momentum) * s["var"] + momentum * unbiased}
    else:
        mean, var = s["mean"], s["var"]
        new_s = s
    inv = torch.rsqrt(var + eps)
    y = (x - mean.unsqueeze(1)) * inv.unsqueeze(1)
    return y * p["scale"].unsqueeze(1) + p["bias"].unsqueeze(1), new_s

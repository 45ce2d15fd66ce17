"""Model zoo, stacked: the MLP G/D pairs, single path and multipath.

Port of the MLP families of ``cglgan_tpu/models/zoo.py`` (same
declarative spec lists, same param/state list layout with ``None`` holes,
so weights transplant entry by entry):

* G ``mnist-mlp``: 100-128-256(BN)-512(BN)-1024(BN)-img, LeakyReLU 0.2,
  Tanh (model/mnist_model.py:5-29);
* D ``mnist``: img-512-256-{1 sigmoid | 2 logits} (model/mnist_model.py:71-88);
* G ``2dmg-mlp``: 100-256-128-2 (FL-GAN, MD-GAN) and ``2dmg-small``:
  100-32-2, LeakyReLU 0.2, Tanh, no BatchNorm;
* D ``2dmg``: 2-128-256-1 sigmoid;
* multipath G ``mnist-multipath``: trunk 100-128-256(BN)-512(BN), k heads
  512-1024(BN)-img + Tanh (model/mnist_model.py:32-66), and
  ``2dmg-multipath``: trunk 100-32, k heads 32-2 + Tanh
  (CGLGAN/2DMG/model.py:26-50).

Multipath layout: params and BN state ``{"trunk": [...], "heads": [...]}``,
trunk leaves ``(S, ...)``, head leaves ``(S, k, ...)``; ``apply`` returns
``(S, k, B, *out)``, head i's batch for client i of the server.  The conv
families raise ``NotImplementedError`` naming their ROADMAP item.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from cglgan_tpu_torch.models import nn
from cglgan_tpu_torch.utils.tree import tree_map

# spec entries: ("linear", din, dout) | ("bn", dim) | ("lrelu", slope)
#             | ("tanh",) | ("sigmoid",)


def mlp_init(gen: torch.Generator, n: int, spec, dtype=torch.float32):
    """Stacked init of ``n`` members: params/state lists aligned to spec."""
    params, state = [], []
    for entry in spec:
        if entry[0] == "linear":
            params.append(nn.linear_init(gen, n, entry[1], entry[2], dtype))
            state.append(None)
        elif entry[0] == "bn":
            p, s = nn.bn_init(n, entry[1], dtype)
            params.append(p)
            state.append(s)
        else:
            params.append(None)
            state.append(None)
    return params, state


def mlp_apply(spec, params, state, x: torch.Tensor, train: bool):
    new_state = list(state)
    for i, entry in enumerate(spec):
        op = entry[0]
        if op == "linear":
            x = nn.linear(params[i], x)
        elif op == "bn":
            x, new_state[i] = nn.batchnorm(params[i], state[i], x, train)
        elif op == "lrelu":
            x = nn.leaky_relu(x, entry[1])
        elif op == "tanh":
            x = torch.tanh(x)
        elif op == "sigmoid":
            x = nn.sigmoid(x)
    return x, new_state


def _block(din, dout, bn=True):
    out = [("linear", din, dout)]
    if bn:
        out.append(("bn", dout))
    out.append(("lrelu", 0.2))
    return out


class Model(NamedTuple):
    """``init(gen, n) -> (params, state)`` stacked over ``n`` members and
    ``apply(params, state, x (N, B, ...), train) -> (y, new_state)``;
    ``spec`` is the spec list, or ``{"trunk", "heads"}`` lists for a
    multipath G."""
    init: Callable
    apply: Callable
    spec: Any
    multipath: bool = False
    out_dim: int = 1


def _mlp_model(spec, out_dim: int = 1, out_shape=None) -> Model:
    spec = tuple(spec)

    def init(gen, n, dtype=torch.float32):
        return mlp_init(gen, n, spec, dtype)

    def apply(params, state, x, train=True):
        if x.ndim > 3:           # (N, B, C, H, W) -> (N, B, C*H*W)
            x = x.reshape(x.shape[0], x.shape[1], -1)
        y, new_state = mlp_apply(spec, params, state, x, train)
        if out_shape is not None:
            y = y.reshape(tuple(y.shape[:2]) + tuple(out_shape))
        return y, new_state

    return Model(init, apply, spec, out_dim=out_dim)


def _multipath_model(trunk_spec, head_spec, num_heads: int,
                     out_shape=None) -> Model:
    """Shared trunk, ``num_heads`` heads a member.  The trunk runs once; its
    hidden state feeds the S*k heads as one batched product a layer, and a
    head's BatchNorm normalises over B for each (server, head)."""
    trunk_spec, head_spec = tuple(trunk_spec), tuple(head_spec)
    k = num_heads

    def init(gen, n, dtype=torch.float32):
        tp, ts = mlp_init(gen, n, trunk_spec, dtype)
        hp, hs = mlp_init(gen, n * k, head_spec, dtype)
        split = lambda x: x.reshape((n, k) + tuple(x.shape[1:]))
        return ({"trunk": tp, "heads": tree_map(split, hp)},
                {"trunk": ts, "heads": tree_map(split, hs)})

    def apply(params, state, z, train=True):
        hidden, new_ts = mlp_apply(trunk_spec, params["trunk"],
                                   state["trunk"], z, train)
        S, B = hidden.shape[0], hidden.shape[1]
        flat = lambda x: x.reshape((S * k,) + tuple(x.shape[2:]))
        x = hidden.unsqueeze(1).expand((S, k) + tuple(hidden.shape[1:])) \
            .reshape((S * k,) + tuple(hidden.shape[1:]))
        y, new_hs = mlp_apply(head_spec, tree_map(flat, params["heads"]),
                              tree_map(flat, state["heads"]), x, train)
        split = lambda t: t.reshape((S, k) + tuple(t.shape[1:]))
        y = split(y)
        if out_shape is not None:
            y = y.reshape((S, k, B) + tuple(out_shape))
        return y, {"trunk": new_ts, "heads": tree_map(split, new_hs)}

    return Model(init, apply, {"trunk": trunk_spec, "heads": head_spec},
                 multipath=True)


def _mnist_g_spec(out: int):
    return (_block(100, 128, bn=False) + _block(128, 256) +
            _block(256, 512) + _block(512, 1024) +
            [("linear", 1024, out), ("tanh",)])


_MNIST_TRUNK_SPEC = (_block(100, 128, bn=False) + _block(128, 256) +
                     _block(256, 512))


def _mnist_head_spec(out: int):
    return _block(512, 1024) + [("linear", 1024, out), ("tanh",)]


def build_generator(family: str, num_heads: int = 1,
                    img_shape: Sequence[int] = (1, 28, 28)) -> Model:
    if family == "2dmg-small":
        return _mlp_model([("linear", 100, 32), ("lrelu", 0.2),
                           ("linear", 32, 2), ("tanh",)])
    if family == "2dmg-mlp":
        return _mlp_model([("linear", 100, 256), ("lrelu", 0.2),
                           ("linear", 256, 128), ("lrelu", 0.2),
                           ("linear", 128, 2), ("tanh",)])
    if family == "2dmg-multipath":
        return _multipath_model([("linear", 100, 32), ("lrelu", 0.2)],
                                [("linear", 32, 2), ("tanh",)], num_heads)
    if family == "mnist-mlp":
        out = int(np.prod(img_shape))
        return _mlp_model(_mnist_g_spec(out), out_shape=tuple(img_shape))
    if family == "mnist-multipath":
        out = int(np.prod(img_shape))
        return _multipath_model(_MNIST_TRUNK_SPEC, _mnist_head_spec(out),
                                num_heads, out_shape=tuple(img_shape))
    raise NotImplementedError(
        f"generator family {family!r} is not ported yet (ROADMAP queue 1 "
        "item 12 conv)")


def build_discriminator(family: str, out_dim: int = 1,
                        in_dim: int = 784) -> Model:
    if family == "2dmg":
        return _mlp_model([("linear", 2, 128), ("lrelu", 0.2),
                           ("linear", 128, 256), ("lrelu", 0.2),
                           ("linear", 256, 1), ("sigmoid",)], out_dim=1)
    if family == "mnist":
        spec = [("linear", in_dim, 512), ("lrelu", 0.2),
                ("linear", 512, 256), ("lrelu", 0.2),
                ("linear", 256, out_dim)]
        if out_dim == 1:
            spec.append(("sigmoid",))
        return _mlp_model(spec, out_dim=out_dim)
    raise NotImplementedError(
        f"discriminator family {family!r} is not ported yet (ROADMAP queue "
        "1 item 12 conv)")


def models_for_config(cfg) -> Tuple[Model, Model]:
    """The (G, D) pair the corresponding reference entry script uses."""
    if cfg.conv:
        raise NotImplementedError(
            "conv=True is not ported yet (ROADMAP queue 1 item 12)")
    # CGL uses a single-path G when iid == 0 (Generator(ims, N if iid != 0
    # else 1), CGLGAN/MNIST/main.py:167); Mix-G is always multipath
    multi = cfg.algo == "mixgan" or (cfg.algo == "cglgan" and cfg.iid != 0)
    k = cfg.clients_per_server
    if cfg.dataset == "2dmg":
        if multi:
            family = "2dmg-multipath"
        else:
            family = "2dmg-mlp" if cfg.algo in ("flgan", "mdgan") \
                else "2dmg-small"
        return build_generator(family, k), build_discriminator("2dmg")
    img_shape = (1, cfg.img_size, cfg.img_size)
    out_dim = 2 if cfg.resolved_d_head == "logits2" else 1
    g = build_generator("mnist-multipath" if multi else "mnist-mlp", k,
                        img_shape=img_shape)
    d = build_discriminator("mnist", out_dim, in_dim=int(np.prod(img_shape)))
    return g, d

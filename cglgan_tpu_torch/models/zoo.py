"""Model zoo, stacked: the MLP G/D pairs, single path and multipath, and
the conv LSGAN family.

Port of ``cglgan_tpu/models/zoo.py`` (same declarative spec lists, same
param/state list layout with ``None`` holes, so weights transplant entry by
entry; the conv families keep the reference's dict trees):

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
``(S, k, B, *out)``, head i's batch for client i of the server.

The conv LSGAN family (model/lsgan.py, 32x32 images, NCHW / OIHW, the
reference's param names, ``cglgan_tpu/models/zoo.py:134-243``):

* G ``conv``: linear 100 -> 128x8x8, up 2x, conv 128-128, BN, LeakyReLU, up
  2x, conv 128-64, BN, LeakyReLU, conv 64-1, Tanh; ``apply`` returns
  ``(S, B, 1, 32, 32)``;
* G ``conv-multipath`` (Mix-G): the same trunk up to conv 128-64, then k
  heads a server of BN(64), LeakyReLU, conv 64-1, Tanh; ``(S, k, B, 1, 32,
  32)``;
* D ``conv``: four stride-2 convs 1-16-32-64-128, each with LeakyReLU and
  Dropout2d(0.25), BN after the last three, then linear 512 -> 1 raw logit.

Route for the stacked members: no loop over them.  Their images live in
the grouped layout ``(B, N*C, H, W)`` (``nn.to_groups``) and each layer's N
convolutions are one ``F.conv2d(..., groups=N)`` (``nn.group_conv2d``);
BatchNorm over (B, H, W) of a grouped channel is each member's own; the
Mix-G heads are S*k groups fed by their server's trunk channels.  The conv
D's ``apply`` takes ``rng``, threefry keys ``(N, 2)`` one a member, splits
each 4 ways as the reference does and draws the four Dropout2d masks in
one hash pass (``threefry.bernoulli_parts``).
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from cglgan_tpu_torch.core import threefry
from cglgan_tpu_torch.models import nn
from cglgan_tpu_torch.models import tp as model_tp
from cglgan_tpu_torch.utils.tree import tree_map

# spec entries: ("linear", din, dout) | ("bn", dim) | ("lrelu", slope)
#             | ("tanh",) | ("sigmoid",)


def mlp_init(key: torch.Tensor, spec, dtype=torch.float32):
    """Stacked init of a member a threefry key (``key`` (n, 2)):
    params/state lists aligned to spec.  Each linear layer takes the next
    ``key, sub = split(key)`` and draws from ``sub``, as the reference's
    ``mlp_init``."""
    params, state = [], []
    n = key.shape[0]
    for entry in spec:
        if entry[0] == "linear":
            key, sub = threefry.split(key).unbind(1)
            params.append(nn.linear_init(sub, entry[1], entry[2], dtype))
            state.append(None)
        elif entry[0] == "bn":
            p, s = nn.bn_init(n, entry[1], dtype, key.device)
            params.append(p)
            state.append(s)
        else:
            params.append(None)
            state.append(None)
    return params, state


def mlp_apply(spec, params, state, x: torch.Tensor, train: bool, tp=None):
    """``tp``: the ``model`` axis of a tensor-parallel mesh, ``params`` and
    ``state`` this rank's blocks (``models/tp.py``); the output is whole
    either way."""
    new_state = list(state)
    blk = False                  # whether x is this rank's feature block
    for i, entry in enumerate(spec):
        op = entry[0]
        if op == "linear":
            x, blk = model_tp.linear(params[i], x, blk, tp, entry[2])
        elif op == "bn":
            x, new_state[i], blk = model_tp.batchnorm(
                params[i], state[i], x, blk, tp, entry[1], train)
        elif op == "lrelu":
            x = nn.leaky_relu(x, entry[1])
        elif op == "tanh":
            x = torch.tanh(x)
        elif op == "sigmoid":
            x = nn.sigmoid(x)
    return model_tp.whole(x, blk, tp), new_state


def _block(din, dout, bn=True):
    out = [("linear", din, dout)]
    if bn:
        out.append(("bn", dout))
    out.append(("lrelu", 0.2))
    return out


class Model(NamedTuple):
    """``init(keys (n, 2), dtype) -> (params, state)`` stacked over the n
    members, member i drawn from threefry key ``keys[i]`` as the
    reference's ``init(key, dtype)`` draws it, and
    ``apply(params, state, x (N, B, ...), train, rng=None, tp=None) -> (y,
    new_state)`` (``rng``: the conv D's dropout keys, ignored elsewhere;
    ``tp``: a G's forward on this rank's blocks over a mesh's ``model``
    axis, ``models/tp.py``, ignored by the Ds);
    ``spec`` is the spec list, ``{"trunk", "heads"}`` lists for a
    multipath G, or the family's name for a conv model."""
    init: Callable
    apply: Callable
    spec: Any
    multipath: bool = False
    out_dim: int = 1


def _mlp_model(spec, out_dim: int = 1, out_shape=None) -> Model:
    spec = tuple(spec)

    def init(keys, dtype=torch.float32):
        return mlp_init(keys, spec, dtype)

    def apply(params, state, x, train=True, rng=None, tp=None):
        if x.ndim > 3:           # (N, B, C, H, W) -> (N, B, C*H*W)
            x = x.reshape(x.shape[0], x.shape[1], -1)
        y, new_state = mlp_apply(spec, params, state, x, train, tp)
        if out_shape is not None:
            y = y.reshape(tuple(y.shape[:2]) + tuple(out_shape))
        return y, new_state

    return Model(init, apply, spec, out_dim=out_dim)


def _fan_out(x: torch.Tensor, shape) -> torch.Tensor:
    """``x.reshape(shape)`` where ``x``'s strides force a copy: the same
    copy and view ``reshape`` makes there, spelled out, so that
    torch.export keeps the batch symbolic down to 1 (``reshape`` itself
    branches on the batch being 1; ``utils/export.py``)."""
    return x.clone(memory_format=torch.contiguous_format).view(shape)


def _multipath_model(trunk_spec, head_spec, num_heads: int,
                     out_shape=None) -> Model:
    """Shared trunk, ``num_heads`` heads a member.  The trunk runs once; its
    hidden state feeds the S*k heads as one batched product a layer, and a
    head's BatchNorm normalises over B for each (server, head)."""
    trunk_spec, head_spec = tuple(trunk_spec), tuple(head_spec)
    k = num_heads

    def init(keys, dtype=torch.float32):
        n = keys.shape[0]
        kt, kh = threefry.split(keys).unbind(1)
        tp, ts = mlp_init(kt, trunk_spec, dtype)
        hp, hs = mlp_init(threefry.split(kh, k).reshape(n * k, 2), head_spec,
                          dtype)
        split = lambda x: x.reshape((n, k) + tuple(x.shape[1:]))
        return ({"trunk": tp, "heads": tree_map(split, hp)},
                {"trunk": ts, "heads": tree_map(split, hs)})

    def apply(params, state, z, train=True, rng=None, tp=None):
        hidden, new_ts = mlp_apply(trunk_spec, params["trunk"],
                                   state["trunk"], z, train, tp)
        S, B = hidden.shape[0], hidden.shape[1]
        flat = lambda x: x.reshape((S * k,) + tuple(x.shape[2:]))
        x = hidden if k == 1 else _fan_out(
            hidden.unsqueeze(1).expand((S, k) + tuple(hidden.shape[1:])),
            (S * k,) + tuple(hidden.shape[1:]))
        y, new_hs = mlp_apply(head_spec, tree_map(flat, params["heads"]),
                              tree_map(flat, state["heads"]), x, train, tp)
        split = lambda t: t.reshape((S, k) + tuple(t.shape[1:]))
        y = split(y)
        if out_shape is not None:
            y = y.reshape((S, k, B) + tuple(out_shape))
        return y, {"trunk": new_ts, "heads": tree_map(split, new_hs)}

    return Model(init, apply, {"trunk": trunk_spec, "heads": head_spec},
                 multipath=True)


# ---------------------------------------------------------------------------
# conv LSGAN family (model/lsgan.py) — 32x32 images
# ---------------------------------------------------------------------------

_D_CHANNELS = (16, 32, 64, 128)
_D_DROPOUT = 0.25


def _conv_trunk_init(ks, dtype):
    """The trunk from the first three of each member's ``split(key, 4)``
    (``ks`` (n, 4, 2))."""
    p = {"l1": nn.linear_init(ks[:, 0], 100, 128 * 8 * 8, dtype),
         "c1": nn.conv_init(ks[:, 1], 128, 128, 3, dtype),
         "c2": nn.conv_init(ks[:, 2], 128, 64, 3, dtype)}
    p["bn1"], s1 = nn.bn_init(ks.shape[0], 128, dtype, ks.device)
    return p, {"bn1": s1}


def _conv_trunk_apply(p, s, z, train, tp=None):
    """z (S, B, 100) -> the second conv's output, grouped (B, S*64, 32, 32)
    (with ``tp``, a block of each member's channels where ``blk``), whether
    it is a block, and the first BatchNorm's new state."""
    n, b = z.shape[0], z.shape[1]
    x, blk = model_tp.linear(p["l1"], z, False, tp, 128 * 8 * 8)
    x = model_tp.whole(x, blk, tp).reshape(n, b, 128, 8, 8)
    # ``nn.to_groups`` of a member-major tensor: the view, or the copy
    # its ``reshape`` would make
    x = x.squeeze(0) if n == 1 else _fan_out(x.transpose(0, 1),
                                             (b, n * 128, 8, 8))
    x, blk = model_tp.conv(p["c1"], nn.upsample2x(x), False, tp)
    x, s1, blk = model_tp.batchnorm(p["bn1"], s["bn1"], x, blk, tp, 128,
                                    train, n)
    # gathered before the upsample, which copies every channel
    x = nn.upsample2x(model_tp.whole(nn.leaky_relu(x), blk, tp, n))
    x, blk = model_tp.conv(p["c2"], x, False, tp)
    return x, blk, s1


def _conv_g_model() -> Model:
    def init(keys, dtype=torch.float32):
        ks = threefry.split(keys, 4)
        p, s = _conv_trunk_init(ks, dtype)
        p["c3"] = nn.conv_init(ks[:, 3], 64, 1, 3, dtype)
        p["bn2"], s["bn2"] = nn.bn_init(keys.shape[0], 64, dtype,
                                        keys.device)
        return p, s

    def apply(params, state, z, train=True, rng=None, tp=None):
        n = z.shape[0]
        x, blk, s1 = _conv_trunk_apply(params, state, z, train, tp)
        x, s2, blk = model_tp.batchnorm(params["bn2"], state["bn2"], x, blk,
                                        tp, 64, train, n)
        x, blk = model_tp.conv(params["c3"], nn.leaky_relu(x), blk, tp)
        x = model_tp.whole(torch.tanh(x), blk, tp, n)
        return nn.from_groups(x, n), {"bn1": s1, "bn2": s2}

    return Model(init, apply, "conv")


def _conv_mixg_model(num_heads: int) -> Model:
    """The trunk runs once a server; its 64 output channels feed the
    server's k heads as k copies in the grouped layout, S*k groups."""
    k = num_heads

    def init(keys, dtype=torch.float32):
        n = keys.shape[0]
        ks = threefry.split(keys, 4)
        tp, ts = _conv_trunk_init(ks, dtype)
        hbn_p, hbn_s = nn.bn_init(n * k, 64, dtype, keys.device)
        # a head's ``hk1, = split(k_head, 1)`` of ``split(kh, k)``
        hkeys = threefry.split(threefry.split(ks[:, 3], k), 1)[..., 0, :]
        hc = nn.conv_init(hkeys, 64, 1, 3, dtype)           # (n, k, ...)
        split = lambda x: x.reshape((n, k) + tuple(x.shape[1:]))
        return ({"trunk": tp, "heads": {"bn": tree_map(split, hbn_p),
                                        "c": hc}},
                {"trunk": ts, "heads": tree_map(split, {"bn": hbn_s})})

    def apply(params, state, z, train=True, rng=None, tp=None):
        S, B = z.shape[0], z.shape[1]
        hidden, blk, s1 = _conv_trunk_apply(params["trunk"], state["trunk"],
                                            z, train, tp)
        # each server's channels (its block of the 64 where ``blk``)
        c, h, w = hidden.shape[1] // S, hidden.shape[2], hidden.shape[3]
        x = hidden if k == 1 else _fan_out(
            hidden.reshape(B, S, 1, c, h, w).expand(B, S, k, c, h, w),
            (B, S * k * c, h, w))
        flat = lambda t: t.reshape((S * k,) + tuple(t.shape[2:]))
        hp, hs = tree_map(flat, params["heads"]), tree_map(flat,
                                                           state["heads"])
        x, new_hs, blk = model_tp.batchnorm(hp["bn"], hs["bn"], x, blk, tp,
                                            64, train, S * k)
        y, blk = model_tp.conv(hp["c"], nn.leaky_relu(x), blk, tp)
        y = model_tp.whole(torch.tanh(y), blk, tp, S * k)
        # grouped (B, S*k, H, W) -> (S, k, B, 1, H, W), a view
        y = y.unflatten(1, (S, k, 1)).permute(1, 2, 0, 3, 4, 5)
        split = lambda t: t.reshape((S, k) + tuple(t.shape[1:]))
        return y, {"trunk": {"bn1": s1},
                   "heads": {"bn": tree_map(split, new_hs)}}

    return Model(init, apply, "conv-multipath", multipath=True)


def _conv_d_keeps(rng: torch.Tensor, batch: int):
    """The four Dropout2d keep masks of one forward, in the grouped layout
    ``(B, N*C, 1, 1)``: ``rngs = split(rng, 4)`` a member, mask j drawn
    from ``rngs[j]`` with shape (B, C_j, 1, 1) (``_conv_d_apply``,
    ``cglgan_tpu/models/zoo.py:227-234``)."""
    rngs = threefry.split(rng, 4)                               # (N, 4, 2)
    keeps = threefry.bernoulli_parts(
        rngs, 1.0 - _D_DROPOUT, [(batch, c, 1, 1) for c in _D_CHANNELS])
    return [nn.to_groups(keep) for keep in keeps]


def _conv_d_model() -> Model:
    def init(keys, dtype=torch.float32):
        ks = threefry.split(keys, 5)
        p, state = {}, {}
        cin = 1
        for i, ch in enumerate(_D_CHANNELS, start=1):
            p[f"c{i}"] = nn.conv_init(ks[:, i - 1], cin, ch, 3, dtype)
            cin = ch
        p["adv"] = nn.linear_init(ks[:, 4], 128 * 2 * 2, 1, dtype)
        for i, ch in zip((2, 3, 4), (32, 64, 128)):
            p[f"bn{i}"], state[f"bn{i}"] = nn.bn_init(keys.shape[0], ch,
                                                      dtype, keys.device)
        return p, state

    def apply(params, state, x, train=True, rng=None, tp=None):
        n, b = x.shape[0], x.shape[1]
        if x.ndim == 3:      # flat real batches from the shards
            side = int(x.shape[2] ** 0.5)
            x = x.reshape(n, b, 1, side, side)
        keeps = None
        if train:
            if rng is None:  # the reference's key(0), a member
                rng = threefry.key(0, x.device).expand(n, 2)
            keeps = _conv_d_keeps(rng, b)
        drop = lambda h, j: h if keeps is None else \
            nn.scale_kept(h, keeps[j], _D_DROPOUT)
        new_state = dict(state)
        h = nn.to_groups(x)
        for i in range(1, 5):
            h = nn.group_conv2d(params[f"c{i}"], h, stride=2)
            h = drop(nn.leaky_relu(h), i - 1)
            if i > 1:
                h, new_state[f"bn{i}"] = nn.batchnorm(
                    params[f"bn{i}"], state[f"bn{i}"], h, train)
        h = nn.from_groups(h, n).reshape(n, b, -1)
        return nn.linear(params["adv"], h), new_state

    return Model(init, apply, "conv", out_dim=1)


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
    if family == "conv":
        return _conv_g_model()
    if family == "conv-multipath":
        return _conv_mixg_model(num_heads)
    raise ValueError(f"unknown generator family {family!r}")


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
    if family == "conv":     # one raw logit (lsgan.py:92-98): BCE on logits
        return _conv_d_model()
    raise ValueError(f"unknown discriminator family {family!r}")


GEN_SPECS = ("2dmg-small", "2dmg-mlp", "2dmg-multipath", "mnist-mlp",
             "mnist-multipath", "conv", "conv-multipath")


def models_for_config(cfg) -> Tuple[Model, Model]:
    """The (G, D) pair the corresponding reference entry script uses."""
    # CGL uses a single-path G when iid == 0 (Generator(ims, N if iid != 0
    # else 1), CGLGAN/MNIST/main.py:167); Mix-G is always multipath
    multi = cfg.algo == "mixgan" or (cfg.algo == "cglgan" and cfg.iid != 0)
    k = cfg.clients_per_server
    if cfg.conv:
        return (build_generator("conv-multipath" if multi else "conv", k),
                build_discriminator("conv"))
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

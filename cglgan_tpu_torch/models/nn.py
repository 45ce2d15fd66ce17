"""Functional NN core on STACKED parameters (leading member axis).

Port of ``cglgan_tpu/models/nn.py``.  Every parameter carries a leading
member axis (servers for G, clients for D) and every activation is
``(N, B, features)``, so W per-client layers are one batched matmul.
Weights stay ``(din, dout)`` as in the reference.

* ``linear_init``: weight & bias ~ U(-1/sqrt(din), +1/sqrt(din)) (torch
  ``nn.Linear``'s default); ``conv_init``: OIHW weights, bound
  1/sqrt(cin k k) (``nn.Conv2d``'s default).  Both draw from threefry keys
  ``(..., 2)`` (``core/threefry.py``), one layer a key, stacked over the
  keys' leading axes, with the reference's bits in float32 and bfloat16.
* ``conv2d``: NCHW / OIHW, the bias added after the convolution.
* ``group_conv2d``: N stacked conv layers (weights
  ``(N, O, I, k, k)``) on the grouped image layout ``(B, N*C, H, W)``,
  member n's channels ``[n*C, (n+1)*C)``: one ``F.conv2d(..., groups=N)``
  runs every member's convolution.  ``to_groups`` / ``from_groups`` move
  stacked images ``(N, B, C, H, W)`` into that layout and back.
* ``upsample2x``: nearest 2x (``nn.Upsample``'s default).
* ``dropout2d``: channel dropout (``nn.Dropout2d``) from a threefry key,
  the reference's draw bit for bit.
* ``batchnorm``: the reference's ``BatchNorm1d(out, 0.8)`` — eps 0.8,
  momentum 0.1, running variance unbiased, normalisation by the biased
  batch variance; on the grouped image layout ``BatchNorm2d(out, 0.8)``,
  each member's channel over (B, H, W).
* ``leaky_relu``: ``where(x >= 0, x, 0.2x)`` — gradient 1 at 0, as in JAX
  (``F.leaky_relu`` gives 0.2 there).
* ``dcgan_reinit``: the reference ``weights_init`` DCGAN re-draw (Mix-G's G
  and D, mixed-gan.py:181,348), a member a threefry key.

bfloat16 (``--dtype bfloat16``): every layer runs in its params' dtype and
rounds as ``cglgan_tpu/models/nn.py`` does under JAX (``core/dtypes.py``):
the slope, momentum, eps and count constants are weak scalars rounded to
bfloat16, matmuls accumulate in float32 and round their output once, and
BatchNorm's batch mean and variance accumulate in float32 and round once
(``jnp.mean`` / ``jnp.var``).  In float32 nothing changes.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from cglgan_tpu_torch.core import dtypes, threefry
from cglgan_tpu_torch.core.dtypes import weak
from cglgan_tpu_torch.utils.tree import tree_leaves

BN_MOMENTUM = 0.1


def linear_init(key: torch.Tensor, din: int, dout: int,
                dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """U(-1/sqrt(din), 1/sqrt(din)) weight (din, dout) and bias (dout,)
    drawn in ``dtype`` from threefry keys ``(..., 2)``, one layer a key
    (leading axes first), as the reference's ``linear_init(key, din, dout,
    dtype)`` under ``jax.vmap`` draws them: ``kw, kb = split(key)``."""
    bound = 1.0 / math.sqrt(din)
    w, b = threefry.uniform_parts(threefry.split(key), [(din, dout), (dout,)],
                                  -bound, bound, dtype)
    return {"w": w, "b": b}


def conv_init(key: torch.Tensor, cin: int, cout: int, k: int,
              dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """Conv layers (OIHW) from threefry keys ``(..., 2)``, one a key, as the
    reference's ``conv_init`` draws them: bound 1/sqrt(cin k k)
    (``nn.Conv2d``'s default), ``kw, kb = split(key)``."""
    bound = 1.0 / math.sqrt(cin * k * k)
    w, b = threefry.uniform_parts(threefry.split(key),
                                  [(cout, cin, k, k), (cout,)], -bound,
                                  bound, dtype)
    return {"w": w, "b": b}


def bn_init(n: int, dim: int, dtype=torch.float32, device="cpu"
            ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    like = dict(dtype=dtype, device=device)
    params = {"scale": torch.ones((n, dim), **like),
              "bias": torch.zeros((n, dim), **like)}
    state = {"mean": torch.zeros((n, dim), **like),
             "var": torch.ones((n, dim), **like)}
    return params, state


def dcgan_reinit(keys: torch.Tensor, params):
    """Re-draw a stacked param tree DCGAN-style (capgan.py:63-72), member n
    from threefry key ``keys[n]``, as the reference's ``dcgan_reinit(key,
    params)`` draws each member's tree: a key a leaf of the member's tree
    (``split(key, leaves)``, in ``tree_leaves`` order, which is
    ``jax.tree``'s); weights ``w`` ~ N(0, 0.02) and BatchNorm ``scale`` ~
    N(1, 0.02), drawn in the leaf's dtype with the scale and shift as weak
    scalars; linear biases and BatchNorm biases 0; conv biases left as they
    are.  A bias is a conv bias where its sibling ``w`` has rank 4 in a
    member's tree (OIHW), the reference's rank rule: a Mix-G head's conv
    weight is (k, O, I, kh, kw) there, so its bias is zeroed, as the
    reference zeroes it."""
    leaves = tree_leaves(params)
    keys = threefry.split(keys, len(leaves))                    # (n, L, 2)
    drawn = []                  # (leaf index, leaf) of every w and scale

    def mark(tree):
        if isinstance(tree, dict):
            for name in sorted(tree):
                x = tree[name]
                if not isinstance(x, torch.Tensor):
                    mark(x)
                elif name in ("w", "scale"):
                    drawn.append(x)
        elif isinstance(tree, (list, tuple)):
            for x in tree:
                mark(x)
    mark(params)
    position = {id(x): i for i, x in enumerate(leaves)}
    normals = threefry.normal_parts(
        keys[:, [position[id(x)] for x in drawn]],
        [tuple(x.shape[1:]) for x in drawn], leaves[0].dtype)
    by_leaf = {id(x): z for x, z in zip(drawn, normals)}

    def walk(tree):
        if isinstance(tree, dict):
            w = tree.get("w")
            out = {}
            for name in sorted(tree):
                x = tree[name]
                if not isinstance(x, torch.Tensor):
                    out[name] = walk(x)
                elif name in ("w", "scale"):
                    draw = by_leaf[id(x)]
                    shift = 1.0 if name == "scale" else 0.0
                    out[name] = weak(0.02, draw) * draw + weak(shift, draw)
                elif name == "b" and w is not None and w.ndim - 1 == 4:
                    out[name] = x                    # conv bias: untouched
                else:                                # linear / BN bias
                    out[name] = torch.zeros_like(x)
            return out
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(x) for x in tree)
        return tree
    return walk(params)


def linear(p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """x (N, B, din) @ w (N, din, dout) + b (N, dout).  Mixed dtypes promote
    as in JAX (float32 latents through bfloat16 params compute in
    float32)."""
    dt = torch.promote_types(x.dtype, p["w"].dtype)
    return torch.matmul(x.to(dt), p["w"].to(dt)) + p["b"].unsqueeze(-2)


def conv2d(p: Dict[str, torch.Tensor], x: torch.Tensor, stride: int = 1,
           padding: int = 1) -> torch.Tensor:
    """NCHW convolution with OIHW weights, then the bias, as the
    reference's ``conv2d`` (``torch.nn.Conv2d``)."""
    y = F.conv2d(x, p["w"], stride=stride, padding=padding)
    return y + p["b"][None, :, None, None]


def to_groups(x: torch.Tensor) -> torch.Tensor:
    """Stacked images ``(N, B, C, H, W)`` -> the grouped layout
    ``(B, N*C, H, W)``."""
    n, b, c, h, w = x.shape
    return x.transpose(0, 1).reshape(b, n * c, h, w)


def from_groups(x: torch.Tensor, n: int) -> torch.Tensor:
    """The grouped layout ``(B, N*C, H, W)`` -> ``(N, B, C, H, W)``."""
    b, nc, h, w = x.shape
    return x.reshape(b, n, nc // n, h, w).transpose(0, 1)


def group_conv2d(p: Dict[str, torch.Tensor], x: torch.Tensor,
                 stride: int = 1, padding: int = 1,
                 bias: bool = True) -> torch.Tensor:
    """N stacked convolutions (``p["w"]`` ``(N, O, I, k, k)``, ``p["b"]``
    ``(N, O)``) on the grouped layout ``(B, N*I, H, W)`` as one grouped
    ``F.conv2d``; each member's bias added after, as ``conv2d`` does
    (``bias=False``: left to the caller, ``models/tp.py``).

    ``x`` takes the weights' dtype first.  Only the eval forwards of a
    bfloat16 G feed it float32: a float32 latent promotes the ``l1``
    product to float32 (``linear``), and FeGAN's float32 eval BatchNorm
    promotes its output.  The reference hands those to its bfloat16 conv
    as they are, and XLA refuses them (``lax.conv_general_dilated`` wants
    one dtype); the rounds run in one dtype, where the cast is a no-op."""
    w = p["w"]
    n = w.shape[0]
    y = F.conv2d(x.to(w.dtype), w.reshape((-1,) + tuple(w.shape[2:])),
                 stride=stride, padding=padding, groups=n)
    return y + p["b"].reshape(1, -1, 1, 1) if bias else y


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsample of the last two axes (``nn.Upsample``'s
    default; the reference's ``jnp.repeat`` twice): every value copied."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


def scale_kept(x: torch.Tensor, keep: torch.Tensor, rate: float
               ) -> torch.Tensor:
    """``x * keep / (1 - rate)``, the reference's dropout arithmetic, with
    ``1 - rate`` a weak scalar."""
    return x * keep / weak(1.0 - rate, x)


def dropout2d(key: torch.Tensor, x: torch.Tensor, rate: float,
              train: bool) -> torch.Tensor:
    """Channel dropout (``nn.Dropout2d``) of ``x`` ``(..., B, C, H, W)``
    with threefry keys ``(..., 2)``, one a member: the keep mask
    ``bernoulli(key, 1 - rate, (B, C, 1, 1))`` as the reference draws it
    (``cglgan_tpu/models/nn.py:150``), then ``x * keep / (1 - rate)``."""
    if not train or rate == 0.0:
        return x
    keep = threefry.bernoulli(key, 1.0 - rate,
                              tuple(x.shape[-4:-2]) + (1, 1))
    return scale_kept(x, keep, rate)


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid``: JAX lowers it as 1 / (1 + exp(-x)) op by op in
    ``x``'s dtype, so in bfloat16 each of the four steps rounds (a share of
    a third of the outputs differs by one step from a sigmoid rounded
    once); float32 keeps torch's sigmoid."""
    if x.dtype != torch.bfloat16:
        return torch.sigmoid(x)
    return 1.0 / (1.0 + torch.exp(-x))


def leaky_relu(x: torch.Tensor, slope: float = 0.2) -> torch.Tensor:
    return torch.where(x >= 0, x, weak(slope, x) * x)


def batchnorm(p, s, x: torch.Tensor, train: bool, eps: float = 0.8,
              momentum: float = BN_MOMENTUM):
    """BatchNorm1d over the batch axis of stacked ``x`` (N, B, C).  The batch
    mean and the biased variance of bfloat16 ``x`` accumulate in float32
    and round once, as ``jnp.mean`` / ``jnp.var`` do; the rest runs in
    ``x``'s dtype with weak constants.  A 4-D ``x`` is the grouped image
    layout (``batchnorm2d``)."""
    if x.ndim == 4:
        return batchnorm2d(p, s, x, train, eps, momentum)
    if train:
        mean = dtypes.mean(x, 1)
        var = dtypes.var(x, 1, mean)
        count = x.shape[1]
        unbiased = var.detach() * weak(count, var) \
            / weak(max(count - 1, 1), var)
        # running stats are buffers: no gradient flows through them
        keep, take = weak(1 - momentum, s["mean"]), weak(momentum, mean)
        new_s = {"mean": keep * s["mean"] + take * mean.detach(),
                 "var": keep * s["var"] + take * unbiased}
    else:
        mean, var = s["mean"], s["var"]
        new_s = s
    inv = torch.rsqrt(var + weak(eps, var))
    y = (x - mean.unsqueeze(1)) * inv.unsqueeze(1)
    return y * p["scale"].unsqueeze(1) + p["bias"].unsqueeze(1), new_s


def batchnorm2d(p, s, x: torch.Tensor, train: bool, eps: float = 0.8,
                momentum: float = BN_MOMENTUM):
    """BatchNorm2d of N stacked members on the grouped layout ``x``
    ``(B, N*C, H, W)``, params and state ``(N, C)``: each member's channel
    normalised over (B, H, W), as the reference's ``batchnorm`` does for a
    4-D input (``cglgan_tpu/models/nn.py:120-147``): eps 0.8, momentum 0.1,
    the running variance unbiased over the B*H*W count.  In bfloat16 the
    rules of ``batchnorm``: batch mean and variance accumulated in float32
    and rounded once, the rest in ``x``'s dtype with weak constants (the
    count and count - 1 too: 6 399 rounds to 6 400)."""
    axes, shape = (0, 2, 3), (1, -1, 1, 1)
    flat = lambda t: t.reshape(-1)
    if train:
        mean = dtypes.mean(x, axes)
        var = dtypes.var(x, axes, mean)
        count = x.shape[0] * x.shape[2] * x.shape[3]
        unbiased = var.detach() * weak(count, var) \
            / weak(max(count - 1, 1), var)
        keep, take = weak(1 - momentum, s["mean"]), weak(momentum, mean)
        like = lambda t: t.reshape(s["mean"].shape)
        new_s = {"mean": keep * s["mean"] + take * like(mean.detach()),
                 "var": keep * s["var"] + take * like(unbiased)}
    else:
        mean, var = flat(s["mean"]), flat(s["var"])
        new_s = s
    inv = torch.rsqrt(var + weak(eps, var))
    y = (x - mean.reshape(shape)) * inv.reshape(shape)
    return y * flat(p["scale"]).reshape(shape) \
        + flat(p["bias"]).reshape(shape), new_s

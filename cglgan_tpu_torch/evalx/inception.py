"""InceptionV3 pool3 features: the reference FID feature space.

Port of ``cglgan_tpu/evalx/inception.py``.  The reference scores FID / IS
with pytorch-ignite's InceptionV3 features (FLGAN/MNIST/flgan.py:62-104:
100-image subsamples bilinear-resized to 299^2, channel-tripled, fed to the
pretrained torchvision ``inception_v3``).  Plain functions over a parameter
dict whose keys are the torchvision state-dict names
("Conv2d_1a_3x3.conv.weight", "Mixed_5b.branch1x1.bn.running_mean", ...),
so pretrained weights load 1:1 from an ``.npz`` archive or a torch
``.pth`` / ``.pt`` state dict.

The 94 BasicConv2d blocks are ``F.conv2d`` (no bias), eval BatchNorm with
eps 1e-3 folded as ``rsqrt(var + eps) * scale``, then ReLU; the pools are
``F.max_pool2d`` / ``F.avg_pool2d`` (cuDNN on the card; the reference's are
``lax.conv_general_dilated`` and ``reduce_window``, no Pallas kernel).
Inference only: no aux head; the output is the 2048-d global average pool.

No weights ship with the repo: ``inception_init`` draws a random network of
the same shapes from a threefry key (``core/threefry.py``), the reference's
draw within threefry's 3-ulp normals, for tests and plumbing.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from cglgan_tpu_torch.core import device as device_mod
from cglgan_tpu_torch.core import threefry
from cglgan_tpu_torch.evalx.fid import Extractor

POOL3_DIM = 2048
BN_EPS = 1e-3


# ---------------------------------------------------------------------------
# primitive: BasicConv2d = Conv(no bias) + BN(eps 1e-3) + ReLU
# ---------------------------------------------------------------------------

def _basic(p: Dict, name: str, x: torch.Tensor, stride=1, padding=0):
    x = F.conv2d(x, p[f"{name}.conv.weight"], stride=stride,
                 padding=padding)
    mean = p[f"{name}.bn.running_mean"]
    inv = torch.rsqrt(p[f"{name}.bn.running_var"] + BN_EPS) \
        * p[f"{name}.bn.weight"]
    shift = p[f"{name}.bn.bias"] - mean * inv
    return torch.relu(x * inv[None, :, None, None]
                      + shift[None, :, None, None])


def _maxpool3s2(x):
    return F.max_pool2d(x, 3, stride=2)


def _avgpool3s1p1(x):
    """torch AvgPool2d(3, stride=1, padding=1), count_include_pad=True."""
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=True)


_P1 = (1, 1)
_P2 = (2, 2)
_P17 = (0, 3)     # (1,7) kernel
_P71 = (3, 0)     # (7,1) kernel
_P13 = (0, 1)     # (1,3) kernel
_P31 = (1, 0)     # (3,1) kernel


# ---------------------------------------------------------------------------
# inception blocks (torchvision inception.py topology)
# ---------------------------------------------------------------------------

def _inception_a(p, n, x):
    b1 = _basic(p, f"{n}.branch1x1", x)
    b5 = _basic(p, f"{n}.branch5x5_1", x)
    b5 = _basic(p, f"{n}.branch5x5_2", b5, padding=_P2)
    b3 = _basic(p, f"{n}.branch3x3dbl_1", x)
    b3 = _basic(p, f"{n}.branch3x3dbl_2", b3, padding=_P1)
    b3 = _basic(p, f"{n}.branch3x3dbl_3", b3, padding=_P1)
    bp = _basic(p, f"{n}.branch_pool", _avgpool3s1p1(x))
    return torch.cat([b1, b5, b3, bp], dim=1)


def _inception_b(p, n, x):
    b3 = _basic(p, f"{n}.branch3x3", x, stride=2)
    bd = _basic(p, f"{n}.branch3x3dbl_1", x)
    bd = _basic(p, f"{n}.branch3x3dbl_2", bd, padding=_P1)
    bd = _basic(p, f"{n}.branch3x3dbl_3", bd, stride=2)
    return torch.cat([b3, bd, _maxpool3s2(x)], dim=1)


def _inception_c(p, n, x):
    b1 = _basic(p, f"{n}.branch1x1", x)
    b7 = _basic(p, f"{n}.branch7x7_1", x)
    b7 = _basic(p, f"{n}.branch7x7_2", b7, padding=_P17)
    b7 = _basic(p, f"{n}.branch7x7_3", b7, padding=_P71)
    bd = _basic(p, f"{n}.branch7x7dbl_1", x)
    bd = _basic(p, f"{n}.branch7x7dbl_2", bd, padding=_P71)
    bd = _basic(p, f"{n}.branch7x7dbl_3", bd, padding=_P17)
    bd = _basic(p, f"{n}.branch7x7dbl_4", bd, padding=_P71)
    bd = _basic(p, f"{n}.branch7x7dbl_5", bd, padding=_P17)
    bp = _basic(p, f"{n}.branch_pool", _avgpool3s1p1(x))
    return torch.cat([b1, b7, bd, bp], dim=1)


def _inception_d(p, n, x):
    b3 = _basic(p, f"{n}.branch3x3_1", x)
    b3 = _basic(p, f"{n}.branch3x3_2", b3, stride=2)
    b7 = _basic(p, f"{n}.branch7x7x3_1", x)
    b7 = _basic(p, f"{n}.branch7x7x3_2", b7, padding=_P17)
    b7 = _basic(p, f"{n}.branch7x7x3_3", b7, padding=_P71)
    b7 = _basic(p, f"{n}.branch7x7x3_4", b7, stride=2)
    return torch.cat([b3, b7, _maxpool3s2(x)], dim=1)


def _inception_e(p, n, x):
    b1 = _basic(p, f"{n}.branch1x1", x)
    b3 = _basic(p, f"{n}.branch3x3_1", x)
    b3 = torch.cat([_basic(p, f"{n}.branch3x3_2a", b3, padding=_P13),
                    _basic(p, f"{n}.branch3x3_2b", b3, padding=_P31)],
                   dim=1)
    bd = _basic(p, f"{n}.branch3x3dbl_1", x)
    bd = _basic(p, f"{n}.branch3x3dbl_2", bd, padding=_P1)
    bd = torch.cat([_basic(p, f"{n}.branch3x3dbl_3a", bd, padding=_P13),
                    _basic(p, f"{n}.branch3x3dbl_3b", bd, padding=_P31)],
                   dim=1)
    bp = _basic(p, f"{n}.branch_pool", _avgpool3s1p1(x))
    return torch.cat([b1, b3, bd, bp], dim=1)


@torch.no_grad()
def inception_pool3(params: Dict, x: torch.Tensor) -> torch.Tensor:
    """x: (N, 3, 299, 299) float.  Returns (N, 2048) pool3 features."""
    x = _basic(params, "Conv2d_1a_3x3", x, stride=2)
    x = _basic(params, "Conv2d_2a_3x3", x)
    x = _basic(params, "Conv2d_2b_3x3", x, padding=_P1)
    x = _maxpool3s2(x)
    x = _basic(params, "Conv2d_3b_1x1", x)
    x = _basic(params, "Conv2d_4a_3x3", x)
    x = _maxpool3s2(x)
    for n in ("Mixed_5b", "Mixed_5c", "Mixed_5d"):
        x = _inception_a(params, n, x)
    x = _inception_b(params, "Mixed_6a", x)
    for n in ("Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e"):
        x = _inception_c(params, n, x)
    x = _inception_d(params, "Mixed_7a", x)
    for n in ("Mixed_7b", "Mixed_7c"):
        x = _inception_e(params, n, x)
    return torch.mean(x, dim=(2, 3))      # adaptive avg pool -> (N, 2048)


# ---------------------------------------------------------------------------
# shapes / init / loading
# ---------------------------------------------------------------------------

def _conv_shapes() -> Dict[str, tuple]:
    """Every BasicConv2d as name -> (cout, cin, kh, kw), in forward order."""
    s = {}

    def basic(name, cout, cin, kh, kw):
        s[name] = (cout, cin, kh, kw)

    basic("Conv2d_1a_3x3", 32, 3, 3, 3)
    basic("Conv2d_2a_3x3", 32, 32, 3, 3)
    basic("Conv2d_2b_3x3", 64, 32, 3, 3)
    basic("Conv2d_3b_1x1", 80, 64, 1, 1)
    basic("Conv2d_4a_3x3", 192, 80, 3, 3)

    def ia(n, cin, pool):
        basic(f"{n}.branch1x1", 64, cin, 1, 1)
        basic(f"{n}.branch5x5_1", 48, cin, 1, 1)
        basic(f"{n}.branch5x5_2", 64, 48, 5, 5)
        basic(f"{n}.branch3x3dbl_1", 64, cin, 1, 1)
        basic(f"{n}.branch3x3dbl_2", 96, 64, 3, 3)
        basic(f"{n}.branch3x3dbl_3", 96, 96, 3, 3)
        basic(f"{n}.branch_pool", pool, cin, 1, 1)
        return 64 + 64 + 96 + pool

    c = ia("Mixed_5b", 192, 32)
    c = ia("Mixed_5c", c, 64)
    c = ia("Mixed_5d", c, 64)

    basic("Mixed_6a.branch3x3", 384, c, 3, 3)
    basic("Mixed_6a.branch3x3dbl_1", 64, c, 1, 1)
    basic("Mixed_6a.branch3x3dbl_2", 96, 64, 3, 3)
    basic("Mixed_6a.branch3x3dbl_3", 96, 96, 3, 3)
    c = 384 + 96 + c      # 768

    def ic(n, cin, c7):
        basic(f"{n}.branch1x1", 192, cin, 1, 1)
        basic(f"{n}.branch7x7_1", c7, cin, 1, 1)
        basic(f"{n}.branch7x7_2", c7, c7, 1, 7)
        basic(f"{n}.branch7x7_3", 192, c7, 7, 1)
        basic(f"{n}.branch7x7dbl_1", c7, cin, 1, 1)
        basic(f"{n}.branch7x7dbl_2", c7, c7, 7, 1)
        basic(f"{n}.branch7x7dbl_3", c7, c7, 1, 7)
        basic(f"{n}.branch7x7dbl_4", c7, c7, 7, 1)
        basic(f"{n}.branch7x7dbl_5", 192, c7, 1, 7)
        basic(f"{n}.branch_pool", 192, cin, 1, 1)
        return 768

    for n, c7 in (("Mixed_6b", 128), ("Mixed_6c", 160), ("Mixed_6d", 160),
                  ("Mixed_6e", 192)):
        c = ic(n, c, c7)

    basic("Mixed_7a.branch3x3_1", 192, c, 1, 1)
    basic("Mixed_7a.branch3x3_2", 320, 192, 3, 3)
    basic("Mixed_7a.branch7x7x3_1", 192, c, 1, 1)
    basic("Mixed_7a.branch7x7x3_2", 192, 192, 1, 7)
    basic("Mixed_7a.branch7x7x3_3", 192, 192, 7, 1)
    basic("Mixed_7a.branch7x7x3_4", 192, 192, 3, 3)
    c = 320 + 192 + c     # 1280

    def ie(n, cin):
        basic(f"{n}.branch1x1", 320, cin, 1, 1)
        basic(f"{n}.branch3x3_1", 384, cin, 1, 1)
        basic(f"{n}.branch3x3_2a", 384, 384, 1, 3)
        basic(f"{n}.branch3x3_2b", 384, 384, 3, 1)
        basic(f"{n}.branch3x3dbl_1", 448, cin, 1, 1)
        basic(f"{n}.branch3x3dbl_2", 384, 448, 3, 3)
        basic(f"{n}.branch3x3dbl_3a", 384, 384, 1, 3)
        basic(f"{n}.branch3x3dbl_3b", 384, 384, 3, 1)
        basic(f"{n}.branch_pool", 192, cin, 1, 1)
        return 2048

    c = ie("Mixed_7b", c)
    ie("Mixed_7c", c)
    return s


CONV_SHAPES = _conv_shapes()


def inception_init(key: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Random-weight InceptionV3 with the pretrained shapes, on ``key``'s
    device: ``split(key, 94)``, one key a conv, weights ``normal *
    sqrt(2 / fan_in)`` as the reference draws them; BN at its identity
    (scale 1, bias 0, mean 0, var 1)."""
    params = {}
    keys = threefry.split(key, len(CONV_SHAPES))
    dev = key.device
    for (name, shape), k in zip(CONV_SHAPES.items(), keys):
        fan_in = shape[1] * shape[2] * shape[3]
        he = float(np.float32(np.sqrt(2.0 / fan_in)))
        params[f"{name}.conv.weight"] = threefry.normal(k, shape) * he
        cout = shape[0]
        params[f"{name}.bn.weight"] = torch.ones((cout,), device=dev)
        params[f"{name}.bn.bias"] = torch.zeros((cout,), device=dev)
        params[f"{name}.bn.running_mean"] = torch.zeros((cout,), device=dev)
        params[f"{name}.bn.running_var"] = torch.ones((cout,), device=dev)
    return params


def load_inception_weights(path: str, device=None) -> Dict[str, torch.Tensor]:
    """A torchvision inception_v3 state dict from ``.npz`` or a torch
    ``.pth`` / ``.pt`` file, as float32 tensors on ``device`` (default the
    card).  fc / AuxLogits entries are ignored; every pool3-path tensor
    must be present with its shape."""
    dev = device_mod.resolve(device)
    if path.endswith(".npz"):
        raw = dict(np.load(path))
    else:
        sd = torch.load(path, map_location="cpu", weights_only=True)
        if hasattr(sd, "state_dict"):
            sd = sd.state_dict()
        raw = {k: v.numpy() for k, v in sd.items()}

    params = {}
    take = lambda x: torch.from_numpy(np.asarray(x, np.float32)).to(dev)
    for name, shape in CONV_SHAPES.items():
        w = raw.get(f"{name}.conv.weight")
        if w is None:
            raise ValueError(f"missing tensor {name}.conv.weight in {path}")
        if tuple(w.shape) != shape:
            raise ValueError(f"{name}.conv.weight: expected {shape}, "
                             f"got {tuple(w.shape)}")
        params[f"{name}.conv.weight"] = take(w)
        for suffix in ("weight", "bias", "running_mean", "running_var"):
            k = f"{name}.bn.{suffix}"
            if k not in raw:
                raise ValueError(f"missing tensor {k} in {path}")
            params[k] = take(raw[k])
    return params


def preprocess(images) -> torch.Tensor:
    """The reference's tick transform (FLGAN/MNIST/flgan.py:81-98): float
    images in [-1, 1], 1 or 3 channels -> (N, 3, 299, 299), bilinear with
    half-pixel centers (``align_corners=False``, ``jax.image.resize``'s
    grid)."""
    x = torch.as_tensor(images, dtype=torch.float32)
    if x.ndim == 3:
        x = x[:, None]
    if x.shape[1] == 1:
        x = x.expand(x.shape[0], 3, x.shape[2], x.shape[3])
    if x.shape[1] != 3:
        raise ValueError(f"expected 1- or 3-channel NCHW images, got "
                         f"channel count {x.shape[1]}")
    return F.interpolate(x, size=(299, 299), mode="bilinear",
                         align_corners=False)


def inception_extractor(params=None, key=None, device=None) -> Extractor:
    """An ``evalx.fid.Extractor`` over pool3 features.  ``params`` from
    ``load_inception_weights`` (real) or ``inception_init`` (random); if
    None, random weights from ``key`` (default ``key(0)`` on ``device``)."""
    if params is None:
        if key is None:
            key = threefry.key(0, device_mod.resolve(device))
        params = inception_init(key)

    def apply(p, images):
        return inception_pool3(p, preprocess(images))

    return Extractor(params, apply)


def load_fid_stats(path: str, expect_side: int = None):
    """Precomputed real-image activation statistics: an ``.npz`` with ``mu``
    (D,) and ``sigma`` (D, D) (pytorch-fid's format; ``cov`` is read too).
    When the file records the image ``side`` its stats were computed at
    and ``expect_side`` is given, a mismatch (28px stats under a 32px conv
    run) raises instead of biasing FID."""
    z = np.load(path)
    mu = np.asarray(z["mu"], np.float64)
    sigma = np.asarray(z["sigma"] if "sigma" in z else z["cov"], np.float64)
    if mu.ndim != 1 or sigma.shape != (mu.shape[0], mu.shape[0]):
        raise ValueError(f"bad stats shapes mu{mu.shape} sigma{sigma.shape}")
    if expect_side is not None and "side" in z \
            and int(z["side"]) != expect_side:
        raise ValueError(
            f"stats in {path} were computed on {int(z['side'])}px images but "
            f"this run evaluates at {expect_side}px — regenerate them at "
            f"{expect_side}px")
    return mu, sigma


def save_fid_stats(path: str, mu, sigma, side: int = None) -> None:
    extra = {} if side is None else {"side": np.int64(side)}
    np.savez(path, mu=np.asarray(mu), sigma=np.asarray(sigma), **extra)

"""MNIST / Fashion-MNIST loading.

The reference pulls torchvision datasets with
``Resize(28) + ToTensor + Normalize([0.5],[0.5])`` (capgan.py:465-478).  This
environment has no torchvision and no network egress, so two paths exist:

* ``load_idx_dataset`` — reads the standard IDX files
  (train-images-idx3-ubyte[.gz], train-labels-idx1-ubyte[.gz]) from
  ``data_dir`` when real data is present on the machine.
* ``synthetic_mnist`` — a deterministic, label-conditioned 28x28 stand-in
  (10 structurally distinct glyph classes with per-sample jitter).  It
  preserves the workload shape exactly (60 000 x 1 x 28 x 28, 10 classes),
  so Non-IID partition structure, throughput and convergence dynamics are
  representative even though pixel content is not handwriting.

All loaders return uint8 images (N, 28, 28) + int labels; normalisation to
[-1, 1] happens on-device at batch time (see algos.common.normalize_images)
to keep HBM-resident shards 4x smaller.

The port's own copy of ``cglgan_tpu/data/mnist.py``: same generators, same
bytes (``tests/test_torch_port_modules.py``).
"""
from __future__ import annotations

import gzip
import os
import struct
from typing import Optional, Tuple

import numpy as np

from cglgan_tpu_torch.data import native


def _open_maybe_gz(path: str):
    return gzip.open(path, "rb") if path.endswith(".gz") else open(path, "rb")


def _read_idx(path: str) -> np.ndarray:
    with _open_maybe_gz(path) as f:
        zero, dtype_code, ndim = struct.unpack(">HBB", f.read(4))
        if zero != 0:
            raise ValueError(f"{path}: bad IDX magic")
        shape = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        dt = {8: np.uint8, 9: np.int8, 11: np.int16, 12: np.int32,
              13: np.float32, 14: np.float64}[dtype_code]
        return np.frombuffer(f.read(), dtype=np.dtype(dt).newbyteorder(">"),
                             ).reshape(shape).astype(dt)


def load_idx_dataset(data_dir: str, split: str = "train") -> Tuple[np.ndarray, np.ndarray]:
    prefix = "train" if split == "train" else "t10k"
    imgs = labels = None
    for ext in ("", ".gz"):
        ip = os.path.join(data_dir, f"{prefix}-images-idx3-ubyte{ext}")
        lp = os.path.join(data_dir, f"{prefix}-labels-idx1-ubyte{ext}")
        if os.path.exists(ip) and os.path.exists(lp):
            imgs, labels = _read_idx(ip), _read_idx(lp)
            break
    if imgs is None:
        raise FileNotFoundError(f"no IDX files for split {split!r} in {data_dir}")
    return imgs, labels.astype(np.int64)


# ---------------------------------------------------------------------------
# Synthetic stand-in
# ---------------------------------------------------------------------------

def _glyph_bank(img: int = 28) -> np.ndarray:
    """10 distinct 28x28 float templates in [0, 1]: rings, bars, crosses,
    blobs at class-dependent positions/scales."""
    yy, xx = np.mgrid[0:img, 0:img].astype(np.float32)
    cx, cy = (img - 1) / 2.0, (img - 1) / 2.0
    r = np.sqrt((xx - cx) ** 2 + (yy - cy) ** 2)
    ang = np.arctan2(yy - cy, xx - cx)
    g = np.zeros((10, img, img), np.float32)
    g[0] = np.exp(-((r - 8.0) ** 2) / 6.0)                          # ring
    g[1] = np.exp(-((xx - cx) ** 2) / 5.0)                          # vertical bar
    g[2] = np.exp(-((yy - cy) ** 2) / 5.0)                          # horizontal bar
    g[3] = np.maximum(g[1], g[2])                                   # cross
    g[4] = np.exp(-((xx - yy) ** 2) / 8.0)                          # diagonal
    g[5] = np.exp(-((xx + yy - 2 * cx) ** 2) / 8.0)                 # anti-diagonal
    g[6] = np.exp(-((r - 4.0) ** 2) / 4.0) + np.exp(-((r - 11.0) ** 2) / 4.0)  # double ring
    g[7] = np.exp(-(((xx - 8) ** 2 + (yy - 8) ** 2)) / 12.0) \
         + np.exp(-(((xx - 20) ** 2 + (yy - 20) ** 2)) / 12.0)      # two blobs
    g[8] = (np.cos(3 * ang) * 0.5 + 0.5) * np.exp(-((r - 8) ** 2) / 16.0)  # 3-lobe
    g[9] = np.exp(-((r - 6.0 - 3.0 * np.sin(2 * ang)) ** 2) / 6.0)  # wavy ring
    return np.clip(g, 0.0, 1.0)


def _soft_rect(xx, yy, x0, x1, y0, y1, sharp: float = 1.5) -> np.ndarray:
    """Soft-edged axis-aligned rectangle mask in [0, 1]."""
    s = lambda t: 1.0 / (1.0 + np.exp(-sharp * t))
    return s(xx - x0) * s(x1 - xx) * s(yy - y0) * s(y1 - yy)


def _fashion_glyph_bank(img: int = 28) -> np.ndarray:
    """10 garment-silhouette templates, structurally DISTINCT from the mnist
    bank, so the two synthetic workloads are genuinely different datasets
    (the reference treats MNIST and Fashion-MNIST as separate sweep entries,
    capgan.py:465-478).  Classes follow the Fashion-MNIST label order:
    t-shirt, trouser, pullover, dress, coat, sandal, shirt, sneaker, bag,
    ankle boot."""
    yy, xx = np.mgrid[0:img, 0:img].astype(np.float32)
    c = (img - 1) / 2.0
    R = lambda x0, x1, y0, y1: _soft_rect(xx, yy, x0, x1, y0, y1)
    g = np.zeros((10, img, img), np.float32)
    # 0 t-shirt: torso + short sleeves
    g[0] = np.maximum(R(9, 18, 7, 22), R(4, 23, 7, 12))
    # 1 trouser: two legs joined at a waistband
    g[1] = np.maximum.reduce([R(9, 13, 9, 24), R(15, 19, 9, 24),
                              R(9, 19, 5, 9)])
    # 2 pullover: wide torso + long sleeves
    g[2] = np.maximum.reduce([R(8, 19, 6, 22), R(2, 8, 6, 18),
                              R(19, 25, 6, 18)])
    # 3 dress: narrow top widening to a skirt (trapezoid)
    width = 2.0 + (yy - 5.0) * 0.45
    g[3] = _soft_rect(xx, yy, c - width, c + width, 5, 24)
    # 4 coat: long torso, long sleeves, centre opening (dark seam)
    g[4] = np.maximum.reduce([R(8, 19, 5, 25), R(3, 8, 5, 20),
                              R(19, 24, 5, 20)]) \
        * (1.0 - 0.8 * _soft_rect(xx, yy, 12.6, 14.4, 6, 25))
    # 5 sandal: sole bar + two thin straps
    g[5] = np.maximum.reduce([R(4, 24, 19, 23), R(7, 10, 10, 19),
                              R(16, 19, 12, 19)])
    # 6 shirt: torso + sleeves + collar notch
    g[6] = np.maximum.reduce([R(9, 18, 7, 23), R(5, 9, 7, 14),
                              R(18, 22, 7, 14)]) \
        * (1.0 - 0.7 * _soft_rect(xx, yy, 12, 15, 5, 10))
    # 7 sneaker: low wedge + thick sole
    g[7] = np.maximum(R(4, 23, 14, 20) * _soft_rect(xx, yy, 4, 23, 10 +
                                                    (23 - xx) * 0.3, 20),
                      R(4, 23, 20, 23))
    # 8 bag: body + handle arc
    r_h = np.sqrt((xx - c) ** 2 + (yy - 8.0) ** 2)
    g[8] = np.maximum(R(6, 21, 11, 23),
                      np.exp(-((r_h - 5.0) ** 2) / 2.0) * (yy < 11))
    # 9 ankle boot: L-shaped shaft + foot
    g[9] = np.maximum(R(8, 14, 5, 21), R(8, 23, 15, 21))
    return np.clip(g, 0.0, 1.0)


def synthetic_mnist(n: int = 60000, num_class: int = 10, img: int = 28,
                    seed: int = 20211212, backend: str = "auto",
                    family: str = "mnist") -> Tuple[np.ndarray, np.ndarray]:
    """Deterministic label-conditioned glyph dataset, uint8 (n, img, img).

    ``backend``: "native" (C++ dataplane, ~50x faster), "numpy", or "auto"
    (native when built, else numpy).  Each backend is deterministic per seed
    but their RNG streams differ — pin a backend for bit-reproducibility.
    ``family``: "mnist" (digit-ish glyphs) or "fashion" (garment
    silhouettes) — two structurally distinct workloads, like the reference's
    two sweep datasets.  The native backend generates the mnist bank only.
    """
    if backend == "native" and family != "mnist":
        raise ValueError(
            "backend='native' generates the mnist glyph bank only; use "
            "backend='numpy' (or 'auto') for family='fashion'")
    if family == "mnist" and (backend == "native" or
                              (backend == "auto" and native.available())):
        return native.synth_glyphs(n, img, num_class, seed)
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, num_class, size=n)
    bank = (_fashion_glyph_bank(img) if family == "fashion"
            else _glyph_bank(img))[:num_class]
    shifts_x = rng.integers(-2, 3, size=n)
    shifts_y = rng.integers(-2, 3, size=n)
    gains = rng.uniform(0.75, 1.0, size=n).astype(np.float32)
    noise = rng.normal(0.0, 0.04, size=(n, img, img)).astype(np.float32)
    base = bank[labels]
    out = np.empty((n, img, img), np.float32)
    for dx in range(-2, 3):            # vectorise over the 25 shift buckets
        for dy in range(-2, 3):
            m = (shifts_x == dx) & (shifts_y == dy)
            if not m.any():
                continue
            out[m] = np.roll(np.roll(base[m], dx, axis=2), dy, axis=1)
    out = np.clip(out * gains[:, None, None] + noise, 0.0, 1.0)
    labels_sorted = np.sort(labels, kind="stable")
    order = np.argsort(labels, kind="stable")
    return (out[order] * 255).astype(np.uint8), labels_sorted.astype(np.int64)


def load_image_dataset(name: str, data_dir: Optional[str] = None,
                       seed: int = 20211212) -> Tuple[np.ndarray, np.ndarray]:
    """Dispatch: real IDX data when available, synthetic otherwise.

    Returned images are label-UNSORTED for mnist idx / synthetic already
    sorted — partition() sorts internally for iid != 0, so ordering here is
    irrelevant; we return whatever the source gives.
    """
    family = "fashion" if name == "fashion-mnist" else "mnist"
    if name == "synthetic-mnist" or data_dir is None:
        return synthetic_mnist(seed=seed, family=family)
    sub = {"mnist": "mnist", "fashion-mnist": "fashion-mnist"}.get(name, name)
    for cand in (os.path.join(data_dir, sub), data_dir):
        try:
            return load_idx_dataset(cand)
        except FileNotFoundError:
            continue
    return synthetic_mnist(seed=seed, family=family)

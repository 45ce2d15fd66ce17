"""Image artifacts: sample grids and 2DMG scatter plots, as PNG files.

Port of ``cglgan_tpu/utils/imaging.py``: 10x10 sample grids every eval tick
on image data (ACGAN/MNIST/acgan.py:64-73, capgan.py:83), per-device
distribution previews at startup (CGLGAN/MNIST/main.py:499-501,
ACGAN/2DMG/acgan.py:344-349) and real-vs-generated scatter plots on 2DMG
(ACGAN/2DMG/acgan.py:67-75).  The reference writes them with PIL and
matplotlib; here the PNG is encoded with ``zlib`` and ``struct`` alone, so
the artifacts need neither.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np


def write_png(path: str, pixels: np.ndarray) -> None:
    """uint8 (H, W) grayscale or (H, W, 3) RGB pixels as an 8-bit PNG
    (one IDAT chunk, no filtering)."""
    pixels = np.ascontiguousarray(pixels, np.uint8)
    h, w = pixels.shape[:2]
    color = {2: 0, 3: 2}[pixels.ndim]             # grayscale / truecolour
    rows = pixels.reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color,
                                           0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)))
        f.write(chunk(b"IEND", b""))


def save_image_grid(images, path: str, nrow: int = 10,
                    normalize: bool = True) -> None:
    """images: (N, 1, H, W) or (N, H, W) in [-1, 1] (normalize=True) or
    [0, 1].  Writes an nrow-wide grayscale PNG grid with a 2-pixel gap,
    the reference's canvas pixel for pixel
    (``cglgan_tpu/utils/imaging.py:22-36``)."""
    x = np.asarray(images, np.float32)
    if x.ndim == 4:
        x = x[:, 0]
    if normalize:
        lo, hi = x.min(), x.max()
        x = (x - lo) / max(hi - lo, 1e-8)
    n, h, w = x.shape
    rows = -(-n // nrow)
    pad = 2
    canvas = np.zeros((rows * (h + pad) + pad, nrow * (w + pad) + pad),
                      np.float32)
    for i in range(n):
        r, c = divmod(i, nrow)
        canvas[pad + r * (h + pad):pad + r * (h + pad) + h,
               pad + c * (w + pad):pad + c * (w + pad) + w] = x[i]
    write_png(path, (canvas * 255).astype(np.uint8))


SCATTER_SIDE = 550          # the reference's 5-inch figure at 110 dpi
_LIM = 1.1
_REAL = (np.array([31, 119, 180], np.float64), 0.2)       # faint
_GEN = (np.array([255, 127, 14], np.float64), 0.8)        # solid


def save_scatter_2d(path: str, real, generated=None) -> None:
    """Real (faint) vs generated (solid) points on the [-1.1, 1.1]^2 frame,
    a ``SCATTER_SIDE`` square RGB PNG.  Each point paints a 2x2 pixel dot
    with the reference's alpha (0.2 real, 0.8 generated), dots blending
    over each other; points outside the frame are left out.  The frame,
    colours and alphas are the reference's matplotlib figure's, but the
    raster is not pixel-equal to it (no axes, ticks or antialiasing)."""
    side = SCATTER_SIDE
    img = np.full((side, side, 3), 255.0)
    for pts, (color, alpha) in ((real, _REAL), (generated, _GEN)):
        if pts is None:
            continue
        pts = np.asarray(pts, np.float64).reshape(-1, 2)
        col = np.floor((pts[:, 0] + _LIM) / (2 * _LIM) * side).astype(
            np.int64)
        row = np.floor((_LIM - pts[:, 1]) / (2 * _LIM) * side).astype(
            np.int64)
        hits = np.zeros(side * side, np.int64)
        for dr in (0, 1):
            for dc in (0, 1):
                r, c = row + dr, col + dc
                ok = (r >= 0) & (r < side) & (c >= 0) & (c < side)
                hits += np.bincount(r[ok] * side + c[ok],
                                    minlength=side * side)
        keep = (1.0 - alpha) ** hits.reshape(side, side, 1)
        img = img * keep + color * (1.0 - keep)
    write_png(path, np.round(img).astype(np.uint8))

"""2DMG evaluation: KL Score and Distribution Score.

Port of ``cglgan_tpu/evalx/hist2d.py`` as plain functions on tensors (any
device; the histogram is a bucketised ``bincount``, so nothing leaves the
device per call).  Reference painter (ACGAN/2DMG/acgan.py:56-99,
CGLGAN/2DMG/main.py:63-101): 16-bin (32 for MD-GAN) 2-D histograms of real
and generated samples on [-1,1]^2; KL Score = scipy entropy(g_hist, r_hist)
restricted to cells where the real histogram is non-zero; Distribution Score
= fraction of generated mass falling inside real-support cells.
"""
from __future__ import annotations

from typing import Tuple

import torch


def hist2d(pts: torch.Tensor, bins: int = 16) -> torch.Tensor:
    """Counts on a bins x bins grid over [-1,1]^2; matches numpy.histogram2d
    with range [[-1,1],[-1,1]] (right-inclusive last edge, out-of-range
    dropped)."""
    pts = pts.float()
    fx = (pts[:, 0] + 1.0) * (bins / 2.0)
    fy = (pts[:, 1] + 1.0) * (bins / 2.0)
    ix = torch.clamp(torch.floor(fx), 0, bins - 1).long()
    iy = torch.clamp(torch.floor(fy), 0, bins - 1).long()
    valid = (fx >= 0) & (fx <= bins) & (fy >= 0) & (fy <= bins)
    counts = torch.bincount(ix * bins + iy, weights=valid.float(),
                            minlength=bins * bins)
    return counts.reshape(bins, bins)


def kl_and_distribution_score(generated: torch.Tensor, real: torch.Tensor,
                              bins: int = 16
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (kl_score, distribution_score).

    kl: entropy(g[support], r[support]) where support = cells with real mass —
    scipy normalises both histograms over the selected cells
    (acgan.py:80-87).  ds: sum(g[support]) / len(generated) (acgan.py:88)."""
    cg = hist2d(generated, bins)
    cr = hist2d(real, bins)
    support = cr > 0
    zero = torch.zeros_like(cg)
    g = torch.where(support, cg, zero)
    r = torch.where(support, cr, zero)
    gn = g / torch.clamp(g.sum(), min=1e-12)
    rn = r / torch.clamp(r.sum(), min=1e-12)
    # where gn == 0 the term is 0 (log of a placeholder 1 keeps it finite)
    safe = torch.where(gn > 0, gn / torch.clamp(rn, min=1e-12),
                       torch.ones_like(gn))
    kl = torch.sum(gn * torch.log(safe))
    ds = g.sum() / generated.shape[0]
    return kl, ds


def mode_coverage(generated: torch.Tensor, real: torch.Tensor,
                  bins: int = 16) -> torch.Tensor:
    """Fraction of real-support cells hit by any generated sample — the
    commented "cs" metric (acgan.py:89)."""
    cg = hist2d(generated, bins)
    cr = hist2d(real, bins)
    support = cr > 0
    hit = (cg > 0) & support
    return hit.sum() / torch.clamp(support.sum(), min=1)

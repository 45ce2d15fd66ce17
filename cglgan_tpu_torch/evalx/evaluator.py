"""The per-workload evaluator: the tick metrics of a run.

Port of ``cglgan_tpu/evalx/evaluator.py`` for 2DMG: KL Score, Distribution
Score and mode coverage on the painter's histogram protocol
(ACGAN/2DMG/acgan.py:56-99), with 32 bins for MD-GAN
(MDGAN/2DMG/mdgan.py:69) and 16 for every other algorithm.  Image configs
(FID / Inception Score) are not ported yet and raise.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from cglgan_tpu_torch.evalx.hist2d import (kl_and_distribution_score,
                                           mode_coverage)


def make_evaluator(cfg, part, eval_n: Optional[int] = None) -> Callable:
    """``evaluate(runner, state, samples=None) -> dict`` for the config's
    workload; ``eval_n`` samples a tick (default ``cfg.num_sample``)."""
    if cfg.is_image:
        raise NotImplementedError(
            "image evaluation (FID / Inception Score) is not ported yet "
            "(ROADMAP queue 1 item 13)")
    bins = 32 if cfg.algo == "mdgan" else 16
    n = eval_n if eval_n is not None else cfg.num_sample
    pool = torch.from_numpy(part.eval_pool)

    def evaluate(runner, state, samples=None) -> Dict[str, float]:
        if samples is None:
            samples = runner.sample(state, n)
        real = pool.to(samples.device)
        kl, ds = kl_and_distribution_score(samples, real, bins)
        cov = mode_coverage(samples, real, bins)
        return {"kl_score": float(kl), "distribution_score": float(ds),
                "mode_coverage": float(cov)}

    return evaluate

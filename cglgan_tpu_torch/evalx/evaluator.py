"""The per-workload evaluator: the tick metrics of a run.

Port of ``cglgan_tpu/evalx/evaluator.py``.  2DMG configs score KL Score,
Distribution Score and mode coverage on the painter's histogram protocol
(ACGAN/2DMG/acgan.py:56-99), with 32 bins for MD-GAN
(MDGAN/2DMG/mdgan.py:69) and 16 for every other algorithm.  Image configs
score FID and Inception Score on 100-image subsamples a tick
(FLGAN/MNIST/flgan.py:62-104) over the reference's proxy feature space
(``evalx/fid.py``): a fixed random-conv embedding for FID and a probe
classifier for IS.  InceptionV3 pool3 and precomputed real-image stats are
ROADMAP queue 1 entry 1 (b) and raise.

Built once a run (the probe trains here, on ``device``); the returned
callable is cheap a tick.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from cglgan_tpu_torch.core import device as device_mod
from cglgan_tpu_torch.evalx.hist2d import (kl_and_distribution_score,
                                           mode_coverage)


def make_evaluator(cfg, part, eval_n: Optional[int] = None,
                   fid_stats: Optional[str] = None,
                   inception_weights: Optional[str] = None,
                   probe_steps: int = 300, device=None) -> Callable:
    """``evaluate(runner, state, samples=None) -> dict`` for the config's
    workload; ``eval_n`` samples a tick (default ``cfg.num_sample`` on
    2DMG, 100 on images).  Runs on ``device`` (default the card)."""
    dev = device_mod.resolve(device)
    if not cfg.is_image:
        bins = 32 if cfg.algo == "mdgan" else 16
        n = eval_n if eval_n is not None else cfg.num_sample
        pool = torch.from_numpy(part.eval_pool).to(dev)

        def evaluate(runner, state, samples=None) -> Dict[str, float]:
            if samples is None:
                samples = runner.sample(state, n)
            samples = samples.to(dev)
            kl, ds = kl_and_distribution_score(samples, pool, bins)
            cov = mode_coverage(samples, pool, bins)
            return {"kl_score": float(kl), "distribution_score": float(ds),
                    "mode_coverage": float(cov)}

        return evaluate

    if fid_stats or inception_weights:
        raise NotImplementedError(
            "InceptionV3 pool3 features and precomputed FID stats are not "
            "ported yet (ROADMAP queue 1 entry 1 (b)); images score with "
            "the proxy feature space")
    from cglgan_tpu_torch.evalx.fid import (activation_stats,
                                            classifier_probe,
                                            conv_feature_extractor,
                                            frechet_distance,
                                            inception_score)

    side = cfg.img_size + 4 if cfg.conv else cfg.img_size
    n = eval_n if eval_n is not None else 100    # reference subsample size
    extractor = conv_feature_extractor(side, device=dev)

    # The flattened partition rows are label-ordered under iid=1/2, so the
    # probe's training subset is a seeded shuffle that sees every class.
    data_all = part.data.reshape(-1, side, side)
    labels_all = part.labels.reshape(-1)
    sel = np.random.default_rng(cfg.seed).permutation(len(data_all))[:20000]
    probe = classifier_probe(data_all[sel], labels_all[sel], cfg.num_class,
                             steps=probe_steps, device=dev)

    real = (part.eval_pool[:n].astype(np.float32) / 255.0 - 0.5) / 0.5
    real = real.reshape(-1, 1, side, side)
    mu_r, cov_r = activation_stats(extractor, real)

    def evaluate(runner, state, samples=None) -> Dict[str, float]:
        if samples is None:
            samples = runner.sample(state, n)
        gen = samples.reshape(-1, 1, side, side)[:n]
        mu_g, cov_g = activation_stats(extractor, gen)
        return {"fid": frechet_distance(mu_g, cov_g, mu_r, cov_r),
                "inception_score": inception_score(probe, gen,
                                                   cfg.num_class)}

    return evaluate

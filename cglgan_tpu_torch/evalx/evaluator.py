"""The per-workload evaluator: the tick metrics of a run.

Port of ``cglgan_tpu/evalx/evaluator.py``.  2DMG configs score KL Score,
Distribution Score and mode coverage on the painter's histogram protocol
(ACGAN/2DMG/acgan.py:56-99), with 32 bins for MD-GAN
(MDGAN/2DMG/mdgan.py:69) and 16 for every other algorithm.  Image configs
score FID and Inception Score on 100-image subsamples a tick
(FLGAN/MNIST/flgan.py:62-104) over a feature space:

* with ``inception_weights`` (an ``.npz`` or ``.pth`` torchvision state
  dict) — InceptionV3 pool3 (``evalx/inception.py``), the reference's FID
  space;
* otherwise — the reference's proxy (``evalx/fid.py``): a fixed random-conv
  embedding for FID.

IS always comes from the probe classifier, trained on the real data: pool3
has no class head.  ``fid_stats`` supplies precomputed real-image
statistics (pytorch-fid's ``.npz`` mu / sigma) in place of the real
subsample's; their dimension must be the extractor's (2048 pool3, 256
proxy) and their recorded side the run's.

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
    2DMG, 100 on images).  On images FID is scored in InceptionV3 pool3
    space when ``inception_weights`` names a weights file, else in the
    proxy space; ``fid_stats`` (a path) replaces the real subsample's
    statistics.  Runs on ``device`` (default the card)."""
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

    from cglgan_tpu_torch.evalx.fid import (activation_stats,
                                            classifier_probe,
                                            conv_feature_extractor,
                                            frechet_distance,
                                            inception_score)

    side = cfg.img_size + 4 if cfg.conv else cfg.img_size
    n = eval_n if eval_n is not None else 100    # reference subsample size
    if inception_weights:
        from cglgan_tpu_torch.evalx.inception import (
            POOL3_DIM, inception_extractor, load_inception_weights)
        extractor = inception_extractor(
            load_inception_weights(inception_weights, dev))
        feat_dim = POOL3_DIM
    else:
        extractor = conv_feature_extractor(side, device=dev)
        feat_dim = 256

    # The flattened partition rows are label-ordered under iid=1/2, so the
    # probe's training subset is a seeded shuffle that sees every class.
    data_all = part.data.reshape(-1, side, side)
    labels_all = part.labels.reshape(-1)
    sel = np.random.default_rng(cfg.seed).permutation(len(data_all))[:20000]
    probe = classifier_probe(data_all[sel], labels_all[sel], cfg.num_class,
                             steps=probe_steps, device=dev)

    if fid_stats:
        from cglgan_tpu_torch.evalx.inception import load_fid_stats
        mu_r, cov_r = load_fid_stats(fid_stats, expect_side=side)
        if mu_r.shape[0] != feat_dim:
            space = "inception-pool3" if inception_weights else "proxy-conv"
            raise ValueError(
                f"fid_stats has {mu_r.shape[0]}-d features but the active "
                f"extractor ({space}) emits {feat_dim}-d — pass matching "
                "stats (pool3 stats require inception_weights)")
    else:
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

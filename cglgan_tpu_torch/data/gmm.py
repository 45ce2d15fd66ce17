"""Synthetic 2-D Gaussian-Mixture dataset ("2DMG").

Port of ``cglgan_tpu/data/gmm.py``: ``n_class`` modes spaced on the unit
circle (radius 1, std 0.01), ``samples_per_class`` samples per class on
average, returned label-sorted (reference ``gmm`` class,
CGLGAN/2DMG/data.py:5-38).

``gmm_modes`` is numpy and equals the reference bit for bit; so does
``gmm_dataset``'s draw: ``k_mode, k_noise = split(key(seed))``, labels
``randint(k_mode, (n,), 0, n_class)`` (bit-equal), ``std * normal(k_noise,
(n, 2))`` in float32 (within 3 ulps, as ``core/threefry.py``'s normals),
then a stable sort by label, as ``jnp.argsort(labels, stable=True)``.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from cglgan_tpu_torch.core import threefry


def gmm_modes(n_class: int, radius: float = 1.0) -> np.ndarray:
    """Mode centres: theta_i = linspace(0, 2*pi*(1-1/n), n) with
    (x, y) = (r*sin, r*cos) exactly as the reference (data.py:28-29)."""
    thetas = np.linspace(0.0, 2.0 * (1.0 - 1.0 / n_class) * np.pi, n_class)
    return np.stack([radius * np.sin(thetas), radius * np.cos(thetas)], axis=1)


def gmm_dataset(n_class: int = 5,
                samples_per_class: int = 10000,
                std: float = 0.01,
                seed: int = 20211212) -> Tuple[np.ndarray, np.ndarray]:
    """Returns ``(data (n*x, 2) float32, labels (n*x,) int32)`` as numpy,
    label-sorted.  Mode assignment is uniform-random per sample (the
    reference draws ``randint(0, n_mixture)`` per sample, then sorts by
    label), so per-class counts are multinomial, not exactly equal."""
    n = n_class * samples_per_class
    k_mode, k_noise = threefry.split(threefry.key(seed))
    labels = threefry.randint(k_mode, (n,), 0, n_class)
    centres = torch.from_numpy(gmm_modes(n_class).astype(np.float32))
    noise = std * threefry.normal(k_noise, (n, 2))
    data = centres[labels.long()] + noise
    order = torch.argsort(labels, stable=True)
    return data[order].numpy(), labels[order].numpy()

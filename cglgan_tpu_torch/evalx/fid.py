"""FID and Inception Score over the proxy feature space.

Port of ``cglgan_tpu/evalx/fid.py``.  The reference protocol scores
100-image subsamples with InceptionV3 features (FLGAN/MNIST/flgan.py:62-104);
without Inception weights the reference uses a documented proxy, and so
does this port (with weights, ``evalx/inception.py``'s pool3):

* ``conv_feature_extractor``: a fixed-seed random convolutional embedding
  for FID; absolute values are not comparable to Inception FID.
* ``classifier_probe``: a small CNN trained on the real data, whose
  penultimate layer is a learned feature space and whose softmax is the
  class model of the Inception Score.

Every weight, probe batch and init comes from the reference's fixed seeds
through ``core/threefry.py``, so on the same samples both packages score
the same metric.  Features are computed on the extractor's device and
cross to the host as float32; the statistics, ``sqrtm`` and the score are
the reference's numpy code, verbatim.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Tuple

import numpy as np
import torch

from cglgan_tpu_torch.algos.common import adam_init, adam_update
from cglgan_tpu_torch.core import device as device_mod
from cglgan_tpu_torch.core import threefry
from cglgan_tpu_torch.models import nn
from cglgan_tpu_torch.utils.tree import tree_leaves, tree_map, \
    tree_unflatten


class Extractor(NamedTuple):
    params: Any
    apply: Callable  # (params, images NCHW float) -> (N, feat_dim)


def _device(extractor: Extractor) -> torch.device:
    return tree_leaves(extractor.params)[0].device


# ---------------------------------------------------------------------------
# feature spaces
# ---------------------------------------------------------------------------

def conv_feature_extractor(img_size: int = 28, feat_dim: int = 256,
                           seed: int = 20211212, device=None) -> Extractor:
    """3 stride-2 conv blocks + global pooling + fixed projection, all with
    frozen N(0, sigma) weights (He-scaled), drawn as the reference draws
    them.  ``img_size`` is unused, as in the reference (any side works)."""
    ks = threefry.split(threefry.key(seed, device_mod.resolve(device)), 4)
    chans = [(1, 32), (32, 64), (64, 128)]
    params = {}
    for i, (cin, cout) in enumerate(chans):
        w = threefry.normal(ks[i], (cout, cin, 3, 3)) \
            * float(np.sqrt(2.0 / (cin * 9)))
        params[f"c{i}"] = {"w": w, "b": torch.zeros((cout,),
                                                    device=w.device)}
    proj = threefry.normal(ks[3], (128, feat_dim))
    params["proj"] = proj / torch.tensor(np.float32(np.sqrt(128)),
                                         device=proj.device)

    def apply(params, x):
        for i in range(3):
            x = nn.conv2d(params[f"c{i}"], x, stride=2)
            x = nn.leaky_relu(x, 0.2)
        x = torch.mean(x, dim=(2, 3))            # global average pool
        return x @ params["proj"]

    return Extractor(params, apply)


def probe_init(side: int, num_class: int = 10, seed: int = 0, device=None):
    """The probe's untrained params, from ``key(seed)`` as the reference's
    ``classifier_probe`` draws them."""
    ks = threefry.split(threefry.key(seed, device_mod.resolve(device)), 5)
    flat = 64 * (side // 4) ** 2
    return {"c0": nn.conv_init(ks[0], 1, 32, 3),
            "c1": nn.conv_init(ks[1], 32, 64, 3),
            "l0": nn.linear_init(ks[2], flat, 128),
            "l1": nn.linear_init(ks[3], 128, num_class)}


def _probe_net(params, x):
    x = nn.leaky_relu(nn.conv2d(params["c0"], x, stride=2))
    x = nn.leaky_relu(nn.conv2d(params["c1"], x, stride=2))
    x = x.reshape(x.shape[0], -1)
    feat = nn.leaky_relu(nn.linear(params["l0"], x))
    return feat, nn.linear(params["l1"], feat)


def probe_batches(seed: int, steps: int, batch: int, n: int, device=None):
    """The probe's batch indices, step by step: ``key(seed + 1)`` split
    once a step, ``randint`` over ``[0, n)`` from the second half (int32
    ``(batch,)`` on ``device``)."""
    k = threefry.key(seed + 1, device_mod.resolve(device))
    for _ in range(steps):
        k, sub = threefry.split(k)
        yield threefry.randint(sub, (batch,), 0, n)


def classifier_probe(images_u8: np.ndarray, labels: np.ndarray,
                     num_class: int = 10, steps: int = 500,
                     batch: int = 256, seed: int = 0,
                     device=None) -> Extractor:
    """Train a small CNN classifier on the real data; its penultimate layer
    is the FID feature space and its softmax the IS class model.  Returns
    an Extractor whose apply gives (features, logits) concatenated (use
    ``split_probe_output``).  Any square side works (the two stride-2 convs
    flatten to 64*(side//4)^2).  The data lives on ``device`` as uint8 and
    the training is optax's float32 Adam (lr 1e-3) in its op order."""
    dev = device_mod.resolve(device)
    side = int(images_u8.shape[-1])
    params = probe_init(side, num_class, seed, dev)
    data = torch.from_numpy(np.ascontiguousarray(images_u8)).to(dev)
    labs = torch.from_numpy(np.asarray(labels, np.int64)).to(dev)
    one = lambda tree: tree_map(lambda x: x.unsqueeze(0), tree)
    opt = adam_init(one(params), 1)
    rows = torch.arange(batch, device=dev)
    for idx in probe_batches(seed, steps, batch, data.shape[0], dev):
        x = ((data[idx].float() / 255.0 - 0.5) / 0.5)[:, None, :, :]
        y = labs[idx]
        leaves = [p.detach().requires_grad_(True)
                  for p in tree_leaves(params)]
        _, logits = _probe_net(tree_unflatten(params, leaves), x)
        loss = -torch.mean(torch.log_softmax(logits, -1)[rows, y])
        grads = torch.autograd.grad(loss, leaves)
        stacked, opt = adam_update(one(params),
                                   one(tree_unflatten(params, list(grads))),
                                   opt, lr=1e-3, b1=0.9, b2=0.999)
        params = tree_map(lambda x: x[0], stacked)

    def apply(params, x):
        feat, logits = _probe_net(params, x)
        return torch.cat([feat, logits], dim=-1)

    return Extractor(params, apply)


def split_probe_output(out, num_class: int = 10):
    return out[:, :-num_class], out[:, -num_class:]


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

@torch.no_grad()
def _features(extractor: Extractor, images) -> np.ndarray:
    return extractor.apply(extractor.params, images).float().cpu().numpy()


def activation_stats(extractor: Extractor, images,
                     batch: int = 100) -> Tuple[np.ndarray, np.ndarray]:
    """images: float NCHW in [-1, 1] (numpy or a tensor).  Returns (mu,
    cov) on the host.  Features are extracted in ``batch``-sized
    minibatches (the reference's own tick size, FLGAN/MNIST/flgan.py:89)."""
    images = torch.as_tensor(images, device=_device(extractor))
    n = images.shape[0]
    chunks = []
    for i in range(0, n, batch):
        chunks.append(_features(extractor, images[i:i + batch]))
    f = np.concatenate(chunks, axis=0)
    mu = f.mean(0)
    cov = np.cov(f, rowvar=False)
    return mu, cov


def frechet_distance(mu1, cov1, mu2, cov2) -> float:
    """Frechet distance between two Gaussians (the FID formula)."""
    from scipy import linalg

    diff = mu1 - mu2
    covmean = linalg.sqrtm(np.atleast_2d(cov1) @ np.atleast_2d(cov2))
    if isinstance(covmean, tuple):       # older scipy returns (sqrtm, errest)
        covmean = covmean[0]
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff @ diff + np.trace(cov1) + np.trace(cov2)
                 - 2.0 * np.trace(covmean))


def fid(extractor: Extractor, generated, real) -> float:
    """generated/real: float NCHW in [-1, 1] (the reference subsamples 100
    of each per tick, FLGAN/MNIST/flgan.py:89-98)."""
    mu_g, cov_g = activation_stats(extractor, generated)
    mu_r, cov_r = activation_stats(extractor, real)
    return frechet_distance(mu_g, cov_g, mu_r, cov_r)


def inception_score(probe: Extractor, generated, num_class: int = 10,
                    eps: float = 1e-12) -> float:
    """IS = exp(E_x KL(p(y|x) || p(y))) over the probe's class posterior."""
    out = _features(probe, torch.as_tensor(generated,
                                           device=_device(probe)))
    _, logits = split_probe_output(out, num_class)
    p = np.exp(logits - logits.max(1, keepdims=True))
    p /= p.sum(1, keepdims=True)
    marginal = p.mean(0)
    kl = (p * (np.log(p + eps) - np.log(marginal + eps))).sum(1).mean()
    return float(np.exp(kl))

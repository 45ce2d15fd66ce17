"""Shared machinery: losses, data access, state containers, Adam in optax
order and the autograd local-D step.

Port of ``cglgan_tpu/algos/common.py`` on stacked tensors: every function
takes a leading member axis and returns per-member values, so W client
updates are one batched pass.

GAN losses reproduce the reference's exact choices:
* ``bce`` — clipped to [1e-12, 1-1e-7] (not ``nn.BCELoss``'s log clamp);
* ``ce2`` — 2-class cross-entropy on raw logits (capgan.py:311);
* ``bce_logits`` — stable BCE on raw logits.
Loss math is float32 whatever the model's dtype.  Under ``--dtype
bfloat16`` the params, activations and Adam moments are bfloat16 and Adam
follows optax's bfloat16 arithmetic op by op (``adam_leaf``).
"""
from __future__ import annotations

from typing import Any, Callable, List, NamedTuple

import torch

from cglgan_tpu_torch.core import threefry
from cglgan_tpu_torch.core.dtypes import weak
from cglgan_tpu_torch.utils.tree import tree_leaves, tree_map, tree_unflatten


# ---------------------------------------------------------------------------
# what the port covers
# ---------------------------------------------------------------------------

CONV_ALGOS = ("capgan", "cglgan", "mixgan")


def check_supported(cfg, mesh=None) -> None:
    """Raise NotImplementedError, naming the ROADMAP item, for what the
    ported slices do not cover: conv models outside the CGL family or in
    bfloat16, and meshes (every algorithm runs on MLP models, on 2DMG and
    the image datasets; CAP-GAN, CGL-GAN and Mix-G also on the conv
    LSGAN pair in float32)."""
    if cfg.conv and cfg.algo not in CONV_ALGOS:
        raise NotImplementedError(
            f"conv=True for {cfg.algo} is not ported yet (ROADMAP queue 1 "
            "item 12: the MD-GAN and FedAvg families' conv branches); the "
            "CGL family (capgan, cglgan, mixgan) runs conv")
    if cfg.conv and cfg.dtype != "float32":
        raise NotImplementedError(
            "conv=True in bfloat16 is not ported yet (ROADMAP queue 1 item "
            "12); the conv LSGAN pair runs in float32")
    if cfg.dtype not in ("float32", "bfloat16"):
        raise ValueError(f"unsupported dtype {cfg.dtype!r}")
    if mesh is not None or cfg.model_shards > 1:
        raise NotImplementedError("meshes and model_shards > 1 are not "
                                  "ported yet (ROADMAP queue 1 item 17)")


def participation_mask(alive: torch.Tensor,
                       dropout_rate: float) -> torch.Tensor:
    """Straggler simulation: the float32 (n,) survival mask of one round
    from its Bernoulli(1 - dropout_rate) draw ``alive`` (bool (n,), drawn
    from the round's stream by ``core/prng.py`` ``survival``, or the
    reference's draw injected).  All ones at rate 0; otherwise client 0 is
    kept alive when nobody survives, so a round always has a survivor
    (``cglgan_tpu/algos/common.py:109-118``)."""
    if dropout_rate <= 0.0:
        return torch.ones(alive.shape, dtype=torch.float32,
                          device=alive.device)
    alive = alive.to(torch.bool).clone()
    alive[0] |= ~alive.any()
    return alive.float()


# ---------------------------------------------------------------------------
# losses: inputs (..., N, C); the mean runs over N, leading axes are members
# ---------------------------------------------------------------------------

def bce(p: torch.Tensor, target: float) -> torch.Tensor:
    p = torch.clamp(p.float(), 1e-12, 1.0 - 1e-7)
    t = target
    return -torch.mean(t * torch.log(p) + (1.0 - t) * torch.log1p(-p),
                       dim=(-2, -1))


def ce2(logits: torch.Tensor, target_idx: int) -> torch.Tensor:
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -torch.mean(logp[..., target_idx], dim=-1)


def bce_logits(logits: torch.Tensor, target: float) -> torch.Tensor:
    z = logits.float().squeeze(-1)
    return torch.mean(torch.clamp(z, min=0) - z * target
                      + torch.log1p(torch.exp(-torch.abs(z))), dim=-1)


def make_adv_loss(head: str) -> Callable:
    """loss(d_out, is_real: float) for the configured D head."""
    if head == "sigmoid":
        return lambda out, t: bce(out, t)
    if head == "logits2":
        return lambda out, t: ce2(out, int(t))
    if head == "raw":
        return lambda out, t: bce_logits(out, t)
    raise ValueError(head)


# ---------------------------------------------------------------------------
# data access
# ---------------------------------------------------------------------------

def normalize_images(x: torch.Tensor) -> torch.Tensor:
    """uint8 -> float in [-1, 1] (ToTensor + Normalize([0.5], [0.5]))."""
    x = x.float() / 255.0
    return (x - 0.5) / 0.5


def slice_batch(shards: torch.Tensor, start: int, batch_size: int):
    """Window [start, start+B) of every client's pre-shuffled shard."""
    return shards[:, start:start + batch_size]


def prepare_real(batch: torch.Tensor, is_image: bool,
                 dtype=torch.float32) -> torch.Tensor:
    """uint8 images scaled to [-1, 1] in float32, float rows as they are;
    then cast to the model's ``dtype`` (as the reference does,
    ``cglgan_tpu/algos/common.py:100-106``)."""
    out = normalize_images(batch) if is_image else batch.float()
    return out.to(dtype)


# ---------------------------------------------------------------------------
# state containers
# ---------------------------------------------------------------------------

class AdamState(NamedTuple):
    count: torch.Tensor    # (N,) int64 per-member step counts
    mu: Any                # first moments, same tree as params
    nu: Any                # second moments


class NetState(NamedTuple):
    params: Any            # stacked param list (reference layout)
    bn: Any                # BatchNorm running stats
    opt: AdamState


class FedState(NamedTuple):
    """CAP-GAN: G stacked (S, ...), D stacked (W, ...), ``lam`` (S,).
    FedAvg family: G and D params global and unstacked, Adam moments and
    counts (fegan: BN state too) stacked (W, ...), ``lam`` is None."""
    g: NetState
    d: NetState
    lam: Any               # (S,) Lambda game variables, or None
    t: int                 # round counter (host)


def adam_init(params, n: int) -> AdamState:
    like = tree_leaves(params)[0]
    zeros = lambda x: torch.zeros_like(x)
    return AdamState(torch.zeros((n,), dtype=torch.int64, device=like.device),
                     tree_map(zeros, params), tree_map(zeros, params))


_DECAYS = {}


def _decay_on(decay: float, device: torch.device) -> torch.Tensor:
    """float32(decay) as a 0-dim tensor on ``device``, made once: a copy from
    host memory on every Adam step (``torch.tensor(decay, device=...)``)
    makes the host wait for the stream each time."""
    key = (float(decay), device)
    if key not in _DECAYS:
        _DECAYS[key] = torch.full((), decay, dtype=torch.float32,
                                  device=device)
    return _DECAYS[key]


def bias_correction(count: torch.Tensor, decay: float) -> torch.Tensor:
    """``1 - decay**count`` in float32 with a float32 ``decay``, as optax
    computes it (f32(0.999)**t, not 0.999**t: they differ by ~1e-5
    relative at small t)."""
    return 1.0 - _decay_on(decay, count.device) ** count.float()


def adam_leaf(p, g, mu, nu, c1, c2, lr: float, b1: float, b2: float,
              eps: float = 1e-8):
    """One Adam update in optax's op order (``scale_by_adam`` then
    ``scale(-lr)`` and ``apply_updates``).  ``c1``/``c2``: float32 bias
    corrections that broadcast against ``p`` (per-member).

    Every op rounds to the leaf's dtype, as optax's does: for bfloat16
    leaves the moments are bfloat16, the constants are weak scalars rounded
    to bfloat16 (b2 = 0.999 becomes 1.0, so nu does not decay, and eps
    becomes 1.00117e-8), and the bias corrections are cast to the moments'
    dtype before the divisions, as optax's ``bias_correction`` does.  In
    float32 this is the float32 update, bit for bit."""
    w = lambda c: weak(c, p)
    mu2 = w(b1) * mu + w(1 - b1) * g
    nu2 = w(b2) * nu + w(1 - b2) * (g * g)
    c1, c2 = c1.to(mu2.dtype), c2.to(nu2.dtype)
    p2 = p + w(-lr) * ((mu2 / c1) / (torch.sqrt(nu2 / c2) + w(eps)))
    return p2, mu2, nu2


def adam_update(params, grads, opt: AdamState, lr: float, b1: float,
                b2: float, eps: float = 1e-8):
    """optax.adam(lr, b1, b2, eps) + apply_updates over stacked trees, with
    per-member counts.  Returns (new_params, new_opt)."""
    count = opt.count + 1
    c1, c2 = bias_correction(count, b1), bias_correction(count, b2)
    p_l, g_l = tree_leaves(params), tree_leaves(grads)
    m_l, n_l = tree_leaves(opt.mu), tree_leaves(opt.nu)
    # the corrections in the moments' dtype, cast once for all leaves
    cast = {m.dtype: (c1.to(m.dtype), c2.to(m.dtype)) for m in m_l}
    outs = []
    for p, g, m, v in zip(p_l, g_l, m_l, n_l):
        lead = (-1,) + (1,) * (p.ndim - 1)
        k1, k2 = cast[m.dtype]
        outs.append(adam_leaf(p, g, m, v, k1.reshape(lead), k2.reshape(lead),
                              lr, b1, b2, eps))
    return (tree_unflatten(params, [o[0] for o in outs]),
            AdamState(count, tree_unflatten(params, [o[1] for o in outs]),
                      tree_unflatten(params, [o[2] for o in outs])))


def with_grad(tree):
    """Detached leaf copies that require grad, plus the leaf list."""
    leaves = [x.detach().requires_grad_(True) for x in tree_leaves(tree)]
    return tree_unflatten(tree, leaves), leaves


# ---------------------------------------------------------------------------
# the per-client discriminator step, through autograd
# ---------------------------------------------------------------------------

def d_step_fn(d_model, adv_loss, lr: float, b1: float, b2: float,
              batch_size: int, is_image: bool, d_loss_half: bool,
              dtype=torch.float32, fuse_concat: bool = True):
    """``step(d_net, shards, start, fake, key=None) -> (d_net, d_loss
    (W,))``: one local D update of every client on (real window, fakes).
    D loss = real + fake, halved for CAP/Mix, in float32; the forward, the
    gradients and Adam in ``dtype``.

    ``fuse_concat``: real and fake through ONE forward on the (2B, ...)
    concatenation (exact for the BN-free MLP D).  Off for the conv D, whose
    BatchNorm takes per-forward statistics (``cglgan_tpu/algos/common.py:
    227-243``): ``key`` (W, 2), one threefry key a client, splits into
    ``r1, r2``; real goes through the D with dropout keys ``r1``, then fake
    with ``r2`` from the BN state the real forward left."""
    B = batch_size

    def losses(params, bn, real, fake, key):
        if fuse_concat:
            both = torch.cat([real, fake], dim=1)
            out, new_bn = d_model.apply(params, bn, both, train=True)
            half = adv_loss(out[:, :B], 1.0) * 0.5 \
                + adv_loss(out[:, B:], 0.0) * 0.5
            return (half if d_loss_half else half * 2.0), new_bn
        r = threefry.split(key)                                 # (W, 2, 2)
        out_r, bn1 = d_model.apply(params, bn, real, train=True,
                                   rng=r[:, 0])
        out_f, new_bn = d_model.apply(params, bn1, fake, train=True,
                                      rng=r[:, 1])
        loss = adv_loss(out_r, 1.0) + adv_loss(out_f, 0.0)
        return (loss * 0.5 if d_loss_half else loss), new_bn

    def step(d_net: NetState, shards, start: int, fake, key=None):
        """``fake``: flat (W, B, din) per-client or (B, din) shared."""
        real = prepare_real(slice_batch(shards, start, B), is_image, dtype)
        fake = fake.detach()
        if fake.ndim == 2:
            fake = fake.unsqueeze(0).expand(real.shape[0], -1, -1)
        params, leaves = with_grad(d_net.params)
        with torch.enable_grad():
            loss, new_bn = losses(params, d_net.bn, real,
                                  fake.to(real.dtype), key)
            grads = torch.autograd.grad(loss.sum(), leaves)
        new_p, new_opt = adam_update(
            d_net.params, tree_unflatten(d_net.params, list(grads)),
            d_net.opt, lr, b1, b2)
        return NetState(new_p, new_bn, new_opt), loss.detach()

    return step


def d_epoch_steps(step, epoch: int):
    """Repeat ``step`` over the ``epoch`` shared window offsets; returns the
    LAST step's loss (the reference inner loop, capgan.py:324-341).  With
    threefry ``key`` (W, 2) (the conv D's dropout), step e takes
    ``split(key, epoch)[:, e]``, or ``key`` itself at epoch 1, as the
    reference's ``d_epoch_steps`` hands them out."""
    def run(d_net: NetState, shards, starts: List[int], fake, key=None):
        keys = threefry.split(key, epoch) \
            if key is not None and epoch > 1 else None
        loss = None
        for e in range(epoch):
            k_e = key if keys is None else keys[:, e]
            d_net, loss = step(d_net, shards, int(starts[e]), fake, k_e)
        return d_net, loss
    return run

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

from typing import Any, Callable, NamedTuple

import torch

from cglgan_tpu_torch.core import meshes, threefry
from cglgan_tpu_torch.core.dtypes import weak
from cglgan_tpu_torch.utils.tree import tree_leaves, tree_map, tree_unflatten


# ---------------------------------------------------------------------------
# what the port covers
# ---------------------------------------------------------------------------

def check_supported(cfg) -> None:
    """Raise ValueError for a dtype the port does not run.  Every
    algorithm runs on the MLP models and on the conv LSGAN pair, on 2DMG
    and the image datasets, in float32 and bfloat16, on one device or
    sharded over a clients mesh (``core/meshes.py``), and the CGL family
    with its G split over a ``model`` axis too (``model_shards > 1``; the
    config refuses it on the other families, as the reference's).  A conv
    config on 2DMG builds, as the reference's does; only its rounds need
    image data (the conv D reads a row as a square image)."""
    if cfg.dtype not in ("float32", "bfloat16"):
        raise ValueError(f"unsupported dtype {cfg.dtype!r}")


def client_keys(k_s: torch.Tensor, k: int) -> torch.Tensor:
    """Servers' threefry keys (S, 2) -> one a client (S*k, 2), client i of
    server s taking ``split(k_s[s], k)[i]``: the conv D's dropout keys of
    a server's k clients, as the reference's ``jax.random.split(k_d, k)``
    hands them out."""
    return threefry.split(k_s, k).reshape(-1, 2)


def conv_stream_keys(streams, device, names: str, extras: int = 0):
    """The conv D's dropout keys of a round's injected ``streams``: slots 3
    and 4, after the family's three draws, as int64 threefry key data on
    ``device``.  ``extras``: how many of the family's own entries may
    follow them (slots 5 on).  Raises ValueError where the keys are
    missing or too much follows."""
    if not 5 <= len(streams) <= 5 + extras:
        tail = ", ..." if extras else ""
        raise ValueError(f"conv rounds take the streams ({names}{tail})")
    return tuple(torch.as_tensor(x, device=device).to(torch.int64)
                 for x in streams[3:5])


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


_ROWS = {}


def _rows(n: int, device: torch.device) -> torch.Tensor:
    """``arange(n)`` on ``device``, made once: a round's gathers add the
    window start to it."""
    key = (n, device)
    if key not in _ROWS:
        _ROWS[key] = torch.arange(n, device=device)
    return _ROWS[key]


def device_starts(starts, device) -> torch.Tensor:
    """A round's window starts as an int32 ``(E,)`` tensor on ``device``.
    A tensor is cast where it lies (a tensor on another device is moved);
    host ints (a list, numpy or JAX array: injected streams) are copied
    once."""
    if isinstance(starts, torch.Tensor):
        return starts.to(device=device, dtype=torch.int32)
    return torch.as_tensor([int(s) for s in starts], dtype=torch.int32,
                           device=device)


def slice_batch(shards: torch.Tensor, start, batch_size: int):
    """Window [start, start+B) of every client's pre-shuffled shard.
    ``start``: a host int (a view of the shards), or a 0-dim tensor on the
    shards' device, gathered there (``index_select``: the host never reads
    it, and a start outside ``[0, max_len - B]`` fails the gather)."""
    if isinstance(start, torch.Tensor):
        return shards.index_select(
            1, start + _rows(batch_size, shards.device))
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


def grads_through(out: torch.Tensor, losses: torch.Tensor, cotangents,
                  leaf_sets, mesh=None) -> list:
    """The G step's gradients where the per-client ``losses`` reach the
    G's leaves only through its output ``out``: for each i, the gradient of
    ``sum(cotangents[i] * losses)`` with respect to ``leaf_sets[i]``.

    First the cotangents of ``out``, one backward through the Ds each; on
    a clients mesh ``losses`` are this rank's clients', and the cotangents
    are summed over the ranks in one all-reduce of ``out``'s size (the
    reference's sharded round all-reduces the same), so every rank's
    replicated G takes every client's gradient.  Then one backward through
    the G each.  The cotangents reaching ``out`` and the G's backward are
    those of one backward from the losses: without a mesh, or on one rank,
    the gradients are the same bits."""
    cots = [torch.autograd.grad(losses, out, grad_outputs=c,
                                retain_graph=True)[0] for c in cotangents]
    cots = meshes.all_reduce(cots, mesh)
    return [torch.autograd.grad(out, leaves, grad_outputs=c,
                                retain_graph=i + 1 < len(cots))
            for i, (c, leaves) in enumerate(zip(cots, leaf_sets))]


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

    def step(d_net: NetState, shards, start, fake, key=None):
        """``fake``: flat (W, B, din) per-client or (B, din) shared;
        ``start``: as ``slice_batch`` takes it."""
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
    reference's ``d_epoch_steps`` hands them out.  ``starts``: the int32
    ``(epoch,)`` device tensor of ``device_starts``; step e gathers its
    window from ``starts[e]`` on the device."""
    def run(d_net: NetState, shards, starts: torch.Tensor, fake, key=None):
        keys = threefry.split(key, epoch) \
            if key is not None and epoch > 1 else None
        loss = None
        for e in range(epoch):
            k_e = key if keys is None else keys[:, e]
            d_net, loss = step(d_net, shards, starts[e], fake, k_e)
        return d_net, loss
    return run

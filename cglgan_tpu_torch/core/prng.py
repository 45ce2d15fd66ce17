"""PRNG discipline: every draw comes from an explicit ``torch.Generator``
seeded from (``cfg.seed``, role tag, index...), never from global state.

Same role tags as ``cglgan_tpu/core/prng.py``, so streams never collide and a
run is reproducible from its seed.  The round draws differ from JAX's
threefry (the algorithms' split tree is an open ROADMAP item); the parity
tests therefore inject the reference's draws through
``round_fn(state, streams=...)``.  The eval noise (``eval_z``) is the
reference's, drawn through ``core/threefry.py``.
"""
from __future__ import annotations

from typing import List

import torch

from cglgan_tpu_torch.core import threefry

ROLE_DATA = 0        # dataset synthesis / partition shuffles
ROLE_INIT_G = 1      # generator init
ROLE_INIT_D = 2      # discriminator init
ROLE_NOISE_D = 3     # latent noise for the D-training fake batch (Xd)
ROLE_NOISE_G = 4     # latent noise for the G-loss batch (Xg)
ROLE_BATCH = 5       # real-data minibatch sampling
ROLE_EVAL = 6        # fixed_z evaluation noise
ROLE_LOCAL = 7       # local-loop noise
ROLE_SWAP = 8        # MD-GAN D-swap shuffle permutation
FOLD_SURVIVAL = 7    # a round's dropout draw (the reference's fold_in(key, 7))

_MASK64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def derive_seed(seed: int, *tags: int) -> int:
    """Fold tags into a seed (the counterpart of ``jax.random.fold_in``)."""
    s = _splitmix64(int(seed) & _MASK64)
    for t in tags:
        s = _splitmix64(s ^ (int(t) & _MASK64))
    return s & ((1 << 63) - 1)


def generator(seed: int, *tags: int, device="cpu") -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(derive_seed(seed, *tags))
    return g


def eval_z(seed: int, shape, device, member=None) -> torch.Tensor:
    """The fixed eval latents: float32 ``normal`` under
    ``fold_in(key(seed), ROLE_EVAL)``, folded with ``member`` (a server)
    where the family draws them a server, as the reference's ``sample``."""
    key = threefry.fold_in(threefry.key(seed, device), ROLE_EVAL)
    if member is not None:
        key = threefry.fold_in(key, member)
    return threefry.normal(key, shape)


def batch_starts(seed: int, t: int, epoch: int, max_len: int,
                 batch_size: int) -> List[int]:
    """(epoch,) shared window offsets for round ``t`` as host ints
    (``common.batch_start``: uniform in [0, max_len - B])."""
    g = generator(seed, ROLE_LOCAL, t, ROLE_BATCH)
    hi = max(max_len - batch_size + 1, 1)
    return torch.randint(0, hi, (epoch,), generator=g).tolist()


def round_streams(cfg, t: int, max_len: int, device) -> tuple:
    """One round's draws: ``(starts (E,), z_d (S,B,zdim), z_g (S,B,zdim))``
    — the same three streams ``cglgan_tpu``'s ``round_fn`` draws — and with
    ``cfg.conv`` each server's dropout keys ``k_d, k_drop`` (S, 2) after
    them (the CGL and MD-GAN families), threefry key data drawn from the
    same generator (the reference splits them from the round's key; inject
    its ``key_data`` to get its masks)."""
    S, B, zdim = cfg.num_servers, cfg.batch_size, cfg.latent_dim
    starts = batch_starts(cfg.seed, t, cfg.epoch, max_len, B)
    g = generator(cfg.seed, ROLE_LOCAL, t, device=device)
    z_d = torch.randn((S, B, zdim), generator=g, device=device)
    z_g = torch.randn((S, B, zdim), generator=g, device=device)
    if not cfg.conv:
        return starts, z_d, z_g
    keys = torch.randint(0, 1 << 32, (2, S, 2), generator=g, device=device,
                         dtype=torch.int64)
    return starts, z_d, z_g, keys[0], keys[1]


def survival(cfg, t: int, n: int, device) -> torch.Tensor:
    """Round ``t``'s dropout draw: bool (n,) Bernoulli(1 - dropout_rate),
    the input of ``algos/common.py`` ``participation_mask``."""
    g = generator(cfg.seed, ROLE_LOCAL, t, FOLD_SURVIVAL, device=device)
    return torch.rand((n,), generator=g, device=device) \
        < 1.0 - cfg.dropout_rate


def swap_permutation(cfg, t: int, n: int, device) -> torch.Tensor:
    """Round ``t``'s MD-GAN shuffle D-swap: a permutation of the n clients
    (int64 (n,))."""
    g = generator(cfg.seed, ROLE_LOCAL, t, ROLE_SWAP, device=device)
    return torch.randperm(n, generator=g, device=device)


def sweep_streams(cfg, t: int, max_len: int, steps: int, device
                  ) -> tuple:
    """One FedAvg-family round's draws: ``(starts (steps,), z1, z2
    (W, steps, B, zdim))`` — z1 feeds each local D step's fake batch, z2
    the G step, as ``cglgan_tpu``'s ``_local_sweep`` draws them — and with
    ``cfg.conv`` each lane's dropout keys ``kd1, kd2`` (W, steps, 2) after
    them, threefry key data drawn from the same generator: ``kd1`` the key
    of a local step's D step (split into the real and the fake forward's),
    ``kd2`` of its G step (the reference's ``kdrop1, kdrop2`` of each step
    key; inject its ``key_data`` to get its masks)."""
    W, B, zdim = cfg.num_workers, cfg.batch_size, cfg.latent_dim
    starts = batch_starts(cfg.seed, t, steps, max_len, B)
    g = generator(cfg.seed, ROLE_LOCAL, t, device=device)
    z1 = torch.randn((W, steps, B, zdim), generator=g, device=device)
    z2 = torch.randn((W, steps, B, zdim), generator=g, device=device)
    if not cfg.conv:
        return starts, z1, z2
    keys = torch.randint(0, 1 << 32, (2, W, steps, 2), generator=g,
                         device=device, dtype=torch.int64)
    return starts, z1, z2, keys[0], keys[1]

"""PRNG discipline: the reference's threefry split tree.

Every draw derives from one root key ``threefry.key(cfg.seed)`` through
``fold_in`` with the role tags of ``cglgan_tpu/core/prng.py`` (``for_role``,
``for_round``, ``for_member`` are all ``fold_in``), so a port run from a
seed is the reference's run from that seed: the same init, window starts,
latents, dropout keys, survival draws and permutations (``core/threefry.py``
gives JAX's bits; normals agree to 3 ulps).

A round's tree (``cglgan_tpu/algos/*_family.py`` ``round_fn``):
``key = fold_in(fold_in(root, ROLE_LOCAL), t)``; the window starts
``randint(split(fold_in(key, ROLE_BATCH), steps), (), 0, max_len - B + 1)``
(``common.batch_start``); the CGL and MD-GAN families ``split(key, S)``,
then ``(k_zd, k_zg, k_d, k_drop) = split(k_s, 4)`` a server
(``server_draws``); the FedAvg family ``split(key, W)``, a worker's
``split(k_w, steps)`` and a step's ``(kzd, kzg, kdrop1, kdrop2) =
split(k, 4)`` (``lane_draws``); survival ``bernoulli(fold_in(key, 7), 1 -
rate)`` (FeGAN: ``fold_in(fold_in(root, t), 7)``); MD-GAN's shuffle
``permutation(fold_in(key, ROLE_SWAP), W)``.

``RoundKeys`` holds a runner's ``fold_in(root, ROLE_LOCAL)`` on its device
and draws the round keys and window starts of a piece of upcoming rounds in
one pass each, into two tables on the device: ``(piece, 2)`` keys and
``(piece, steps)`` int32 starts.  The CGL and MD-GAN families gather their
windows with a round's row of starts on the device; a captured round
(``algos/runner.py`` ``RoundProgram``) reads both rows at a device round
index, so nothing of a round crosses to the host.  The FedAvg family
slices its ragged sweep with host ints, copied once a piece
(``RoundKeys.starts``).  The piece follows the reference's rule
(``scan_piece``).  ``round_streams``, ``sweep_streams``, ``survival`` and
``swap_permutation`` give one round's draws as the round functions take
them injected (``round_fn(state, streams=...)``); ``survival_of_key`` and
``permutation_of_key`` draw the last two from a round's key, which a
captured round reads on the device.
"""
from __future__ import annotations

from typing import List

import torch

from cglgan_tpu_torch.core import threefry
from cglgan_tpu_torch.core.dtypes import torch_dtype

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
FOLD_REINIT_G = 99   # Mix-G's DCGAN re-init of a G member's key
FOLD_REINIT_D = 98   # ... and of a D member's


def role_key(seed: int, role: int, device) -> torch.Tensor:
    """``for_role(root_key(seed), role)``."""
    return threefry.fold_in(threefry.key(seed, device), role)


def eval_z(seed: int, shape, device, member=None) -> torch.Tensor:
    """The fixed eval latents: float32 ``normal`` under
    ``fold_in(key(seed), ROLE_EVAL)``, folded with ``member`` (a server)
    where the family draws them a server, as the reference's ``sample``."""
    key = role_key(seed, ROLE_EVAL, device)
    if member is not None:
        key = threefry.fold_in(key, member)
    return threefry.normal(key, shape)


def window_starts(keys: torch.Tensor, steps: int, max_len: int,
                  batch_size: int) -> torch.Tensor:
    """Round keys ``(..., 2)`` -> int32 ``(..., steps)`` window offsets:
    ``common.batch_start`` on ``split(fold_in(key, ROLE_BATCH), steps)``,
    uniform in ``[0, max_len - B]``."""
    hi = max(max_len - batch_size + 1, 1)
    return threefry.randint(
        threefry.split(threefry.fold_in(keys, ROLE_BATCH), steps), (), 0, hi)


def scan_piece(cfg, max_len: int, eval_every: int) -> int:
    """Rounds a piece, the reference's rule
    (``cglgan_tpu/algos/runner.py:100-115``): ``cfg.scan_rounds`` where it
    is > 0, else about 10 000 local steps' worth, ``min(eval_every, 10000
    // steps)``, at least 1; ``steps`` a round is the epoch, times the
    batches in a shard of ``max_len`` rows under the "epochs" sweep."""
    if cfg.scan_rounds and cfg.scan_rounds > 0:
        return int(cfg.scan_rounds)
    steps = max(1, cfg.epoch)
    if cfg.resolved_local_sweep == "epochs":
        steps *= -(-max_len // cfg.batch_size)
    return max(1, min(eval_every, 10000 // steps))


class RoundKeys:
    """A runner's round keys and window starts (module docstring).
    ``steps``: window starts a round (the epoch, or the FedAvg sweep's
    largest step count); ``piece``: the tables' rows, by default
    ``scan_piece`` for a tick of ``cfg.num_plt`` rounds.  The tables are
    made at the first ``fill`` and kept: a graph that reads them reads
    every later fill's rounds."""

    def __init__(self, cfg, max_len: int, steps: int, device, piece=None):
        self.cfg, self.steps, self.max_len = cfg, steps, max_len
        self.root = threefry.key(cfg.seed, device)
        self.local = threefry.fold_in(self.root, ROLE_LOCAL)
        self.piece = piece or scan_piece(cfg, max_len, cfg.num_plt)
        self.keys = self.starts_of = None
        self.t0, self.n, self._host = None, 0, None

    def fill(self, t: int, n=None) -> None:
        """Draw rounds ``t .. t + n - 1`` (``n`` at most ``piece``, a piece
        by default) into the tables' first rows, on the device."""
        n = self.piece if n is None else n
        if not 1 <= n <= self.piece:
            raise ValueError(f"{n} rounds into tables of {self.piece}")
        keys = threefry.fold_in(self.local, range(t, t + n))
        starts = window_starts(keys, self.steps, self.max_len,
                               self.cfg.batch_size)
        if self.keys is None:
            self.keys = torch.empty((self.piece, 2), dtype=keys.dtype,
                                    device=keys.device)
            self.starts_of = torch.empty((self.piece, self.steps),
                                         dtype=starts.dtype,
                                         device=keys.device)
        self.keys[:n].copy_(keys)
        self.starts_of[:n].copy_(starts)
        self.t0, self.n, self._host = t, n, None

    def _at(self, t: int) -> int:
        if self.t0 is None or not self.t0 <= t < self.t0 + self.n:
            self.fill(t)
        return t - self.t0

    def key(self, t: int) -> torch.Tensor:
        """``for_round(for_role(root, ROLE_LOCAL), t)``, (2,)."""
        i = self._at(t)
        return self.keys[i]

    def device_starts(self, t: int) -> torch.Tensor:
        """Round t's ``steps`` window starts, an int32 row of the table on
        the device (read before the next ``fill``)."""
        i = self._at(t)
        return self.starts_of[i]

    def starts(self, t: int) -> List[int]:
        """Round t's ``steps`` window starts as host ints, the piece's
        table copied to the host once."""
        i = self._at(t)
        if self._host is None:
            self._host = self.starts_of[:self.n].tolist()
        return self._host[i]

    def survival(self, t: int, n: int) -> torch.Tensor:
        """Round t's dropout draw (``survival_of_key``); FeGAN's from
        ``fold_in(root, t)``."""
        base = threefry.fold_in(self.root, t) if self.cfg.algo == "fegan" \
            else self.key(t)
        return survival_of_key(self.cfg, base, n)

    def permutation(self, t: int, n: int) -> torch.Tensor:
        """Round t's MD-GAN shuffle D-swap (``permutation_of_key``)."""
        return permutation_of_key(self.key(t), n)


def survival_of_key(cfg, key: torch.Tensor, n: int) -> torch.Tensor:
    """A round's dropout draw from its key ``(2,)``, a host int's row of
    the tables or the captured round's device row: bool (n,)
    ``bernoulli(fold_in(key, FOLD_SURVIVAL), 1 - dropout_rate)``, the input
    of ``algos/common.py`` ``participation_mask``."""
    return threefry.bernoulli(threefry.fold_in(key, FOLD_SURVIVAL),
                              1.0 - cfg.dropout_rate, (n,))


def permutation_of_key(key: torch.Tensor, n: int) -> torch.Tensor:
    """A round's MD-GAN shuffle D-swap from its key ``(2,)``: a permutation
    of the n clients (int64 (n,)), ``permutation(fold_in(key, ROLE_SWAP),
    n)``."""
    return threefry.permutation(threefry.fold_in(key, ROLE_SWAP), n)


def server_draws(cfg, key: torch.Tensor) -> tuple:
    """A CGL / MD-GAN round's draws from its key: ``(z_d, z_g)`` (S, B,
    zdim) in the run's dtype, and with ``cfg.conv`` each server's dropout
    keys ``k_d, k_drop`` (S, 2) after them."""
    S, B, zdim = cfg.num_servers, cfg.batch_size, cfg.latent_dim
    keys = threefry.split(threefry.split(key, S), 4)            # (S, 4, 2)
    z_d, z_g = threefry.normal_parts(keys[:, :2], [(B, zdim)] * 2,
                                     torch_dtype(cfg))
    if not cfg.conv:
        return z_d, z_g
    return z_d, z_g, keys[:, 2], keys[:, 3]


def lane_draws(cfg, key: torch.Tensor, steps: int, lanes=None) -> tuple:
    """A FedAvg round's draws from its key: ``(z1, z2)`` (W, steps, B,
    zdim) in the run's dtype — z1 feeds each local D step's fake batch, z2
    the G step — and with ``cfg.conv`` each lane's dropout keys ``kd1,
    kd2`` (W, steps, 2) after them: ``kd1`` the D step's (split into the
    real and the fake forward's), ``kd2`` the G step's.  ``lanes``: a
    slice of the W workers (a mesh rank's block), drawn alone; a lane's
    draws come from its own key, so they are the same bits as the whole
    draw's rows."""
    W, B, zdim = cfg.num_workers, cfg.batch_size, cfg.latent_dim
    worker_keys = threefry.split(key, W)
    if lanes is not None:
        worker_keys = worker_keys[lanes]
    keys = threefry.split(threefry.split(worker_keys, steps), 4)
    z1, z2 = threefry.normal_parts(keys[..., :2, :], [(B, zdim)] * 2,
                                   torch_dtype(cfg))
    if not cfg.conv:
        return z1, z2
    return z1, z2, keys[..., 2, :], keys[..., 3, :]


def round_streams(cfg, t: int, max_len: int, device) -> tuple:
    """Round t's CGL / MD-GAN draws: ``(starts (E,), z_d, z_g[, k_d,
    k_drop])`` (``server_draws``), the starts int32 on ``device``."""
    rk = RoundKeys(cfg, max_len, cfg.epoch, device, piece=1)
    return (rk.device_starts(t), *server_draws(cfg, rk.key(t)))


def sweep_streams(cfg, t: int, max_len: int, steps: int, device) -> tuple:
    """Round t's FedAvg draws: ``(starts (steps,), z1, z2[, kd1, kd2])``
    (``lane_draws``)."""
    rk = RoundKeys(cfg, max_len, steps, device, piece=1)
    return (rk.starts(t), *lane_draws(cfg, rk.key(t), steps))


def survival(cfg, t: int, n: int, device) -> torch.Tensor:
    """Round t's dropout draw (``RoundKeys.survival``)."""
    return RoundKeys(cfg, 1, 1, device, piece=1).survival(t, n)


def swap_permutation(cfg, t: int, n: int, device) -> torch.Tensor:
    """Round t's MD-GAN shuffle permutation (``RoundKeys.permutation``)."""
    return RoundKeys(cfg, 1, 1, device, piece=1).permutation(t, n)

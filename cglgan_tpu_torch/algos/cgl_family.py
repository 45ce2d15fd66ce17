"""CAP-GAN: the 3-tier cloud/edge/client hierarchy with the Lambda game.

Port of the capgan branch of ``cglgan_tpu/algos/cgl_family.py``
(capgan.py:86-349).  Every round each edge server makes a detached fake
batch Xd; every client runs ``epoch`` local D steps on (real window, Xd);
the server's G takes one step on F = sum(w * l) with ``cap_exp`` weights
w from the clients' losses l through the UPDATED Ds; on the data-size-scaled
cadence the cloud averages the servers' G params and sigma-mixes them back.

Layout: G state stacked (S, ...), D state flat (W, ...) with clients
``[s*k, (s+1)*k)`` on server s.  The local-D phase runs the fused CUDA
kernel (``ops/fused_dstep.py``) when ``fused_dstep.eligible`` says so —
the reference's rule: auto at epoch > 1 in float32 — and autograd otherwise.
"""
from __future__ import annotations

import numpy as np
import torch

from cglgan_tpu_torch.algos import common
from cglgan_tpu_torch.algos.common import FedState, NetState
from cglgan_tpu_torch.algos.game import game_step
from cglgan_tpu_torch.algos.runner import Runner
from cglgan_tpu_torch.core import device as device_mod
from cglgan_tpu_torch.core import prng
from cglgan_tpu_torch.data.partition import Partition
from cglgan_tpu_torch.fed import collectives, topology
from cglgan_tpu_torch.models.zoo import models_for_config
from cglgan_tpu_torch.ops import fused_dstep
from cglgan_tpu_torch.utils.tree import tree_map, tree_unflatten


def build_cgl_family(cfg, part: Partition, device=None) -> Runner:
    dev = device_mod.resolve(device)
    common.check_supported(cfg)
    S, k, W = cfg.num_servers, cfg.clients_per_server, cfg.num_workers
    g_model, d_model = models_for_config(cfg)
    adv = common.make_adv_loss(cfg.resolved_d_head)
    weighting = cfg.resolved_weighting
    B, zdim = cfg.batch_size, cfg.latent_dim
    max_len = part.data.shape[1]

    # flat (W, max_len, din) uint8 shards, resident on the device
    shards = torch.from_numpy(
        np.ascontiguousarray(part.data.reshape(W, max_len, -1))).to(dev)
    din = shards.shape[2]
    beta = torch.from_numpy(topology.server_beta(part.lengths, S)).to(dev)
    data_len = topology.server_data_len(part.lengths, S)
    a_weights = torch.from_numpy(
        (data_len / data_len.sum()).astype(np.float32)).to(dev)
    # capgan.py:169 — the sync period scales with server data size
    periods = np.maximum(
        1, (data_len * cfg.cloud_epoch / cfg.batch_size).astype(np.int64))
    cloud_enabled = cfg.cloud_epoch > 0

    d_step = common.d_epoch_steps(
        common.d_step_fn(d_model, adv, cfg.lr_d, cfg.b1, cfg.b2, B,
                         cfg.is_image, d_loss_half=True), cfg.epoch)
    use_kernel = fused_dstep.eligible(cfg)

    def init_state() -> FedState:
        gp, gbn = g_model.init(prng.generator(cfg.seed, prng.ROLE_INIT_G), S)
        dp, dbn = d_model.init(prng.generator(cfg.seed, prng.ROLE_INIT_D), W)
        to = lambda tree: tree_map(lambda x: x.to(dev), tree)
        gp, gbn, dp, dbn = to(gp), to(gbn), to(dp), to(dbn)
        return FedState(NetState(gp, gbn, common.adam_init(gp, S)),
                        NetState(dp, dbn, common.adam_init(dp, W)),
                        torch.zeros((S,), dtype=torch.float32, device=dev), 0)

    def route(fake):
        """(S, B, ...) server batches -> (W, B, din): the full batch to
        every client of the server (capgan.py:224-225)."""
        return fake.reshape(S, 1, B, din).expand(S, k, B, din) \
            .reshape(W, B, din)

    def g_update(g: NetState, gbn1, z_g, d_new: NetState, lam):
        """One G forward from gbn1; per-client losses through the updated
        Ds are both the game's inputs and the primal of ONE backward with
        cotangent w (capgan.py:247-259)."""
        gp, leaves = common.with_grad(g.params)
        with torch.enable_grad():
            fake, gbn2 = g_model.apply(gp, gbn1, z_g, train=True)
            out, _ = d_model.apply(d_new.params, d_new.bn, route(fake),
                                   train=True)
            losses = adv(out, 1.0).reshape(S, k)
            game = game_step(weighting, losses.detach(), beta, lam,
                             cfg.lr_lambda)
            grads = torch.autograd.grad(losses, leaves,
                                        grad_outputs=game.w.to(losses.dtype))
        l0 = losses.detach()
        f_max = torch.sum(game.w * l0, dim=-1) - game.lam_coeff * lam
        new_p, new_opt = common.adam_update(
            g.params, tree_unflatten(g.params, list(grads)), g.opt,
            cfg.lr_g, cfg.b1, cfg.b2)
        metrics = {"g_loss": l0.mean(), "f_max": f_max.mean(),
                   "f_beta": game.f_beta.mean(),
                   "f_gamma": game.f_gamma.mean(),
                   "lambda": game.lam_new.mean()}
        return NetState(new_p, gbn2, new_opt), game.lam_new, metrics

    # capgan syncs model.parameters() ONLY (fedlab serialize_model,
    # capgan.py:170-175): each server's G BN running stats stay local
    def cloud_sync(g: NetState, t: int) -> NetState:
        # the reference counts t DOWN from num_communication and syncs when
        # the countdown is divisible by the period (capgan.py:155,169)
        mask_np = ((cfg.num_communication - t) % periods) == 0
        if not mask_np.any():
            return g     # the masked select would keep every member exactly
        mask = torch.from_numpy(mask_np.astype(np.float32)).to(dev)
        avg = collectives.masked_weighted_avg_tree(g.params, a_weights, mask)
        avg_b = tree_map(lambda x: x.unsqueeze(0).expand((S,) + x.shape),
                         avg)
        mixed = collectives.sigma_mix(g.params, avg_b, cfg.segema)
        mixed = collectives.select_update_tree(g.params, mixed, mask)
        return NetState(mixed, g.bn, g.opt)

    def round_fn(state: FedState, streams=None):
        """One federated round.  ``streams``: optional injected
        ``(starts (E,), z_d (S,B,zdim), z_g (S,B,zdim))``; by default they
        are drawn from ``core.prng`` for round ``state.t``."""
        t = state.t
        g = cloud_sync(state.g, t) if cloud_enabled else state.g
        if streams is None:
            streams = prng.round_streams(cfg, t, max_len, dev)
        starts, z_d, z_g = streams
        z_d = torch.as_tensor(z_d, dtype=torch.float32, device=dev)
        z_g = torch.as_tensor(z_g, dtype=torch.float32, device=dev)
        starts = [int(s) for s in starts]

        if use_kernel:
            new_d, d_loss, gbn1 = fused_dstep.kernel_local_phase(
                cfg, g_model, g, state.d, shards, starts, z_d)
        else:
            with torch.no_grad():
                xd, gbn1 = g_model.apply(g.params, g.bn, z_d, train=True)
            fake = xd.reshape(B, din) if S == 1 else route(xd)
            new_d, d_loss = d_step(state.d, shards, starts, fake)

        new_g, lam_new, gm = g_update(g, gbn1, z_g, new_d, state.lam)
        metrics = {"d_loss": d_loss.mean(), **gm}

        if cfg.E > 0 and (t + 1) % cfg.E == 0:
            # every-E-rounds neighbour D-share within a server's block
            blocked = lambda tree: tree_map(
                lambda x: x.reshape((S, k) + x.shape[1:]), tree)
            flat = lambda tree: tree_map(
                lambda x: x.reshape((W,) + x.shape[2:]), tree)
            new_d = NetState(
                flat(collectives.neighbor_share_tree(blocked(new_d.params),
                                                     k, blocked=True)),
                flat(collectives.neighbor_share_tree(blocked(new_d.bn), k,
                                                     blocked=True)),
                new_d.opt)
        return FedState(new_g, new_d, lam_new, t + 1), metrics

    @torch.no_grad()
    def gen(state: FedState, z):
        """Eval-mode samples from caller latents z (n, zdim), n divisible
        by S; server i generates from the block z[i*per:(i+1)*per]."""
        per = z.shape[0] // S
        out, _ = g_model.apply(state.g.params, state.g.bn,
                               z.reshape(S, per, zdim), train=False)
        return out.reshape((S * per,) + tuple(out.shape[2:]))

    @torch.no_grad()
    def gen_client(state: FedState, z, client: int):
        """Client ``client``'s generator: its server's G (single path)."""
        if not 0 <= client < cfg.num_workers:
            raise ValueError(f"client {client} out of range "
                             f"[0, {cfg.num_workers})")
        s = client // k
        take = lambda tree: tree_map(lambda x: x[s:s + 1], tree)
        out, _ = g_model.apply(take(state.g.params), take(state.g.bn),
                               z.unsqueeze(0), train=False)
        return out[0]

    def sample(state: FedState, n: int):
        """Painter semantics: per server, G(fixed_z) in eval mode."""
        per = max(n // S, 1)
        z = torch.stack([
            torch.randn((per, zdim),
                        generator=prng.generator(cfg.seed, prng.ROLE_EVAL, i))
            for i in range(S)]).to(dev)
        return gen(state, z.reshape(S * per, zdim))

    return Runner(cfg, part, init_state, round_fn, sample, gen=gen,
                  gen_batch_multiple=S, gen_client=gen_client, device=dev)

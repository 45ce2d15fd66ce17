"""CGL-GAN, CAP-GAN and Mix-G: the 3-tier cloud/edge/client hierarchy with
the Lambda game.

Port of ``cglgan_tpu/algos/cgl_family.py`` (MLP models in float32 or
bfloat16, the conv LSGAN pair in float32, one device).  Every round each
edge server makes a detached fake batch Xd; every client runs ``epoch``
local D steps on (real window, Xd); the server's G takes one step on the
per-client losses l through the UPDATED Ds; on each server's cadence the
cloud averages the servers' G (or their trunks) and sigma-mixes the
average back in.

| algo   | generator            | D head (MNIST) | D x0.5 | cloud sync          | cadence          |
|--------|----------------------|----------------|--------|---------------------|------------------|
| cglgan | multipath (iid != 0) | sigmoid        | no     | trunk (whole G) + BN | cloud_epoch      |
| capgan | single path          | 2 logits       | yes    | whole G, params only | data_len*H/B     |
| mixgan | multipath + DCGAN    | 2 logits       | yes    | trunk + BN          | cloud_epoch      |

A multipath G sends head i's batch to client i of the server
(mixed-gan.py:247-252); a single-path G sends its whole batch to every
client of the server (capgan.py:224-225).  Multipath G step: head gradients
from cotangent ones, trunk gradients from the game weights w, both from ONE
forward (CGLGAN/MNIST/main.py:272-289).

Layout: G state stacked (S, ...) (a multipath G: trunk (S, ...), heads
(S, k, ...)), D state flat (W, ...) with clients ``[s*k, (s+1)*k)`` on
server s.  The local-D phase runs the fused CUDA kernel
(``ops/fused_dstep.py``) when ``fused_dstep.eligible`` says so — the
reference's rule: auto at epoch > 1 in float32, forced only in bfloat16 —
and autograd otherwise.

bfloat16 (``dtype="bfloat16"``): G and D params, BN state, latents, fakes
and Adam moments are bfloat16; the per-client losses, the game (w, Lambda)
and the metrics are float32, as in the reference.

Conv (``conv=True``, ``cglgan_tpu/algos/cgl_family.py:63,93,133-170``): the
D has one raw logit (BCE on logits), the local D step runs real and fake
through separate forwards (the conv D's BatchNorm takes per-forward
statistics), ``conv-multipath`` is a multipath G (trunk synced with its BN
buffers), and the conv D's Dropout2d takes threefry keys: each server's
``(k_d, k_drop)`` of the round's streams split k ways, one a client, for
the local D steps and for the G step's D forwards.
"""
from __future__ import annotations

import numpy as np
import torch

from cglgan_tpu_torch.algos import common
from cglgan_tpu_torch.algos.common import FedState, NetState
from cglgan_tpu_torch.algos.game import game_step
from cglgan_tpu_torch.algos.runner import Runner
from cglgan_tpu_torch.core import device as device_mod
from cglgan_tpu_torch.core import prng, threefry
from cglgan_tpu_torch.core.dtypes import torch_dtype
from cglgan_tpu_torch.data.partition import Partition
from cglgan_tpu_torch.fed import collectives, topology
from cglgan_tpu_torch.models import nn
from cglgan_tpu_torch.models.zoo import models_for_config
from cglgan_tpu_torch.ops import fused_dstep
from cglgan_tpu_torch.utils.tree import (tree_leaves, tree_map,
                                          tree_unflatten)


def build_cgl_family(cfg, part: Partition, device=None) -> Runner:
    dev = device_mod.resolve(device)
    common.check_supported(cfg)
    S, k, W = cfg.num_servers, cfg.clients_per_server, cfg.num_workers
    algo = cfg.algo
    g_model, d_model = models_for_config(cfg)
    multipath = g_model.multipath
    adv = common.make_adv_loss("raw" if cfg.conv else cfg.resolved_d_head)
    weighting = cfg.resolved_weighting
    B, zdim = cfg.batch_size, cfg.latent_dim
    dtype = torch_dtype(cfg)
    max_len = part.data.shape[1]

    # flat (W, max_len, din) shards, resident on the device: uint8 images,
    # or float32 2DMG points
    shards = torch.from_numpy(
        np.ascontiguousarray(part.data.reshape(W, max_len, -1))).to(dev)
    din = shards.shape[2]
    beta = torch.from_numpy(topology.server_beta(part.lengths, S)).to(dev)
    data_len = topology.server_data_len(part.lengths, S)
    a_weights = torch.from_numpy(
        (data_len / data_len.sum()).astype(np.float32)).to(dev)
    if algo == "capgan":
        # capgan.py:169 — the sync period scales with server data size
        periods = np.maximum(
            1, (data_len * cfg.cloud_epoch / cfg.batch_size).astype(np.int64))
    else:
        periods = np.full(S, max(cfg.cloud_epoch, 1), dtype=np.int64)
    cloud_enabled = cfg.cloud_epoch > 0

    d_step = common.d_epoch_steps(
        common.d_step_fn(d_model, adv, cfg.lr_d, cfg.b1, cfg.b2, B,
                         cfg.is_image,
                         d_loss_half=algo in ("capgan", "mixgan"),
                         dtype=dtype, fuse_concat=not cfg.conv),
        cfg.epoch)
    use_kernel = fused_dstep.eligible(cfg)

    def init_state() -> FedState:
        gp, gbn = g_model.init(prng.generator(cfg.seed, prng.ROLE_INIT_G), S,
                               dtype)
        dp, dbn = d_model.init(prng.generator(cfg.seed, prng.ROLE_INIT_D), W,
                               dtype)
        if algo == "mixgan":
            # net_g / net_d .apply(weights_init) (mixed-gan.py:181,348)
            gp = nn.dcgan_reinit(
                prng.generator(cfg.seed, prng.ROLE_INIT_G, 99), gp)
            dp = nn.dcgan_reinit(
                prng.generator(cfg.seed, prng.ROLE_INIT_D, 98), dp)
        to = lambda tree: tree_map(lambda x: x.to(dev), tree)
        gp, gbn, dp, dbn = to(gp), to(gbn), to(dp), to(dbn)
        return FedState(NetState(gp, gbn, common.adam_init(gp, S)),
                        NetState(dp, dbn, common.adam_init(dp, W)),
                        torch.zeros((S,), dtype=torch.float32, device=dev), 0)

    def route(fake):
        """G output -> (W, B, din) per-client fakes: a multipath G's
        (S, k, B, ...) head i to client i; a single-path G's (S, B, ...)
        full batch to every client of the server."""
        if multipath:
            return fake.reshape(W, B, din)
        return fake.reshape(S, 1, B, din).expand(S, k, B, din) \
            .reshape(W, B, din)

    def client_keys(k_s):
        """Servers' keys (S, 2) -> one a client (W, 2): ``split(k, k)``."""
        return threefry.split(k_s, k).reshape(W, 2)

    def g_update(g: NetState, gbn1, z_g, d_new: NetState, lam,
                 drop_keys=None):
        """One G forward from gbn1; the per-client losses through the
        updated Ds are both the game's inputs and the primal of the
        backward: cotangent w for a single-path G; for a multipath G,
        cotangent ones for the heads and w for the trunk
        (cglgan_tpu/algos/cgl_family.py:169-181).  ``drop_keys``: the conv
        D's dropout keys (W, 2)."""
        gp, leaves = common.with_grad(g.params)
        with torch.enable_grad():
            fake, gbn2 = g_model.apply(gp, gbn1, z_g, train=True)
            out, _ = d_model.apply(d_new.params, d_new.bn, route(fake),
                                   train=True, rng=drop_keys)
            losses = adv(out, 1.0).reshape(S, k)
            game = game_step(weighting, losses.detach(), beta, lam,
                             cfg.lr_lambda)
            w = game.w.to(losses.dtype)
            if multipath:
                # leaves run heads then trunk (sorted keys)
                n_heads = len(tree_leaves(gp["heads"]))
                heads = torch.autograd.grad(
                    losses, leaves[:n_heads], grad_outputs=torch.ones_like(
                        losses), retain_graph=True)
                trunk = torch.autograd.grad(losses, leaves[n_heads:],
                                            grad_outputs=w)
                grads = list(heads) + list(trunk)
            else:
                grads = list(torch.autograd.grad(losses, leaves,
                                                 grad_outputs=w))
        l0 = losses.detach()
        f_max = torch.sum(game.w * l0, dim=-1) - game.lam_coeff * lam
        new_p, new_opt = common.adam_update(
            g.params, tree_unflatten(g.params, grads), g.opt,
            cfg.lr_g, cfg.b1, cfg.b2)
        metrics = {"g_loss": l0.mean(), "f_max": f_max.mean(),
                   "f_beta": game.f_beta.mean(),
                   "f_gamma": game.f_gamma.mean(),
                   "lambda": game.lam_new.mean()}
        return NetState(new_p, gbn2, new_opt), game.lam_new, metrics

    # capgan syncs model.parameters() ONLY (fedlab serialize_model,
    # capgan.py:170-175): each server's G BN running stats stay local.
    # cglgan / mixgan sync a state_dict walk (copy_parameters,
    # CGLGAN/MNIST/main.py:140-145), which moves the BN buffers too; a
    # multipath G syncs its trunk only.
    sync_bn = algo != "capgan"
    scope = (lambda tree: tree["trunk"]) if multipath else (lambda tree: tree)

    def put(tree, sub):
        return {**tree, "trunk": sub} if multipath else sub

    def cloud_sync(g: NetState, t: int) -> NetState:
        # the reference counts t DOWN from num_communication and syncs when
        # the countdown is divisible by the period (capgan.py:155,169)
        mask_np = ((cfg.num_communication - t) % periods) == 0
        if not mask_np.any():
            return g     # the masked select would keep every member exactly
        mask = torch.from_numpy(mask_np.astype(np.float32)).to(dev)
        payload = (scope(g.params), scope(g.bn)) if sync_bn \
            else (scope(g.params),)
        avg = collectives.masked_weighted_avg_tree(payload, a_weights, mask)
        avg_b = tree_map(lambda x: x.unsqueeze(0).expand((S,) + x.shape),
                         avg)
        mixed = collectives.sigma_mix(payload, avg_b, cfg.segema)
        mixed = collectives.select_update_tree(payload, mixed, mask)
        return NetState(put(g.params, mixed[0]),
                        put(g.bn, mixed[1]) if sync_bn else g.bn, g.opt)

    def round_fn(state: FedState, streams=None):
        """One federated round.  ``streams``: optional injected
        ``(starts (E,), z_d (S,B,zdim), z_g (S,B,zdim))``, and with conv
        each server's ``k_d, k_drop`` (S, 2) threefry key data after them;
        by default they are drawn from ``core.prng`` for round
        ``state.t``."""
        t = state.t
        g = cloud_sync(state.g, t) if cloud_enabled else state.g
        if streams is None:
            streams = prng.round_streams(cfg, t, max_len, dev)
        starts, z_d, z_g = streams[:3]
        d_keys = drop_keys = None
        if cfg.conv:
            if len(streams) != 5:
                raise ValueError("conv rounds take the streams (starts, "
                                 "z_d, z_g, k_d, k_drop)")
            k_d, k_drop = (torch.as_tensor(x, device=dev).to(torch.int64)
                           for x in streams[3:5])
            d_keys, drop_keys = client_keys(k_d), client_keys(k_drop)
        # the latents in the run's dtype (the reference draws them so)
        z_d = torch.as_tensor(z_d, device=dev).to(dtype)
        z_g = torch.as_tensor(z_g, device=dev).to(dtype)
        starts = [int(s) for s in starts]

        if use_kernel:
            new_d, d_loss, gbn1 = fused_dstep.kernel_local_phase(
                cfg, g_model, g, state.d, shards, starts, z_d)
        else:
            with torch.no_grad():
                xd, gbn1 = g_model.apply(g.params, g.bn, z_d, train=True)
            shared = S == 1 and not multipath
            fake = xd.reshape(B, din) if shared else route(xd)
            new_d, d_loss = d_step(state.d, shards, starts, fake, d_keys)

        new_g, lam_new, gm = g_update(g, gbn1, z_g, new_d, state.lam,
                                      drop_keys)
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
        by S; server i generates from the block z[i*per:(i+1)*per].  A
        multipath G's output is the concat of its heads, strided back down
        to the per-server quota (painter routing, capgan.py:79-83)."""
        per = z.shape[0] // S
        out, _ = g_model.apply(state.g.params, state.g.bn,
                               z.reshape(S, per, zdim), train=False)
        if multipath:
            out = out.reshape((S, k * per) + tuple(out.shape[3:]))[:, ::k]
        return out.reshape((S * per,) + tuple(out.shape[2:]))

    @torch.no_grad()
    def gen_client(state: FedState, z, client: int):
        """Client ``client``'s generator: head ``client % k`` of server
        ``client // k``'s G (mixed-gan.py:242-252), or that server's G when
        it is single path."""
        if not 0 <= client < cfg.num_workers:
            raise ValueError(f"client {client} out of range "
                             f"[0, {cfg.num_workers})")
        s, head = client // k, client % k
        take = lambda tree: tree_map(lambda x: x[s:s + 1], tree)
        out, _ = g_model.apply(take(state.g.params), take(state.g.bn),
                               z.unsqueeze(0), train=False)
        return out[0, head] if multipath else out[0]

    def sample(state: FedState, n: int):
        """Painter semantics: per server, G(fixed_z) in eval mode."""
        per = max(n // S, 1)
        z = torch.stack([prng.eval_z(cfg.seed, (per, zdim), dev, i)
                         for i in range(S)])
        return gen(state, z.reshape(S * per, zdim))

    return Runner(cfg, part, init_state, round_fn, sample, gen=gen,
                  gen_batch_multiple=S, gen_client=gen_client, device=dev)

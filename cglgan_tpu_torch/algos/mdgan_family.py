"""AC-GAN and MD-GAN: central generator(s), distributed discriminators,
loss feedback.

Port of ``cglgan_tpu/algos/mdgan_family.py`` (the MLP models
and the conv LSGAN pair, in float32 or bfloat16, on one device or a
clients mesh).  Every round
each server's G makes a detached fake batch Xd (train mode, so its BN buffers
advance); every client trains its D ``epoch`` steps on (real window,
Xd); the server's G then takes one Adam step on the mean of its clients'
losses ``adv(D(G(z_g)), 1)`` through the UPDATED Ds
(ACGAN/2DMG/acgan.py:102-257, MDGAN/MNIST/mdgan.py:107-297).
MD-GAN has one server (``num_servers=1``); AC-GAN S servers of k clients.

Dropout (``dropout_rate > 0``): a dropped client keeps its D and its loss
counts for nothing; a server's G loss is the mean over its survivors
(``max(survivors, 1)``), the metrics the mean over servers of those means.

Every E rounds (``E > 0``, at ``(t + 1) % E == 0``) the Ds are exchanged;
the Adam state stays with the client:
* MD-GAN: the D-swap over all W clients, ``d_swap="ring"`` (client i's D to
  client i+1) or ``"shuffle"`` (a fresh permutation a swap);
* AC-GAN: within a server's block, ``gossip="mean"`` (the block mean) or
  ``"delta"`` (``fed/collectives.py`` ``delta_share_tree``, with per-client
  anchors for params and BN carried in the state's ``lam`` slot, zero at
  init and replaced on exchange rounds only).

The round loop (``algos/runner.py``): ``train`` runs an MLP runner without
a mesh as replays of one captured CUDA graph of a round (``RoundProgram``,
the reference's ``scan_rounds``).  Its ``round_body`` reads the round
counter, key and window starts on the device, draws the survival draw and
MD-GAN's permutation from that key every round, and exchanges every round,
keeping the result where ``(t + 1) % E == 0``, as the reference's jitted
round.  ``round_fn`` (the per-round loop: conv, a mesh, injected streams)
runs the same body from a host counter, which exchanges only on the
rounds that do.

Layout: G state stacked ``(S, ...)``, D state flat ``(W, ...)`` with
clients ``[s*k, (s+1)*k)`` on server s (viewed ``(S, k, ...)`` where a
server sees only its own clients).  The local-D phase runs the fused CUDA
kernel (``ops/fused_dstep.py``) when ``fused_dstep.eligible`` says so — the
reference's rule: auto at epoch > 1 in float32, forced by
``pallas_dstep=True`` (also in bfloat16), never with dropout — and
autograd otherwise.  The kernel path's G loss is the plain mean over the
server's clients, as the reference's (equal to the masked mean when every
client survives).

A clients mesh (``mesh``, ``core/meshes.py``; the reference's ``P(None,
"clients")`` on ``(S, k, ...)``): each rank holds k / n clients of every
server, flat, with their shards, D state, delta anchors and dropout keys;
the G, the round draws and the survival draw are replicated.  The G step
gathers the per-client G and D losses (the metrics and the survivors' means
read them all) and all-reduces the cotangent of the G's output
(``common.grads_through``); the ring swap sends one client's D to the next
rank, the shuffle the Ds whose source is on another rank, the gossips
all-reduce ``(S, ...)`` partial sums (``fed/collectives.py``).  No kernel
runs on a mesh, as in the reference (``fused_dstep.eligible``).

Conv (``conv=True``, ``cglgan_tpu/algos/mdgan_family.py:51,65-68,97-124``):
the D has one raw logit (BCE on logits), the local D step runs real and
fake through separate forwards (the conv D's BatchNorm takes per-forward
statistics), and the conv D's Dropout2d takes threefry keys: each server's
``(k_d, k_drop)`` of the round's streams split k ways, one a client
(``common.client_keys``), for the local D steps and for the G step's D
forwards.  The exchanges move the conv D's BatchNorm buffers with its
params; ``fused_dstep`` refuses a conv D, as the reference's does.
"""
from __future__ import annotations

import numpy as np
import torch

from cglgan_tpu_torch.algos import common
from cglgan_tpu_torch.algos.common import FedState, NetState
from cglgan_tpu_torch.algos.runner import RoundProgram, Runner
from cglgan_tpu_torch.core import device as device_mod
from cglgan_tpu_torch.core import meshes, prng, threefry
from cglgan_tpu_torch.core.meshes import CLIENTS, P
from cglgan_tpu_torch.core.dtypes import torch_dtype
from cglgan_tpu_torch.data.partition import Partition
from cglgan_tpu_torch.fed import collectives
from cglgan_tpu_torch.models.zoo import models_for_config
from cglgan_tpu_torch.ops import fused_dstep
from cglgan_tpu_torch.utils.tree import tree_map, tree_unflatten


def build_mdgan_family(cfg, part: Partition, device=None,
                       mesh=None) -> Runner:
    """algo == "acgan" (S servers) or "mdgan" (one central G); ``mesh``:
    an optional clients mesh (module docstring)."""
    dev = device_mod.resolve(device)
    common.check_supported(cfg)
    S, k, W = cfg.num_servers, cfg.clients_per_server, cfg.num_workers
    if cfg.algo == "mdgan" and S != 1:
        raise ValueError("mdgan has one central generator (num_servers=1)")
    # this rank's clients of each server: k_loc of them, from blk.start
    blk = slice(0, k) if mesh is None else mesh.block(k)
    k_loc = blk.stop - blk.start
    spec_sk = P(None, CLIENTS)
    local = lambda tree: meshes.place(tree, mesh, spec_sk, groups=S)
    everyone = lambda x: meshes.gather_clients(x, mesh, groups=S)
    g_model, d_model = models_for_config(cfg)
    adv = common.make_adv_loss("raw" if cfg.conv else cfg.resolved_d_head)
    B, zdim = cfg.batch_size, cfg.latent_dim
    dtype = torch_dtype(cfg)
    max_len = part.data.shape[1]
    shards = local(torch.from_numpy(
        np.ascontiguousarray(part.data.reshape(W, max_len, -1)))).to(dev)
    din = shards.shape[2]

    d_step = common.d_epoch_steps(
        common.d_step_fn(d_model, adv, cfg.lr_d, cfg.b1, cfg.b2, B,
                         cfg.is_image, d_loss_half=False, dtype=dtype,
                         fuse_concat=not cfg.conv),
        cfg.epoch)
    use_kernel = fused_dstep.eligible(cfg, mesh)
    dropout = cfg.dropout_rate > 0.0
    exchange = cfg.E > 0
    swap = exchange and cfg.algo == "mdgan"
    shuffle = swap and cfg.d_swap == "shuffle"
    delta = exchange and cfg.algo == "acgan" and cfg.gossip == "delta"
    rounds = prng.RoundKeys(cfg, max_len, cfg.epoch, dev)
    # the D state and the delta anchors are this rank's clients; G is
    # replicated
    layout = {"d": (spec_sk, S), **({"lam": (spec_sk, S)} if delta else {})}

    def init_state() -> FedState:
        # a G a server, a D a client (cglgan_tpu/algos/mdgan_family.py:
        # 77-79, common.init_net_stacked)
        gp, gbn = g_model.init(threefry.split(
            prng.role_key(cfg.seed, prng.ROLE_INIT_G, dev), S), dtype)
        dp, dbn = d_model.init(threefry.split(
            prng.role_key(cfg.seed, prng.ROLE_INIT_D, dev), W), dtype)
        # the delta gossip's per-client anchors start at zero, as the
        # reference sketch's ``w[key] = 0`` (ACGAN/MNIST/acgan.py:235-237)
        aux = tree_map(torch.zeros_like, (dp, dbn)) if delta else None
        state = FedState(NetState(gp, gbn, common.adam_init(gp, S)),
                         NetState(dp, dbn, common.adam_init(dp, W)), aux, 0)
        return meshes.commit_tree(meshes.place_state(state, mesh, layout),
                                  mesh)

    def route(fake):
        """A server's (S, B, ...) batch to each of its clients on this
        rank."""
        return fake.reshape(S, 1, B, din).expand(S, k_loc, B, din) \
            .reshape(S * k_loc, B, din)

    def server_mean(x, mask):
        """(W,) per-client values -> (S,): the mean over a server's
        clients, or with ``mask`` (S, k) over its survivors
        (``max(survivors, 1)``)."""
        x = x.reshape(S, k)
        if mask is None:
            return x.mean(dim=1)
        return (x * mask).sum(dim=1) / torch.clamp(mask.sum(dim=1), min=1.0)

    def g_update(g: NetState, gbn1, z_g, d_new: NetState, mask, d_loss,
                 drop_keys=None):
        """One G forward from gbn1 through each server's k updated Ds, one
        Adam step on each server's ``server_mean`` of its clients' losses.
        ``drop_keys``: the conv D's dropout keys, one a client of this
        rank.  Returns (new G, G loss (S,), every client's D loss (W,),
        gathered with the G losses on a mesh)."""
        gp, leaves = common.with_grad(g.params)
        with torch.enable_grad():
            fake, gbn2 = g_model.apply(gp, gbn1, z_g, train=True)
            out, _ = d_model.apply(d_new.params, d_new.bn, route(fake),
                                   train=True, rng=drop_keys)
            losses = adv(out, 1.0)
        both = everyone(torch.stack([losses.detach(), d_loss.float()],
                                    dim=1)).t().contiguous()
        # each client's cotangent in sum_s server_mean_s, as autograd
        # makes it
        l_all = both[0].requires_grad_(True)
        with torch.enable_grad():
            g_loss = server_mean(l_all, mask)
            coef, = torch.autograd.grad(g_loss.sum(), l_all)
        grads = common.grads_through(
            fake, losses, [local(coef)], [leaves], mesh)[0]
        new_p, new_opt = common.adam_update(
            g.params, tree_unflatten(g.params, list(grads)), g.opt,
            cfg.lr_g, cfg.b1, cfg.b2)
        return NetState(new_p, gbn2, new_opt), g_loss.detach(), both[1]

    # the streams: the three draws, with conv the dropout keys at slots 3
    # and 4, then the survival draw and the swap permutation
    first_extra = 5 if cfg.conv else 3

    def extras_of(key):
        """(survival draw or None, swap permutation or None) from the
        round's key: a host round's row of the tables, or the captured
        round's device row (the same code on both loops)."""
        alive = prng.survival_of_key(cfg, key, W) if dropout else None
        perm = prng.permutation_of_key(key, W) if shuffle else None
        return alive, perm

    def exchange_d(d: NetState, lam, t, perm):
        """The every-E-rounds exchange of the Ds after round ``t`` (module
        docstring), and the delta gossip's anchors.  A host ``t`` decides
        on the host: only the rounds at ``(t + 1) % E == 0`` exchange (on a
        mesh only they run the collectives).  A device ``t`` exchanges
        every round and keeps the result, anchors included, where ``(t +
        1) % E == 0``, as the reference's ``jnp.where(do_share, ...)``
        (``cglgan_tpu/algos/mdgan_family.py:216-236``)."""
        device_t = isinstance(t, torch.Tensor)
        if not device_t and (t + 1) % cfg.E:
            return d, lam
        blocked = lambda tree: tree_map(
            lambda x: x.reshape((S, k_loc) + x.shape[1:]), tree)
        flat = lambda tree: tree_map(
            lambda x: x.reshape((S * k_loc,) + x.shape[2:]), tree)
        old = (d.params, d.bn)
        new_lam = lam
        if shuffle:
            cur = collectives.permute_tree(
                old, torch.as_tensor(perm, device=dev), mesh)
        elif swap:
            cur = collectives.ring_shift_tree(old, 1, mesh)
        elif delta:
            cur, new_lam = collectives.delta_share_tree(
                blocked(old), blocked(lam), k, blocked=True, mesh=mesh)
            cur, new_lam = flat(cur), flat(new_lam)
        else:
            cur = flat(collectives.neighbor_share_tree(
                blocked(old), k, blocked=True, mesh=mesh))
        if device_t and cfg.E > 1:
            due = torch.remainder(t + 1, cfg.E) == 0
            keep = lambda new, was: tree_map(
                lambda a, b: torch.where(due, a, b), new, was)
            cur = keep(cur, old)
            if delta:
                new_lam = keep(new_lam, lam)
        return NetState(cur[0], cur[1], d.opt), new_lam

    def round_body(state: FedState, t, streams):
        """One federated round from its draws ``streams`` (``round_fn``'s)
        at round ``t``: a host int, or an int64 0-dim device tensor (the
        captured round's counter).  The host reads no tensor here.  The
        state's ``t`` is left as it is."""
        alive, perm = (*streams[first_extra:], None, None)[:2]
        starts, z_d, z_g = streams[:3]
        d_keys = drop_keys = None
        if cfg.conv:
            k_d, k_drop = common.conv_stream_keys(
                streams, dev, "starts, z_d, z_g, k_d, k_drop", extras=2)
            d_keys = local(common.client_keys(k_d, k))
            drop_keys = local(common.client_keys(k_drop, k))
        z_d = torch.as_tensor(z_d, device=dev).to(dtype)
        z_g = torch.as_tensor(z_g, device=dev).to(dtype)
        # the windows are gathered on the device: the host reads no start
        starts = common.device_starts(starts, dev)
        g = state.g

        if use_kernel:
            new_d, d_loss, gbn1 = fused_dstep.kernel_local_phase(
                cfg, g_model, g, state.d, shards, starts, z_d)
            new_g, g_loss, d_all = g_update(g, gbn1, z_g, new_d, None,
                                            d_loss)
            metrics = {"d_loss": d_all.mean(), "g_loss": g_loss.mean()}
        else:
            with torch.no_grad():
                xd, gbn1 = g_model.apply(g.params, g.bn, z_d, train=True)
            fake = xd.reshape(B, din) if S == 1 else route(xd)
            new_d, d_loss = d_step(state.d, shards, starts, fake, d_keys)
            mask = None
            if dropout:
                m = common.participation_mask(
                    torch.as_tensor(alive, device=dev), cfg.dropout_rate)
                old, m_loc = state.d, local(m)
                new_d = NetState(
                    collectives.select_update_tree(old.params, new_d.params,
                                                   m_loc),
                    collectives.select_update_tree(old.bn, new_d.bn, m_loc),
                    common.AdamState(*collectives.select_update_tree(
                        tuple(old.opt), tuple(new_d.opt), m_loc)))
                mask = m.reshape(S, k)
            new_g, g_loss, d_all = g_update(g, gbn1, z_g, new_d, mask,
                                            d_loss, drop_keys)
            metrics = {"d_loss": server_mean(d_all, mask).mean(),
                       "g_loss": g_loss.mean()}

        lam = state.lam
        if exchange:
            new_d, lam = exchange_d(new_d, lam, t, perm)
        return FedState(new_g, new_d, lam, state.t), metrics

    def round_fn(state: FedState, streams=None):
        """One federated round.  ``streams``: optional injected
        ``(starts (E,), z_d (S,B,zdim), z_g (S,B,zdim)[, alive (W,),
        perm (W,)])`` (``alive`` the survival draw, ``perm`` MD-GAN's
        shuffle; either may be None where the config uses none); with conv
        each server's dropout keys ``k_d, k_drop`` (S, 2) threefry key data
        come at slots 3 and 4, before ``alive`` and ``perm``, and a conv
        stream without them raises ValueError.  By default they are the
        reference's draws for round ``state.t`` (``core/prng.py``); streams
        that stop before ``alive`` take the round's own survival draw and
        permutation."""
        t = state.t
        if streams is None:
            streams = (rounds.device_starts(t),
                       *prng.server_draws(cfg, rounds.key(t)))
        if len(streams) == first_extra:
            streams = (*streams, *extras_of(rounds.key(t)))
        new, metrics = round_body(state, t, streams)
        return new._replace(t=t + 1), metrics

    program = None
    if not cfg.conv and mesh is None:
        # the MLP runners without a mesh: ``train`` runs them as replays
        # of one captured round (algos/runner.py); the tables hold the
        # longest piece the reference's rule gives
        piece = prng.scan_piece(cfg, max_len, 1 << 62)
        program = RoundProgram(
            lambda state, t, key, starts: round_body(
                state, t, (starts, *prng.server_draws(cfg, key),
                           *extras_of(key))),
            prng.RoundKeys(cfg, max_len, cfg.epoch, dev, piece=piece), dev)

    @torch.no_grad()
    def gen(state: FedState, z):
        """Eval-mode samples from caller latents z (n, zdim), n divisible
        by S; server i generates from the block z[i*per:(i+1)*per]."""
        per = z.shape[0] // S
        out, _ = g_model.apply(state.g.params, state.g.bn,
                               z.reshape(S, per, zdim), train=False)
        return torch.cat(out.unbind(0))

    def sample(state: FedState, n: int):
        """Eval samples: each server gives n/S (the painter pools the
        servers' fixed_z outputs, ACGAN/2DMG/acgan.py:69-75)."""
        per = n // S
        z = torch.stack([prng.eval_z(cfg.seed, (per, zdim), dev, i)
                         for i in range(S)])
        return gen(state, z.reshape(S * per, zdim))

    return Runner(cfg, part, init_state, round_fn, sample, gen=gen,
                  gen_batch_multiple=S, device=dev, mesh=mesh,
                  layout=layout, program=program)

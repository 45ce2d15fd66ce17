"""CGL-GAN, CAP-GAN and Mix-G: the 3-tier cloud/edge/client hierarchy with
the Lambda game.

Port of ``cglgan_tpu/algos/cgl_family.py`` (the MLP models
and the conv LSGAN pair, in float32 or bfloat16, on one device or a
clients mesh).  Every round
each edge server makes a detached fake batch Xd; every client runs ``epoch``
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

A clients mesh (``mesh``, ``core/meshes.py``; the reference's ``P(None,
"clients")`` on ``(S, k, ...)``): each rank holds k / n clients of every
server, flat ``(S * k / n, ...)``, with their shards, D state and dropout
keys, and the replicated G, Lambda and round draws; the G step gathers the
``(S, k)`` per-client losses (the game reads them all) and all-reduces the
cotangent of the G's output (``common.grads_through``); the E-round share
all-reduces ``(S, ...)`` partial sums; the cloud sync runs on the
replicated G; the metrics are the means over every client.  No kernel runs
on a mesh, as in the reference (``fused_dstep.eligible``).

Tensor parallelism (``model_shards > 1`` on a ``(clients, model)`` mesh,
``cglgan_tpu/algos/cgl_family.py:117-126``): the G is drawn whole from the
seed and each rank keeps its blocks of its params, BN state and Adam
moments (``meshes.place_model_tp``, the servers axis whole); both G
forwards run column-parallel (``models/tp.py``), the output whole, so the
D phase and the per-client losses are those of the clients mesh; Adam, the
cloud sync and the Lambda game act on the blocks with no collective.  The
runner's ``gen`` and ``sample`` take a state with the whole G
(``meshes.gather_state`` of ``layout["g"]``; ``train`` gathers it a tick).

bfloat16 (``dtype="bfloat16"``): G and D params, BN state, latents, fakes
and Adam moments are bfloat16; the per-client losses, the game (w, Lambda)
and the metrics are float32, as in the reference.

Conv (``conv=True``, ``cglgan_tpu/algos/cgl_family.py:63,93,133-170``): the
D has one raw logit (BCE on logits), the local D step runs real and fake
through separate forwards (the conv D's BatchNorm takes per-forward
statistics), ``conv-multipath`` is a multipath G (trunk synced with its BN
buffers), and the conv D's Dropout2d takes threefry keys: each server's
``(k_d, k_drop)`` of the round's streams split k ways, one a client
(``common.client_keys``), for the local D steps and for the G step's D
forwards.
"""
from __future__ import annotations

import numpy as np
import torch

from cglgan_tpu_torch.algos import common
from cglgan_tpu_torch.algos.common import FedState, NetState
from cglgan_tpu_torch.algos.game import game_step
from cglgan_tpu_torch.algos.runner import RoundProgram, Runner
from cglgan_tpu_torch.core import device as device_mod
from cglgan_tpu_torch.core import meshes, prng, threefry
from cglgan_tpu_torch.core.meshes import CLIENTS, P
from cglgan_tpu_torch.core.dtypes import torch_dtype
from cglgan_tpu_torch.data.partition import Partition
from cglgan_tpu_torch.fed import collectives, topology
from cglgan_tpu_torch.models import nn
from cglgan_tpu_torch.models.zoo import models_for_config
from cglgan_tpu_torch.ops import fused_dstep
from cglgan_tpu_torch.utils.tree import (tree_leaves, tree_map,
                                          tree_unflatten)


def build_cgl_family(cfg, part: Partition, device=None,
                     mesh=None) -> Runner:
    """``mesh``: an optional clients mesh, or a ``(clients, model)`` one;
    this rank's block of every server's clients is placed here, and with
    ``model_shards > 1`` its blocks of the G (module docstring)."""
    dev = device_mod.resolve(device)
    common.check_supported(cfg)
    S, k, W = cfg.num_servers, cfg.clients_per_server, cfg.num_workers
    # this rank's clients of each server: k_loc of them, from blk.start
    blk = slice(0, k) if mesh is None else mesh.block(k)
    # the G's column blocks over the mesh's model axis, as the reference
    # places them only where the config asks (cgl_family.py:117-126)
    tp = mesh.tp if mesh is not None and cfg.model_shards > 1 else None
    k_loc = blk.stop - blk.start
    spec_sk = P(None, CLIENTS)
    local = lambda tree: meshes.place(tree, mesh, spec_sk, groups=S)
    everyone = lambda x: meshes.gather_clients(x, mesh, groups=S)
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
    shards = local(torch.from_numpy(
        np.ascontiguousarray(part.data.reshape(W, max_len, -1)))).to(dev)
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
    periods_dev = torch.from_numpy(periods).to(dev)
    cloud_enabled = cfg.cloud_epoch > 0

    d_step = common.d_epoch_steps(
        common.d_step_fn(d_model, adv, cfg.lr_d, cfg.b1, cfg.b2, B,
                         cfg.is_image,
                         d_loss_half=algo in ("capgan", "mixgan"),
                         dtype=dtype, fuse_concat=not cfg.conv),
        cfg.epoch)
    use_kernel = fused_dstep.eligible(cfg, mesh)
    rounds = prng.RoundKeys(cfg, max_len, cfg.epoch, dev)

    # the D state is this rank's clients; Lambda is replicated, and so is
    # the G but with tensor parallelism, where ``init_state`` records its
    # blocks' plan under "g"
    layout = {"d": (spec_sk, S)}

    def init_state() -> FedState:
        # a G a server and a D a client, each from its own key of the
        # role's split (cglgan_tpu/algos/cgl_family.py:99-116)
        kg = threefry.split(prng.role_key(cfg.seed, prng.ROLE_INIT_G, dev),
                            S)
        kd = threefry.split(prng.role_key(cfg.seed, prng.ROLE_INIT_D, dev),
                            W)
        gp, gbn = g_model.init(kg, dtype)
        dp, dbn = d_model.init(kd, dtype)
        if algo == "mixgan":
            # net_g / net_d .apply(weights_init) (mixed-gan.py:181,348)
            gp = nn.dcgan_reinit(threefry.fold_in(kg, prng.FOLD_REINIT_G), gp)
            dp = nn.dcgan_reinit(threefry.fold_in(kd, prng.FOLD_REINIT_D), dp)
        state = FedState(NetState(gp, gbn, common.adam_init(gp, S)),
                         NetState(dp, dbn, common.adam_init(dp, W)),
                         torch.zeros((S,), dtype=torch.float32, device=dev),
                         0)
        if tp is not None:
            # the servers axis stays whole (lead=1), as the reference's
            # place_model_tp(t, mesh, lead=1)
            layout["g"] = (meshes.TP, meshes.tp_plan(state.g, tp.size, 1))
        return meshes.commit_tree(meshes.place_state(state, mesh, layout),
                                  mesh)

    def route(fake):
        """G output -> (S * k_loc, B, din) fakes of this rank's clients: a
        multipath G's (S, k, B, ...) head i to client i; a single-path G's
        (S, B, ...) full batch to every client of the server."""
        if multipath:
            return fake[:, blk].reshape(S * k_loc, B, din)
        return fake.reshape(S, 1, B, din).expand(S, k_loc, B, din) \
            .reshape(S * k_loc, B, din)

    def g_update(g: NetState, gbn1, z_g, d_new: NetState, lam, d_loss,
                 drop_keys=None):
        """One G forward from gbn1; the per-client losses through the
        updated Ds are both the game's inputs (every client's, gathered on
        a mesh, with the D losses ``d_loss`` for the metrics) and the primal
        of the backward: cotangent w for a single-path G; for a multipath
        G, cotangent ones for the heads and w for the trunk
        (cglgan_tpu/algos/cgl_family.py:169-181).  ``drop_keys``: the conv
        D's dropout keys, one a client of this rank."""
        gp, leaves = common.with_grad(g.params)
        with torch.enable_grad():
            fake, gbn2 = g_model.apply(gp, gbn1, z_g, train=True, tp=tp)
            out, _ = d_model.apply(d_new.params, d_new.bn, route(fake),
                                   train=True, rng=drop_keys)
            losses = adv(out, 1.0).reshape(S, k_loc)
        both = everyone(torch.stack([losses.detach().reshape(-1),
                                     d_loss.float()], dim=1)).t().contiguous()
        l0 = both[0].reshape(S, k)
        game = game_step(weighting, l0, beta, lam, cfg.lr_lambda)
        w = game.w.to(losses.dtype)[:, blk]
        if multipath:
            # leaves run heads then trunk (sorted keys)
            n_heads = len(tree_leaves(gp["heads"]))
            heads, trunk = common.grads_through(
                fake, losses, [torch.ones_like(losses), w],
                [leaves[:n_heads], leaves[n_heads:]], mesh)
            grads = list(heads) + list(trunk)
        else:
            grads = list(common.grads_through(fake, losses, [w], [leaves],
                                              mesh)[0])
        f_max = torch.sum(game.w * l0, dim=-1) - game.lam_coeff * lam
        new_p, new_opt = common.adam_update(
            g.params, tree_unflatten(g.params, grads), g.opt,
            cfg.lr_g, cfg.b1, cfg.b2)
        metrics = {"d_loss": both[1].mean(), "g_loss": l0.mean(),
                   "f_max": f_max.mean(),
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

    def cloud_sync(g: NetState, t) -> NetState:
        """The masked sync of round ``t``, its mask made on the device.  A
        device ``t`` (the captured round's counter) syncs every round, as
        the reference's: a server outside the mask keeps its G (``o * 1 +
        nw * 0``, which may turn -0.0 into +0.0).  A host ``t`` skips the
        rounds where no server syncs, since the select would keep every
        member."""
        # the reference counts t DOWN from num_communication and syncs when
        # the countdown is divisible by the period (capgan.py:155,169)
        if not isinstance(t, torch.Tensor) and \
                not (((cfg.num_communication - t) % periods) == 0).any():
            return g
        mask = (torch.remainder(cfg.num_communication - t, periods_dev)
                == 0).float()
        payload = (scope(g.params), scope(g.bn)) if sync_bn \
            else (scope(g.params),)
        avg = collectives.masked_weighted_avg_tree(payload, a_weights, mask)
        avg_b = tree_map(lambda x: x.unsqueeze(0).expand((S,) + x.shape),
                         avg)
        mixed = collectives.sigma_mix(payload, avg_b, cfg.segema)
        mixed = collectives.select_update_tree(payload, mixed, mask)
        return NetState(put(g.params, mixed[0]),
                        put(g.bn, mixed[1]) if sync_bn else g.bn, g.opt)

    def neighbour_share(d: NetState, t) -> NetState:
        """The every-E-rounds D share within a server's block, after round
        ``t``.  A host ``t`` decides on the host (on a mesh the share's
        all-reduce runs only in the rounds that share); a device ``t``
        shares every round and keeps the share where ``(t + 1) % E == 0``,
        as the reference's ``jnp.where`` (``cgl_family.py:298-300``)."""
        device_t = isinstance(t, torch.Tensor)
        if not device_t and (t + 1) % cfg.E:
            return d
        blocked = lambda tree: tree_map(
            lambda x: x.reshape((S, k_loc) + x.shape[1:]), tree)
        flat = lambda tree: tree_map(
            lambda x: x.reshape((S * k_loc,) + x.shape[2:]), tree)
        shared = flat(collectives.neighbor_share_tree(
            blocked((d.params, d.bn)), k, blocked=True, mesh=mesh))
        if device_t:
            due = torch.remainder(t + 1, cfg.E) == 0
            shared = tree_map(lambda a, b: torch.where(due, a, b), shared,
                              (d.params, d.bn))
        return NetState(shared[0], shared[1], d.opt)

    def round_body(state: FedState, t, streams):
        """One federated round from its draws ``streams`` (``round_fn``'s)
        at round ``t``: a host int, or an int64 0-dim device tensor (the
        captured round's counter).  The host reads no tensor here.  The
        state's ``t`` is left as it is."""
        g = cloud_sync(state.g, t) if cloud_enabled else state.g
        starts, z_d, z_g = streams[:3]
        d_keys = drop_keys = None
        if cfg.conv:
            k_d, k_drop = common.conv_stream_keys(
                streams, dev, "starts, z_d, z_g, k_d, k_drop")
            d_keys = local(common.client_keys(k_d, k))
            drop_keys = local(common.client_keys(k_drop, k))
        # the latents in the run's dtype (the reference draws them so)
        z_d = torch.as_tensor(z_d, device=dev).to(dtype)
        z_g = torch.as_tensor(z_g, device=dev).to(dtype)
        # the windows are gathered on the device: the host reads no start
        starts = common.device_starts(starts, dev)

        if use_kernel:
            new_d, d_loss, gbn1 = fused_dstep.kernel_local_phase(
                cfg, g_model, g, state.d, shards, starts, z_d)
        else:
            with torch.no_grad():
                xd, gbn1 = g_model.apply(g.params, g.bn, z_d, train=True,
                                         tp=tp)
            shared = S == 1 and not multipath
            fake = xd.reshape(B, din) if shared else route(xd)
            new_d, d_loss = d_step(state.d, shards, starts, fake, d_keys)

        new_g, lam_new, metrics = g_update(g, gbn1, z_g, new_d, state.lam,
                                           d_loss, drop_keys)
        if cfg.E > 0:
            new_d = neighbour_share(new_d, t)
        return FedState(new_g, new_d, lam_new, state.t), metrics

    def round_fn(state: FedState, streams=None):
        """One federated round.  ``streams``: optional injected
        ``(starts (E,), z_d (S,B,zdim), z_g (S,B,zdim))``, and with conv
        each server's ``k_d, k_drop`` (S, 2) threefry key data after them;
        by default they are the reference's draws for round ``state.t``
        (``core/prng.py``)."""
        t = state.t
        if streams is None:
            streams = (rounds.device_starts(t),
                       *prng.server_draws(cfg, rounds.key(t)))
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
                state, t, (starts, *prng.server_draws(cfg, key))),
            prng.RoundKeys(cfg, max_len, cfg.epoch, dev, piece=piece), dev)

    @torch.no_grad()
    def gen(state: FedState, z):
        """Eval-mode samples from caller latents z (n, zdim), n divisible
        by S, of a state with the whole G; server i generates from the
        block z[i*per:(i+1)*per].  A
        multipath G's output is the concat of its heads, strided back down
        to the per-server quota (painter routing, capgan.py:79-83)."""
        per = z.shape[0] // S
        out, _ = g_model.apply(state.g.params, state.g.bn,
                               z.reshape(S, per, zdim), train=False)
        # copies by ``cat``, not ``reshape``: torch.export then keeps the
        # batch symbolic down to one row a server (``utils/export.py``)
        if multipath:
            out = torch.cat(out.unbind(1), dim=1)[:, ::k]
        return torch.cat(out.unbind(0))

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
                  gen_batch_multiple=S, gen_client=gen_client, device=dev,
                  mesh=mesh, layout=layout, program=program)

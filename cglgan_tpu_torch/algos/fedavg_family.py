"""FL-GAN and FeGAN: FedAvg of whole G and D with local alternating training.

Port of ``cglgan_tpu/algos/fedavg_family.py`` for the 2DMG "batches" sweep.

FL-GAN (FLGAN/2DMG/flgan.py): one server broadcasts (p_g, p_d); each worker
loads them, trains ``epoch`` batches locally, returns the state dicts; the
server averages uniformly.

FeGAN (fegan.py): adds (a) KL device scores, (b) per-round exp-score
aggregation weights, (c) the balanced group schedule — only sampled workers
train each round.

Layout: G and D params are global and unstacked; every worker starts the
round from the same broadcast params, so the W local sweeps are one batched
pass over stacked ``(W, ...)`` tensors.  Adam moments and counts persist per
worker, stacked ``(W, ...)``; FeGAN also stacks the BN state per worker (the
2DMG nets have none; the layout is kept).  ``lam`` is None.

The local phase runs the fused CUDA kernel (``ops/fused_sweep.py``) when
``fused_sweep.eligible`` says so — the reference's rule: only when
``pallas_sweep=True`` forces it — and autograd otherwise.  The ragged
"epochs" sweep of the image datasets (``_plan_buckets``, ``_sweep_buckets``)
and dropout participation are not ported yet: ``common.check_supported``
raises for them.

bfloat16 (``dtype="bfloat16"``, on 2DMG only with ``force_dtype``, as the
reference's config demands): params, latents, fakes, real rows and Adam
moments are bfloat16, the losses float32; the kernel stays float32-only
(``fused_sweep.eligible`` raises for ``pallas_sweep=True`` in bfloat16).
"""
from __future__ import annotations

import numpy as np
import torch

from cglgan_tpu_torch.algos import common
from cglgan_tpu_torch.algos.common import FedState, NetState
from cglgan_tpu_torch.algos.runner import Runner
from cglgan_tpu_torch.core import device as device_mod
from cglgan_tpu_torch.core import prng
from cglgan_tpu_torch.core.dtypes import torch_dtype
from cglgan_tpu_torch.data.partition import Partition
from cglgan_tpu_torch.fed import collectives
from cglgan_tpu_torch.fed.sampling import fegan_scores, init_groups
from cglgan_tpu_torch.models.zoo import models_for_config
from cglgan_tpu_torch.ops import fused_sweep
from cglgan_tpu_torch.utils.tree import tree_map, tree_unflatten


def _local_steps(cfg, lengths: np.ndarray) -> np.ndarray:
    """Per-worker local step counts for one round."""
    if cfg.resolved_local_sweep == "batches":
        return np.full(len(lengths), cfg.epoch, dtype=np.int32)
    per_epoch = np.ceil(np.asarray(lengths) / cfg.batch_size).astype(np.int32)
    return (cfg.epoch * per_epoch).astype(np.int32)


def _local_sweep(cfg, g_model, d_model, adv):
    """The local round of n worker lanes at once: ``steps`` iterations of
    (D step on real + fresh fake, unhalved; then G step through the updated
    D) — the reference worker train loop (FLGAN/2DMG/flgan.py:229-256,
    fegan.py:282-303).  Returns the mean loss over the steps."""
    B = cfg.batch_size
    dtype = torch_dtype(cfg)

    def g_step(g: NetState, gbn, d_params, dbn, z):
        """One batched G Adam step on adv(D(G(z)), 1) through ``d_params``."""
        gp, leaves = common.with_grad(g.params)
        with torch.enable_grad():
            fake, gbn2 = g_model.apply(gp, gbn, z, train=True)
            out, _ = d_model.apply(d_params, dbn, fake, train=True)
            loss = adv(out, 1.0)
            grads = torch.autograd.grad(loss.sum(), leaves)
        new_p, new_opt = common.adam_update(
            g.params, tree_unflatten(g.params, list(grads)), g.opt,
            cfg.lr_g, cfg.b1, cfg.b2)
        return NetState(new_p, gbn2, new_opt), loss.detach()

    def d_step(d: NetState, real, fake):
        dp, leaves = common.with_grad(d.params)
        with torch.enable_grad():
            out_r, bn1 = d_model.apply(dp, d.bn, real, train=True)
            out_f, bn2 = d_model.apply(dp, bn1, fake, train=True)
            loss = adv(out_r, 1.0) + adv(out_f, 0.0)
            grads = torch.autograd.grad(loss.sum(), leaves)
        new_p, new_opt = common.adam_update(
            d.params, tree_unflatten(d.params, list(grads)), d.opt,
            cfg.lr_d, cfg.b1, cfg.b2)
        return NetState(new_p, bn2, new_opt), loss.detach()

    def sweep(g: NetState, d: NetState, shards, starts, z1, z2, steps: int):
        """g, d: (n, ...) stacked lane states (params already broadcast);
        shards (n, L, ...); z1, z2 (n, steps, B, zdim)."""
        d_sum = g_sum = 0.0
        for i in range(steps):
            real = common.prepare_real(
                common.slice_batch(shards, int(starts[i]), B), cfg.is_image,
                dtype)
            # D step: fake regenerated by the local G, gradient discarded
            with torch.no_grad():
                fake, gbn_d = g_model.apply(g.params, g.bn, z1[:, i],
                                            train=True)
            d, d_loss = d_step(d, real, fake)
            # G step against the updated D
            g, g_loss = g_step(g, gbn_d, d.params, d.bn, z2[:, i])
            d_sum, g_sum = d_sum + d_loss, g_sum + g_loss
        denom = max(steps, 1)
        return g, d, d_sum / denom, g_sum / denom

    return sweep


def _kernel_sweep_all(cfg, g: NetState, d: NetState, shards, starts, z1, z2):
    """FedAvg-family local phase in the fused kernel over flat stacked
    (W, ...) lane states; BN state (empty for the 2DMG MLPs) passes through
    unchanged."""
    new_g, new_d, d_loss, g_loss = fused_sweep.kernel_sweep_phase(
        NetState(g.params, None, g.opt), NetState(d.params, None, d.opt),
        shards, starts, z1, z2, cfg)
    return (NetState(new_g.params, g.bn, new_g.opt),
            NetState(new_d.params, d.bn, new_d.opt), d_loss, g_loss)


def _family_parts(cfg, part: Partition, dev, adv_head: str):
    """What both runners share: models, shards, the local phase and the
    serving functions."""
    common.check_supported(cfg)
    g_model, d_model = models_for_config(cfg)
    adv = common.make_adv_loss(adv_head)
    W, B, zdim = cfg.num_workers, cfg.batch_size, cfg.latent_dim
    dtype = torch_dtype(cfg)
    shards = torch.from_numpy(np.ascontiguousarray(part.data)).to(dev)
    steps_np = _local_steps(cfg, part.lengths)
    max_steps = int(steps_np.max())
    max_len = part.data.shape[1]
    sweep = _local_sweep(cfg, g_model, d_model, adv)
    use_kernel = fused_sweep.eligible(cfg)

    def init_nets():
        """Unstacked (gp, gbn, dp, dbn) and per-worker Adam states."""
        gp, gbn = g_model.init(prng.generator(cfg.seed, prng.ROLE_INIT_G), 1,
                               dtype)
        dp, dbn = d_model.init(prng.generator(cfg.seed, prng.ROLE_INIT_D), 1,
                               dtype)
        one = lambda tree: tree_map(lambda x: x[0].to(dev), tree)
        gp, gbn, dp, dbn = one(gp), one(gbn), one(dp), one(dbn)
        stacked = lambda tree: tree_map(
            lambda x: x.unsqueeze(0).expand((W,) + tuple(x.shape)), tree)
        # optimizer state persists per worker across rounds (the reference
        # constructs Adam once per worker thread, FLGAN/2DMG/flgan.py:203-204)
        return (gp, gbn, dp, dbn, common.adam_init(stacked(gp), W),
                common.adam_init(stacked(dp), W))

    def streams_for(t: int, streams):
        if streams is None:
            streams = prng.sweep_streams(cfg, t, max_len, max_steps, dev)
        starts, z1, z2 = streams
        # the latents in the run's dtype (the reference draws them so)
        z1 = torch.as_tensor(z1, device=dev).to(dtype)
        z2 = torch.as_tensor(z2, device=dev).to(dtype)
        return [int(s) for s in starts], z1, z2

    def local_phase(g: NetState, d: NetState, lane_shards, starts, z1, z2):
        """g, d: lane-stacked states with params broadcast."""
        if use_kernel:
            return _kernel_sweep_all(cfg, g, d, lane_shards, starts, z1, z2)
        return sweep(g, d, lane_shards, starts, z1, z2, max_steps)

    def make_gen(bn_of):
        @torch.no_grad()
        def gen(state: FedState, z):
            """Serving contract: eval-mode samples from caller latents."""
            up = lambda tree: tree_map(lambda x: x.unsqueeze(0), tree)
            out, _ = g_model.apply(up(state.g.params), up(bn_of(state)),
                                   z.unsqueeze(0), train=False)
            return out[0]

        def sample(state: FedState, n: int):
            z = torch.randn((n, zdim),
                            generator=prng.generator(cfg.seed,
                                                     prng.ROLE_EVAL)).to(dev)
            return gen(state, z)
        return gen, sample

    return (W, shards, init_nets, streams_for, local_phase, make_gen,
            use_kernel)


def build_flgan(cfg, part: Partition, device=None) -> Runner:
    dev = device_mod.resolve(device)
    (W, shards, init_nets, streams_for, local_phase, make_gen,
     _) = _family_parts(cfg, part, dev, cfg.resolved_d_head)

    def init_state() -> FedState:
        gp, gbn, dp, dbn, gopt, dopt = init_nets()
        return FedState(NetState(gp, gbn, gopt), NetState(dp, dbn, dopt),
                        None, 0)

    def round_fn(state: FedState, streams=None):
        """One federated round.  ``streams``: optional injected
        ``(starts (E,), z1 (W,E,B,zdim), z2 (W,E,B,zdim))``; by default
        they are drawn from ``core.prng`` for round ``state.t``."""
        starts, z1, z2 = streams_for(state.t, streams)
        bcast = lambda tree: collectives.broadcast_tree(tree, W)
        g, d, d_loss, g_loss = local_phase(
            NetState(bcast(state.g.params), bcast(state.g.bn), state.g.opt),
            NetState(bcast(state.d.params), bcast(state.d.bn), state.d.opt),
            shards, starts, z1, z2)
        # uniform FedAvg of params and BN buffers (state_dict transfer,
        # FLGAN/MNIST/flgan.py:148-162)
        agg = collectives.fedavg_tree
        metrics = {"d_loss": d_loss.mean(), "g_loss": g_loss.mean()}
        return FedState(NetState(agg(g.params), agg(g.bn), g.opt),
                        NetState(agg(d.params), agg(d.bn), d.opt),
                        None, state.t + 1), metrics

    gen, sample = make_gen(lambda state: state.g.bn)
    return Runner(cfg, part, init_state, round_fn, sample, gen=gen,
                  device=dev)


def build_fegan(cfg, part: Partition, device=None) -> Runner:
    dev = device_mod.resolve(device)
    # fegan.py:224 uses BCELoss with a 2-logit D whose Sigmoid is commented
    # out — shape-incompatible in torch.  As the reference package does, the
    # intended semantics are implemented: sigmoid head + BCE.
    (W, shards, init_nets, streams_for, local_phase, make_gen,
     use_kernel) = _family_parts(cfg, part, dev, "sigmoid")

    sk = fegan_scores(part.class_freq, part.class_freq.sum(0))
    schedule = init_groups(W, part.class_freq, cfg.frac_workers,
                           num_rounds=cfg.num_communication,
                           num_class=cfg.num_class)       # (R, gp_size), once
    # first-occurrence lane mask: init_groups only repeats a member in the
    # degenerate group-smaller-than-gp_size fallback; duplicate lanes must
    # count once in the aggregate and write once in the scatter
    lane_valid = np.ones(schedule.shape, np.float32)
    for j in range(1, schedule.shape[1]):
        dup = (schedule[:, :j] == schedule[:, j:j + 1]).any(axis=1)
        lane_valid[dup, j] = 0.0
    # group-gather: with partial participation, train ONLY the gp_size
    # sampled members — gather their (shard, opt, BN) state, sweep, scatter
    # back — instead of sweeping all W and masking away (1-frac) of the work
    gather_mode = not use_kernel and schedule.shape[1] < W
    # Every round's lanes, masks and aggregation weights are known from the
    # schedule, so they are made once here and live on the device: a round
    # then copies nothing from the host (a host-to-device copy would make the
    # host wait for the device each round).
    rounds = np.arange(len(schedule))[:, None]
    if gather_mode:
        member_np = lane_valid                             # (R, gp_size)
        groups_dev = torch.from_numpy(schedule.astype(np.int64)).to(dev)
    else:
        member_np = np.zeros((len(schedule), W), np.float32)   # (R, W)
        member_np[rounds, schedule] = 1.0
    # w = exp(sk) over the group, normalised (fegan.py:145-146)
    weight_np = (np.exp(sk)[schedule] if gather_mode
                 else np.exp(sk)[None, :]) * member_np
    total_np = weight_np.sum(axis=1, keepdims=True)
    any_alive = total_np[:, 0] > 0
    weight_dev = torch.from_numpy(
        weight_np / np.maximum(total_np, np.float32(1e-12))).to(dev)
    member_dev = torch.from_numpy(member_np).to(dev)
    members = np.maximum(member_np.sum(axis=1), 1.0)       # metric denominators

    def init_state() -> FedState:
        gp, gbn, dp, dbn, gopt, dopt = init_nets()
        # BN buffers persist per worker (fedlab serialization moves
        # parameters only, fegan.py:133-134) — stack them
        stack = lambda tree: tree_map(
            lambda x: x.unsqueeze(0).repeat((W,) + (1,) * x.ndim), tree)
        return FedState(NetState(gp, stack(gbn), gopt),
                        NetState(dp, stack(dbn), dopt), None, 0)

    def aggregate(lanes, t: int, old):
        """Score-weighted aggregate over round t's lanes; if the weights sum
        to zero the round is a no-op and the old params stay."""
        if not any_alive[t]:
            return old
        return collectives.weighted_avg_tree(lanes, weight_dev[t])

    def metrics_of(d_loss, g_loss, t: int):
        m = member_dev[t]
        return {"d_loss": (d_loss * m).sum() / float(members[t]),
                "g_loss": (g_loss * m).sum() / float(members[t])}

    def round_fn(state: FedState, streams=None):
        """One federated round; ``streams`` as for FL-GAN, for all W
        workers also in gather mode (the sampled lanes take ``z[group]``)."""
        t = state.t
        starts, z1, z2 = streams_for(t, streams)

        if gather_mode:
            # ---- train only the sampled lanes -------------------------
            idx = groups_dev[t]
            n = idx.shape[0]
            take = lambda tree: tree_map(lambda x: x[idx], tree)
            bcast = lambda tree: collectives.broadcast_tree(tree, n)
            g, d, d_loss, g_loss = local_phase(
                NetState(bcast(state.g.params), take(state.g.bn),
                         common.AdamState(*take(tuple(state.g.opt)))),
                NetState(bcast(state.d.params), take(state.d.bn),
                         common.AdamState(*take(tuple(state.d.opt)))),
                shards[idx], starts, z1[idx], z2[idx])
            # scatter local state back; duplicate lanes (lane_valid == 0,
            # the degenerate schedule only) are dropped, so each worker is
            # written once
            if lane_valid[t].all():
                src, dst = None, idx
            else:
                src = torch.from_numpy(np.flatnonzero(lane_valid[t])).to(dev)
                dst = idx[src]

            def scatter(old_full, new_lanes):
                def put(full, lane):
                    out = full.clone()
                    out[dst] = lane if src is None else lane[src]
                    return out
                return tree_map(put, old_full, new_lanes)

            opt_of = lambda old, new: common.AdamState(
                *scatter(tuple(old), tuple(new)))
            new_g = NetState(aggregate(g.params, t, state.g.params),
                             scatter(state.g.bn, g.bn),
                             opt_of(state.g.opt, g.opt))
            new_d = NetState(aggregate(d.params, t, state.d.params),
                             scatter(state.d.bn, d.bn),
                             opt_of(state.d.opt, d.opt))
            return (FedState(new_g, new_d, None, t + 1),
                    metrics_of(d_loss, g_loss, t))

        # ---- full-width path (kernel / full participation) ------------
        bcast = lambda tree: collectives.broadcast_tree(tree, W)
        g, d, d_loss, g_loss = local_phase(
            NetState(bcast(state.g.params), state.g.bn, state.g.opt),
            NetState(bcast(state.d.params), state.d.bn, state.d.opt),
            shards, starts, z1, z2)
        # local state (opt, BN) advances only for sampled workers —
        # unsampled workers stay blocked on their queue in the reference
        mask = member_dev[t]
        sel = lambda old, new: collectives.select_update_tree(old, new, mask)
        opt_of = lambda old, new: common.AdamState(
            *sel(tuple(old), tuple(new)))
        new_g = NetState(aggregate(g.params, t, state.g.params),
                         sel(state.g.bn, g.bn), opt_of(state.g.opt, g.opt))
        new_d = NetState(aggregate(d.params, t, state.d.params),
                         sel(state.d.bn, d.bn), opt_of(state.d.opt, d.opt))
        return (FedState(new_g, new_d, None, t + 1),
                metrics_of(d_loss, g_loss, t))

    # the server evaluates with a net whose BN buffers were never trained
    # (deserialize moves params only, fegan.py:169): the fixed init BN
    g_model, _ = models_for_config(cfg)
    _, eval_bn = g_model.init(prng.generator(cfg.seed, prng.ROLE_INIT_G), 1,
                              torch_dtype(cfg))
    eval_bn = tree_map(lambda x: x[0].to(dev), eval_bn)
    gen, sample = make_gen(lambda state: eval_bn)
    return Runner(cfg, part, init_state, round_fn, sample, gen=gen,
                  device=dev, extras={"sk": sk, "schedule": schedule})

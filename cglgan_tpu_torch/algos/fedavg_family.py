"""FL-GAN and FeGAN: FedAvg of whole G and D with local alternating training.

Port of ``cglgan_tpu/algos/fedavg_family.py``: the 2DMG "batches" sweep and
the image datasets' ragged "epochs" sweep, on MLP models and on the conv
LSGAN pair (float32 or bfloat16).

FL-GAN (FLGAN/2DMG/flgan.py, FLGAN/MNIST/flgan.py): one server broadcasts
(p_g, p_d); each worker loads them, trains locally (2DMG: ``epoch``
batches; MNIST: ``epoch`` full local epochs), returns the state dicts; the
server averages uniformly, params and BN buffers alike.

FeGAN (fegan.py): adds (a) KL device scores, (b) per-round exp-score
aggregation weights, (c) the balanced group schedule — only sampled workers
train each round.  On image data its D is the 1-logit ``mnist`` D whatever
``d_head`` says (``cglgan_tpu/algos/fedavg_family.py:320-323``).

Layout: G and D params are global and unstacked; every worker starts the
round from the same broadcast params, so the W local sweeps are one batched
pass over stacked ``(W, ...)`` lanes.  Adam moments and counts persist per
worker, stacked ``(W, ...)``; FeGAN also stacks the BN state per worker
(the MNIST G's running stats really change; the 2DMG nets have none).
``lam`` is None.

The ragged sweep: worker w takes ``steps[w]`` local steps
(``_local_steps``: ``epoch`` full passes over its shard), so a lane's step
i is active where ``i < steps[lane]`` and an inactive step leaves the whole
lane state (G and D params, BN state, Adam) as it was; the losses average
over the active steps.  The counts are host ints, so the host knows which
steps have every lane active (no merge) and stops at the lanes' largest
count.  Every full-width sweep is this one masked sweep of all lanes.  The
reference, on one device, splits the workers into step-count buckets
(``_plan_buckets``) and sweeps each for only its own largest count: less
device work, more sequential steps.  The port's sweep is host-bound on the
H100, so it keeps the fewer sequential steps; ``_plan_buckets`` stays to
report the reference's plan beside the port's.

The local phase runs the fused CUDA kernel (``ops/fused_sweep.py``) when
``fused_sweep.eligible`` says so — the reference's rule: only when
``pallas_sweep=True`` forces it, on 2DMG's "batches" sweep, never with
dropout — and autograd otherwise.

Dropout (``dropout_rate > 0``, ``common.participation_mask`` on the
round's survival draw): FL-GAN's dropped workers train but neither enter
the aggregate nor keep their new Adam state, and the metrics count the
survivors (``participants``); FeGAN's drop mask multiplies its group
schedule, so a dropped sampled worker is treated as unsampled, and a round
whose every sampled worker dropped leaves the global params as they were.

Conv (``conv=True``, ``cglgan_tpu/algos/fedavg_family.py:112-121,195,
320-323``): both runners take the raw-logit head (BCE on logits; FeGAN
keeps the conv D), and the conv D's Dropout2d takes threefry keys, one a
lane and local step: ``kd1`` of the round's streams for the D step, split
into the real and the fake forward's, and ``kd2`` for the G step's D
forward.  FL-GAN averages the conv nets' BatchNorm buffers with their
params; FeGAN keeps them per worker.  The keys of a lane's masked steps
are drawn and unused, as in the reference.

A clients mesh (``mesh``, ``core/meshes.py``; the reference's
``P("clients")`` on ``(W, ...)``): each rank holds a contiguous block of
W / n workers, with their shards, Adam state (FeGAN: BN state too), step
counts and lane draws (``prng.lane_draws(..., lanes=)``); the G and D
params are replicated.  FL-GAN's FedAvg, with the loss means, is one
all-reduce of local partials; FeGAN's schedule is made on every rank from
the same seed, and each rank trains its own sampled workers in gather mode
(at full width its block), all-reducing the weighted partial sums.  No
kernel runs on a mesh, as in the reference (``fused_sweep.eligible``).

bfloat16 (``dtype="bfloat16"``; on 2DMG only with ``force_dtype``, as the
reference's config demands): params, BN state, latents, fakes, real rows
and Adam moments are bfloat16, the losses float32; the kernel stays
float32-only (``fused_sweep.eligible`` raises for ``pallas_sweep=True`` in
bfloat16).
"""
from __future__ import annotations

import numpy as np
import torch

from cglgan_tpu_torch.algos import common
from cglgan_tpu_torch.algos.common import FedState, NetState
from cglgan_tpu_torch.algos.runner import Runner
from cglgan_tpu_torch.core import device as device_mod
from cglgan_tpu_torch.core import meshes, prng, threefry
from cglgan_tpu_torch.core.meshes import CLIENTS, P
from cglgan_tpu_torch.core.dtypes import torch_dtype
from cglgan_tpu_torch.data.partition import Partition
from cglgan_tpu_torch.fed import collectives
from cglgan_tpu_torch.fed.sampling import fegan_scores, init_groups
from cglgan_tpu_torch.models.zoo import (build_discriminator,
                                         models_for_config)
from cglgan_tpu_torch.ops import fused_sweep
from cglgan_tpu_torch.utils.tree import tree_map, tree_unflatten


def _local_steps(cfg, lengths: np.ndarray) -> np.ndarray:
    """Per-worker local step counts for one round."""
    if cfg.resolved_local_sweep == "batches":
        return np.full(len(lengths), cfg.epoch, dtype=np.int32)
    per_epoch = np.ceil(np.asarray(lengths) / cfg.batch_size).astype(np.int32)
    return (cfg.epoch * per_epoch).astype(np.int32)


def _plan_buckets(steps: np.ndarray, max_buckets: int = 4):
    """Partition workers into <= max_buckets step-count buckets
    (``cglgan_tpu/algos/fedavg_family.py:45-83``, the same DP and output).

    Under iid=1 the shard sizes, hence the ragged sweep's step counts,
    spread ~20x, so a sweep of every lane for max(steps) iterations masks
    most lane-steps away.  The counts are static host ints, so the workers
    are sorted and split into contiguous buckets, each swept for only its
    own largest count; the DP minimises sum(|bucket| * bucket_max).
    Returns [(worker_idx_array, bucket_max), ...] in ascending step order,
    or None when one bucket is optimal.  The port sweeps all lanes at once
    and reads this plan only to report it (``chip_smoke.py``)."""
    steps = np.asarray(steps)
    n = len(steps)
    if n < 2 or steps.max() == steps.min() or max_buckets < 2:
        return None
    order = np.argsort(steps, kind="stable")
    s = steps[order]
    K = min(max_buckets, n)
    INF = float("inf")
    dp = [[INF] * (n + 1) for _ in range(K + 1)]
    cut = [[0] * (n + 1) for _ in range(K + 1)]
    dp[0][0] = 0
    for k in range(1, K + 1):
        dp[k][0] = 0
        for i in range(1, n + 1):
            for j in range(i):
                c = dp[k - 1][j] + (i - j) * int(s[i - 1])
                if c < dp[k][i]:
                    dp[k][i], cut[k][i] = c, j
    segs = []
    i, k = n, K
    while i > 0:
        j = cut[k][i]
        segs.append((order[j:i].astype(np.int64), int(s[i - 1])))
        i, k = j, k - 1
    segs.reverse()
    return segs if len(segs) > 1 else None


def _merge(active: torch.Tensor, new: NetState, old: NetState) -> NetState:
    """Lane by lane, ``new`` where ``active`` (n,) and ``old`` elsewhere:
    an inactive step of the ragged sweep leaves the lane as it was."""
    def pick(a, b):
        return torch.where(active.reshape((-1,) + (1,) * (a.ndim - 1)), a, b)
    both = lambda x, y: tree_map(pick, x, y)
    return NetState(both(new.params, old.params), both(new.bn, old.bn),
                    common.AdamState(*both(tuple(new.opt), tuple(old.opt))))


def _local_sweep(cfg, g_model, d_model, adv):
    """The local round of n worker lanes at once: iterations of (D step on
    real + fresh fake, unhalved; then G step through the updated D) — the
    reference worker train loop (FLGAN/2DMG/flgan.py:229-256,
    FLGAN/MNIST/flgan.py:249-269, fegan.py:282-303).  Lane j takes
    ``steps[j]`` of them; returns each lane's mean loss over its steps."""
    B = cfg.batch_size
    dtype = torch_dtype(cfg)

    def g_step(g: NetState, gbn, d_params, dbn, z, key=None):
        """One batched G Adam step on adv(D(G(z)), 1) through ``d_params``;
        ``key`` (n, 2): the conv D's dropout keys, one a lane."""
        gp, leaves = common.with_grad(g.params)
        with torch.enable_grad():
            fake, gbn2 = g_model.apply(gp, gbn, z, train=True)
            out, _ = d_model.apply(d_params, dbn, fake, train=True, rng=key)
            loss = adv(out, 1.0)
            grads = torch.autograd.grad(loss.sum(), leaves)
        new_p, new_opt = common.adam_update(
            g.params, tree_unflatten(g.params, list(grads)), g.opt,
            cfg.lr_g, cfg.b1, cfg.b2)
        return NetState(new_p, gbn2, new_opt), loss.detach()

    def d_step(d: NetState, real, fake, key=None):
        """One batched D Adam step on real, then fake, through two
        forwards; ``key`` (n, 2): the conv D's dropout keys, one a lane,
        split into the real forward's and the fake forward's."""
        r1 = r2 = None
        if key is not None:
            r = threefry.split(key)                             # (n, 2, 2)
            r1, r2 = r[:, 0], r[:, 1]
        dp, leaves = common.with_grad(d.params)
        with torch.enable_grad():
            out_r, bn1 = d_model.apply(dp, d.bn, real, train=True, rng=r1)
            out_f, bn2 = d_model.apply(dp, bn1, fake, train=True, rng=r2)
            loss = adv(out_r, 1.0) + adv(out_f, 0.0)
            grads = torch.autograd.grad(loss.sum(), leaves)
        new_p, new_opt = common.adam_update(
            d.params, tree_unflatten(d.params, list(grads)), d.opt,
            cfg.lr_d, cfg.b1, cfg.b2)
        return NetState(new_p, bn2, new_opt), loss.detach()

    def sweep(g: NetState, d: NetState, shards, starts, z1, z2,
              steps: np.ndarray, steps_dev=None, keys=None):
        """g, d: (n, ...) stacked lane states (params already broadcast);
        shards (n, L, ...); z1, z2 (n, >= max(steps), B, zdim); ``steps``
        the lanes' step counts on the host, ``steps_dev`` the same on the
        device (needed only where they differ); ``keys``: the conv D's
        ``(kd1, kd2)``, each (n, >= max(steps), 2), or None.  No lanes (a
        mesh rank none of whose workers is sampled): nothing to do."""
        if len(steps) == 0:
            none = torch.zeros((0,), dtype=torch.float32, device=z1.device)
            return g, d, none, none
        lo, hi = int(steps.min()), int(steps.max())
        d_sum = g_sum = 0.0
        for i in range(hi):
            real = common.prepare_real(
                common.slice_batch(shards, int(starts[i]), B), cfg.is_image,
                dtype)
            # D step: fake regenerated by the local G, gradient discarded;
            # its train-mode forward moves the G's BN running stats
            with torch.no_grad():
                fake, gbn_d = g_model.apply(g.params, g.bn, z1[:, i],
                                            train=True)
            kd1, kd2 = (None, None) if keys is None else \
                (keys[0][:, i], keys[1][:, i])
            d_new, d_loss = d_step(d, real, fake, kd1)
            # G step against the updated D, from the stats the D step left
            g_new, g_loss = g_step(g, gbn_d, d_new.params, d_new.bn,
                                   z2[:, i], kd2)
            if i < lo:                   # every lane active: nothing to mask
                g, d = g_new, d_new
            else:
                active = steps_dev > i
                g, d = _merge(active, g_new, g), _merge(active, d_new, d)
                d_loss = torch.where(active, d_loss, 0.0)
                g_loss = torch.where(active, g_loss, 0.0)
            d_sum, g_sum = d_sum + d_loss, g_sum + g_loss
        if lo == hi:
            denom = max(hi, 1)
        else:
            denom = torch.clamp(steps_dev, min=1).to(torch.float32)
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


def _family_parts(cfg, part: Partition, dev, adv_head: str, d_model=None,
                  mesh=None):
    """What both runners share: models, shards, the local phase and the
    serving functions.  ``d_model`` replaces the config's D (FeGAN's on
    image data); ``mesh``: a clients mesh, whose rank holds the workers
    ``blk`` (all W without one)."""
    common.check_supported(cfg)
    g_model, cfg_d = models_for_config(cfg)
    d_model = d_model or cfg_d
    adv = common.make_adv_loss(adv_head)
    W, B, zdim = cfg.num_workers, cfg.batch_size, cfg.latent_dim
    blk = slice(0, W) if mesh is None else mesh.block(W)
    local = lambda tree: meshes.place(tree, mesh, P(CLIENTS))
    dtype = torch_dtype(cfg)
    shards = local(torch.from_numpy(np.ascontiguousarray(part.data))).to(dev)
    steps_all = _local_steps(cfg, part.lengths)
    # this rank's workers' step counts, on the host and on the device
    steps_np = steps_all[blk]
    steps_dev = torch.from_numpy(steps_np.astype(np.int64)).to(dev)
    # every rank sweeps to the largest count of all W: their draws and
    # window starts are the unsharded run's
    max_steps = int(steps_all.max())
    max_len = part.data.shape[1]
    sweep = _local_sweep(cfg, g_model, d_model, adv)
    use_kernel = fused_sweep.eligible(cfg, mesh)
    rounds = prng.RoundKeys(cfg, max_len, max_steps, dev)

    def init_nets():
        """Unstacked (gp, gbn, dp, dbn) and per-worker Adam states: one
        init on each role's key (cglgan_tpu/algos/fedavg_family.py:
        216-219)."""
        role = lambda r: prng.role_key(cfg.seed, r, dev).unsqueeze(0)
        gp, gbn = g_model.init(role(prng.ROLE_INIT_G), dtype)
        dp, dbn = d_model.init(role(prng.ROLE_INIT_D), dtype)
        one = lambda tree: tree_map(lambda x: x[0], tree)
        gp, gbn, dp, dbn = one(gp), one(gbn), one(dp), one(dbn)
        stacked = lambda tree: tree_map(
            lambda x: x.unsqueeze(0).expand((W,) + tuple(x.shape)), tree)
        # optimizer state persists per worker across rounds (the reference
        # constructs Adam once per worker thread, FLGAN/2DMG/flgan.py:203-204)
        return (gp, gbn, dp, dbn, common.adam_init(stacked(gp), W),
                common.adam_init(stacked(dp), W))

    # the injected streams: the three draws, with conv the dropout keys at
    # slots 3 and 4, then the survival draw
    first_extra = 5 if cfg.conv else 3

    def streams_for(t: int, streams):
        """(starts, z1, z2, dropout keys or None, survival mask or None):
        the lanes' draws this rank's, the survival mask every worker's.
        ``streams`` may carry the survival draw after its draws and keys;
        else it is drawn for round t.  Injected streams cover all W
        workers."""
        alive = streams[first_extra] \
            if streams is not None and len(streams) > first_extra else None
        if streams is None:
            streams = (rounds.starts(t), *prng.lane_draws(
                cfg, rounds.key(t), max_steps,
                None if mesh is None else blk))
        elif mesh is not None:
            streams = (streams[0], *(torch.as_tensor(x)[blk]
                                     for x in streams[1:first_extra]))
        starts, z1, z2 = streams[:3]
        keys = common.conv_stream_keys(
            streams, dev, "starts, z1, z2, kd1, kd2", extras=1) \
            if cfg.conv else None
        # the latents in the run's dtype (the reference draws them so)
        z1 = torch.as_tensor(z1, device=dev).to(dtype)
        z2 = torch.as_tensor(z2, device=dev).to(dtype)
        mask = None
        if cfg.dropout_rate > 0.0:
            if alive is None:
                alive = rounds.survival(t, W)
            mask = common.participation_mask(
                torch.as_tensor(alive, device=dev), cfg.dropout_rate)
        return [int(s) for s in starts], z1, z2, keys, mask

    def local_phase(g: NetState, d: NetState, lane_shards, starts, z1, z2,
                    keys, lanes=None, lanes_dev=None):
        """g, d: lane-stacked states with params broadcast; ``keys``: the
        lanes' conv dropout keys or None; ``lanes``: the lanes' workers
        (indices into this rank's block) on the host and ``lanes_dev`` on
        the device (gather mode), or None for all of its workers in
        order."""
        if use_kernel:
            return _kernel_sweep_all(cfg, g, d, lane_shards, starts, z1, z2)
        if lanes is not None:
            return sweep(g, d, lane_shards, starts, z1, z2, steps_np[lanes],
                         steps_dev[lanes_dev], keys)
        return sweep(g, d, lane_shards, starts, z1, z2, steps_np, steps_dev,
                     keys)

    def make_gen(bn_of):
        @torch.no_grad()
        def gen(state: FedState, z):
            """Serving contract: eval-mode samples from caller latents."""
            up = lambda tree: tree_map(lambda x: x.unsqueeze(0), tree)
            out, _ = g_model.apply(up(state.g.params), up(bn_of(state)),
                                   z.unsqueeze(0), train=False)
            return out[0]

        def sample(state: FedState, n: int):
            return gen(state, prng.eval_z(cfg.seed, (n, zdim), dev))
        return gen, sample

    return (blk, shards, init_nets, streams_for, local_phase, make_gen,
            use_kernel)


def build_flgan(cfg, part: Partition, device=None, mesh=None) -> Runner:
    dev = device_mod.resolve(device)
    W = cfg.num_workers
    (blk, shards, init_nets, streams_for, local_phase, make_gen,
     _) = _family_parts(cfg, part, dev,
                        "raw" if cfg.conv else cfg.resolved_d_head,
                        mesh=mesh)
    n_loc = blk.stop - blk.start
    # the Adam state is this rank's workers'; params and BN are replicated
    layout = {"g.opt": (P(CLIENTS), 1), "d.opt": (P(CLIENTS), 1)}

    def init_state() -> FedState:
        gp, gbn, dp, dbn, gopt, dopt = init_nets()
        return meshes.commit_tree(meshes.place_state(
            FedState(NetState(gp, gbn, gopt), NetState(dp, dbn, dopt),
                     None, 0), mesh, layout), mesh)

    def round_fn(state: FedState, streams=None):
        """One federated round.  ``streams``: optional injected
        ``(starts (E,), z1 (W,E,B,zdim), z2 (W,E,B,zdim)[, alive (W,)])``
        (``alive``: the survival draw, with dropout); with conv each lane's
        dropout keys ``kd1, kd2`` (W, E, 2) threefry key data come at slots
        3 and 4, before ``alive``, and a conv stream without them raises
        ValueError.  By default they are drawn from ``core.prng`` for round
        ``state.t``."""
        starts, z1, z2, keys, mask = streams_for(state.t, streams)
        bcast = lambda tree: collectives.broadcast_tree(tree, n_loc)
        g, d, d_loss, g_loss = local_phase(
            NetState(bcast(state.g.params), bcast(state.g.bn), state.g.opt),
            NetState(bcast(state.d.params), bcast(state.d.bn), state.d.opt),
            shards, starts, z1, z2, keys)
        nets = (g.params, g.bn, d.params, d.bn)
        if mask is None:
            # uniform FedAvg of params and BN buffers (state_dict transfer,
            # FLGAN/MNIST/flgan.py:148-162), and of the lanes' losses: one
            # all-reduce on a mesh
            *nets, dl, gl = collectives.fedavg_tree(
                (*nets, d_loss, g_loss), mesh)
            metrics = {"d_loss": dl, "g_loss": gl}
            gopt, dopt = g.opt, d.opt
        else:
            # dropped workers neither enter the aggregate nor keep their
            # new Adam state
            ones = torch.ones((W,), dtype=torch.float32, device=dev)
            nets = collectives.masked_weighted_avg_tree(nets, ones, mask,
                                                        mesh)
            m_loc = mask if mesh is None else mask[blk]
            keep = lambda old, new: common.AdamState(
                *collectives.select_update_tree(tuple(old), tuple(new),
                                                m_loc))
            gopt, dopt = keep(state.g.opt, g.opt), keep(state.d.opt, d.opt)
            n = mask.sum()
            denom = torch.clamp(n, min=1.0)
            d_sum, g_sum = meshes.all_reduce(
                [(d_loss * m_loc).sum(), (g_loss * m_loc).sum()], mesh)
            metrics = {"d_loss": d_sum / denom, "g_loss": g_sum / denom,
                       "participants": n}
        gp, gbn, dp, dbn = nets
        return FedState(NetState(gp, gbn, gopt), NetState(dp, dbn, dopt),
                        None, state.t + 1), metrics

    gen, sample = make_gen(lambda state: state.g.bn)
    return Runner(cfg, part, init_state, round_fn, sample, gen=gen,
                  device=dev, mesh=mesh, layout=layout)


def build_fegan(cfg, part: Partition, device=None, mesh=None) -> Runner:
    dev = device_mod.resolve(device)
    W = cfg.num_workers
    sk = fegan_scores(part.class_freq, part.class_freq.sum(0))
    schedule = init_groups(W, part.class_freq, cfg.frac_workers,
                           num_rounds=cfg.num_communication,
                           num_class=cfg.num_class)       # (R, gp_size), once
    # group-gather: with partial participation, train ONLY the gp_size
    # sampled members — gather their (shard, opt, BN) state, sweep, scatter
    # back — instead of sweeping all W and masking away (1-frac) of the work;
    # on a mesh each rank the sampled members of its block
    gather_mode = not fused_sweep.eligible(cfg, mesh) and \
        schedule.shape[1] < W
    # fegan.py:224 uses BCELoss with a 2-logit D whose Sigmoid is commented
    # out — shape-incompatible in torch.  As the reference package does, the
    # intended semantics are implemented: sigmoid head + BCE, and on image
    # data the 1-logit mnist D whatever d_head says.  The conv D keeps its
    # raw logit and BCE on logits (``cglgan_tpu/algos/fedavg_family.py:
    # 320-323``).
    d_model = build_discriminator("mnist", 1) \
        if cfg.is_image and not cfg.conv else None
    (blk, shards, init_nets, streams_for, local_phase, make_gen,
     use_kernel) = _family_parts(cfg, part, dev,
                                 "raw" if cfg.conv else "sigmoid", d_model,
                                 mesh)
    n_loc = blk.stop - blk.start
    # the Adam and BN state is this rank's workers'; params are replicated
    layout = {f"{net}.{field}": (P(CLIENTS), 1)
              for net in ("g", "d") for field in ("bn", "opt")}

    # first-occurrence lane mask: init_groups only repeats a member in the
    # degenerate group-smaller-than-gp_size fallback; duplicate lanes must
    # count once in the aggregate and write once in the scatter
    lane_valid = np.ones(schedule.shape, np.float32)
    for j in range(1, schedule.shape[1]):
        dup = (schedule[:, :j] == schedule[:, j:j + 1]).any(axis=1)
        lane_valid[dup, j] = 0.0
    # Every round's lanes, masks and aggregation weights are known from the
    # schedule, so they are made once here and live on the device: a round
    # then copies nothing from the host (a host-to-device copy would make the
    # host wait for the device each round; on a mesh of more than one rank
    # a round copies its sampled lanes' positions).
    rounds = np.arange(len(schedule))[:, None]
    if gather_mode:
        member_np = lane_valid                             # (R, gp_size)
        groups_dev = torch.from_numpy(schedule.astype(np.int64)).to(dev)
    else:
        member_np = np.zeros((len(schedule), W), np.float32)   # (R, W)
        member_np[rounds, schedule] = 1.0
    # w = exp(sk) over the group, normalised (fegan.py:145-146)
    exp_np = np.exp(sk)[schedule] if gather_mode else np.exp(sk)[None, :]
    weight_np = exp_np * member_np
    total_np = weight_np.sum(axis=1, keepdims=True)
    any_alive = total_np[:, 0] > 0
    weight_dev = torch.from_numpy(
        weight_np / np.maximum(total_np, np.float32(1e-12))).to(dev)
    member_dev = torch.from_numpy(member_np).to(dev)
    members = np.maximum(member_np.sum(axis=1), 1.0)       # metric denominators
    exp_dev = torch.from_numpy(exp_np.astype(np.float32)).to(dev)

    def init_state() -> FedState:
        gp, gbn, dp, dbn, gopt, dopt = init_nets()
        # BN buffers persist per worker (fedlab serialization moves
        # parameters only, fegan.py:133-134) — stack them
        stack = lambda tree: tree_map(
            lambda x: x.unsqueeze(0).repeat((W,) + (1,) * x.ndim), tree)
        return meshes.commit_tree(meshes.place_state(
            FedState(NetState(gp, stack(gbn), gopt),
                     NetState(dp, stack(dbn), dopt), None, 0), mesh, layout),
            mesh)

    def round_weights(t: int, drop):
        """Round t's member mask (lanes in gather mode, else workers), its
        normalised aggregation weights, whether any weight is left, and
        the metric denominator: from the schedule, times the survival mask
        ``drop`` (on the device, every worker's) with dropout."""
        if drop is None:
            return (member_dev[t], weight_dev[t], bool(any_alive[t]),
                    float(members[t]))
        m = member_dev[t] * (drop[groups_dev[t]] if gather_mode else drop)
        w = exp_dev[t if gather_mode else 0] * m
        total = w.sum()
        return (m, w / torch.clamp(total, min=1e-12), total > 0,
                torch.clamp(m.sum(), min=1.0))

    def aggregate(lanes, w, alive, old):
        """Score-weighted aggregate over round t's lanes (this rank's, with
        ``w`` their weights); if the weights sum to zero the round is a
        no-op and the old params stay."""
        if alive is False:
            return old
        avg = collectives.weighted_avg_tree(lanes, w, mesh)
        if alive is True:
            return avg
        return tree_map(lambda a, b: torch.where(alive, a, b), avg, old)

    def metrics_of(d_loss, g_loss, m, denom):
        """The losses' means over the round's members (``m`` this rank's
        lanes' member mask)."""
        d_sum, g_sum = meshes.all_reduce([(d_loss * m).sum(),
                                          (g_loss * m).sum()], mesh)
        return {"d_loss": d_sum / denom, "g_loss": g_sum / denom}

    def sampled(t: int):
        """Round t's sampled lanes on this rank: (the workers as indices
        into its block, on the host and on the device; their positions in
        the group, on the host, or None where every lane is this rank's)."""
        if mesh is None:
            return schedule[t], groups_dev[t], None
        group = schedule[t]
        pos = np.flatnonzero((group >= blk.start) & (group < blk.stop))
        lanes = group[pos] - blk.start
        return lanes, torch.from_numpy(lanes).to(dev), pos

    def round_fn(state: FedState, streams=None):
        """One federated round; ``streams`` as for FL-GAN, for all W
        workers also in gather mode (the sampled lanes take ``z[group]``
        and, with conv, ``kd1[group], kd2[group]``)."""
        t = state.t
        starts, z1, z2, keys, drop = streams_for(t, streams)
        m, w, alive, denom = round_weights(t, drop)
        params = (state.g.params, state.d.params)

        if gather_mode:
            # ---- train only the sampled lanes -------------------------
            lanes, idx, pos = sampled(t)
            valid = lane_valid[t]
            if pos is not None:
                pos_dev = torch.from_numpy(pos).to(dev)
                m, w, valid = m[pos_dev], w[pos_dev], valid[pos]
            n = idx.shape[0]
            take = lambda tree: tree_map(lambda x: x[idx], tree)
            bcast = lambda tree: collectives.broadcast_tree(tree, n)
            g, d, d_loss, g_loss = local_phase(
                NetState(bcast(state.g.params), take(state.g.bn),
                         common.AdamState(*take(tuple(state.g.opt)))),
                NetState(bcast(state.d.params), take(state.d.bn),
                         common.AdamState(*take(tuple(state.d.opt)))),
                shards[idx], starts, z1[idx], z2[idx],
                None if keys is None else tuple(k[idx] for k in keys),
                lanes=lanes, lanes_dev=idx)
            # scatter local state back; duplicate lanes (lane_valid == 0,
            # the degenerate schedule only) are dropped, so each worker is
            # written once; with dropout a dropped lane writes its old state
            if valid.all():
                src, dst = None, idx
            else:
                src = torch.from_numpy(np.flatnonzero(valid)).to(dev)
                dst = idx[src]
            live = None if drop is None else \
                (m if src is None else m[src]) > 0

            def scatter(old_full, new_lanes):
                def put(full, lane):
                    out = full.clone()
                    new = lane if src is None else lane[src]
                    if live is not None:
                        new = torch.where(live.reshape(
                            (-1,) + (1,) * (new.ndim - 1)), new, full[dst])
                    out[dst] = new
                    return out
                return tree_map(put, old_full, new_lanes)

            opt_of = lambda old, new: common.AdamState(
                *scatter(tuple(old), tuple(new)))
            gp, dp = aggregate((g.params, d.params), w, alive, params)
            new_g = NetState(gp, scatter(state.g.bn, g.bn),
                             opt_of(state.g.opt, g.opt))
            new_d = NetState(dp, scatter(state.d.bn, d.bn),
                             opt_of(state.d.opt, d.opt))
            return (FedState(new_g, new_d, None, t + 1),
                    metrics_of(d_loss, g_loss, m, denom))

        # ---- full-width path (kernel / full participation) ------------
        if mesh is not None:
            m, w = m[blk], w[blk]
        bcast = lambda tree: collectives.broadcast_tree(tree, n_loc)
        g, d, d_loss, g_loss = local_phase(
            NetState(bcast(state.g.params), state.g.bn, state.g.opt),
            NetState(bcast(state.d.params), state.d.bn, state.d.opt),
            shards, starts, z1, z2, keys)
        # local state (opt, BN) advances only for sampled workers —
        # unsampled workers stay blocked on their queue in the reference
        sel = lambda old, new: collectives.select_update_tree(old, new, m)
        opt_of = lambda old, new: common.AdamState(
            *sel(tuple(old), tuple(new)))
        gp, dp = aggregate((g.params, d.params), w, alive, params)
        new_g = NetState(gp, sel(state.g.bn, g.bn),
                         opt_of(state.g.opt, g.opt))
        new_d = NetState(dp, sel(state.d.bn, d.bn),
                         opt_of(state.d.opt, d.opt))
        return (FedState(new_g, new_d, None, t + 1),
                metrics_of(d_loss, g_loss, m, denom))

    # the server evaluates with a net whose BN buffers were never trained
    # (deserialize moves params only, fegan.py:169): the fixed init BN, in
    # float32 whatever the run's dtype, as the reference makes it
    # (``g_model.init(key)``, ``cglgan_tpu/algos/fedavg_family.py:504``)
    g_model, _ = models_for_config(cfg)
    _, eval_bn = g_model.init(
        prng.role_key(cfg.seed, prng.ROLE_INIT_G, dev).unsqueeze(0))
    eval_bn = tree_map(lambda x: x[0], eval_bn)
    gen, sample = make_gen(lambda state: eval_bn)
    return Runner(cfg, part, init_state, round_fn, sample, gen=gen,
                  device=dev, extras={"sk": sk, "schedule": schedule},
                  mesh=mesh, layout=layout)

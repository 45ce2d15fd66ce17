#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``cglgan_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line:
  device    the card (nvidia-smi name and power limit) and the kernel build
            (one ``nvcc`` per source, all started together);
  kernel    every ported kernel against its plain PyTorch version on the
            card at its path's shapes, with the times of the kernel, the
            plain version, the autograd path or library call, and the bound:
            ``fused_dstep`` (16 clients, E=5, B=100, 784-512-256-{2,1}, both
            heads, diverging per-client Adam counts, with the host's time to
            enqueue a call beside the device's time to run it; the CGL
            path's shapes with distinct fakes a client: CGL-GAN (W=20,
            784-512-256-1, sigmoid, x1), Mix-G (W=20, ...-2, x0.5) and 2DMG
            CGL-GAN (W=10, float rows, 2-128-256-1); AC-GAN's (W=10, a
            server's fake batch to each of its k=2 clients, 784-512-256-2,
            2-logit CE at x1); then small ragged
            shapes, W=3, E=3, B=37, 50-24-40 and W=2, E=2, B=19, 33-27-30
            (u8, shared fakes) and W=3, E=3, B=37, 2-24-40 and the second
            again (float rows, per-client fakes), for errors only, so that
            partial tiles in M, N and K and the unaligned paths run on the
            card); ``fused_sweep`` (16
            workers, E=5, B=100, G 100-256-128-2 and 100-32-2, D 2-128-256-1,
            diverging per-worker G and D counts; the kernels one call puts
            on the card, which must be 1; its cluster size and
            ``cudaOccupancyMaxActiveClusters``; then W=3, E=1, B=37 / W=20,
            E=3, B=19 / W=2, E=32, B=16 with both G shapes, for errors
            only); ``fused_adam`` (the
            16-client discriminator stack as one list call, float32 /
            bfloat16 / stochastic bfloat16 moments; a list longer than one
            launch takes, with an empty leaf and sizes no multiple of 4, held
            bit-equal; then three steps through ``init``/``step``);
            ``fused_dstep`` with bf16 state (phase ``dstep_bf16``): the
            main shape (shared bf16 fakes), the CGL-GAN shape (W=20,
            784-512-256-1, a bf16 fake batch a client) and W=3, E=3, B=37,
            2-24-40 (float rows), held to the plain version with the state
            returned in bf16, timed beside the bf16 autograd D phase;
  threefry  the threefry kernel against its plain version on the card, every
            mode (split, fold_in over a key and over a range, 32-, 16- and
            8-bit bits, uniform float32 / bfloat16, Bernoulli parts,
            randint, the window starts, permutation) bit for bit, normals
            float32 / bfloat16 within 3 ulps with the count that differ,
            at the MNIST FedAvg sweep's z1 / z2 (W, steps, B, zdim), the
            largest draw a phase makes; its time beside the plain
            version's, ``torch.randn``'s at the same size and the bound;
  reference a shrunk CAP-GAN, CGL-GAN (multipath and iid=0), Mix-G, 2DMG
            CGL-GAN, MD-GAN (shuffle D-swap), AC-GAN (delta gossip; and
            dropout, autograd), FL-GAN and FeGAN on the card (kernel path)
            against the same rounds on the CPU (plain path) from one init
            and one stream (the CGL and MD-GAN families held on the inputs
            their limits were measured on, the same rounds from the seed
            reported beside); then CAP-GAN from its seed with no stream
            injected: the card's init equal to the CPU's, one round each;
  main      16-client CAP-GAN on MNIST shapes at epoch=5 (the kernel path),
            20 rounds through ``build_runner`` and ``train`` (replays of
            the runner's captured round, as in ``cgl``, ``bf16``, ``cli``,
            ``serve`` and ``eval_image``; the profile after them is of
            eager ``round_fn`` rounds); the kernel's launch count must rise
            by exactly 20 (once a replay) and every metric be finite;
  autograd  the same configuration at epoch=1 (the autograd D path);
  draws     the CAP-GAN main path at epoch=5 and the FL-GAN 2DMG kernel
            path, 20 rounds drawing their own streams against the same
            rounds fed the same streams drawn beforehand, in turns: both
            rounds/s, the launches a round the draws add (the CAP-GAN
            path: at most 10), the end states held to each other;
  graph     the CGL family's MLP runners through ``train`` as replays of
            one captured round (``algos/runner.py`` ``RoundProgram``), at
            full width, each case from one state: the main config at e=1
            and e=5, e=5 in bf16 with ``pallas_dstep=True``, CGL-GAN and
            Mix-G on ``CGL_MNIST`` at e=5, the main config at e=5 with
            E=2, and at e=1 with a cloud-sync period that fires at round
            10 only; 20 replays (a tick a round) against 20 eager
            ``round_fn`` rounds, every state tensor and metric under
            ``torch.equal``; ``fused_dstep`` launches once a replay,
            ``threefry``'s a replay as captured plus the tables' fills;
            every piece's replays under ``set_sync_debug_mode("error")``;
            one capture across every ``train`` call of the runner;
            rounds/s eager and graph in turns (eager, graph, graph,
            eager), the host's launch calls, device ms a round and the
            busy share of each, capture seconds and the graph pool's
            memory;
  eval_image
            the proxy image evaluator (FID / Inception Score) on the main
            path's config: threefry draws and the random-conv extractor's
            weights card against CPU (equal); the probe's 300 Adam steps on
            the card (seconds); a tick part by part (sample, features,
            stats, sqrtm, IS, ms); features, mu / cov, FID and IS card
            against CPU with the card's probe carried over; the card's
            probe against one trained on the CPU; ``make_evaluator`` against
            those parts; FID and IS with cuDNN TF32 on; then 4 rounds of
            ``train`` with its default evaluator (``fused_dstep``'s count,
            set to 0 just before, must rise by 4; every tick a finite FID
            and IS);
  fedavg    16-worker FL-GAN and FeGAN (frac_workers=0.5) on 2DMG at
            epoch=5 through ``load_partition``, ``build_runner`` and
            ``train``, 20 rounds each with ``pallas_sweep=True`` (the sweep
            kernel's launch count must rise by exactly 20, and the profile
            must show it once a round) and with the default (autograd; the
            count must stay 0); KL and Distribution Score of 10 000 samples
            are printed, not gated;
  fedavg_image
            FL-GAN and FeGAN on MNIST shapes: the shrunk setup of
            ``tests/test_torch_port_fedavg_image.py`` (800 images, 4
            workers, B=32) card against CPU for 3 rounds (FL-GAN iid=1 with
            ragged step counts, FeGAN frac 0.5 in gather mode and frac 1.0
            at full width, FL-GAN's "batches" sweep, FL-GAN with dropout
            0.5, FL-GAN in bf16); then the archived
            ``mnist-ref-iid1-flgan`` (epoch=1, 3 timed rounds),
            ``-flgan-e5`` (1 timed round) and ``mnist-ref-iid1-fegan``
            (frac 0.2, 3 timed rounds) on synthetic-mnist after a warm-up
            round (none at epoch=5), through ``build_runner`` and ``train``,
            with the step plan (the reference's step-count buckets
            beside it), rounds/s, launches a round and a step and the busy
            share from a 1-round profile at epoch=1, and peak memory (no
            kernel may launch: the reference's fused sweep is 2DMG-only);
            FeGAN's profile sums are held to ``key_averages()``;
  cgl       CGL-GAN and Mix-G at 20 workers / 5 servers on MNIST shapes
            (iid=1, B=100, cloud sync every round, segema 0) and CGL-GAN at
            10 workers / 5 servers on 2DMG (iid=2): 20 rounds each at
            epoch=5 (``fused_dstep``'s count must rise by exactly 20), and
            CGL-GAN on MNIST shapes at epoch=1 too (the count must stay 0);
  mdgan     MD-GAN (10 workers, 1 server) and AC-GAN (10 workers / 5
            servers, 2-logit D) on MNIST shapes at epoch=5 (the kernel
            path) and epoch=1, MD-GAN (10 workers, iid=2) and AC-GAN (20 /
            5, 10 000 samples a class) on 2DMG at epoch=5, and at epoch=1
            with E=2 the ring and shuffle D-swaps, the mean and delta
            gossips and AC-GAN with dropout_rate=0.2: 20 rounds each (the
            count must rise by exactly 20 where the kernel is engaged, and
            stay 0 elsewhere); the 2DMG runs print the evaluator's KL,
            Distribution Score and mode coverage;
  conv      the conv LSGAN family (32x32, 28x28 images zero-padded): the
            archived conv flagship ``mnist-iid1-cglgan-conv`` (CGL-GAN,
            multipath conv G, 16 workers / 4 servers, B=100, iid=1, cloud
            sync every round) card against CPU for 2 rounds at B=25 from
            one init and one stream (dropout keys included), then at
            epoch=1 and
            epoch=5, and CAP-GAN conv (16 workers, 1 server) at epoch=5,
            2 warm-up and 10 timed rounds each (``fused_dstep`` refuses a
            conv D, as the reference's: its count must stay 0);
  conv_baselines
            the conv pair on the MD-GAN and FedAvg families: MD-GAN conv
            (the archived ``mnist-iid1-mdgan-conv``, 16 workers, B=100)
            card against CPU for 2 rounds at B=25, FL-GAN and FeGAN (gather
            mode) conv on the shrunk image setup card against CPU for 2
            rounds; then MD-GAN conv at epoch 1 and 5 and with the ring
            D-swap (E=2), AC-GAN conv (16 workers / 4 servers) with the
            delta gossip (E=2), 2 warm-up and 10 timed rounds each, and
            ``mnist-iid1-flgan`` / ``-fegan`` with conv (16 workers, the
            ragged sweep) 1 profiled round, as the warm-up, and 1 timed
            round each, with the step
            plan beside the reference's buckets; every run prints rounds/s,
            device ms and launches a round from the profile and peak
            memory, and ``fused_dstep`` and ``fused_sweep`` must not
            launch;
  conv_bf16 the conv pair in bfloat16: the conv flagship and MD-GAN conv
            card against CPU for 2 rounds at B=25, FL-GAN and FeGAN (gather
            mode) conv on the shrunk image setup card against CPU for 2
            rounds, and what cuBLAS's bf16 reduced-precision reduction
            (off in ``build_runner``) would move; then the flagship at
            epoch=1 in float32 and in bf16 in this one call, CAP-GAN conv
            at epoch=5, MD-GAN conv at epoch=1, AC-GAN conv with the delta
            gossip (E=2), 2 warm-up and 10 timed rounds each, and FL-GAN
            conv (16 workers) 1 profiled and 1 timed round, in bf16, each
            with rounds/s, device ms and launches a round, peak memory and
            the top kernel; ``fused_dstep`` and ``fused_sweep`` must not
            launch;
  inception InceptionV3 pool3 with ``inception_init``'s random weights
            written to an ``.npz`` and loaded back: pool3 ms for 100 images
            at 299^2, ``preprocess`` ms, the host's ``sqrtm`` at 2048-d,
            features and FID card against CPU, what cuDNN TF32 moves, a
            ``fid_stats`` round trip at 32 px, and 4 rounds of conv
            CGL-GAN ``train`` with ``make_evaluator(inception_weights=...,
            fid_stats=...)`` at one tick;
  bf16      ``dtype="bfloat16"``: shrunk CAP-GAN (forced kernel and
            autograd), CGL-GAN (forced kernel) and FL-GAN on 2DMG, card
            against CPU at a bf16 tolerance; then the CAP-GAN main path at
            epoch=5 with ``pallas_dstep=True`` (the count must rise by
            20), epoch=5 auto and epoch=1 (autograd: it must stay 0),
            CGL-GAN (20 workers / 5 servers) and MD-GAN (10 workers) at
            epoch=5 forced and FL-GAN on 2DMG (``force_dtype``, default
            path), 20 rounds each;
  cli       the CLI, ``cglgan_tpu_torch.cli.main`` called in process:
            ``run capgan`` on the main config at epoch=5 (``fused_dstep``)
            and ``run flgan --dataset 2dmg --pallas-sweep on`` (16 workers,
            ``fused_sweep``), 40 rounds, a tick and a checkpoint every 20,
            then each resumed from its ``ckpt_20`` to round 40 in a second
            run dir (the kernel's count, set to 0 just before each run,
            must rise by 40 and by 20; both ``ckpt_final`` restored on the
            card and held bit for bit, every leaf, with the params' and
            moments' largest difference against each group's scale
            reported; the tick's rounds/s, checkpoint MB and save and
            restore seconds); ``eval`` of the CAP-GAN ``ckpt_final``,
            ``compare`` of the four run dirs and ``doctor`` (exit 0, naming
            the card);
  serve     serving and migration on the main config: a reference-layout
            ``mnist-mlp`` G (``nn.Sequential`` under ``model``, seeded, its
            BN statistics moved) ``torch.save``d; ``warm_start_generators``
            onto the card's init (G equal to the file bit for bit, Linear
            weights transposed; D and the optimiser state untouched); ``run
            capgan ... --epoch 5 --rounds 20 --init-from-torch`` through the
            CLI (``fused_dstep``'s count, set to 0 just before, must reach
            20); ``export`` of its ``ckpt_final`` at ``--n 100`` and ``--n
            0``, served at n = 1, 100 and 10 000 against ``runner.gen`` on
            the restored state (bit-equal, or the phase fails; the largest
            difference reported); samples/s of the program against eager
            ``gen`` at n = 100 and 10 000, in turns; a consumer process that
            imports torch only serves the program on the card; and
            ``import-torch`` of the ``.pt`` with ``--samples`` and
            ``--export``, its program bit-equal to the imported model's
            eager forward; ``plot`` of the run dir (without matplotlib it must
            exit naming it);
  mesh      the clients mesh (``core/meshes.py``) over NCCL, one spawned
            process a card, at world = the largest power of two of the
            cards, at most 4 (printed first): the main config at epoch 1
            (2 warm-up and 10 timed rounds), FL-GAN on 2DMG (16 workers)
            and MD-GAN with the ring D-swap every round on MNIST shapes
            (10 workers, 12 on 4 ranks, which must divide them),
            each on the mesh and unsharded on rank 0's card, in turns in
            the ranks' processes, beside ``utils/dryrun.py``'s configs
            on the same ranks; at
            world 1 every mesh run must be the unsharded one bit for bit
            (state and metrics), at world >= 2 the dryrun's within the
            CPU tests' limits, the others within the card-against-CPU
            ones; rounds/s of both, the collectives a round by kind and
            bytes, threefry launches a round; then ``run capgan --devices
            <world>`` through the CLI, its ``ckpt_final`` held the same way
            to the unsharded run of its ``config.json``;
  tp        tensor parallelism over a ``model`` axis (``models/tp.py``) on
            ranks that share the card (``meshes.spawn(...,
            share_cards=True)``: gloo, collectives through host memory),
            after the card's compute mode: on ``(1, 2)`` the main config
            at epoch 1, its G 100-128-256-512-1024-784 split over 2 (2
            warm-up and 10 timed rounds), and CAP-GAN conv float32 (5);
            on ``(2, 2)`` the main config again, CGL-GAN on MNIST shapes
            (20 workers / 5 servers, a multipath G, 5 rounds) and the
            dryrun's "capgan dp x tp"; on ``(1, 3)`` CAP-GAN conv and Mix-G
            conv (1 warm-up and 5 rounds), whose conv weights the rule
            splits on kW; each in turns against the unsharded run on rank
            0's card (unsharded, tp, tp, unsharded), held within the world
            >= 2 limits of ``mesh``, and on ``(1, 3)`` bit for bit with
            the collectives over ``model`` the predicted ones; rounds/s of
            both, the collectives a round by kind, axis and bytes,
            threefry launches a round; with 4 cards also the main config
            over NCCL, one rank a card, on ``(2, 2)`` and ``(1, 4)``, and
            CAP-GAN conv on ``(1, 3)``, three of the cards.
The round phases also profile a few further rounds (device time by kernel,
busy share; ``cglgan_tpu_torch/utils/profiling.py``).
Each phase prints ``{"starting": name}`` before it runs.  Then the card
line, the ``kernels`` line and, last, the ok line.  Any failure raises and
exits non-zero; without a card it exits 2 and prints no result.
``--phases a,b`` runs only the named phases (of ``dstep dstep_bf16 sweep
adam threefry reference main draws graph eval_image fedavg fedavg_image cgl
mdgan bf16 conv conv_baselines conv_bf16 inception cli serve mesh tp``)
for a short first look at a new kernel; the
``kernels`` and ok lines are printed only by a full run.  Imports nothing
of JAX.
"""
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# the main path's kernel shapes
W, E, B, DIN, H1, H2 = 16, 5, 100, 784, 512, 256
ROUNDS = 20
PROFILE_ROUNDS = 5
# the FedAvg-family path's kernel shapes: G widths by algorithm, D widths
G_DIMS = {"flgan": (100, 256, 128, 2), "fegan": (100, 32, 2)}
D_DIMS = (2, 128, 256, 1)
FEDAVG = dict(dataset="2dmg", num_workers=16, num_class=8, num_sample=1000,
              batch_size=100, iid=1, epoch=5)
# Kernel vs plain on the card, both at float32 accuracy, same inputs.  Sums
# run in another order (3xTF32 tensor-core tiles, summed slab by slab, vs
# cuBLAS).  When the order flips the sign of a pre-activation within ~1e-6 of
# 0 (8.2M of them per call), LeakyReLU's slope jumps 1 <-> 0.2 and that
# row's term of the weight gradient changes; Adam carries it over the E=5
# steps.  Measured on an NVIDIA H100 80GB HBM3 at 700 W: mu within 2.0e-6
# (logits2, no slope flipped) and 7.8e-3 (sigmoid) of its scale, losses
# 1.7e-7; with the earlier SIMT kernel 7.8e-4 and 5.3e-3.
# So each of the 18 state tensors must satisfy max|kernel - plain| <=
# 1e-2 * max|plain|, and the losses 1e-5 relative; a wrong index or a
# missing term gives O(1).
TOL_SCALED = 1e-2
TOL_LOSS = 1e-5
# fused_sweep is held to the same two limits for the same reason: 15M
# pre-activations per call pass a LeakyReLU, and the G step differentiates
# through the D that the D step has just updated, so one flipped slope moves
# both nets by ~1e-3 of a tensor's scale.  On these seeded inputs no slope
# flipped: measured on an H100, every state tensor within 1.4e-6 of its
# scale and both losses within 1.7e-7 relative.
#
# fused_adam is elementwise, with no sum to reorder: kernel and plain
# version do the same float32 operations in the same order (the kernel's _rn
# intrinsics forbid FMA contraction), so params and float32 moments must
# agree to 1e-6 of each tensor's largest entry.  bfloat16 moments are one
# rounding of those float32 values: they may differ from the plain version's
# by one bfloat16 step where the float32 values differ in the last place
# across a rounding boundary, on at most 1e-4 of the elements.
TOL_ADAM = 1e-6
TOL_BF16_SHARE = 1e-4
# bf16 rounds on the card against the same rounds on the CPU (--dtype
# bfloat16): every op rounds to bf16 on both sides, but the card's cuBLAS
# and kernels and the CPU's matmuls sum in other orders, and where a float32
# sum moves by its last place across a bf16 rounding boundary the bf16
# value (an activation, a product operand) lands one step (2^-8) the other
# way; the gradients, and most of all the moments, follow.  One call of the
# bf16-state kernel shows the size (its plain version in float32 against
# float64, printed by the dstep_bf16 phase: moments up to ~5e-2 of their
# scale, params one bf16 step); five rounds carry it on.  So params are
# held to 2^-5 of the group's largest entry (8 bf16 steps there), the Adam
# moments to 0.2, the metrics (losses ~0.7) to 1e-2 absolute; a wrong route
# or a missing term moves them by O(1).
TOL_BF16_SCALED = {"params": 2.0 ** -5, "mu": 0.2, "nu": 0.2}
TOL_BF16_METRICS = 1e-2
# fused_dstep with bf16 state against its plain version: both do the same
# float32 math on bf16-rounded product operands and round the state once,
# but where float32's sum order moves an activation by its last place
# across a bf16 rounding boundary, that operand rounds one bf16 step the
# other way and the step's gradients follow.  The plain version against
# itself in float64 (``work_dtype``) shows the size, and each call below
# prints it beside the kernel's error (on an H100: moments 4.5e-2 / 4.9e-2
# of their scale at the main / CGL-GAN shape, params 3.9e-3 / 5.1e-3,
# losses 3.6e-6 / 4.0e-6 relative).  So bf16 state is held to 0.1 of each
# tensor's largest entry and losses to 2e-4 relative; a wrong fragment
# layout, index or term gives O(1).
TOL_BF16_KERNEL = 0.1
TOL_BF16_LOSS = 2e-4


def emit(obj):
    print(json.dumps(obj), flush=True)


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def peaks(name):
    """(non-tensor f32 FLOP/s, HBM bytes/s, dense TF32 tensor FLOP/s) of the
    card, from NVIDIA's data sheets (SXM part unless the name says
    otherwise)."""
    if "H100" in name and "PCIe" in name:
        return 51.2e12, 2.0e12, 378e12
    if "H100" in name and "NVL" in name:
        return 60e12, 3.9e12, 417.5e12
    if "H200" in name:
        return 67e12, 4.8e12, 495e12
    return 67e12, 3.35e12, 495e12                # H100 SXM


def bf16_peak(name):
    """Dense bf16 tensor-core FLOP/s of the card (NVIDIA's data sheets, SXM
    part unless the name says otherwise)."""
    if "H100" in name and "PCIe" in name:
        return 756e12
    if "H100" in name and "NVL" in name:
        return 835e12
    return 989e12                                # H100 / H200 SXM


def cuda_ms(fn, reps):
    import torch
    fn()                                       # warm-up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def enqueue_ms(fn, reps):
    """Host time to enqueue one call: the host's clock around the call, with
    no synchronise inside it and an empty stream before it; mean of ``reps``."""
    import torch
    fn()
    total = 0.0
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        total += time.perf_counter() - t0
    torch.cuda.synchronize()
    return total / reps * 1e3


def device_ms(fn, reps):
    """Device time of one call, whatever the host's speed: the sum of the
    device time of every kernel and copy that ``reps`` calls put on the card
    (``torch.profiler``), over ``reps``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(ev.self_device_time_total for ev in prof.key_averages()
             if ev.device_type == torch.autograd.DeviceType.CUDA)
    if not us > 0:
        raise AssertionError("the profiler saw no device time")
    return us / reps / 1e3


def dstep_work(W, E, B, din, h1, h2, dout, row_bytes=1, fake_sets=1,
               state_bytes=4, fake_bytes=4):
    """(FLOP, bytes) one fused_d_epoch_steps call must do: forward, weight
    and input grads (the first layer's input grad is not needed) for every
    client-step; each input read once and each output written once.
    ``row_bytes``: 1 for u8 images, 4 for float rows; ``fake_sets``: 1 for
    a shared fake batch, W for per-client fakes; ``state_bytes`` and
    ``fake_bytes``: 4 for float32, 2 for bf16."""
    R = 2 * B
    fwd = 2 * R * (din * h1 + h1 * h2 + h2 * dout)
    bwd = fwd + 2 * R * (h2 * dout + h1 * h2)
    flops = W * E * (fwd + bwd)
    n_state = din * h1 + h1 + h1 * h2 + h2 + h2 * dout + dout
    state = 3 * W * n_state * state_bytes
    bytes_ = 2 * state + E * W * B * din * row_bytes \
        + fake_sets * B * din * fake_bytes + W * E * 2 * 4 + W * 4 + W * 8
    return flops, bytes_


def scaled_errs(got, ref, tol):
    """Max abs error and max of max|got - ref| / max|ref| over two tensor
    lists."""
    abs_err = max(float((x.float() - y.float()).abs().max())
                  for x, y in zip(got, ref))
    scaled = max(float((x.float() - y.float()).abs().max()
                       / y.float().abs().max().clamp_min(1e-30))
                 for x, y in zip(got, ref))
    return {"max_abs_err": abs_err, "max_scaled_err": scaled,
            "tol_scaled": tol, "ok": scaled <= tol}


def compare(got, ref, tol=TOL_SCALED, tol_loss=TOL_LOSS):
    """fused_dstep results per group (params, mu, nu, loss) against the
    plain version's, each with its tolerance; the state must come back in
    the plain version's dtype (bf16 state stays bf16), the losses
    float32."""
    import torch
    if not torch.equal(got[3].cpu(), ref[3].cpu()):
        raise AssertionError("Adam counts differ")
    for i in range(3):
        if any(x.dtype != y.dtype for x, y in zip(got[i], ref[i])):
            raise AssertionError(f"fused_dstep returned state group {i} in "
                                 f"{[str(x.dtype) for x in got[i]]}")
    if got[4].dtype != torch.float32:
        raise AssertionError(f"fused_dstep losses in {got[4].dtype}")
    out = {g: scaled_errs(got[i], ref[i], tol)
           for i, g in enumerate(("params", "mu", "nu"))}
    out["loss"] = scaled_errs([got[4]], [ref[4]], tol_loss)
    return out


def dstep_inputs(gen, W, E, B, din, h1, h2, dout, six=None, max_len=1000,
                 float_rows=False, per_client=False, servers=None):
    """Seeded inputs of one fused_d_epoch_steps call on the card: state
    (``six`` or random weights at 1/sqrt(fan-in)), nonzero moments, Adam
    counts that differ between clients, shards (u8 images, or float32 2DMG
    points: ring modes plus noise), window starts, fakes (shared (B, din),
    or per client (W, B, din): a batch a client, or with ``servers`` a
    batch a server, routed to each of its W / servers clients)."""
    import torch
    dev = torch.device("cuda")
    if six is None:
        dims = (din, h1, h2, dout)
        six = [x for a, b in zip(dims[:-1], dims[1:])
               for x in (torch.randn((W, a, b), generator=gen) / a ** 0.5,
                         torch.randn((W, b), generator=gen) * 0.1)]
    six = [x.to(dev) for x in six]
    mu6 = [(torch.randn(x.shape, generator=gen) * 1e-3).to(dev) for x in six]
    nu6 = [(torch.randn(x.shape, generator=gen).abs() * 1e-6).to(dev)
           for x in six]
    count = (torch.arange(W, dtype=torch.int64) * 3).to(dev)     # diverge
    if float_rows and din == 2:
        from cglgan_tpu_torch.data.gmm import gmm_modes
        modes = torch.from_numpy(gmm_modes(10)).float()
        lab = torch.randint(0, 10, (W, max_len), generator=gen)
        shards = (modes[lab] + 0.01 * torch.randn((W, max_len, 2),
                                                  generator=gen)).to(dev)
    elif float_rows:
        shards = (torch.rand((W, max_len, din), generator=gen) * 2 - 1
                  ).to(dev)
    else:
        shards = torch.randint(0, 256, (W, max_len, din), generator=gen,
                               dtype=torch.uint8).to(dev)
    # int32 on the card, as a round's table row hands them to the kernel
    starts = torch.randint(0, max_len - B + 1, (E,), generator=gen).to(
        device=dev, dtype=torch.int32)
    if servers:
        fake = torch.tanh(torch.randn((servers, 1, B, din), generator=gen))
        fake = fake.expand(servers, W // servers, B, din).reshape(W, B, din)
    else:
        fake_shape = (W, B, din) if per_client else (B, din)
        fake = torch.tanh(torch.randn(fake_shape, generator=gen))
    return six, mu6, nu6, count, shards, starts, fake.contiguous().to(dev)


def seeded_init(model, gen, n):
    """A kernel phase's test weights for ``n`` members of an MLP ``model``
    (spec list): each linear layer's weight then bias U(-1/sqrt(din),
    1/sqrt(din)) from the torch generator ``gen``, BatchNorm at its init;
    the inputs the kernel phases' limits were measured on (the seeds that
    flip no LeakyReLU slope)."""
    import math
    import torch
    from cglgan_tpu_torch.models import nn
    params, state = [], []
    for entry in model.spec:
        if entry[0] == "linear":
            bound = 1.0 / math.sqrt(entry[1])
            u = lambda shape: (torch.rand(shape, generator=gen) * 2.0
                               - 1.0) * bound
            params.append({"w": u((n, entry[1], entry[2])),
                           "b": u((n, entry[2]))})
            state.append(None)
        elif entry[0] == "bn":
            p, s = nn.bn_init(n, entry[1])
            params.append(p)
            state.append(s)
        else:
            params.append(None)
            state.append(None)
    return params, state


def dstep_call(args, kw):
    """The wrapper on ``args``: uint8 shards are images, float32 rows are
    used as they are."""
    from cglgan_tpu_torch.ops import fused_dstep
    return fused_dstep.fused_d_epoch_steps(
        *args, is_image=not args[4].is_floating_point(), **kw)


def dstep_check(args, kw, f64=False, **tols):
    """One kernel call against the plain version on the same inputs, which
    the call must leave as they were.  ``f64``: also against the plain
    version in float64, and a group passes within its tolerance of either
    (each group's ``vs_plain_f64``; ``plain_f32_vs_f64`` says how far
    float32 rounding alone moves the plain version)."""
    import torch
    from cglgan_tpu_torch.ops import fused_dstep
    state = [t for ts in args[:3] for t in ts]
    before = [t.clone() for t in state]
    got = dstep_call(args, kw)
    torch.cuda.synchronize()
    if not all(torch.equal(x, y) for x, y in zip(before, state)):
        raise AssertionError("fused_dstep modified its inputs")
    ref = fused_dstep.fused_d_epoch_steps_plain(*args, **kw)
    errs = compare(got, ref, **tols)
    if f64:
        ref64 = dstep_plain64(args, kw)
        errs64 = compare(got, ref64, **tols)
        plain64 = compare(ref, ref64, **tols)
        for g, e in errs.items():
            e["vs_plain_f64"] = errs64[g]
            e["plain_f32_vs_f64"] = plain64[g]["max_scaled_err"]
            e["ok"] = e["ok"] or errs64[g]["ok"]
    return errs


# no size a multiple of a tile or of 8; the first has rows of the first
# layer's input that are not 16-byte aligned, the second also widths that are
# no multiple of 4 (h2) or of 2 (h1): the kernel's scalar paths
RAGGED = (dict(W=3, E=3, B=37, din=50, h1=24, h2=40),
          dict(W=2, E=2, B=19, din=33, h1=27, h2=30))
# the same with float rows and per-client fakes; the first at 2DMG's din=2
RAGGED_ROWS = (dict(W=3, E=3, B=37, din=2, h1=24, h2=40),
               dict(W=2, E=2, B=19, din=33, h1=27, h2=30))
# the CGL path's kernel shapes: (label, W, din, h1, h2, out, head, x0.5,
# float rows): CGL-GAN and Mix-G at 20 workers on MNIST shapes, CGL-GAN at
# 10 workers on 2DMG; every one with distinct fakes a client (a multipath
# G's head i feeds client i)
CGL_SHAPES = (("cglgan", 20, DIN, H1, H2, 1, "sigmoid", False, False),
              ("mixgan", 20, DIN, H1, H2, 2, "logits2", True, False),
              ("cglgan-2dmg", 10, 2, 128, 256, 1, "sigmoid", False, True))


# the MD-GAN family's new kernel shape: AC-GAN on MNIST shapes (label, W,
# servers, din, h1, h2, out, head, x0.5): a server's batch to each of its
# k=2 clients, the 2-logit CE head at x1
MDGAN_SHAPES = (("acgan", 10, 5, DIN, H1, H2, 2, "logits2", False),)


def dstep_plain64(args, kw):
    """The plain version of fused_dstep run in float64 on ``args`` (float32
    state), its state and losses rounded to float32 once at the end."""
    from cglgan_tpu_torch.ops import fused_dstep
    wide = lambda ts: [t.double() for t in ts]
    r64 = fused_dstep.fused_d_epoch_steps_plain(
        *map(wide, args[:3]), *args[3:6], args[6].double(), **kw)
    narrow = lambda ts: [t.float() for t in ts]
    return (*map(narrow, r64[:3]), r64[3], r64[4].float())


def dstep_shape(card_name, label, gen, d_model, W, din, h1, h2, dout, head,
                half, float_rows=False, per_client=False, servers=None,
                f64=False):
    """fused_dstep at one full shape: errors against the plain version
    (``f64``: as ``dstep_check``), the kernel's time (call, host enqueue,
    device), the plain version's and the autograd D phase's, and the bound;
    raises if they disagree."""
    from cglgan_tpu_torch.algos import common
    from cglgan_tpu_torch.ops import fused_dstep

    params, bn = seeded_init(d_model, gen, W)
    args = dstep_inputs(gen, W, E, B, din, h1, h2, dout,
                        six=[x for p in params if p is not None
                             for x in (p["w"], p["b"])],
                        float_rows=float_rows, per_client=per_client,
                        servers=servers)
    six, mu6, nu6, count, shards, starts, fake = args
    kw = dict(head=head, d_loss_half=half, lr=2e-4, b1=0.5, b2=0.999)
    errs = dstep_check(args, kw, f64)

    # timings on the same inputs
    call = lambda: dstep_call(args, kw)
    kernel_ms = cuda_ms(call, 20)
    enq_ms = enqueue_ms(call, 10)
    dev_ms = device_ms(call, 10)
    plain_ms = cuda_ms(lambda: fused_dstep.fused_d_epoch_steps_plain(
        *args, **kw), 5)
    net = fused_dstep.repack_net(
        common.NetState(params, bn, common.AdamState(count, params, params)),
        six, mu6, nu6, count)
    step = common.d_epoch_steps(common.d_step_fn(
        d_model, common.make_adv_loss(head), 2e-4, 0.5, 0.999, B,
        not float_rows, half), E)
    autograd_ms = cuda_ms(lambda: step(net, shards, starts, fake), 5)

    # The least time at float32 accuracy: the non-tensor f32 rate, or
    # three TF32 tensor-core passes (3xTF32), whichever is faster; against
    # the bytes.
    flops, nbytes = dstep_work(W, E, B, din, h1, h2, dout,
                               row_bytes=4 if float_rows else 1,
                               fake_sets=servers or (W if per_client
                                                     else 1))
    f32_peak, hbm, tf32_peak = peaks(card_name)
    t_simt = flops / f32_peak * 1e3
    t_ops = min(t_simt, 3 * flops / tf32_peak * 1e3)
    t_bytes = nbytes / hbm * 1e3
    res = {"phase": "kernel", "kernel": "fused_dstep", "shape_of": label,
           "head": head, "d_loss_half": half,
           "rows": "float32" if float_rows else "uint8",
           "fakes": f"a server's to its {W // servers} clients" if servers
           else "per client" if per_client else "shared",
           "shape": {"W": W, "E": E, "B": B, "din": din, "h1": h1,
                     "h2": h2, "out": dout},
           "errors": errs,
           "kernel_ms": kernel_ms, "enqueue_ms": enq_ms,
           "device_ms": dev_ms, "plain_ms": plain_ms,
           "autograd_ms": autograd_ms, "gflop": flops / 1e9,
           "mbytes": nbytes / 1e6, "bound_ms": max(t_ops, t_bytes),
           "bound_f32_simt_ms": max(t_simt, t_bytes),
           "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           "launches_inside_call": E * fused_dstep.LAUNCHES_PER_STEP}
    emit(res)
    if not all(v["ok"] for v in errs.values()):
        raise AssertionError(f"fused_dstep ({label}, {head}) disagrees with "
                             f"its plain version: {errs}")
    return res


def phase_kernel(card_name):
    import torch
    from cglgan_tpu_torch.models.zoo import build_discriminator

    results = []
    # the CAP-GAN main path's shape, both heads, one shared fake batch
    for head, dout, half in (("logits2", 2, True), ("sigmoid", 1, False)):
        gen = torch.Generator().manual_seed(1234 + dout)
        results.append(dstep_shape(
            card_name, "capgan", gen, build_discriminator("mnist", dout,
                                                          in_dim=DIN),
            W, DIN, H1, H2, dout, head, half))
    # the CGL path's shapes, per-client fakes (2DMG: float rows)
    for label, w, din, h1, h2, dout, head, half, rows in CGL_SHAPES:
        gen = torch.Generator().manual_seed(2468 + w + dout)
        d_model = build_discriminator("2dmg") if rows else \
            build_discriminator("mnist", dout, in_dim=din)
        results.append(dstep_shape(card_name, label, gen, d_model, w, din,
                                   h1, h2, dout, head, half, rows, True))
    # the MD-GAN family's: a server's fakes to its clients, also held to
    # the plain version in float64: on these inputs one LeakyReLU slope that
    # float32 rounding flips puts the plain version's mu 1.0005e-2 of its
    # scale from the plain version in float64 (on an H100 80GB HBM3 at
    # 700 W), and the kernel's rounding may fall on either side
    for label, w, servers, din, h1, h2, dout, head, half in MDGAN_SHAPES:
        gen = torch.Generator().manual_seed(3579 + w + dout)
        results.append(dstep_shape(
            card_name, label, gen, build_discriminator("mnist", dout,
                                                       in_dim=din),
            w, din, h1, h2, dout, head, half, False, True, servers,
            f64=True))

    # small ragged shapes; errors only
    cases = [(shape, False, False) for shape in RAGGED] + \
        [(shape, True, True) for shape in RAGGED_ROWS]
    for shape, rows, per_client in cases:
        for head, dout, half in (("logits2", 2, True), ("sigmoid", 1, False)):
            gen = torch.Generator().manual_seed(4242 + dout)
            args = dstep_inputs(gen, dout=dout, max_len=90,
                                float_rows=rows, per_client=per_client,
                                **shape)
            errs = dstep_check(args, dict(head=head, d_loss_half=half,
                                          lr=2e-4, b1=0.5, b2=0.999))
            res = {"phase": "kernel", "kernel": "fused_dstep", "head": head,
                   "shape": {**shape, "out": dout}, "ragged": True,
                   "rows": "float32" if rows else "uint8",
                   "fakes": "per client" if per_client else "shared",
                   "errors": errs}
            emit(res)
            if not all(v["ok"] for v in errs.values()):
                raise AssertionError(f"fused_dstep (ragged, {head}) disagrees "
                                     f"with its plain version: {errs}")
    return results


# fused_dstep with bf16 state (--dtype bfloat16, pallas_dstep=True): the
# CAP-GAN main path's shape (shared fakes, u8 images), the CGL-GAN shape (a
# bf16 fake batch a client) and a ragged shape at din=2 (float rows, per
# client): (label, W, E, B, din, h1, h2, out, head, x0.5, float rows, per
# client, timed against the autograd D phase)
BF16_SHAPES = (("capgan", W, E, B, DIN, H1, H2, 2, "logits2", True, False,
                False, True),
               ("cglgan", 20, E, B, DIN, H1, H2, 1, "sigmoid", False, False,
                True, True),
               ("ragged din=2", 3, 3, 37, 2, 24, 40, 1, "sigmoid", False,
                True, True, False))


def phase_kernel_bf16(card_name):
    """fused_dstep with bf16 state against its plain version at
    BF16_SHAPES: both return bf16 state and float32 losses, held to
    TOL_BF16_KERNEL / TOL_BF16_LOSS, beside the plain version's own
    float32-vs-float64 difference on the same inputs; the call, device,
    plain and bf16 autograd D phase times and the bound at the dense bf16
    rate."""
    import torch
    from cglgan_tpu_torch.algos import common
    from cglgan_tpu_torch.models.zoo import build_discriminator
    from cglgan_tpu_torch.ops import fused_dstep

    bf = torch.bfloat16
    results = []
    for (label, w, e, b, din, h1, h2, dout, head, half, rows, per_client,
         timed) in BF16_SHAPES:
        gen = torch.Generator().manual_seed(1357 + w + dout)
        d_model = None
        if timed:
            d_model = build_discriminator("mnist", dout, in_dim=din)
            params, bn = seeded_init(d_model, gen, w)
            six = [x for p in params if p is not None
                   for x in (p["w"], p["b"])]
        else:
            six = None
        six, mu6, nu6, count, shards, starts, fake = dstep_inputs(
            gen, w, e, b, din, h1, h2, dout, six=six, max_len=90 if not timed
            else 1000, float_rows=rows, per_client=per_client)
        args = ([x.to(bf) for x in six], [x.to(bf) for x in mu6],
                [x.to(bf) for x in nu6], count, shards, starts, fake.to(bf))
        kw = dict(head=head, d_loss_half=half, lr=2e-4, b1=0.5, b2=0.999)
        launched = fused_dstep.launches
        errs = dstep_check(args, kw, tol=TOL_BF16_KERNEL,
                           tol_loss=TOL_BF16_LOSS)
        if fused_dstep.launches != launched + 1:
            raise AssertionError("fused_dstep (bf16) did not launch")
        # the yardstick: what float32's own rounding moves the plain
        # version by on these inputs
        plain32 = fused_dstep.fused_d_epoch_steps_plain(*args, **kw)
        plain64 = fused_dstep.fused_d_epoch_steps_plain(
            *args, work_dtype=torch.float64, **kw)
        pairs = list(zip(plain32[:3], plain64[:3])) + [([plain32[4]],
                                                        [plain64[4]])]
        yard = {g: scaled_errs(a, b, 1.0)["max_scaled_err"]
                for g, (a, b) in zip(("params", "mu", "nu", "loss"), pairs)}
        call = lambda: dstep_call(args, kw)
        res = {"phase": "kernel", "kernel": "fused_dstep", "state": "bf16",
               "shape_of": label, "head": head, "d_loss_half": half,
               "rows": "float32" if rows else "uint8",
               "fakes": "per client (bf16)" if per_client else "shared (bf16)",
               "shape": {"W": w, "E": e, "B": b, "din": din, "h1": h1,
                         "h2": h2, "out": dout},
               "errors": errs, "plain_f32_vs_f64": yard,
               "kernel_ms": cuda_ms(call, 20),
               "device_ms": device_ms(call, 10),
               "device_kernels_in_call": device_kernels(call),
               "launches_inside_call": e * fused_dstep.LAUNCHES_PER_STEP
               + fused_dstep.BF16_EXTRA_LAUNCHES,
               "plain_ms": cuda_ms(
                   lambda: fused_dstep.fused_d_epoch_steps_plain(*args, **kw),
                   5)}
        if timed:
            # the local-D phase that auto runs in bf16: autograd, bf16
            # params, activations and Adam moments
            net = fused_dstep.repack_net(
                common.NetState(params, bn, common.AdamState(
                    count, params, params)), *args[:3], count)
            step = common.d_epoch_steps(common.d_step_fn(
                d_model, common.make_adv_loss(head), 2e-4, 0.5, 0.999, b,
                not rows, half, dtype=bf), e)
            res["autograd_bf16_ms"] = cuda_ms(
                lambda: step(net, shards, starts, args[6]), 5)
        flops, nbytes = dstep_work(w, e, b, din, h1, h2, dout,
                                   row_bytes=4 if rows else 1,
                                   fake_sets=w if per_client else 1,
                                   state_bytes=2, fake_bytes=2)
        _, hbm, _ = peaks(card_name)
        t_ops, t_bytes = flops / bf16_peak(card_name) * 1e3, nbytes / hbm * 1e3
        res.update(gflop=flops / 1e9, mbytes=nbytes / 1e6,
                   bound_ms=max(t_ops, t_bytes),
                   bound_by="operations" if t_ops >= t_bytes else "bytes")
        emit(res)
        results.append(res)
        if not all(v["ok"] for v in errs.values()):
            raise AssertionError(f"fused_dstep bf16 ({label}) disagrees with "
                                 f"its plain version: {errs}")
    return results


def sweep_work(W, E, B, gdims, ddims):
    """(FLOP, bytes) one fused_sweep_steps call must do.  Per worker and
    iteration: G forward twice, D forward on 2B and on B rows, D weight
    grads and the two hidden input grads on 2B rows, D input grads down to
    the samples on B rows, G weight grads and hidden input grads; each
    input read once and each output written once."""
    pair = lambda d: sum(a * b for a, b in zip(d[:-1], d[1:]))
    inner = lambda d: sum(a * b for a, b in zip(d[1:-1], d[2:]))
    fg, fd = 2 * B * pair(gdims), 2 * B * pair(ddims)
    per_iter = (fg                                  # fake = G(z1)
                + 2 * fd + 2 * fd + 2 * 2 * B * inner(ddims)   # D step
                + fg + fd + fd                      # G(z2), D fwd, D dx
                + fg + 2 * B * inner(gdims))        # G grads
    flops = W * E * per_iter
    n_state = sum(a * b + b for d in (gdims, ddims)
                  for a, b in zip(d[:-1], d[1:]))
    bytes_ = (2 * 3 * W * n_state * 4 + W * E * B * ddims[0] * 4
              + 2 * W * E * B * gdims[0] * 4 + 2 * W * E * 2 * 4
              + 2 * W * 8 + 2 * W * 4)
    return flops, bytes_


# small ragged shapes for fused_sweep, errors only: no size a multiple of a
# tile; W=20 is more workers than the card may hold clusters at once; E=32
# is MAX_EPOCH
SWEEP_RAGGED = (dict(W=3, E=1, B=37), dict(W=20, E=3, B=19),
                dict(W=2, E=32, B=16))


def sweep_inputs(gen, g_model, d_model, W, E, B, gdims):
    """Seeded inputs of one fused_sweep_steps call on the card: both nets'
    init weights, nonzero moments, per-worker Adam counts that differ
    between workers and between G and D, 2DMG reals, latents.  Returns
    (g_net, d_net, args)."""
    import torch
    from cglgan_tpu_torch.algos import common
    from cglgan_tpu_torch.data.gmm import gmm_modes
    from cglgan_tpu_torch.ops import fused_dstep
    dev = torch.device("cuda")

    def net(model, count):
        params, bn = seeded_init(model, gen, W)
        to = lambda fn: [None if p is None else
                         {k: fn(x).to(dev) for k, x in p.items()}
                         for p in params]
        return common.NetState(
            to(lambda x: x), bn, common.AdamState(
                count.to(dev),
                to(lambda x: torch.randn(x.shape, generator=gen) * 1e-3),
                to(lambda x: torch.randn(x.shape, generator=gen).abs()
                   * 1e-6)))

    g_net = net(g_model, torch.arange(W, dtype=torch.int64) * 3)
    d_net = net(d_model, torch.arange(W, dtype=torch.int64) * 2 + 1)
    modes = torch.from_numpy(gmm_modes(8)).float()
    lab = torch.randint(0, 8, (W, E, B), generator=gen)
    reals = (modes[lab] + 0.01 * torch.randn((W, E, B, 2), generator=gen)
             ).to(dev)
    z1 = torch.randn((W, E, B, gdims[0]), generator=gen).to(dev)
    z2 = torch.randn((W, E, B, gdims[0]), generator=gen).to(dev)
    gp, gmu, gnu, gc = fused_dstep.unpack_net_generic(g_net)
    dp, dmu, dnu, dc = fused_dstep.unpack_net_generic(d_net)
    return g_net, d_net, (gp, gmu, gnu, gc, dp, dmu, dnu, dc, reals, z1, z2)


def sweep_check(args, kw):
    """One kernel call against the plain version on the same inputs, which
    the call must leave as they were; errors per state group and loss."""
    import torch
    from cglgan_tpu_torch.ops import fused_sweep
    state = [t for i in (0, 1, 2, 4, 5, 6) for t in args[i]]
    before = [t.clone() for t in state]
    got = fused_sweep.fused_sweep_steps(*args, **kw)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(before, state)):
        raise AssertionError("fused_sweep modified its inputs")
    ref = fused_sweep.fused_sweep_steps_plain(*args, **kw)
    names = ("g.params", "g.mu", "g.nu", "d.params", "d.mu", "d.nu")
    errs = {n: scaled_errs(got[i], ref[i], TOL_SCALED)
            for i, n in enumerate(names)}
    errs["d_loss"] = scaled_errs([got[6]], [ref[6]], TOL_LOSS)
    errs["g_loss"] = scaled_errs([got[7]], [ref[7]], TOL_LOSS)
    return errs


def device_kernels(fn, tries=3):
    """Device kernels (and copies) one call of ``fn`` puts on the card, by
    ``torch.profiler``.  A profile that holds no device event at all is
    the profiler's miss, not the call's (seen on the H100: 0 events for a
    ``fused_sweep`` call whose device time the same phase had just
    measured): it is taken again, up to ``tries`` profiles."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        count = sum(ev.count for ev in prof.key_averages()
                    if ev.device_type == torch.autograd.DeviceType.CUDA)
        if count:
            break
    return count


def phase_kernel_sweep(card_name):
    import numpy as np
    import torch
    from cglgan_tpu_torch.algos import common, fedavg_family
    from cglgan_tpu_torch.core.config import FedGANConfig
    from cglgan_tpu_torch.models.zoo import (build_discriminator,
                                             build_generator)
    from cglgan_tpu_torch.ops import fused_sweep

    results = []
    occupancy = fused_sweep.cluster_occupancy()
    d_model = build_discriminator("2dmg")
    kw = dict(lr_g=2e-4, lr_d=2e-4, b1=0.5, b2=0.999)
    for algo, family in (("flgan", "2dmg-mlp"), ("fegan", "2dmg-small")):
        gdims = G_DIMS[algo]
        gen = torch.Generator().manual_seed(4321 + len(gdims))
        g_model = build_generator(family)
        g_net, d_net, args = sweep_inputs(gen, g_model, d_model, W, E, B,
                                          gdims)
        errs = sweep_check(args, kw)
        call = lambda: fused_sweep.fused_sweep_steps(*args, **kw)
        in_call = device_kernels(call)
        kernel_ms = cuda_ms(call, 20)
        enq_ms = enqueue_ms(call, 10)
        dev_ms = device_ms(call, 10)
        plain_ms = cuda_ms(lambda: fused_sweep.fused_sweep_steps_plain(
            *args, **kw), 5)
        cfg = FedGANConfig(algo=algo, **FEDAVG)
        sweep = fedavg_family._local_sweep(
            cfg, g_model, d_model, common.make_adv_loss("sigmoid"))
        reals, z1, z2 = args[8:]
        shards = reals.reshape(W, E * B, 2)
        starts = [e * B for e in range(E)]
        steps = np.full(W, E)               # every worker takes E steps
        autograd_ms = cuda_ms(lambda: sweep(g_net, d_net, shards, starts,
                                            z1, z2, steps), 5)

        flops, nbytes = sweep_work(W, E, B, gdims, D_DIMS)
        f32_peak, hbm, _ = peaks(card_name)
        t_ops, t_bytes = flops / f32_peak * 1e3, nbytes / hbm * 1e3
        res = {"phase": "kernel", "kernel": "fused_sweep", "algo": algo,
               "shape": {"W": W, "E": E, "B": B, "g": list(gdims),
                         "d": list(D_DIMS)},
               "errors": errs, "kernel_ms": kernel_ms,
               "enqueue_ms": enq_ms, "device_ms": dev_ms,
               "plain_ms": plain_ms, "autograd_ms": autograd_ms,
               "gflop": flops / 1e9, "mbytes": nbytes / 1e6,
               "bound_ms": max(t_ops, t_bytes),
               "bound_by": "operations" if t_ops >= t_bytes else "bytes",
               "gflop_per_s": flops / kernel_ms / 1e6,
               "launches_inside_call": in_call, **occupancy}
        emit(res)
        results.append(res)
        if not all(v["ok"] for v in errs.values()):
            raise AssertionError(f"fused_sweep ({algo}) disagrees with its "
                                 f"plain version: {errs}")
        if in_call != 1:
            raise AssertionError(f"fused_sweep put {in_call} kernels on the "
                                 f"card in one call, expected 1")

    # small ragged shapes, both G shapes each; errors only
    for shape in SWEEP_RAGGED:
        for algo, family in (("flgan", "2dmg-mlp"), ("fegan", "2dmg-small")):
            gdims = G_DIMS[algo]
            g_model = build_generator(family)
            # inputs on which float32 itself is stable: the plain version in
            # float32 within TOL_SCALED / 10 of the plain version in float64
            # (at B=16 and E=32 one LeakyReLU slope that float32 rounding
            # flips moves a moment by up to ~0.2 of its scale, in the plain
            # version as in the kernel); the first such of a fixed list of
            # seeds, chosen before the kernel runs
            rejected = []
            for seed in range(777, 777 + 8):
                gen = torch.Generator().manual_seed(seed + shape["W"])
                _, _, args = sweep_inputs(gen, g_model, d_model,
                                          gdims=gdims, **shape)
                f32_f64 = plain_precision_err(args, kw)
                if f32_f64 <= TOL_SCALED / 10:
                    break
                rejected.append([seed, f32_f64])
            else:
                raise AssertionError(f"fused_sweep ragged {shape}: no stable "
                                     f"inputs among {rejected}")
            errs = sweep_check(args, kw)
            res = {"phase": "kernel", "kernel": "fused_sweep", "algo": algo,
                   "shape": {**shape, "g": list(gdims), "d": list(D_DIMS)},
                   "ragged": True, "seed": seed,
                   "plain_f32_vs_f64": f32_f64, "seeds_rejected": rejected,
                   "errors": errs}
            emit(res)
            if not all(v["ok"] for v in errs.values()):
                raise AssertionError(f"fused_sweep (ragged {shape}, {algo}) "
                                     f"disagrees with its plain version: "
                                     f"{errs}")
    return results


def plain_precision_err(args, kw):
    """max over the state tensors of max|plain32 - plain64| / max|plain64|:
    how far float32 rounding alone moves the plain version on these
    inputs."""
    from cglgan_tpu_torch.ops import fused_sweep
    wide = lambda a: ([t.double() for t in a] if isinstance(a, list)
                      else a.double() if a.is_floating_point() else a)
    r32 = fused_sweep.fused_sweep_steps_plain(*args, **kw)
    r64 = fused_sweep.fused_sweep_steps_plain(*map(wide, args), **kw)
    return max(float((x.double() - y).abs().max() / y.abs().max())
               for i in range(6) for x, y in zip(r32[i], r64[i]))


ADAM_SHAPES = ((W, DIN, H1), (W, H1), (W, H1, H2), (W, H2), (W, H2, 2),
               (W, 2))


def library_adam_ms(ps, gs, ms, vs, kw):
    """Time of the one PyTorch call that computes an Adam step over the same
    tensor list (``torch._fused_adam_``, what ``torch.optim.Adam(fused=True)``
    calls; that optimizer's own ``step`` if the private name is missing).
    A yardstick only: the port never calls it."""
    import torch
    ps, ms, vs = ([t.clone() for t in ts] for ts in (ps, ms, vs))
    if hasattr(torch, "_fused_adam_"):
        steps = [torch.full((), 7.0, device=ps[0].device) for _ in ps]
        fn = lambda: torch._fused_adam_(
            ps, gs, ms, vs, [], steps, lr=kw["lr"], beta1=kw["b1"],
            beta2=kw["b2"], weight_decay=0.0, eps=kw["eps"], amsgrad=False,
            maximize=False)
        return cuda_ms(fn, 20), "torch._fused_adam_"
    for p, g in zip(ps, gs):
        p.grad = g
    opt = torch.optim.Adam(ps, lr=kw["lr"], betas=(kw["b1"], kw["b2"]),
                           eps=kw["eps"], fused=True)
    return cuda_ms(opt.step, 20), "torch.optim.Adam(fused=True).step"


# threefry on the card against its plain version (``ops/threefry.py``
# ``draw_plain``: the same arithmetic as int64 torch ops, run on the card
# on the same keys by routing ``draw`` to it).  Every mode but the normals
# is integer work or exact float work: bits equal.  The normals: the kernel
# rounds its erf_inv polynomial's multiply-adds once in float32 (fmaf)
# where the plain version rounds them from float64, and float64 log1p may
# differ in its last bit: within TOL_NORMAL_ULPS ulps of the dtype, with the
# count of elements that differ at all printed.
TOL_NORMAL_ULPS = 3
# the hash's 32-bit integer operations against the H100 SXM's int32 rate:
# 64 INT32 lanes an SM x 132 SMs x 1.98 GHz boost (NVIDIA Hopper white
# paper); bytes against 3.35 TB/s
INT32_OPS_PER_S = 64 * 132 * 1.98e9
HBM_BYTES_PER_S = 3.35e12
THREEFRY_REPS = 20
# the most launches the draws may add to a CAP-GAN main-path round
MAX_DRAW_LAUNCHES = 10


class plain_threefry:
    """Inside the block every threefry draw runs ``draw_plain`` on the
    keys' device, the card included (the comparison's reference)."""

    def __enter__(self):
        from cglgan_tpu_torch.ops import threefry as tk
        self.saved = tk.draw
        tk.draw = tk.draw_plain

    def __exit__(self, *exc):
        from cglgan_tpu_torch.ops import threefry as tk
        tk.draw = self.saved


def ulps_apart(a, b):
    """Largest distance in units in the last place of a's dtype (float32
    or bfloat16), and how many elements differ at all."""
    import torch
    view = torch.int32 if a.dtype == torch.float32 else torch.int16
    d = (a.contiguous().view(view).long() - b.contiguous().view(view).long()
         ).abs()
    return int(d.max()), int((d != 0).sum())


def phase_kernel_threefry(card_name, part):
    """The kernel against its plain version on the card, every mode, at the
    largest draw a phase makes: the MNIST FedAvg sweep's z1 / z2 (W, steps,
    B, zdim) of ``mnist-ref-iid1-flgan``; its time beside the plain
    version's, ``torch.randn``'s at the same size (a different function:
    for scale, not a library yardstick) and the bound."""
    import torch
    from cglgan_tpu_torch.algos.fedavg_family import _local_steps
    from cglgan_tpu_torch.core import prng, threefry
    from cglgan_tpu_torch.core.config import FedGANConfig
    from cglgan_tpu_torch.ops import _build
    from cglgan_tpu_torch.ops import threefry as tk

    t_phase = time.perf_counter()
    cfg = FedGANConfig(algo="flgan", epoch=1, **FEDAVG_MNIST)
    W, B, zdim = cfg.num_workers, cfg.batch_size, cfg.latent_dim
    steps = int(_local_steps(cfg, part.lengths).max())
    rk = prng.RoundKeys(cfg, part.data.shape[1], steps, "cuda", piece=1)
    key = rk.key(0)
    keys = threefry.split(threefry.split(threefry.split(key, W), steps), 4)
    lane = keys[..., 0, :]                                  # (W, steps, 2)
    bf = torch.bfloat16
    draws = {
        "normal_f32": lambda: threefry.normal_parts(
            keys[..., :2, :], [(B, zdim)] * 2),
        "normal_bf16": lambda: threefry.normal_parts(
            keys[..., :2, :], [(B, zdim)] * 2, bf),
        "split": lambda: threefry.split(keys, 7),
        "fold_in": lambda: threefry.fold_in(keys, 123),
        "fold_in_range": lambda: threefry.fold_in(rk.local, range(5, 2005)),
        "bits32": lambda: threefry.random_bits(lane, (B, zdim)),
        "bits16": lambda: threefry.random_bits(lane, (B,), 16),
        "bits8": lambda: threefry.random_bits(lane, (B,), 8),
        "uniform_f32": lambda: threefry.uniform(lane, (B, zdim), -1 / 3,
                                                1 / 3),
        "uniform_bf16": lambda: threefry.uniform(lane, (B, zdim), -1 / 3,
                                                 1 / 3, bf),
        "bernoulli_parts": lambda: threefry.bernoulli_parts(
            keys, 0.75, [(B, c, 1, 1) for c in (16, 32, 64, 128)]),
        "randint": lambda: threefry.randint(lane, (B,), 0, 20000),
        "randint_int32": lambda: threefry.randint(lane, (B,), -2**31,
                                                  2**31 - 1),
        "window_starts": lambda: prng.window_starts(
            threefry.fold_in(rk.local, range(0, 500)), steps,
            part.data.shape[1], B),
        "permutation_20": lambda: threefry.permutation(key, 20),
        "permutation_1700": lambda: threefry.permutation(key, 1700)}
    launched = tk.launches
    got = {name: fn() for name, fn in draws.items()}
    torch.cuda.synchronize()
    kernel_launches = tk.launches - launched
    with plain_threefry():
        ref = {name: fn() for name, fn in draws.items()}
    torch.cuda.synchronize()
    if tk.launches != launched + kernel_launches:
        raise AssertionError("the plain version launched the kernel")
    errors, bad = {}, []
    for name in draws:
        a, b = got[name], ref[name]
        a, b = (a, b) if isinstance(a, list) else ([a], [b])
        err = {"max_abs_err": max(float((x.double() - y.double()).abs()
                                        .max()) for x, y in zip(a, b)),
               "elements": sum(x.numel() for x in a)}
        if any(x.dtype != y.dtype or x.shape != y.shape
               for x, y in zip(a, b)):
            raise AssertionError(f"threefry {name}: dtype or shape differs")
        if name.startswith("normal"):
            apart = [ulps_apart(x, y) for x, y in zip(a, b)]
            err["max_ulps"] = max(u for u, _ in apart)
            err["elements_differing"] = sum(n for _, n in apart)
            if err["max_ulps"] > TOL_NORMAL_ULPS:
                bad.append(name)
        elif err["max_abs_err"] != 0.0:
            bad.append(name)
        errors[name] = err
    # card against the CPU's plain version: the permutation and starts
    cpu_key = key.cpu()
    if not torch.equal(threefry.permutation(cpu_key, 1700),
                       got["permutation_1700"].cpu()):
        bad.append("permutation_1700 vs cpu")

    z_keys = keys[..., :2, :]
    big = lambda: threefry.normal_parts(z_keys, [(B, zdim)] * 2)
    n_elem = 2 * W * steps * B * zdim
    ms = cuda_ms(big, THREEFRY_REPS)
    with plain_threefry():
        plain_ms = cuda_ms(big, 3)
    randn_ms = cuda_ms(lambda: torch.randn((2, W, steps, B, zdim),
                                           device="cuda"), THREEFRY_REPS)
    ops_ms = n_elem * tk.HASH_OPS / INT32_OPS_PER_S * 1e3
    bytes_ms = (n_elem * 4 + 2 * W * steps * 16) / HBM_BYTES_PER_S * 1e3
    res = {"phase": "threefry", "card": card_name,
           "shape": [2, W, steps, B, zdim], "elements": n_elem,
           "errors": errors, "tol_normal_ulps": TOL_NORMAL_ULPS,
           "kernel_launches_in_checks": kernel_launches,
           "kernel_ms": ms, "plain_ms": plain_ms,
           "torch_randn_ms_same_size": randn_ms,
           "bound_ms": max(ops_ms, bytes_ms),
           "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
           "bound_ops_ms": ops_ms, "bound_bytes_ms": bytes_ms,
           "hash_ops_per_element": tk.HASH_OPS,
           "ptxas": [line for line in _build.ptxas_report(
               "threefry").splitlines() if "Used" in line]}
    res["seconds"] = time.perf_counter() - t_phase
    emit(res)
    if bad:
        raise AssertionError(f"threefry kernel and plain version differ: "
                             f"{bad}")
    return res


def launches_per_round(fn, rounds):
    """Device kernel launches and copies a round of ``fn(i)`` (round i),
    from the profiler's raw device events."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from cglgan_tpu_torch.utils.profiling import device_kernel_sums
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(rounds):
            fn(i)
        torch.cuda.synchronize()
    return sum(n for _, n in device_kernel_sums(prof).values()) / rounds


def phase_draws(part_main):
    """The CAP-GAN main path at epoch=5 and the FL-GAN 2DMG kernel path,
    each from one state: ROUNDS rounds drawing their own streams against
    the same rounds fed the same streams drawn beforehand on the card
    (``prng.round_streams`` / ``sweep_streams``), in turns (own, injected,
    injected, own); rounds/s of each, the launches a round that the draws
    add (profiler), the kernel's own launches a round, and the two end
    states held to each other."""
    import torch
    from cglgan_tpu_torch.algos.fedavg_family import _local_steps
    from cglgan_tpu_torch.algos.registry import build_runner, load_partition
    from cglgan_tpu_torch.algos.runner import train
    from cglgan_tpu_torch.core import prng
    from cglgan_tpu_torch.core.config import FedGANConfig
    from cglgan_tpu_torch.ops import threefry as tk

    out = {}
    for label, cfg, part in (
            ("capgan e5", FedGANConfig(algo="capgan", epoch=5, **MAIN),
             part_main),
            ("flgan 2dmg kernel", FedGANConfig(algo="flgan",
                                               pallas_sweep=True, **FEDAVG),
             None)):
        part = part if part is not None else load_partition(cfg)
        runner = build_runner(cfg, part)
        L = part.data.shape[1]
        state = train(runner, 2, eval_every=2, evaluator=False)["state"]
        t0 = state.t
        if cfg.algo == "flgan":
            steps = int(_local_steps(cfg, part.lengths).max())
            pre = [prng.sweep_streams(cfg, t0 + i, L, steps, "cuda")
                   for i in range(ROUNDS)]
        else:
            pre = [prng.round_streams(cfg, t0 + i, L, "cuda")
                   for i in range(ROUNDS)]

        def run(injected, n=ROUNDS):
            s = state
            for i in range(n):
                s, _ = runner.round_fn(s, pre[i] if injected else None)
            return s

        run(False, 2)
        run(True, 2)
        walls = {"own": [], "injected": []}
        ends = {}
        for name in ("own", "injected", "injected", "own"):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            ends[name] = run(name == "injected")
            torch.cuda.synchronize()
            walls[name].append(time.perf_counter() - t1)
        errs = state_errs(ends["own"], ends["injected"])
        for _ in range(3):
            launched = tk.launches
            own = launches_per_round(lambda i: run(False, 1), 1)
            own_tf = tk.launches - launched
            injected = launches_per_round(lambda i: run(True, 1), 1)
            # a profile that misses device events (an injected round has
            # read 374 launches against its own 612 on an H100) is taken
            # again, up to 3 times; the check below still holds the last
            if 0 <= own - injected <= MAX_DRAW_LAUNCHES:
                break
        res = {"phase": "draws", "path": label,
               "config": {"algo": cfg.algo, "epoch": cfg.epoch,
                          "num_workers": cfg.num_workers,
                          "dataset": cfg.dataset},
               "rounds": ROUNDS,
               "rounds_per_s_own": [ROUNDS / w for w in walls["own"]],
               "rounds_per_s_injected": [ROUNDS / w
                                         for w in walls["injected"]],
               "launches_per_round_own": own,
               "launches_per_round_injected": injected,
               "draw_launches_per_round": own - injected,
               "threefry_launches_per_round": own_tf,
               "own_vs_injected_max_scaled_err": errs}
        emit(res)
        if over_limit(errs, TOL_SCALED):
            raise AssertionError(f"{label}: own draws and the same draws "
                                 f"injected disagree: {errs}")
        if label.startswith("capgan") and \
                own - injected > MAX_DRAW_LAUNCHES:
            raise AssertionError(f"{label}: the draws add "
                                 f"{own - injected} launches a round")
        out[label] = res
    return out


def seed_round():
    """A shrunk CAP-GAN run from its seed, no streams injected: the card's
    init against the CPU's (every leaf equal: the uniforms are JAX's bits
    on both), the card's round-0 draws against the CPU's, then one round on
    each within the reference phase's limits.  Where the normals' <= 3-ulp
    gap moves the round beyond them, the gap is printed and the round is
    held again with the CPU's streams injected on both sides."""
    import numpy as np
    import torch
    from cglgan_tpu_torch.algos.registry import build_runner
    from cglgan_tpu_torch.core import prng
    from cglgan_tpu_torch.core.config import FedGANConfig
    from cglgan_tpu_torch.data.partition import Partition
    from cglgan_tpu_torch.utils.transplant import to_numpy
    from cglgan_tpu_torch.utils.tree import tree_leaves

    rng = np.random.default_rng(7)
    nw, L, d = 4, 48, 64
    part = Partition(rng.integers(0, 256, (nw, L, d)).astype(np.uint8),
                     np.zeros((nw, L), np.int32),
                     np.asarray([30, 48, 41, 36], np.int32),
                     np.zeros((nw, 10), np.int64),
                     np.zeros((10, d), np.uint8))
    cfg = FedGANConfig(algo="capgan", dataset="synthetic-mnist",
                       num_workers=nw, num_servers=2, img_size=8,
                       batch_size=8, epoch=2, num_communication=12)
    gpu = build_runner(cfg, part)
    cpu = build_runner(cfg, part, device="cpu")
    sg, sc = gpu.init_state(), cpu.init_state()
    a = tree_leaves(to_numpy(sg, bf16="float32"))
    b = tree_leaves(to_numpy(sc, bf16="float32"))
    init_equal = len(a) == len(b) and all(
        np.array_equal(x, y) for x, y in zip(a, b))
    card_draws = prng.round_streams(cfg, 0, L, "cuda")
    cpu_draws = prng.round_streams(cfg, 0, L, "cpu")
    z_apart = [ulps_apart(a.cpu(), b)
               for a, b in zip(card_draws[1:], cpu_draws[1:])]
    g1, mg = gpu.round_fn(sg)
    c1, mc = cpu.round_fn(sc)
    errs = state_errs(g1, c1)
    merr = max(abs(float(mg[k]) - float(mc[k])) for k in mg)
    res = {"phase": "reference", "algo": "capgan from its seed",
           "init_equal": init_equal,
           "starts_equal": card_draws[0].tolist() == cpu_draws[0].tolist(),
           "z_max_ulps": max(u for u, _ in z_apart),
           "z_elements_differing": sum(n for _, n in z_apart),
           "max_scaled_err": errs, "tol_scaled": TOL_SCALED,
           "metrics_max_abs_err": merr, "tol_metrics": 1e-4}
    held = not (over_limit(errs, TOL_SCALED) or merr > 1e-4)
    if not held:
        # the normals' gap moved the round: print it, hold the same round
        # with one set of draws
        g1, mg = gpu.round_fn(sg, cpu_draws)
        c1, mc = cpu.round_fn(sc, cpu_draws)
        res["injected_max_scaled_err"] = errs = state_errs(g1, c1)
        res["injected_metrics_max_abs_err"] = merr = max(
            abs(float(mg[k]) - float(mc[k])) for k in mg)
    res["held_without_injection"] = held
    emit(res)
    if not (init_equal and res["starts_equal"]) or \
            res["z_max_ulps"] > TOL_NORMAL_ULPS or \
            over_limit(errs, TOL_SCALED) or merr > 1e-4:
        raise AssertionError(f"the run from its seed: card and CPU "
                             f"disagree: {res}")
    return res


def phase_kernel_adam(card_name):
    import torch
    from cglgan_tpu_torch.ops import fused_adam as fa

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(99)
    rnd = lambda s, scale: (torch.randn(s, generator=gen) * scale).to(dev)
    ps = [rnd(s, 0.05) for s in ADAM_SHAPES]
    gs = [rnd(s, 1e-2) for s in ADAM_SHAPES]
    ms32 = [rnd(s, 1e-3) for s in ADAM_SHAPES]
    vs32 = [rnd(s, 1e-6).abs() for s in ADAM_SHAPES]
    count = torch.tensor(7, dtype=torch.int64, device=dev)
    kw = dict(lr=2e-4, b1=0.5, b2=0.999, eps=1e-8)
    n_el = sum(p.numel() for p in ps)
    _, hbm, _ = peaks(card_name)
    results = []

    def run(ms, vs, stochastic, plain):
        if plain:
            return [fa.fused_adam_step_plain(g, p, m, v, count, **kw)
                    for g, p, m, v in zip(gs, ps, ms, vs)]
        return fa.fused_adam_leaves(gs, ps, ms, vs, count,
                                    stochastic=stochastic, **kw)

    for mode in ("f32", "bf16", "bf16_sr"):
        bf = mode != "f32"
        ms = [m.bfloat16() for m in ms32] if bf else ms32
        vs = [v.bfloat16() for v in vs32] if bf else vs32
        sr = mode == "bf16_sr"
        fa.launches = 0
        got = run(ms, vs, sr, plain=False)
        torch.cuda.synchronize()
        list_launches = fa.launches
        if list_launches != 1:
            raise AssertionError(f"fused_adam: {list_launches} launches for "
                                 f"a list of {len(ps)} tensors, expected 1")
        ref = run(ms, vs, False, plain=True)
        errs = {"params": scaled_errs([o[0] for o in got],
                                      [o[0] for o in ref], TOL_ADAM)}
        if mode == "f32":
            errs["m"] = scaled_errs([o[1] for o in got], [o[1] for o in ref],
                                    TOL_ADAM)
            errs["v"] = scaled_errs([o[2] for o in got], [o[2] for o in ref],
                                    TOL_ADAM)
        elif mode == "bf16":
            for k, name in ((1, "m"), (2, "v")):
                a = torch.cat([o[k].reshape(-1) for o in got])
                b = torch.cat([o[k].reshape(-1) for o in ref])
                step = (a.view(torch.int16).int()
                        - b.view(torch.int16).int()).abs()
                share = float((step > 0).float().mean())
                errs[name] = {
                    "max_abs_err": float((a.float() - b.float()).abs().max()),
                    "share_off_by_one_bf16_step": share,
                    "max_bf16_steps": int(step.max()),
                    "tol_share": TOL_BF16_SHARE,
                    "ok": share <= TOL_BF16_SHARE and int(step.max()) <= 1}
        else:
            # the float32 moments the plain version computes from the same
            # bfloat16 inputs; each stored moment must be one of their two
            # bfloat16 neighbours, and the signed rounding error, in units
            # of the neighbours' distance, must average to zero
            f32 = run([m.float() for m in ms], [v.float() for v in vs],
                      False, plain=True)
            for k, name in ((1, "m"), (2, "v")):
                x = torch.cat([o[k].reshape(-1) for o in f32])
                y = torch.cat([o[k].reshape(-1) for o in got]).float()
                lo = (x.view(torch.int32) & -65536)
                hi = lo + 65536
                lo_f, hi_f = lo.view(torch.float32), hi.view(torch.float32)
                neighbour = (y == lo_f) | (y == hi_f)
                unit = ((y - x) / (hi_f - lo_f)).double()
                mean = float(unit.mean())
                se = float(unit.std()) / math.sqrt(unit.numel())
                errs[name] = {
                    "max_abs_err": float((y - x).abs().max()),
                    "not_a_neighbour": int((~neighbour).sum()),
                    "rounded_up_share": float((y == hi_f).float().mean()),
                    "mean_signed_err_in_steps": mean, "std_err": se,
                    "ok": bool(neighbour.all()) and abs(mean) <= 3 * se}
        call = lambda: run(ms, vs, sr, plain=False)
        kernel_ms = cuda_ms(call, 20)
        enq_ms = enqueue_ms(call, 20)
        dev_ms = device_ms(call, 20)
        plain_ms = cuda_ms(lambda: run(ms, vs, False, plain=True), 5)
        lib_ms, lib_name = (library_adam_ms(ps, gs, ms, vs, kw)
                            if mode == "f32" else (None, None))
        nbytes = n_el * (28 if mode == "f32" else 20)
        res = {"phase": "kernel", "kernel": "fused_adam", "mode": mode,
               "shapes": [list(s) for s in ADAM_SHAPES],
               "elements": n_el, "errors": errs, "kernel_ms": kernel_ms,
               "enqueue_ms": enq_ms, "device_ms": dev_ms,
               "launches_per_call": list_launches,
               "plain_ms": plain_ms, "library_ms": lib_ms,
               "library_call": lib_name, "mbytes": nbytes / 1e6,
               "bound_ms": nbytes / hbm * 1e3, "bound_by": "bytes",
               "gbytes_per_s": nbytes / kernel_ms / 1e6,
               "device_gbytes_per_s": nbytes / dev_ms / 1e6}
        emit(res)
        results.append(res)
        if not all(v["ok"] for v in errs.values()):
            raise AssertionError(f"fused_adam ({mode}) disagrees with its "
                                 f"plain version: {errs}")

    # a list that one launch cannot take: MAX_TENSORS + 9 leaves, among them
    # an empty one, sizes that are no multiple of 4 and one leaf far larger
    # than the rest; float32 moments, bit-equal to the plain version
    sizes = [(7 * j * j + 3 * j + 1) % 9973 for j in range(fa.MAX_TENSORS + 9)]
    sizes[5], sizes[11] = 0, 1_000_003
    lp, lg, lm = ([rnd((n,), sc) for n in sizes] for sc in (0.05, 1e-2, 1e-3))
    lv = [rnd((n,), 1e-6).abs() for n in sizes]
    fa.launches = 0
    got = fa.fused_adam_leaves(lg, lp, lm, lv, count, stochastic=False, **kw)
    torch.cuda.synchronize()
    n_launches = fa.launches
    ref = [fa.fused_adam_step_plain(g, p, m, v, count, **kw)
           for g, p, m, v in zip(lg, lp, lm, lv)]
    differing = sum(int((a != b).sum()) for o, r in zip(got, ref)
                    for a, b in zip(o, r))
    res = {"phase": "kernel", "kernel": "fused_adam", "mode": "long list",
           "leaves": len(sizes), "max_tensors": fa.MAX_TENSORS,
           "not_multiple_of_4": sum(n % 4 != 0 for n in sizes),
           "empty": sizes.count(0), "elements": sum(sizes),
           "launches": n_launches, "expected_launches": len(
               fa.plan_launches(sizes)),
           "elements_differing_from_plain": differing}
    emit(res)
    if differing or n_launches != 2 or res["expected_launches"] != 2 or \
            any(tuple(o[0].shape) != (n,) for o, n in zip(got, sizes)):
        raise AssertionError(f"fused_adam long list: {res}")

    # the public surface: three steps on a small tree (a leaf whose size is
    # no multiple of 4 takes the tail path), counts set to 0 just before
    tree = [{"w": rnd((130, 170), 0.05), "b": rnd((171,), 0.05)}]
    grads = [{"w": rnd((130, 170), 1e-2), "b": rnd((171,), 1e-2)}]
    opt = fa.fused_adam(2e-4, b1=0.5, b2=0.999)       # bf16, stochastic
    state = opt.init(tree)
    fa.launches = 0
    params = tree
    for _ in range(3):
        params, state = opt.step(grads, state, params)
    torch.cuda.synchronize()
    launches = fa.launches
    moved = float((params[0]["w"] - tree[0]["w"]).abs().max())
    res = {"phase": "kernel", "kernel": "fused_adam", "mode": "init/step",
           "steps": 3, "count": int(state.count), "launches": launches,
           "moment_dtype": str(state.m[0]["w"].dtype),
           "max_param_move": moved}
    emit(res)
    finite = all(bool(torch.isfinite(x.float()).all())
                 for x in (params[0]["w"], params[0]["b"], state.m[0]["b"],
                           state.v[0]["w"]))
    if int(state.count) != 3 or launches != 3 or not finite \
            or not 0 < moved < 3 * 2e-4 * 1.01 / 0.5:
        raise AssertionError(f"fused_adam init/step: {res}")
    return results, launches


def finite_metrics(history):
    for tick in history:
        for key, v in tick.items():
            if not math.isfinite(float(v)):
                raise AssertionError(f"metric {key} = {v}")


def leaf_paths(tree, prefix=()):
    """The key paths of a tree's leaves, in ``tree_leaves`` order (dict
    keys sorted, list entries by index, ``None`` holes skipped)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in leaf_paths(tree[k],
                                                             prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [p for i, t in enumerate(tree)
                for p in leaf_paths(t, prefix + (i,))]
    return [prefix]


def is_sum_bias(path):
    """A conv bias or the conv D's ``adv`` bias: every ``b`` of a conv
    model's dict tree but the G's ``l1`` one.  Their gradients are sums over
    the batch and every pixel, and behind a BatchNorm they nearly cancel."""
    return len(path) > 1 and path[-1] == "b" and path[-2] != "l1"


def state_errs(card_state, cpu_state, apart=False):
    """Card rounds against CPU rounds: per net and group (params, mu, nu)
    the largest |card - cpu| over the group's largest |cpu| entry (the G's
    pre-BN linear biases have an exactly-zero gradient, so their moments are
    rounding noise on both devices, as in the JAX reference; scaling by the
    group keeps them from deciding).  Adam counts must be equal.  With
    ``apart`` the sum biases' moments (``is_sum_bias``) are reported on
    their own, as ``{net}.bias_mu`` / ``{net}.bias_nu``, still over their
    group's largest entry."""
    import numpy as np
    from cglgan_tpu_torch.utils.transplant import to_numpy
    from cglgan_tpu_torch.utils.tree import tree_leaves
    a = to_numpy(card_state, bf16="float32")
    b = to_numpy(cpu_state, bf16="float32")
    errs = {}
    for net in ("g", "d"):
        if not np.array_equal(a[net]["count"], b[net]["count"]):
            raise AssertionError(f"{net} Adam counts differ")
        for group in ("params", "mu", "nu"):
            mine, ref = tree_leaves(a[net][group]), tree_leaves(b[net][group])
            scale = max(float(np.abs(y).max()) for y in ref)
            own = [apart and group != "params" and is_sum_bias(p)
                   for p in leaf_paths(b[net][group])]
            for key, sel in ((f"{net}.{group}", False),
                             (f"{net}.bias_{group}", True)):
                diffs = [float(np.abs(x - y).max())
                         for x, y, o in zip(mine, ref, own) if o == sel]
                if diffs:
                    errs[key] = max(diffs) / scale
    return errs


def over_limit(errs, tol):
    """Whether a state_errs result exceeds ``tol``: one limit for every
    group, or a limit by group kind (``params``, ``mu``, ``nu``); a kind
    that ``tol`` does not name is reported, not held."""
    kind = lambda k: k.split(".", 1)[1]
    if not isinstance(tol, dict):
        return any(v > tol for v in errs.values())
    return any(v > tol[kind(k)] for k, v in errs.items() if kind(k) in tol)


# The reference phase's inputs as its limits were measured, before the
# port drew the reference's threefry tree: a torch.Generator a role and
# round, splitmix-seeded from cfg.seed, uniform U(-1/sqrt(fan_in), +)
# layers, the latents ``randn``.  ``reference_rounds`` holds card against
# CPU on them, and reports the same rounds from the seed (the runners' own
# init and the tree's streams) beside: a near-zero gradient whose sign the
# card's and the CPU's float32 sums set apart becomes a full Adam step, and
# on some inputs that outgrows the limits within 5 rounds (from the seed,
# the shrunk CGL-GAN's D moments part by 1.35e-2 of their group's scale).
def legacy_generator(seed, *tags):
    import torch
    mask = (1 << 64) - 1

    def mix(x):
        x = (x + 0x9E3779B97F4A7C15) & mask
        x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & mask
        x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & mask
        return x ^ (x >> 31)
    s = mix(int(seed) & mask)
    for t in tags:
        s = mix(s ^ (int(t) & mask))
    return torch.Generator().manual_seed(s & ((1 << 63) - 1))


_LEGACY_CONV_ORDER = {"conv": ("l1", "c1", "c2", "c3"),
                      "conv-multipath": (("trunk", "l1"), ("trunk", "c1"),
                                         ("trunk", "c2"), ("heads", "c")),
                      "conv-d": ("c1", "c2", "c3", "c4", "adv")}


def legacy_layers(model, params, is_d):
    """A model's layers ({"w", "b"} dicts) in the order the legacy init drew
    them: spec order (a multipath G's trunk, then its heads), or the conv
    families' construction order."""
    if isinstance(model.spec, str):
        order = _LEGACY_CONV_ORDER["conv-d" if is_d else model.spec]
        get = lambda k: params[k] if isinstance(k, str) else \
            params[k[0]][k[1]]
        return [get(k) for k in order]
    trees = [params["trunk"], params["heads"]] if model.multipath \
        else [params]
    return [p for tree in trees for p in tree
            if isinstance(p, dict) and "w" in p]


def legacy_params(model, params, gen, is_d):
    """``params`` (the new init's tree) with every layer re-drawn from
    ``gen`` as the legacy init drew it: weight, then bias, float32
    U(-bound, bound) in the tensors' stacked shapes, bound 1/sqrt(fan_in),
    cast to the leaves' dtype."""
    import math
    import torch
    from cglgan_tpu_torch.utils.tree import tree_map
    params = tree_map(lambda x: x, params)        # fresh containers
    for layer in legacy_layers(model, params, is_d):
        w = layer["w"]
        conv = w.ndim - (layer["b"].ndim - 1) == 4
        bound = 1.0 / math.sqrt(math.prod(w.shape[-3:]) if conv
                                else w.shape[-2])
        for name in ("w", "b"):
            x = layer[name]
            layer[name] = ((torch.rand(x.shape, generator=gen) * 2.0 - 1.0)
                           * bound).to(x.dtype).to(x.device)
    return params


def legacy_dcgan(gen, params):
    """The legacy DCGAN re-draw (Mix-G): ``randn`` a w / scale leaf in
    ``tree_leaves`` order, in the leaf's dtype."""
    import torch
    from cglgan_tpu_torch.core.dtypes import weak

    def walk(tree):
        if isinstance(tree, dict):
            w = tree.get("w")
            out = {}
            for key in sorted(tree):
                x = tree[key]
                if not isinstance(x, torch.Tensor):
                    out[key] = walk(x)
                elif key in ("w", "scale"):
                    draw = torch.randn(x.shape, generator=gen,
                                       dtype=x.dtype).to(x.device)
                    shift = 1.0 if key == "scale" else 0.0
                    out[key] = weak(0.02, draw) * draw + weak(shift, draw)
                elif key == "b" and w is not None \
                        and w.ndim - (x.ndim - 1) == 4:
                    out[key] = x
                else:
                    out[key] = torch.zeros_like(x)
            return out
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(x) for x in tree)
        return tree
    return walk(params)


def legacy_state(cfg, state):
    """A CGL- or MD-GAN-family init state with the legacy params (BN
    state, Adam state and the delta anchors are seed-free zeros / ones)."""
    from cglgan_tpu_torch.core import prng
    from cglgan_tpu_torch.models.zoo import models_for_config
    g_model, d_model = models_for_config(cfg)
    gp = legacy_params(g_model, state.g.params,
                       legacy_generator(cfg.seed, prng.ROLE_INIT_G), False)
    dp = legacy_params(d_model, state.d.params,
                       legacy_generator(cfg.seed, prng.ROLE_INIT_D), True)
    if cfg.algo == "mixgan":
        gp = legacy_dcgan(legacy_generator(cfg.seed, prng.ROLE_INIT_G, 99),
                          gp)
        dp = legacy_dcgan(legacy_generator(cfg.seed, prng.ROLE_INIT_D, 98),
                          dp)
    return state._replace(g=state.g._replace(params=gp),
                          d=state.d._replace(params=dp))


def legacy_streams(cfg, t, max_len):
    """Round t's legacy draws, as ``round_fn`` takes them injected:
    ``(starts, z_d, z_g[, k_d, k_drop][, alive, perm])`` on the host."""
    import torch
    from cglgan_tpu_torch.core import prng
    S, B, zdim, W = (cfg.num_servers, cfg.batch_size, cfg.latent_dim,
                     cfg.num_workers)
    hi = max(max_len - B + 1, 1)
    starts = torch.randint(0, hi, (cfg.epoch,), generator=legacy_generator(
        cfg.seed, prng.ROLE_LOCAL, t, prng.ROLE_BATCH)).tolist()
    g = legacy_generator(cfg.seed, prng.ROLE_LOCAL, t)
    out = [starts, torch.randn((S, B, zdim), generator=g),
           torch.randn((S, B, zdim), generator=g)]
    if cfg.conv:
        keys = torch.randint(0, 1 << 32, (2, S, 2), generator=g,
                             dtype=torch.int64)
        out += [keys[0], keys[1]]
    if cfg.algo in ("acgan", "mdgan"):
        out.append(torch.rand((W,), generator=legacy_generator(
            cfg.seed, prng.ROLE_LOCAL, t, prng.FOLD_SURVIVAL))
            < 1.0 - cfg.dropout_rate)
        out.append(torch.randperm(W, generator=legacy_generator(
            cfg.seed, prng.ROLE_LOCAL, t, prng.ROLE_SWAP)))
    return tuple(out)


def reference_rounds(label, cfg, part, rounds, tol=TOL_SCALED,
                     tol_metrics=1e-4, apart=False):
    """Card (kernel path) against CPU (plain path) from one init and one
    stream: ``rounds`` rounds of the CGL or MD-GAN family (with the latter's
    survival draw and swap permutation in the stream), held on the legacy
    inputs (above); the same rounds from the seed (each runner's own init,
    the tree's streams drawn on the host) are reported beside them.  The
    card must launch ``fused_dstep`` once a round where the config engages
    it, else never.  ``apart``: ``state_errs``'s."""
    from cglgan_tpu_torch.algos.registry import build_runner
    from cglgan_tpu_torch.core import prng
    from cglgan_tpu_torch.ops import fused_dstep

    L = part.data.shape[1]
    W = cfg.num_workers
    gpu = build_runner(cfg, part)
    cpu = build_runner(cfg, part, device="cpu")

    def run(legacy):
        sg, sc = gpu.init_state(), cpu.init_state()
        if legacy:
            sg, sc = legacy_state(cfg, sg), legacy_state(cfg, sc)
        launched = fused_dstep.launches
        for t in range(rounds):
            if legacy:
                streams = legacy_streams(cfg, t, L)
            else:
                streams = prng.round_streams(cfg, t, L, "cpu")
                if cfg.algo in ("acgan", "mdgan"):
                    streams = (*streams, prng.survival(cfg, t, W, "cpu"),
                               prng.swap_permutation(cfg, t, W, "cpu"))
            sg, mg = gpu.round_fn(sg, streams)
            sc, mc = cpu.round_fn(sc, streams)
        merr = max(abs(float(mg[k]) - float(mc[k])) for k in mg)
        return (state_errs(sg, sc, apart), merr,
                fused_dstep.launches - launched)

    seed_errs, seed_merr, _ = run(False)
    errs, merr, launches = run(True)
    expect = rounds if fused_dstep.eligible(cfg) else 0
    # same math on two devices, sums in another order: as in the kernel
    # phase, scaled by each tensor's max; float32 metrics 1e-4 absolute
    res = {"phase": "reference", "algo": label, "dtype": cfg.dtype,
           "rounds": rounds, "fused_dstep_launches": launches,
           "max_scaled_err": errs, "tol_scaled": tol,
           "metrics_max_abs_err": merr, "tol_metrics": tol_metrics,
           "from_seed": {"max_scaled_err": seed_errs,
                         "metrics_max_abs_err": seed_merr,
                         "within_tol": not (over_limit(seed_errs, tol)
                                            or seed_merr > tol_metrics)}}
    emit(res)
    if over_limit(errs, tol) or merr > tol_metrics or launches != expect:
        raise AssertionError(f"card and CPU rounds disagree: {res}")
    return res


def phase_reference():
    """Shrunk CAP-GAN, CGL-GAN (multipath and single path), Mix-G, 2DMG
    CGL-GAN, MD-GAN (shuffle D-swap every round) and AC-GAN (delta gossip
    every round; dropout, on the autograd path): card (kernel path) vs CPU
    (plain path)."""
    import numpy as np
    from cglgan_tpu_torch.algos.registry import load_partition
    from cglgan_tpu_torch.core.config import FedGANConfig
    from cglgan_tpu_torch.data.partition import Partition

    rng = np.random.default_rng(7)
    nw, L, d = 4, 48, 64
    part = Partition(rng.integers(0, 256, (nw, L, d)).astype(np.uint8),
                     np.zeros((nw, L), np.int32),
                     np.asarray([30, 48, 41, 36], np.int32),
                     np.zeros((nw, 10), np.int64),
                     np.zeros((10, d), np.uint8))
    image = dict(dataset="synthetic-mnist", num_workers=nw, num_servers=2,
                 img_size=8, batch_size=8, epoch=2)
    out = [reference_rounds("capgan", FedGANConfig(
        algo="capgan", num_communication=12, **image), part, 5)]
    for label, kw in (("cglgan", dict(algo="cglgan", iid=1)),
                      ("cglgan iid=0", dict(algo="cglgan", iid=0)),
                      ("mixgan", dict(algo="mixgan", iid=1))):
        out.append(reference_rounds(label, FedGANConfig(**kw, **image),
                                    part, 5))
    for label, kw in (
            ("mdgan shuffle", dict(algo="mdgan", num_servers=1, E=1,
                                   d_swap="shuffle")),
            ("acgan delta", dict(algo="acgan", E=1, gossip="delta")),
            ("acgan dropout", dict(algo="acgan", dropout_rate=0.5))):
        out.append(reference_rounds(label, FedGANConfig(
            **{**image, **kw}), part, 5))
    cfg = FedGANConfig(algo="cglgan", dataset="2dmg", num_workers=4,
                       num_servers=2, num_class=4, num_sample=64,
                       batch_size=16, iid=1, epoch=2)
    out.append(reference_rounds("cglgan 2dmg", cfg, load_partition(cfg), 5))
    return out


def phase_reference_bf16():
    """bf16 rounds, card against CPU from one init and one stream, at
    TOL_BF16_SCALED / TOL_BF16_METRICS: shrunk CAP-GAN with the forced
    kernel (bf16 state) and on the autograd path, CGL-GAN with the forced
    kernel (per-client bf16 fakes), FL-GAN on 2DMG (default path)."""
    import numpy as np
    from cglgan_tpu_torch.core.config import FedGANConfig
    from cglgan_tpu_torch.data.partition import Partition

    rng = np.random.default_rng(7)
    nw, L, d = 4, 48, 64
    part = Partition(rng.integers(0, 256, (nw, L, d)).astype(np.uint8),
                     np.zeros((nw, L), np.int32),
                     np.asarray([30, 48, 41, 36], np.int32),
                     np.zeros((nw, 10), np.int64),
                     np.zeros((10, d), np.uint8))
    image = dict(dataset="synthetic-mnist", num_workers=nw, num_servers=2,
                 img_size=8, batch_size=8, epoch=2, dtype="bfloat16")
    tols = (TOL_BF16_SCALED, TOL_BF16_METRICS)
    out = [reference_rounds(label, FedGANConfig(**kw, **image), part, 5,
                            *tols)
           for label, kw in (
               ("capgan bf16 kernel", dict(algo="capgan", pallas_dstep=True,
                                           num_communication=12)),
               ("capgan bf16 autograd", dict(algo="capgan",
                                             num_communication=12)),
               ("cglgan bf16 kernel", dict(algo="cglgan", iid=1,
                                           pallas_dstep=True)))]
    out += phase_reference_fedavg([(fedavg_shrunk(
        "flgan", dtype="bfloat16", force_dtype=True), *tols)])
    return out


# the CGL path: the reference-exact runs RESULTS.md archives
# (results/runs/{mnist-ref-iid1-cglgan,mnist-ref-iid1-mixgan,2dmg-ref-cglgan}
# /config.json), on synthetic-mnist for MNIST, at epoch=5 (the kernel path)
# and, for CGL-GAN on MNIST shapes, at the scripts' own epoch=1
CGL_MNIST = dict(dataset="synthetic-mnist", num_workers=20, num_servers=5,
                 iid=1, batch_size=100, cloud_epoch=1, segema=0.0)
CGL_2DMG = dict(dataset="2dmg", num_workers=10, num_servers=5, num_class=10,
                num_sample=10000, iid=2, batch_size=100, cloud_epoch=1,
                segema=0.0, num_communication=10000)
CGL_RUNS = (("cglgan", "cglgan", CGL_MNIST, 5),
            ("cglgan", "cglgan", CGL_MNIST, 1),
            ("mixgan", "mixgan", CGL_MNIST, 5),
            ("cglgan-2dmg", "cglgan", CGL_2DMG, 5))
# the CAP-GAN main path (bench.py:111-113)
MAIN = dict(dataset="synthetic-mnist", num_workers=16, num_servers=1, iid=1,
            batch_size=100)
# the MD-GAN family: the archived reference runs
# (results/runs/{mnist-ref-iid1-mdgan,mnist-ref-iid1-acgan,2dmg-ref-mdgan,
# 2dmg-ref-acgan}/config.json), on synthetic-mnist for MNIST, at epoch=5
# (the kernel path) and, on MNIST shapes, at the scripts' own epoch=1;
# then the exchanges and dropout at epoch=1, E=2
MDGAN_MNIST = dict(dataset="synthetic-mnist", num_workers=10, num_servers=1,
                   iid=1, batch_size=100)
ACGAN_MNIST = dict(dataset="synthetic-mnist", num_workers=10, num_servers=5,
                   iid=1, batch_size=100)
MDGAN_2DMG = dict(dataset="2dmg", num_workers=10, num_servers=1,
                  num_class=10, num_sample=1000, iid=2, batch_size=100,
                  num_communication=10000)
ACGAN_2DMG = dict(dataset="2dmg", num_workers=20, num_servers=5,
                  num_class=10, num_sample=10000, iid=2, batch_size=100,
                  num_communication=10000)
MDGAN_RUNS = (("mdgan", "mdgan", MDGAN_MNIST, 5, {}),
              ("mdgan", "mdgan", MDGAN_MNIST, 1, {}),
              ("acgan", "acgan", ACGAN_MNIST, 5, {}),
              ("acgan", "acgan", ACGAN_MNIST, 1, {}),
              ("mdgan-2dmg", "mdgan", MDGAN_2DMG, 5, {}),
              ("acgan-2dmg", "acgan", ACGAN_2DMG, 5, {}),
              ("mdgan ring", "mdgan", MDGAN_MNIST, 1,
               dict(E=2, d_swap="ring")),
              ("mdgan shuffle", "mdgan", MDGAN_MNIST, 1,
               dict(E=2, d_swap="shuffle")),
              ("acgan mean", "acgan", ACGAN_MNIST, 1,
               dict(E=2, gossip="mean")),
              ("acgan delta", "acgan", ACGAN_MNIST, 1,
               dict(E=2, gossip="delta")),
              ("acgan dropout", "acgan", ACGAN_MNIST, 1,
               dict(dropout_rate=0.2)))


def phase_rounds(phase, label, algo, base, epoch, part, rounds=ROUNDS,
                 **extra):
    """One CGL- or MD-GAN-family configuration at full width through
    ``build_runner``
    and ``train``: 2 warm-up and ``rounds`` timed rounds; ``fused_dstep``'s
    count, set to 0 just before, must rise by ``rounds`` where the config
    engages the kernel (epoch > 1 in float32, ``pallas_dstep=True``) and
    stay 0 elsewhere (the conv D), and ``fused_sweep``'s must stay 0;
    finite metrics and samples in [-1, 1].  ``extra``: further config
    fields (``dtype``, ``pallas_dstep``)."""
    import torch
    from cglgan_tpu_torch.algos.registry import build_runner
    from cglgan_tpu_torch.algos.runner import train
    from cglgan_tpu_torch.core.config import FedGANConfig
    from cglgan_tpu_torch.evalx.evaluator import make_evaluator
    from cglgan_tpu_torch.models.zoo import models_for_config
    from cglgan_tpu_torch.ops import fused_dstep, fused_sweep
    from cglgan_tpu_torch.ops import threefry as tk
    from cglgan_tpu_torch.utils.profiling import profile_rounds

    cfg = FedGANConfig(algo=algo, epoch=epoch, **base, **extra)
    runner = build_runner(cfg, part)
    # rounds/s leaves evaluation out: the evaluator is timed in eval_image
    state = train(runner, 2, eval_every=2,
                  evaluator=False)["state"]                # warm-up rounds
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fused_dstep.launches = fused_sweep.launches = tk.launches = 0
    t0 = time.perf_counter()
    out = train(runner, rounds, eval_every=10, state=state, evaluator=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, threefry_launches = fused_dstep.launches, tk.launches
    peak = torch.cuda.max_memory_allocated() / 1e9
    finite_metrics(out["history"])
    uses_kernel = fused_dstep.eligible(cfg)
    expect = rounds if uses_kernel else 0
    if launches != expect or fused_sweep.launches or \
            threefry_launches < rounds:
        raise AssertionError(f"{label} epoch={epoch} {extra}: fused_dstep "
                             f"launches {launches}, expected {expect}; "
                             f"fused_sweep {fused_sweep.launches}; "
                             f"threefry {threefry_launches}")
    # painter semantics: n // S samples a server
    n = (16 if cfg.is_image else 10000) // cfg.num_servers * cfg.num_servers
    samples = runner.sample(out["state"], n)
    side = cfg.img_size + 4 if cfg.conv else cfg.img_size   # 28 -> 32 conv
    shape = (n, 1, side, side) if cfg.is_image else (n, 2)
    if tuple(samples.shape) != shape or \
            not bool(torch.isfinite(samples).all()) or \
            float(samples.abs().max()) > 1.0:
        raise AssertionError(f"{label}: bad samples {tuple(samples.shape)}")
    res = {"phase": phase, "path": "kernel" if uses_kernel else "autograd",
           "config": {"algo": algo, **base, "epoch": epoch, **extra},
           "multipath": models_for_config(cfg)[0].multipath,
           "shards": list(part.data.shape), "rounds": rounds,
           "wall_s": wall, "rounds_per_s": rounds / wall,
           "fused_dstep_launches": launches,
           "fused_sweep_launches": fused_sweep.launches,
           "threefry_launches": threefry_launches,
           "uses_kernel": uses_kernel,
           "last_tick": out["history"][-1], "peak_mem_gb": peak}
    if not cfg.is_image:
        # the evaluator's KL, DS and mode coverage (32 bins for MD-GAN)
        res.update(make_evaluator(cfg, part)(runner, out["state"],
                                             samples=samples))
    # after the counted run: where a round's time goes
    res["profile"] = profile_rounds(runner, out["state"], PROFILE_ROUNDS)
    emit(res)
    return res, launches


# the ``graph`` phase: the CGL and MD-GAN families' MLP rounds as replays of
# one captured round (``algos/runner.py`` ``RoundProgram``), each case from
# one state; ``None`` as num_communication: the CAP-GAN cadence case, whose
# cloud sync fires at round GRAPH_SYNC_AT only (its period, from the
# partition, + that).  The MD-GAN family's cases are ``MDGAN_RUNS``' (the
# archived reference runs, the exchanges and dropout at E=2) and MD-GAN's
# forced bf16-state kernel.
GRAPH_ROUNDS = 20
GRAPH_SYNC_AT = 10
GRAPH_CASES = (("capgan e1", "capgan", MAIN, 1, {}),
               ("capgan e5", "capgan", MAIN, 5, {}),
               ("capgan e5 bf16 kernel", "capgan", MAIN, 5,
                dict(dtype="bfloat16", pallas_dstep=True)),
               ("cglgan e5", "cglgan", CGL_MNIST, 5, {}),
               ("mixgan e5", "mixgan", CGL_MNIST, 5, {}),
               ("capgan e5 E=2", "capgan", MAIN, 5, dict(E=2)),
               ("capgan e1 cadence", "capgan", MAIN, 1,
                dict(num_communication=None)),
               *((f"{label} e{epoch}" if not extra else label, algo, base,
                  epoch, extra)
                 for label, algo, base, epoch, extra in MDGAN_RUNS),
               ("mdgan e5 bf16 kernel", "mdgan", MDGAN_MNIST, 5,
                dict(dtype="bfloat16", pallas_dstep=True)))


def threefry_per_round(cfg) -> int:
    """``threefry`` launches a replayed MLP round makes, predicted from the
    config: ``prng.server_draws`` 3 (two splits, one normal draw of both
    latents); the survival draw 2 (``fold_in``, ``bernoulli``); MD-GAN's
    shuffle permutation 3 (``fold_in``, then one round of ``split`` and
    ``random_bits`` below 1 626 clients), every round under capture."""
    shuffle = cfg.algo == "mdgan" and cfg.E > 0 and cfg.d_swap == "shuffle"
    return 3 + 2 * (cfg.dropout_rate > 0) + 3 * shuffle


# the host's CUDA launch calls, as the profiler names them
HOST_LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC",
                     "cuLaunchKernel", "cuLaunchKernelEx", "cudaGraphLaunch",
                     "cudaMemcpyAsync", "cudaMemsetAsync")


def graph_profile(fn, rounds):
    """``fn()`` (``rounds`` rounds) under the profiler: the host's CUDA
    launch calls a round by name (a graph replay is one ``cudaGraphLaunch``),
    device ms and events a round (every kernel and copy, those a replay
    runs included) with the 10 largest, wall ms a round and the busy
    share."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from cglgan_tpu_torch.utils.profiling import device_kernel_sums
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    calls = {}
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() != torch.autograd.DeviceType.CUDA and \
                ev.name() in HOST_LAUNCH_CALLS:
            calls[ev.name()] = calls.get(ev.name(), 0) + 1
    kernels = sorted(device_kernel_sums(prof).items(), key=lambda k: -k[1][0])
    device_us = sum(us for _, (us, _) in kernels)
    return {"host_launch_calls_per_round": sum(calls.values()) / rounds,
            "host_calls_by_name": {k: v / rounds for k, v in calls.items()},
            "device_ms_per_round": device_us / 1e3 / rounds,
            "wall_ms_per_round": wall * 1e3 / rounds,
            "device_busy_share": device_us / 1e6 / wall,
            "device_events_per_round": sum(n for _, (_, n) in kernels) / rounds,
            "top": [{"kernel": name[:80], "ms_per_round": us / 1e3 / rounds,
                     "calls_per_round": n / rounds}
                    for name, (us, n) in kernels[:10]]}


def phase_graph(part_of):
    """The CGL and MD-GAN families' MLP runners through ``train`` as
    replays of one captured round, at full width (``GRAPH_CASES``), each
    case from one state: GRAPH_ROUNDS replays (a tick a round) against as
    many eager ``round_fn`` rounds, every state tensor and metric under
    ``torch.equal``; ``fused_dstep`` launches counted once a replay and
    ``threefry``'s as the capture counted them a replay (which must be
    ``threefry_per_round``'s prediction) plus the tables' fills; every
    piece's replays under ``set_sync_debug_mode("error")``;
    rounds/s eager (the per-round loop, ``program=None``) and graph in
    turns (eager, graph, graph, eager); host launch calls, device ms a
    round and busy share of each; capture seconds and the graph pool's
    memory; one capture across every ``train`` call of the runner."""
    import torch
    from cglgan_tpu_torch.algos import runner as rmod
    from cglgan_tpu_torch.algos.registry import build_runner
    from cglgan_tpu_torch.core.config import FedGANConfig
    from cglgan_tpu_torch.fed import topology
    from cglgan_tpu_torch.ops import fused_dstep
    from cglgan_tpu_torch.ops import threefry as tk
    from cglgan_tpu_torch.utils.tree import tree_leaves

    N = GRAPH_ROUNDS
    leaves = lambda st: tree_leaves([[n.params, n.bn, n.opt.count, n.opt.mu,
                                      n.opt.nu] for n in (st.g, st.d)]
                                    + [st.lam])
    results, launches = [], {}
    for label, algo, base, epoch, extra in GRAPH_CASES:
        part = part_of(algo, base)
        extra = dict(extra)
        sync_at = None
        if "num_communication" in extra:
            cfg = FedGANConfig(algo=algo, epoch=epoch, **base)
            period = int(max(1, topology.server_data_len(
                part.lengths, cfg.num_servers)[0] * cfg.cloud_epoch
                // cfg.batch_size))
            if period <= N:
                raise AssertionError(f"{label}: a sync period of {period}")
            extra["num_communication"] = period + GRAPH_SYNC_AT
            sync_at = GRAPH_SYNC_AT
        cfg = FedGANConfig(algo=algo, epoch=epoch, **base, **extra)
        t_build = time.perf_counter()
        runner = build_runner(cfg, part)
        program = runner.program
        if program is None:
            raise AssertionError(f"{label}: no RoundProgram")
        state0 = runner.init_state()
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t_build
        captures0 = rmod.captures

        plain_run = program.run

        def watched(t, n, _run=plain_run, _p=program):
            """A piece's replays with any host synchronisation an error
            (the capture, which synchronises, runs before them)."""
            if _p.graph is None:
                return _run(t, n)
            torch.cuda.set_sync_debug_mode("error")
            try:
                return _run(t, n)
            finally:
                torch.cuda.set_sync_debug_mode(0)

        program.run = watched
        # equality: N eager rounds, then N replays a tick each
        s, eager_m = state0, []
        for _ in range(N):
            s, m = runner.round_fn(s)
            eager_m.append(m)
        fill_before = tk.launches
        program.keys.fill(0, 1)
        per_fill = tk.launches - fill_before
        fused_dstep.launches = tk.launches = 0
        out = rmod.train(runner, N, eval_every=1, state=state0,
                         evaluator=False)
        torch.cuda.synchronize()
        dstep_n, tf_n = fused_dstep.launches, tk.launches
        unequal = [i for i, (a, b) in enumerate(zip(
            leaves(out["state"]), leaves(s), strict=True))
            if a.dtype != b.dtype or not torch.equal(a, b)]
        bad_metrics = [(i, k, tick[k], float(m[k]))
                       for i, (tick, m) in enumerate(zip(out["history"],
                                                         eager_m))
                       for k in m if tick[k] != float(m[k])]
        per_replay = {mod.__name__.rsplit(".", 1)[1]: n
                      for mod, n in program.per_replay.items()}
        uses_kernel = fused_dstep.eligible(cfg)
        want_dstep = N if uses_kernel else 0
        want_tf = N * per_replay.get("threefry", 0) + N * per_fill
        if sync_at is not None:
            syncs = [t for t in range(N)
                     if (cfg.num_communication - t) % (
                         cfg.num_communication - sync_at) == 0]
            if syncs != [sync_at]:
                raise AssertionError(f"{label}: syncs at {syncs}")
        # speed in turns: eager (the per-round loop), graph, graph, eager
        eager_runner = runner._replace(program=None)
        walls = {"eager": [], "graph": []}
        for name in ("eager", "graph", "graph", "eager"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rmod.train(eager_runner if name == "eager" else runner, N,
                       eval_every=N, state=state0, evaluator=False)
            torch.cuda.synchronize()
            walls[name].append(time.perf_counter() - t0)
        prof = {name: graph_profile(
            lambda r=r: rmod.train(r, N, eval_every=N, state=state0,
                                   evaluator=False), N)
            for name, r in (("eager", eager_runner), ("graph", runner))}
        captured = rmod.captures - captures0
        res = {"phase": "graph", "case": label,
               "config": {"algo": algo, **base, "epoch": epoch, **extra},
               "path": "kernel" if uses_kernel else "autograd",
               "rounds": N, "equal_state": not unequal,
               "unequal_leaves": unequal[:10],
               "unequal_metrics": bad_metrics[:10],
               "sync_at": sync_at,
               "fused_dstep_launches": dstep_n,
               "threefry_launches": tf_n, "threefry_expected": want_tf,
               "per_replay": per_replay, "threefry_per_fill": per_fill,
               "threefry_per_replay_predicted": threefry_per_round(cfg),
               "captures": captured,
               "capture_s": program.capture_s,
               "graph_pool_mb": program.pool_bytes / 1e6,
               "build_s": build_s,
               "rounds_per_s_eager": [N / w for w in walls["eager"]],
               "rounds_per_s_graph": [N / w for w in walls["graph"]],
               "profile": prof}
        emit(res)
        if unequal or bad_metrics:
            raise AssertionError(f"{label}: replays differ from eager "
                                 f"rounds: leaves {unequal[:10]}, metrics "
                                 f"{bad_metrics[:10]}")
        if dstep_n != want_dstep or tf_n != want_tf or \
                per_replay.get("threefry") != threefry_per_round(cfg):
            raise AssertionError(f"{label}: fused_dstep launches {dstep_n} "
                                 f"(expected {want_dstep}), threefry "
                                 f"{tf_n} (expected {want_tf}), a replay "
                                 f"{per_replay.get('threefry')} (predicted "
                                 f"{threefry_per_round(cfg)})")
        if captured != 1:
            raise AssertionError(f"{label}: {captured} captures across "
                                 f"the runner's train calls")
        if prof["graph"]["host_calls_by_name"].get("cudaGraphLaunch") != 1:
            raise AssertionError(f"{label}: not one replay a round: "
                                 f"{prof['graph']['host_calls_by_name']}")
        results.append(res)
        launches[label] = dstep_n
    return results, launches


def fedavg_shrunk(algo, **extra):
    """The shrunk 2DMG FedAvg-family config of the reference phases."""
    from cglgan_tpu_torch.core.config import FedGANConfig
    return FedGANConfig(algo=algo, dataset="2dmg", num_workers=4,
                        num_class=4, num_sample=64, batch_size=16, iid=1,
                        epoch=2, num_communication=8, **extra)


def phase_reference_fedavg(cases=None, part=None, rounds=3, apart=False):
    """Shrunk FL-GAN and FeGAN: card vs CPU from one init and one stream
    (by default on the kernel path, the CPU on its plain version) for
    ``rounds`` rounds.  ``cases``: (config, scaled tolerance, metric
    tolerance) triples; ``part``: their partition (default:
    ``load_partition``).  The streams cover the largest local step count
    (the ragged "epochs" sweep), and with conv the dropout keys.
    ``apart``: ``state_errs``'s."""
    from cglgan_tpu_torch.algos.fedavg_family import _local_steps
    from cglgan_tpu_torch.algos.registry import build_runner, load_partition
    from cglgan_tpu_torch.core import prng
    from cglgan_tpu_torch.ops import fused_dstep, fused_sweep

    if cases is None:
        # as for capgan: the same float32 math on two devices, scaled by
        # the group's largest entry; metrics 1e-4 absolute
        cases = [(fedavg_shrunk("flgan", pallas_sweep=True), TOL_SCALED,
                  1e-4),
                 (fedavg_shrunk("fegan", pallas_sweep=True,
                                frac_workers=0.5), TOL_SCALED, 1e-4)]
    out = []
    for cfg, tol, tol_metrics in cases:
        algo = cfg.algo
        cpart = part if part is not None else load_partition(cfg)
        steps = int(_local_steps(cfg, cpart.lengths).max())
        gpu = build_runner(cfg, cpart)
        cpu = build_runner(cfg, cpart, device="cpu")
        sg, sc = gpu.init_state(), cpu.init_state()
        launched = fused_sweep.launches, fused_dstep.launches
        for t in range(rounds):
            streams = prng.sweep_streams(cfg, t, cpart.data.shape[1], steps,
                                         "cpu")
            if cfg.dropout_rate > 0.0:          # one survival draw for both
                streams = (*streams,
                           prng.survival(cfg, t, cfg.num_workers, "cpu"))
            sg, mg = gpu.round_fn(sg, streams)
            sc, mc = cpu.round_fn(sc, streams)
        launches = {"fused_sweep": fused_sweep.launches - launched[0],
                    "fused_dstep": fused_dstep.launches - launched[1]}
        expect = rounds if fused_sweep.eligible(cfg) else 0
        errs = state_errs(sg, sc, apart)
        merr = max(abs(float(mg[k]) - float(mc[k])) for k in mg)
        res = {"phase": "reference", "algo": algo, "dtype": cfg.dtype,
               "dataset": cfg.dataset, "pallas_sweep": cfg.pallas_sweep,
               "frac_workers": cfg.frac_workers, "conv": cfg.conv,
               "sweep": cfg.resolved_local_sweep, "steps": steps,
               "rounds": rounds, "launches": launches,
               "max_scaled_err": errs, "tol_scaled": tol,
               "metrics_max_abs_err": merr, "tol_metrics": tol_metrics}
        emit(res)
        if over_limit(errs, tol) or merr > tol_metrics or \
                launches != {"fused_sweep": expect, "fused_dstep": 0}:
            raise AssertionError(f"card and CPU rounds disagree: {res}")
        out.append(res)
    return out


def phase_fedavg(algo, use_kernel, phase="fedavg", **extra):
    """One full-width 2DMG configuration through ``load_partition``,
    ``build_runner`` and ``train``; returns (result, sweep launches).
    ``extra``: further config fields (``dtype``, ``force_dtype``)."""
    import torch
    from cglgan_tpu_torch.algos.registry import build_runner, load_partition
    from cglgan_tpu_torch.algos.runner import train
    from cglgan_tpu_torch.core.config import FedGANConfig
    from cglgan_tpu_torch.evalx import hist2d
    from cglgan_tpu_torch.ops import fused_sweep
    from cglgan_tpu_torch.ops import threefry as tk
    from cglgan_tpu_torch.utils.profiling import profile_rounds

    workers = {"frac_workers": 0.5} if algo == "fegan" else {}
    cfg = FedGANConfig(algo=algo, pallas_sweep=True if use_kernel else None,
                       **FEDAVG, **workers, **extra)
    t0 = time.perf_counter()
    part = load_partition(cfg)
    runner = build_runner(cfg, part)
    setup_s = time.perf_counter() - t0
    state = train(runner, 2, eval_every=2,
                  evaluator=False)["state"]                # warm-up rounds
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fused_sweep.launches = tk.launches = 0
    t0 = time.perf_counter()
    out = train(runner, ROUNDS, eval_every=10, state=state, evaluator=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fused_sweep.launches
    threefry_launches = tk.launches
    finite_metrics(out["history"])
    expect = ROUNDS if use_kernel else 0
    if launches != expect or threefry_launches < ROUNDS:
        raise AssertionError(f"{algo}: fused_sweep launches {launches}, "
                             f"expected {expect}; threefry "
                             f"{threefry_launches}")
    n = 10000
    pts = runner.sample(out["state"], n)
    if tuple(pts.shape) != (n, 2) or not bool(torch.isfinite(pts).all()) \
            or float(pts.abs().max()) > 1.0:
        raise AssertionError(f"bad samples {tuple(pts.shape)}")
    real = torch.from_numpy(part.eval_pool).to(pts.device)
    kl, ds = hist2d.kl_and_distribution_score(pts, real, 16)
    # a profile short of sweep kernels is the profiler's miss (seen on the
    # H100: 4 of a 5-round window's 5 recorded), not the rounds': their
    # launches are counted exactly above, so it is taken again, up to 3
    for _ in range(3):
        prof = profile_rounds(runner, out["state"], PROFILE_ROUNDS)
        sweep_calls = sum(k["calls_per_round"] for k in prof["top"]
                          if "sweep_kernel" in k["kernel"])
        if sweep_calls == (1.0 if use_kernel else 0.0):
            break
    if sweep_calls != (1.0 if use_kernel else 0.0):
        raise AssertionError(f"{algo}: {sweep_calls} sweep kernels a round "
                             f"in the profile")
    res = {"phase": phase, "path": "kernel" if use_kernel else "autograd",
           "config": {"algo": algo, **FEDAVG, **workers, **extra,
                      "pallas_sweep": cfg.pallas_sweep},
           "shards": list(part.data.shape), "setup_s": setup_s,
           "rounds": ROUNDS, "wall_s": wall, "rounds_per_s": ROUNDS / wall,
           "fused_sweep_launches": launches,
           "threefry_launches": threefry_launches,
           "uses_kernel": fused_sweep.eligible(cfg),
           "last_tick": out["history"][-1],
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "kl_score": float(kl), "distribution_score": float(ds),
           "mode_coverage": float(hist2d.mode_coverage(pts, real, 16)),
           "sweep_kernels_per_round": sweep_calls, "profile": prof}
    emit(res)
    return res, launches


# FL-GAN and FeGAN on MNIST shapes: the archived reference runs
# (results/runs/{mnist-ref-iid1-flgan,mnist-ref-iid1-flgan-e5,
# mnist-ref-iid1-fegan}/config.json) on synthetic-mnist, as archived
# otherwise: W=10, iid=1, B=100, the ragged "epochs" sweep (FeGAN: 2 of the
# 10 workers a round); (algo, epoch, extra config, timed rounds)
FEDAVG_MNIST = dict(dataset="synthetic-mnist", num_workers=10, num_class=10,
                    num_sample=1000, iid=1, batch_size=100,
                    num_communication=20000)
FEDAVG_IMAGE_RUNS = (("flgan", 1, {}, 3), ("flgan", 5, {}, 1),
                     ("fegan", 1, {"frac_workers": 0.2}, 3))
# Card against CPU on the shrunk image setup.  The G's BatchNorm outputs
# now and then lie within float32 rounding of 0, so the LeakyReLU after one
# takes another slope on each device, that channel's gradient moves by ~10%
# of its leaf's scale and Adam carries it on
# (tests/test_torch_port_fedavg_image.py: the port and JAX on the CPU part so
# by up to 1.7e-2 of mu's scale in 3 rounds).  So params are held to
# TOL_SCALED of their group's largest entry, the Adam moments to 0.05,
# metrics to 1e-4; a wrong route or a missing term moves them by O(1).
TOL_IMAGE_FEDAVG = {"params": TOL_SCALED, "mu": 0.05, "nu": 0.05}


def fedavg_image_shrunk(conv=False):
    """The shrunk image setup of ``tests/test_torch_port_fedavg_image.py``
    (800 synthetic 28x28 images, 4 workers, B=32, the full-width MNIST G and
    D) through the port's own ``synthetic_mnist`` and ``partition``; with
    ``conv`` the images zero-padded to 32x32 and the conv pair, as
    ``load_partition`` does."""
    import numpy as np
    from cglgan_tpu_torch.core.config import FedGANConfig
    from cglgan_tpu_torch.data.mnist import synthetic_mnist
    from cglgan_tpu_torch.data.partition import partition
    imgs, labels = synthetic_mnist(n=800, seed=3)
    if conv:
        imgs = np.pad(imgs, ((0, 0), (2, 2), (2, 2)))
    part = partition(imgs.reshape(800, -1), labels, 4, 1, num_class=10,
                     num_sample=100, seed=FedGANConfig().seed)
    base = dict(dataset="synthetic-mnist", num_workers=4, num_class=10,
                num_sample=100, iid=1, batch_size=32, num_communication=8,
                conv=conv)
    return base, part


def step_plan(cfg, part, runner, rounds):
    """The ragged sweep's plan for ``rounds`` (round indices): the largest
    local step count and the lane-steps and sequential steps of the port's
    one masked sweep of every lane (in FeGAN's gather mode, of the sampled
    lanes, on average a round), with the step-count buckets the reference
    takes at full width beside them."""
    import numpy as np
    from cglgan_tpu_torch.algos.fedavg_family import (_local_steps,
                                                      _plan_buckets)
    steps = _local_steps(cfg, part.lengths)
    W, top = len(steps), int(steps.max())
    plan = {"steps": steps.tolist(), "max_steps": top,
            "sequential_steps_per_round": top,
            "lane_steps_per_round": W * top}
    schedule = (runner.extras or {}).get("schedule")
    if schedule is not None and schedule.shape[1] < W:
        lanes = [steps[schedule[t]] for t in rounds]
        plan["gather_lanes"] = int(schedule.shape[1])
        plan["lane_steps_per_round"] = float(np.mean(
            [len(x) * int(x.max()) for x in lanes]))
        plan["sequential_steps_per_round"] = float(np.mean(
            [int(x.max()) for x in lanes]))
        return plan
    buckets = _plan_buckets(steps)
    if buckets is not None:
        plan["reference_buckets"] = [[len(idx), mb] for idx, mb in buckets]
        plan["reference_sequential_steps"] = sum(mb for _, mb in buckets)
        plan["reference_lane_steps"] = sum(len(i) * mb for i, mb in buckets)
    return plan


def phase_fedavg_image_run(algo, epoch, extra, rounds, part,
                           check_sums=False, base=FEDAVG_MNIST,
                           phase="fedavg_image", profile_first=False):
    """One archived configuration (``base`` with ``extra``) at full width
    through ``build_runner``
    and ``train``: at epoch=1 1 warm-up round (at epoch=5 none: the
    epoch=1 run before it has warmed the same kernels and shapes), then
    ``rounds`` timed rounds; no kernel may launch (``fused_sweep`` and
    ``fused_dstep`` counts, set to 0 just before, stay 0); finite metrics
    and samples in [-1, 1]; at epoch=1 a 1-round profile (launches a round
    and a step, busy share) after the timed rounds, or with
    ``profile_first`` in place of the warm-up round (rounds of seconds:
    one round fewer), and with ``check_sums`` its sums held to
    ``key_averages()`` on one more round."""
    import torch
    from cglgan_tpu_torch.algos.registry import build_runner
    from cglgan_tpu_torch.algos.runner import train
    from cglgan_tpu_torch.core.config import FedGANConfig
    from cglgan_tpu_torch.ops import fused_dstep, fused_sweep
    from cglgan_tpu_torch.utils.profiling import profile_rounds

    cfg = FedGANConfig(algo=algo, epoch=epoch, **base, **extra)
    t0 = time.perf_counter()
    runner = build_runner(cfg, part)
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    prof = None
    if profile_first:          # the profiled round is the warm-up round
        state = runner.init_state()
        prof = profile_rounds(runner, state, 1)
    elif epoch == 1:
        state = train(runner, 1, eval_every=1, evaluator=False)["state"]
    else:
        state = runner.init_state()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    plan = step_plan(cfg, part, runner, range(state.t, state.t + rounds))
    torch.cuda.reset_peak_memory_stats()
    fused_sweep.launches = fused_dstep.launches = 0
    t0 = time.perf_counter()
    out = train(runner, rounds, eval_every=rounds, state=state,
                evaluator=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"fused_sweep": fused_sweep.launches,
                "fused_dstep": fused_dstep.launches}
    peak = torch.cuda.max_memory_allocated() / 1e9
    finite_metrics(out["history"])
    if any(launches.values()) or fused_sweep.eligible(cfg):
        raise AssertionError(f"{algo} epoch={epoch}: a kernel launched on "
                             f"the image FedAvg path: {launches}")
    samples = runner.sample(out["state"], 16)
    side = 32 if cfg.conv else 28                        # 28 -> 32 conv
    if tuple(samples.shape) != (16, 1, side, side) or \
            not bool(torch.isfinite(samples).all()) or \
            float(samples.abs().max()) > 1.0:
        raise AssertionError(f"{algo}: bad samples {tuple(samples.shape)}")
    res = {"phase": phase, "path": "autograd",
           "config": {"algo": algo, **base, "epoch": epoch, **extra},
           "shards": list(part.data.shape), "setup_s": setup_s,
           "warmup_round_s": warm_s, "rounds": rounds, "wall_s": wall,
           "rounds_per_s": rounds / wall, "s_per_round": wall / rounds,
           "plan": plan, "launches": launches,
           "last_tick": out["history"][-1], "peak_mem_gb": peak}
    if epoch == 1:
        t = state.t if profile_first else out["state"].t
        t0 = time.perf_counter()
        if prof is None:
            prof = profile_rounds(runner, out["state"], 1)
        prof["profile_s"] = warm_s if profile_first \
            else time.perf_counter() - t0
        prof["sequential_steps"] = step_plan(
            cfg, part, runner, [t])["sequential_steps_per_round"]
        prof["launches_per_step"] = (prof["kernel_launches_per_round"]
                                     / prof["sequential_steps"])
        res["profile"] = prof
    if check_sums:
        res["profile_sums"] = check_profile_sums(runner, out["state"])
    emit(res)
    return res


def check_profile_sums(runner, state):
    """``profile_rounds`` sums the profiler's raw device events
    (``utils/profiling.py`` ``device_kernel_sums``); hold them to
    ``key_averages()`` on one round: the same kernel names and launch
    counts, and device µs within 1 µs a launch (whole-µs rounding)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from cglgan_tpu_torch.utils.profiling import device_kernel_sums

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        runner.round_fn(state)
        torch.cuda.synchronize()
    raw = device_kernel_sums(prof)
    t0 = time.perf_counter()
    avg = {}
    for ev in prof.key_averages():
        if getattr(ev, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", 0.0)
        if us > 0:
            avg[ev.key] = (us, ev.count)
    avg_s = time.perf_counter() - t0
    both = set(raw) & set(avg)
    worst = max((abs(raw[k][0] - avg[k][0]) / raw[k][1] for k in both),
                default=0.0)
    res = {"phase": "fedavg_image",
           "what": "profile sums: raw device events vs key_averages()",
           "kernels": len(raw), "launches": sum(n for _, n in raw.values()),
           "device_us": {"raw": sum(us for us, _ in raw.values()),
                         "key_averages": sum(us for us, _ in avg.values())},
           "only_raw": sorted(set(raw) - both)[:4],
           "only_key_averages": sorted(set(avg) - both)[:4],
           "count_mismatches": sorted(k for k in both
                                      if raw[k][1] != avg[k][1])[:4],
           "max_us_diff_per_launch": worst, "key_averages_s": avg_s}
    if set(raw) != set(avg) or res["count_mismatches"] or worst > 1.0:
        raise AssertionError(f"profile sums disagree: {res}")
    return res


def phase_fedavg_image(part):
    """FL-GAN and FeGAN on MNIST shapes: the shrunk setup card against CPU
    (FL-GAN with ragged step counts, FeGAN in gather mode and at full
    width, FL-GAN's "batches" sweep, with dropout and in bf16), then the
    archived runs at full width.  ``part``: the synthetic-mnist partition
    of the archived runs."""
    from cglgan_tpu_torch.algos.fedavg_family import _local_steps
    from cglgan_tpu_torch.core.config import FedGANConfig

    t0 = time.perf_counter()
    base, small = fedavg_image_shrunk()
    flgan = FedGANConfig(algo="flgan", **base)
    if len(set(_local_steps(flgan, small.lengths).tolist())) < 2:
        raise AssertionError("the shrunk partition's step counts are equal")
    out = phase_reference_fedavg([
        (flgan, TOL_IMAGE_FEDAVG, 1e-4),
        (FedGANConfig(algo="fegan", frac_workers=0.5, **base),
         TOL_IMAGE_FEDAVG, 1e-4),
        (FedGANConfig(algo="fegan", frac_workers=1.0, **base),
         TOL_IMAGE_FEDAVG, 1e-4),
        (flgan.replace(local_sweep="batches", epoch=2), TOL_IMAGE_FEDAVG,
         1e-4),
        (flgan.replace(dropout_rate=0.5), TOL_IMAGE_FEDAVG, 1e-4),
        (flgan.replace(dtype="bfloat16"), TOL_BF16_SCALED,
         TOL_BF16_METRICS)], part=small)
    for algo, epoch, extra, rounds in FEDAVG_IMAGE_RUNS:
        out.append(phase_fedavg_image_run(algo, epoch, extra, rounds, part,
                                          check_sums=algo == "fegan"))
    emit({"phase": "fedavg_image", "seconds": time.perf_counter() - t0})
    return out


# The proxy image evaluator (phase eval_image).  Card against CPU on the same
# inputs: threefry's integer work is exact on both, and its float work is
# IEEE-rounded float32 or float64 ops, so bits, uniforms and randints must be
# equal.  Normals round a float64 log1p to float32; the card's and the CPU's
# log1p may differ in their last float64 bit, and where that moves the
# float32 rounding the polynomial after it carries one ulp to a few (on an
# H100: 15 of a million normals, at most 2 ulps apart).  So normals are
# held to TOL_NORMAL_ULPS, the bound the tests hold them to against JAX's.
# Features are one float32 forward pass (cuDNN convs and cuBLAS against the
# CPU's, TF32 off): 1e-5 of each feature set's largest entry, and the numpy
# mean / covariance of them as much.  FID is a difference of traces over a
# rank-deficient product (100 samples in 256-d) and is held relatively,
# 1e-4; IS, from softmax posteriors, 1e-5 relative.
TOL_EVAL_FEATURES = 1e-5
TOL_EVAL_FID = 1e-4
TOL_EVAL_IS = 1e-5
# Two probes trained 300 steps each, one on the card (cuDNN backward) and
# one on the CPU, part where a pre-activation within float32 rounding of 0
# flips a LeakyReLU slope, and Adam carries the flip on.  On an H100 (700 W)
# the leaves were 1.1e-4 of their scale apart and the IS of the real images
# equal; a flipped slope moves a leaf by up to ~1e-2 of its scale (the
# kernel phases' limit for the same effect).  So each param leaf is held
# to 1e-2 of its largest entry, and their IS of the same images to 1e-3
# relative.
TOL_TWO_PROBES = 1e-2
TOL_TWO_PROBES_IS = 1e-3
EVAL_TICKS = 5


def _rel_err(got, ref):
    import numpy as np
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


def threefry_card_vs_cpu():
    """threefry's draws on the card against the CPU's, at the evaluator's
    shapes and a million elements: the largest |card - cpu| of each (0 is
    equal) and, for normals, the number of elements that differ and the
    largest difference in ulps."""
    import torch
    from cglgan_tpu_torch.core import prng, threefry

    def draws(dev):
        key = threefry.key(20211212, dev)
        sub = threefry.split(key, 4)[3]
        big = (1 << 20,)
        return {"bits": threefry.random_bits(key, big),
                "fold_in": threefry.fold_in(sub, 6),
                "uniform": threefry.uniform(key, big),
                "uniform_conv_bound": threefry.uniform(sub, big, -1 / 3,
                                                       1 / 3),
                "normal": threefry.normal(key, big),
                "eval_z": prng.eval_z(20211212, (100, 100), dev, 0),
                "randint_20000": threefry.randint(sub, (256,), 0, 20000),
                "randint_int32": threefry.randint(key, big, 0, 2**31 - 1)}

    card, cpu = draws("cuda"), draws("cpu")
    res = {}
    for name, x in card.items():
        x = x.cpu()
        res[name] = float((x.double() - cpu[name].double()).abs().max())
        if x.dtype != cpu[name].dtype or x.shape != cpu[name].shape:
            raise AssertionError(f"threefry {name}: {x.dtype} {x.shape}")
    float_draws = ("normal", "eval_z")
    differ = {k: int((card[k].cpu() != cpu[k]).sum()) for k in float_draws}
    ulps = {k: int((card[k].cpu().view(torch.int32).long()
                    - cpu[k].view(torch.int32).long()).abs().max())
            for k in float_draws}
    bad = [k for k, v in res.items() if k not in float_draws and v != 0] \
        + [k for k in float_draws if ulps[k] > TOL_NORMAL_ULPS]
    if bad:
        raise AssertionError(f"threefry card and CPU draws differ: {bad} "
                             f"{res} {ulps}")
    return {"max_abs_err": res, "normal_elements_differing": differ,
            "normal_max_ulps": ulps, "tol_normal_ulps": TOL_NORMAL_ULPS}


def phase_eval_image(card, part):
    """The proxy evaluator (FID / IS) on the main path's config (CAP-GAN,
    synthetic-mnist, W=16, B=100, epoch=5): threefry and the extractor's
    weights card against CPU; the probe's 300 steps on the card; each part
    of a tick timed (sample, features, stats, sqrtm, IS); features, stats,
    FID and IS card against CPU with the card's probe carried over; the
    card probe against one trained on the CPU; FID and IS with cuDNN TF32
    on; then ``train(runner, 4, eval_every=2)`` with the default evaluator
    (``fused_dstep``'s count, set to 0 just before, must be 4).  Returns
    that count."""
    import numpy as np
    import torch
    from cglgan_tpu_torch.algos.registry import build_runner
    from cglgan_tpu_torch.algos.runner import train
    from cglgan_tpu_torch.core.config import FedGANConfig
    from cglgan_tpu_torch.evalx import fid
    from cglgan_tpu_torch.evalx.evaluator import make_evaluator
    from cglgan_tpu_torch.ops import fused_dstep
    from cglgan_tpu_torch.utils.tree import tree_leaves, tree_map

    t_phase = time.perf_counter()
    res = {"phase": "eval_image", "card": card,
           "threefry": threefry_card_vs_cpu()}
    cfg = FedGANConfig(algo="capgan", epoch=5, **MAIN)
    side, n, steps = cfg.img_size, 100, 300

    ext = fid.conv_feature_extractor(side, device="cuda")
    ext_cpu = fid.conv_feature_extractor(side, device="cpu")
    res["extractor_weights_max_abs_err"] = max(
        float((a.cpu() - b).abs().max())
        for a, b in zip(tree_leaves(ext.params), tree_leaves(ext_cpu.params)))
    # normals at most TOL_NORMAL_ULPS apart, times a scale below 0.5
    if res["extractor_weights_max_abs_err"] > 1e-6:
        raise AssertionError(f"extractor weights differ: {res}")

    runner = build_runner(cfg, part)
    state = train(runner, 4, eval_every=4, evaluator=False)["state"]
    # the evaluator's probe set, as make_evaluator draws it
    data_all = part.data.reshape(-1, side, side)
    labels_all = part.labels.reshape(-1)
    sel = np.random.default_rng(cfg.seed).permutation(len(data_all))[:20000]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    probe = fid.classifier_probe(data_all[sel], labels_all[sel],
                                 cfg.num_class, steps=steps, device="cuda")
    torch.cuda.synchronize()
    res["probe_s"] = time.perf_counter() - t0
    real = ((part.eval_pool[:n].astype(np.float32) / 255.0 - 0.5) / 0.5) \
        .reshape(-1, 1, side, side)
    mu_r, cov_r = fid.activation_stats(ext, real)

    # a tick, part by part (mean of EVAL_TICKS after one warm-up)
    parts = {k: 0.0 for k in ("sample", "features", "stats", "sqrtm", "is")}
    for tick in range(EVAL_TICKS + 1):
        keep = tick > 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gen = runner.sample(state, n).reshape(-1, 1, side, side)[:n]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        feats = fid._features(ext, gen)
        t2 = time.perf_counter()
        mu_g, cov_g = feats.mean(0), np.cov(feats, rowvar=False)
        t3 = time.perf_counter()
        fid_card = fid.frechet_distance(mu_g, cov_g, mu_r, cov_r)
        t4 = time.perf_counter()
        is_card = fid.inception_score(probe, gen, cfg.num_class)
        t5 = time.perf_counter()
        for k, dt in zip(parts, (t1 - t0, t2 - t1, t3 - t2, t4 - t3,
                                 t5 - t4)):
            parts[k] += dt * 1e3 / EVAL_TICKS if keep else 0.0
    res["tick_ms"] = {**parts, "total": sum(parts.values())}
    res["fid"], res["inception_score"] = fid_card, is_card

    # card against CPU, the card's probe carried over, the same samples
    gen_cpu = gen.cpu()
    probe_cpu = fid.Extractor(tree_map(lambda x: x.cpu(), probe.params),
                              probe.apply)
    mu_c, cov_c = fid.activation_stats(ext_cpu, gen_cpu)
    mu_rc, cov_rc = fid.activation_stats(ext_cpu, real)
    fid_cpu = fid.frechet_distance(mu_c, cov_c, mu_rc, cov_rc)
    is_cpu = fid.inception_score(probe_cpu, gen_cpu, cfg.num_class)
    errs = {"features": _rel_err(feats, fid._features(ext_cpu, gen_cpu)),
            "probe_features": _rel_err(fid._features(probe, gen),
                                       fid._features(probe_cpu, gen_cpu)),
            "mu": _rel_err(mu_g, mu_c), "cov": _rel_err(cov_g, cov_c),
            "real_mu": _rel_err(mu_r, mu_rc),
            "real_cov": _rel_err(cov_r, cov_rc),
            "fid": abs(fid_card - fid_cpu) / abs(fid_cpu),
            "inception_score": abs(is_card - is_cpu) / is_cpu}
    tols = {"fid": TOL_EVAL_FID, "inception_score": TOL_EVAL_IS}
    res["card_vs_cpu"] = {"rel_err": errs, "fid_cpu": fid_cpu,
                          "inception_score_cpu": is_cpu,
                          "tol": {**tols, "others": TOL_EVAL_FEATURES}}
    if any(v > tols.get(k, TOL_EVAL_FEATURES) for k, v in errs.items()):
        raise AssertionError(f"evaluator card and CPU disagree: {res}")

    # the same probe set trained on the CPU
    t0 = time.perf_counter()
    probe_host = fid.classifier_probe(data_all[sel], labels_all[sel],
                                      cfg.num_class, steps=steps,
                                      device="cpu")
    host_s = time.perf_counter() - t0
    leaf_gap = max(_rel_err(a.cpu(), b) for a, b in zip(
        tree_leaves(probe.params), tree_leaves(probe_host.params)))
    # IS of the samples, and of the real images (where the probe's classes
    # are sharp and IS is far from 1)
    scores = {k: (fid.inception_score(probe_cpu, x, cfg.num_class),
                  fid.inception_score(probe_host, x, cfg.num_class))
              for k, x in (("samples", gen_cpu), ("real", real))}
    gaps = {k: abs(a - b) / b for k, (a, b) in scores.items()}
    res["two_probes"] = {
        "cpu_probe_s": host_s, "params_max_scaled_gap": leaf_gap,
        "inception_score_rel_gap": gaps, "inception_scores": scores,
        "tol": {"params": TOL_TWO_PROBES, "inception_score":
                TOL_TWO_PROBES_IS}}
    if leaf_gap > TOL_TWO_PROBES or max(gaps.values()) > TOL_TWO_PROBES_IS:
        raise AssertionError(f"the card and CPU probes part: {res}")

    # make_evaluator on the card: the same metrics as the parts above
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    evaluate = make_evaluator(cfg, part)
    torch.cuda.synchronize()
    res["make_evaluator_s"] = time.perf_counter() - t0
    got = evaluate(runner, state)
    t0 = time.perf_counter()
    for _ in range(EVAL_TICKS):
        evaluate(runner, state)
    res["evaluate_ms"] = (time.perf_counter() - t0) * 1e3 / EVAL_TICKS
    # the same extractor and samples give the same FID; its own probe is a
    # second card-trained one (cuDNN's weight gradients may sum in another
    # order from one run to the next)
    res["make_evaluator_vs_parts"] = {
        "fid_rel": abs(got["fid"] - fid_card) / fid_card,
        "inception_score_rel": abs(got["inception_score"] - is_card)
        / is_card}
    if got["fid"] != fid_card or \
            res["make_evaluator_vs_parts"]["inception_score_rel"] \
            > TOL_TWO_PROBES_IS:
        raise AssertionError(f"make_evaluator {got} against its parts {res}")

    # what the default cuDNN TF32 moves: the evaluator built and run with
    # it on (the rest of this script turns it off), on a line of its own
    torch.backends.cudnn.allow_tf32 = True
    try:
        tf32 = make_evaluator(cfg, part)(runner, state)
    finally:
        torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "eval_image", "cudnn_tf32": True, "card": card, **tf32,
          "fid_rel_moved": abs(tf32["fid"] - fid_card) / fid_card,
          "inception_score_rel_moved":
          abs(tf32["inception_score"] - is_card) / is_card})

    # the main path with train's default evaluator
    fused_dstep.launches = 0
    t0 = time.perf_counter()
    out = train(runner, 4, eval_every=2, state=state)
    torch.cuda.synchronize()
    res["train_s"] = time.perf_counter() - t0
    launches = fused_dstep.launches
    ticks = out["history"]
    if launches != 4 or len(ticks) != 2 or not all(
            math.isfinite(t["fid"]) and math.isfinite(t["inception_score"])
            for t in ticks):
        raise AssertionError(f"train with the default evaluator: "
                             f"{launches} launches, ticks {ticks}")
    res["train_ticks"] = [{k: t[k] for k in ("round", "fid",
                                             "inception_score", "d_loss",
                                             "g_loss")} for t in ticks]
    res["fused_dstep_launches"] = launches
    res["seconds"] = time.perf_counter() - t_phase
    emit(res)
    return launches

# ---------------------------------------------------------------------------
# The conv LSGAN family on the CGL family (phase conv): the study's conv
# flagship, results/runs/mnist-iid1-cglgan-conv/config.json (CGL-GAN, W=16,
# S=4, B=100, iid=1, cloud sync every round, segema 0), at epoch 1 and 5,
# and CAP-GAN conv on the main path's layout (W=16, S=1).  No TPU kernel
# runs here, as in the reference (its fused_dstep refuses a conv D):
# fused_dstep's count must stay 0.
# ---------------------------------------------------------------------------

CGL_CONV = dict(dataset="synthetic-mnist", num_workers=16, num_servers=4,
                iid=1, batch_size=100, cloud_epoch=1, segema=0.0,
                num_communication=20000, conv=True)
CAP_CONV = dict(MAIN, conv=True)
CONV_RUNS = (("cglgan conv", "cglgan", CGL_CONV, 1),
             ("cglgan conv", "cglgan", CGL_CONV, 5),
             ("capgan conv", "capgan", CAP_CONV, 5))
CONV_ROUNDS = 10
# the card-against-CPU rounds at batch 25 (the CPU takes ~15 s a round at
# B=100): the same widths, workers and servers
CONV_REF_BATCH = 25
# Card against CPU, 2 conv rounds from one init and one stream (the dropout
# keys included): cuDNN and the CPU's convolutions sum in other orders, and
# Adam turns the rounding of a near-zero gradient (the conv biases before a
# BatchNorm, the D's BN shifts) into a full step of either sign, up to lr
# (2e-4) a step on a few elements (tests/test_torch_port_conv.py measures
# the same against JAX on the CPU).  Held to the kernel phases' 1e-2 of a
# group's largest entry, metrics (losses ~0.7) to 1e-4 absolute.
TOL_CONV_SCALED = 1e-2


def phase_conv(parts_of):
    """The conv CGL-GAN flagship card against CPU for 2 rounds (batch
    CONV_REF_BATCH), then each of CONV_RUNS at full width: 2 warm-up and
    CONV_ROUNDS timed rounds (rounds/s, device ms and launches a round from
    the profile, peak memory); ``fused_dstep`` never launches."""
    from cglgan_tpu_torch.core.config import FedGANConfig

    t0 = time.perf_counter()
    part = parts_of("cglgan", CGL_CONV)
    if part.data.shape[2] != 32 * 32:
        raise AssertionError(f"conv shards are not 32x32: {part.data.shape}")
    reference_rounds("cglgan conv", FedGANConfig(
        algo="cglgan", epoch=1, **dict(CGL_CONV, batch_size=CONV_REF_BATCH)),
        part, 2, tol=TOL_CONV_SCALED)
    launches = {}
    for label, algo, base, epoch in CONV_RUNS:
        # one partition for all: 16 workers at iid=1 hold the same shards
        # whatever the servers
        _, n = phase_rounds("conv", label, algo, base, epoch, part,
                            rounds=CONV_ROUNDS)
        launches[f"{label} e{epoch}"] = n
    emit({"phase": "conv", "fused_dstep_launches": launches,
          "seconds": time.perf_counter() - t0})


# ---------------------------------------------------------------------------
# The conv LSGAN pair on the MD-GAN and FedAvg families (phase
# conv_baselines), float32.  MD-GAN: the archived
# results/runs/mnist-iid1-mdgan-conv/config.json (W=16, S=1, B=100, iid=1,
# E=0) at epoch 1 and 5, then at epoch 1 with the ring D-swap every 2
# rounds; AC-GAN at W=16 / S=4 with the delta gossip every 2 rounds.
# FL-GAN and FeGAN: results/runs/mnist-iid1-{flgan,fegan}/config.json (W=16,
# B=100, iid=1, the ragged "epochs" sweep, FeGAN at frac 1.0) with
# conv=True.  No TPU kernel runs here, as in the reference (its fused_dstep
# refuses a conv D, its fused_sweep takes 2DMG MLPs only): both counts must
# stay 0.
# ---------------------------------------------------------------------------

MDGAN_CONV = dict(dataset="synthetic-mnist", num_workers=16, num_servers=1,
                  iid=1, batch_size=100, num_communication=20000, conv=True)
ACGAN_CONV = dict(MDGAN_CONV, num_servers=4)
MDGAN_CONV_RUNS = (("mdgan conv", "mdgan", MDGAN_CONV, 1, {}),
                   ("mdgan conv", "mdgan", MDGAN_CONV, 5, {}),
                   ("mdgan conv ring", "mdgan", MDGAN_CONV, 1,
                    dict(E=2, d_swap="ring")),
                   ("acgan conv delta", "acgan", ACGAN_CONV, 1,
                    dict(E=2, gossip="delta")))
FEDAVG_CONV = dict(FEDAVG_MNIST, num_workers=16, conv=True)
# (algo, extra config, timed rounds): the profiled round first, as the
# warm-up (a round is ~20 s on the card), then 1 timed round each
FEDAVG_CONV_RUNS = (("flgan", {}, 1), ("fegan", {"frac_workers": 1.0}, 1))
# Card against CPU on the shrunk image setup with the conv pair: FL-GAN and
# FeGAN in gather mode.  Params are held to TOL_CONV_SCALED; the Adam
# moments to TOL_IMAGE_FEDAVG's 0.05 of their group's largest entry: a G
# BatchNorm output within float32 rounding of 0 takes another LeakyReLU
# slope on each device, and the lanes' several G steps a round compound it
# (tests/test_torch_port_conv_fedavg.py: the port and JAX on the CPU part so
# by up to 0.034 of the G's mu scale in 2 rounds, and the port in float32
# from itself in float64 as much).
TOL_CONV_FEDAVG = {"params": TOL_CONV_SCALED, "mu": 0.05, "nu": 0.05}


def phase_conv_baselines(parts_of):
    """MD-GAN conv card against CPU for 2 rounds (batch CONV_REF_BATCH), then
    each of MDGAN_CONV_RUNS at full width (2 warm-up and CONV_ROUNDS timed
    rounds: rounds/s, device ms and launches a round from the profile, peak
    memory); FL-GAN and FeGAN (gather mode) conv on the shrunk image setup
    card against CPU for 2 rounds, then each of FEDAVG_CONV_RUNS at full
    width with the sweep's sequential steps and lane-steps beside the
    reference's bucket plan.  Neither ``fused_dstep`` nor ``fused_sweep``
    launches."""
    from cglgan_tpu_torch.core.config import FedGANConfig

    t0 = time.perf_counter()
    part = parts_of("mdgan", MDGAN_CONV)
    if part.data.shape[2] != 32 * 32:
        raise AssertionError(f"conv shards are not 32x32: {part.data.shape}")
    reference_rounds("mdgan conv", FedGANConfig(
        algo="mdgan", epoch=1, **dict(MDGAN_CONV, batch_size=CONV_REF_BATCH)),
        part, 2, tol=TOL_CONV_SCALED)
    base, small = fedavg_image_shrunk(conv=True)
    phase_reference_fedavg([
        (FedGANConfig(algo="flgan", **base), TOL_CONV_FEDAVG, 1e-4),
        (FedGANConfig(algo="fegan", frac_workers=0.5, **base),
         TOL_CONV_FEDAVG, 1e-4)], part=small, rounds=2)
    launches = {}
    for label, algo, cbase, epoch, extra in MDGAN_CONV_RUNS:
        # one partition for both: 16 workers at iid=1 hold the same shards
        # whatever the servers
        res, _ = phase_rounds("conv_baselines", label, algo, cbase, epoch,
                              part, rounds=CONV_ROUNDS, **extra)
        launches[f"{label} e{epoch}"] = {
            "fused_dstep": res["fused_dstep_launches"],
            "fused_sweep": res["fused_sweep_launches"]}
    fedavg_part = parts_of("flgan", FEDAVG_CONV)
    for algo, extra, rounds in FEDAVG_CONV_RUNS:
        res = phase_fedavg_image_run(algo, 1, extra, rounds, fedavg_part,
                                     base=FEDAVG_CONV, phase="conv_baselines",
                                     profile_first=True)
        launches[algo] = res["launches"]
    if any(n for run in launches.values() for n in run.values()):
        raise AssertionError(f"a kernel launched on a conv path: {launches}")
    emit({"phase": "conv_baselines", "launches": launches,
          "seconds": time.perf_counter() - t0})


# ---------------------------------------------------------------------------
# The conv LSGAN pair in bfloat16 (phase conv_bf16), on the three families.
# Card against CPU for 2 rounds from one init and one stream: the conv
# flagship at B=25, MD-GAN conv at B=25, FL-GAN and FeGAN (gather mode) conv
# on the shrunk image setup.  Then at full width: the conv flagship
# results/runs/mnist-iid1-cglgan-conv/config.json at epoch 1 in float32 and
# in bf16 in this one call (wall time moves up to 2.9x between calls),
# CAP-GAN conv (W=16, S=1) at epoch 5, results/runs/mnist-iid1-mdgan-conv
# at epoch 1, AC-GAN conv (W=16, S=4) with the delta gossip at E=2, 2
# warm-up and CONV_ROUNDS timed rounds each, and FL-GAN conv
# (results/runs/mnist-iid1-flgan with conv=True, W=16) 1 timed round after
# a profiled one.  No TPU kernel runs on these paths, as in the reference
# (fused_dstep refuses a conv D, fused_sweep takes 2DMG float32 MLPs only):
# both counts must stay 0.  build_runner turns cuBLAS's bf16
# reduced-precision reduction off (algos/registry.py); the phase measures
# what turning it back on moves on the flagship's card rounds.
# ---------------------------------------------------------------------------

CONV_BF16_RUNS = (("capgan conv", "capgan", CAP_CONV, 5, {}),
                  ("mdgan conv", "mdgan", MDGAN_CONV, 1, {}),
                  ("acgan conv delta", "acgan", ACGAN_CONV, 1,
                   dict(E=2, gossip="delta")))
# Card against CPU in bf16: phase_reference_bf16's limits (params 2^-5 of a
# group's largest entry, moments 0.2, metrics 1e-2), but for the moments of
# the sum biases (``is_sum_bias``: the conv biases and the D's adv bias, 8
# leaves of a conv G / D pair), which are reported apart and not held.
# Their gradients are sums of up to 25 600 terms a member at B=25 (the
# batch and every pixel), near-cancelling behind a BatchNorm, which cuDNN
# and the CPU add in other orders; Adam turns the rounding into a step of
# either sign.  Measured on an H100 after 2 rounds: the flagship's D
# sum-bias mu 0.67 of its group's scale apart, MD-GAN conv's 0.47, FL-GAN
# and FeGAN's at most 0.03; every held group within 0.091 of its scale.
# Their params are held with the rest.
TOL_CONV_BF16 = TOL_BF16_SCALED
TOL_CONV_BF16_METRICS = TOL_BF16_METRICS


def reduction_moves(cfg, part, rounds):
    """The card's rounds of ``cfg`` with cuBLAS's bf16 reduced-precision
    reduction allowed against the same rounds without it (what
    ``build_runner`` sets), from one init and one stream: per group the
    largest |on - off| over the group's largest entry, and the metrics'
    largest difference.  Leaves the reduction off."""
    import torch
    from cglgan_tpu_torch.algos.registry import build_runner
    from cglgan_tpu_torch.core import prng

    runner = build_runner(cfg, part)
    out = {}
    for allowed in (False, True):
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction \
            = allowed
        state = runner.init_state()
        for t in range(rounds):
            state, m = runner.round_fn(state, prng.round_streams(
                cfg, t, part.data.shape[1], "cpu"))
        out[allowed] = (state, m)
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    (on, m_on), (off, m_off) = out[True], out[False]
    return {"max_scaled_diff": state_errs(on, off, apart=True),
            "metrics_max_abs_diff": max(abs(float(m_on[k]) - float(m_off[k]))
                                        for k in m_on)}


def run_summary(res):
    """One full-width run's figures: rounds/s (seconds a round), device ms,
    launches and busy share a round from its profile, peak memory and the
    top kernel by device time."""
    prof = res["profile"]
    top = prof["top"][0]
    out = {"config": res["config"], "rounds": res["rounds"],
           "rounds_per_s": res["rounds_per_s"],
           "device_ms_per_round": prof["device_ms_per_round"],
           "launches_per_round": prof["kernel_launches_per_round"],
           "busy_share": prof["device_busy_share"],
           "peak_mem_gb": res["peak_mem_gb"],
           "top_kernel": top["kernel"], "top_ms_per_round": top[
               "ms_per_round"], "top_calls_per_round": top["calls_per_round"]}
    if "s_per_round" in res:
        out["s_per_round"] = res["s_per_round"]
    return out


def phase_conv_bf16(parts_of):
    """Conv in bf16: card against CPU for 2 rounds (the flagship and MD-GAN
    at batch CONV_REF_BATCH, FL-GAN and FeGAN gather on the shrunk image
    setup) and what cuBLAS's reduced-precision reduction would move; then
    the flagship at full width in float32 and bf16, and CONV_BF16_RUNS and
    FL-GAN conv in bf16, each with rounds/s, device ms, launches, peak
    memory and top kernel.  Neither ``fused_dstep`` nor ``fused_sweep``
    launches."""
    import torch
    from cglgan_tpu_torch.core.config import FedGANConfig

    t0 = time.perf_counter()
    bf = dict(dtype="bfloat16")
    part = parts_of("cglgan", CGL_CONV)
    if part.data.shape[2] != 32 * 32:
        raise AssertionError(f"conv shards are not 32x32: {part.data.shape}")
    md_part = parts_of("mdgan", MDGAN_CONV)
    tols = (TOL_CONV_BF16, TOL_CONV_BF16_METRICS)
    flagship_ref = FedGANConfig(algo="cglgan", epoch=1, **bf, **dict(
        CGL_CONV, batch_size=CONV_REF_BATCH))
    reference_rounds("cglgan conv bf16", flagship_ref, part, 2, *tols,
                     apart=True)
    if torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction:
        raise AssertionError("build_runner left cuBLAS's bf16 reduced-"
                             "precision reduction on")
    reference_rounds("mdgan conv bf16", FedGANConfig(
        algo="mdgan", epoch=1, **bf, **dict(
            MDGAN_CONV, batch_size=CONV_REF_BATCH)), md_part, 2, *tols,
        apart=True)
    base, small = fedavg_image_shrunk(conv=True)
    phase_reference_fedavg([
        (FedGANConfig(algo="flgan", **bf, **base), *tols),
        (FedGANConfig(algo="fegan", frac_workers=0.5, **bf, **base),
         *tols)], part=small, rounds=2, apart=True)
    emit({"phase": "conv_bf16", "algo": "cglgan conv bf16",
          "cublas_bf16_reduced_precision_reduction": "off (build_runner)",
          "if_on": reduction_moves(flagship_ref, part, 2)})
    runs, launches = [], {}
    for dtype in ("float32", "bfloat16"):
        res, n = phase_rounds("conv_bf16", "cglgan conv", "cglgan", CGL_CONV,
                              1, part, rounds=CONV_ROUNDS, dtype=dtype)
        runs.append(run_summary(res))
        launches[f"cglgan conv {dtype}"] = {
            "fused_dstep": n, "fused_sweep": res["fused_sweep_launches"]}
    for label, algo, cbase, epoch, extra in CONV_BF16_RUNS:
        res, n = phase_rounds("conv_bf16", label, algo, cbase, epoch,
                              parts_of(algo, cbase), rounds=CONV_ROUNDS,
                              **bf, **extra)
        runs.append(run_summary(res))
        launches[f"{label} e{epoch} bf16"] = {
            "fused_dstep": n, "fused_sweep": res["fused_sweep_launches"]}
    res = phase_fedavg_image_run("flgan", 1, bf, 1,
                                 parts_of("flgan", FEDAVG_CONV),
                                 base=FEDAVG_CONV, phase="conv_bf16",
                                 profile_first=True)
    runs.append(run_summary(res))
    launches["flgan conv bf16"] = res["launches"]
    if any(n for run in launches.values() for n in run.values()):
        raise AssertionError(f"a kernel launched on a conv path: {launches}")
    emit({"phase": "conv_bf16", "runs": runs, "launches": launches,
          "seconds": time.perf_counter() - t0})


# ---------------------------------------------------------------------------
# InceptionV3 pool3 (phase inception): random weights from inception_init
# (no pretrained weights exist offline), written to an .npz and loaded back
# through the evaluator's entry point.  pool3 is F.conv2d / pools on cuDNN,
# as the reference's is XLA: no TPU kernel.
# ---------------------------------------------------------------------------

# card against CPU on the same weights and samples: 94 convs in float32, sums
# in another order; features held to 1e-4 of their largest entry, FID of
# rank-99 covariances in 2048-d to 1e-3 relative (the CPU tests' limits
# against the reference).  The CPU's pool3 takes ~17 s a 100 images and
# each 2048-d sqrtm ~20 s on the card machine's host: the CPU scores the
# samples against the card's real statistics, and TF32's move is read off
# the features.
TOL_POOL3 = 1e-4
TOL_POOL3_FID = 1e-3
POOL3_REPS = 5


def phase_inception(card, part_main, part_conv):
    """pool3 on the main config's samples: ms for 100 images at 299^2 and
    for ``preprocess``; the host's ``sqrtm`` at 2048-d (s, once); features
    and FID card against CPU; what cuDNN TF32 moves (features, stats,
    pool3 ms); a ``fid_stats`` round trip; then 4 rounds of conv CGL-GAN
    ``train`` with ``make_evaluator(inception_weights=..., fid_stats=...)``
    at one tick."""
    import tempfile

    import numpy as np
    import torch
    from cglgan_tpu_torch.algos.registry import build_runner
    from cglgan_tpu_torch.algos.runner import train
    from cglgan_tpu_torch.core import threefry
    from cglgan_tpu_torch.core.config import FedGANConfig
    from cglgan_tpu_torch.evalx import fid, inception
    from cglgan_tpu_torch.evalx.evaluator import make_evaluator
    from cglgan_tpu_torch.ops import fused_dstep

    t_phase = time.perf_counter()
    res = {"phase": "inception", "card": card}
    tmp = tempfile.TemporaryDirectory()
    try:
        t0 = time.perf_counter()
        params = inception.inception_init(threefry.key(0, "cuda"))
        torch.cuda.synchronize()
        res["init_s"] = time.perf_counter() - t0
        path = os.path.join(tmp.name, "pool3.npz")
        np.savez(path, **{k: v.cpu().numpy() for k, v in params.items()})
        ext = inception.inception_extractor(
            inception.load_inception_weights(path))
        ext_cpu = inception.inception_extractor(
            inception.load_inception_weights(path, device="cpu"))
        if any(not torch.equal(ext.params[k].cpu(), v)
               for k, v in ext_cpu.params.items()):
            raise AssertionError("pool3 weights changed in the .npz trip")

        # the main config's samples after 4 rounds
        cfg = FedGANConfig(algo="capgan", epoch=5, **MAIN)
        side, n = cfg.img_size, 100
        runner = build_runner(cfg, part_main)
        state = train(runner, 4, eval_every=4, evaluator=False)["state"]
        gen = runner.sample(state, n).reshape(-1, 1, side, side)[:n]
        real = ((part_main.eval_pool[:n].astype(np.float32) / 255.0 - 0.5)
                / 0.5).reshape(-1, 1, side, side)
        x = inception.preprocess(gen)
        res["preprocess_ms"] = cuda_ms(lambda: inception.preprocess(gen),
                                       POOL3_REPS)
        res["pool3_ms_100"] = cuda_ms(
            lambda: inception.inception_pool3(ext.params, x), POOL3_REPS)
        feats = fid._features(ext, gen)
        mu_g, cov_g = feats.mean(0), np.cov(feats, rowvar=False)
        mu_r, cov_r = fid.activation_stats(ext, real)
        t0 = time.perf_counter()
        fid_card = fid.frechet_distance(mu_g, cov_g, mu_r, cov_r)
        res["sqrtm_s_2048"] = time.perf_counter() - t0
        res["fid"] = fid_card

        # card against CPU: the same weights, the same samples
        gen_cpu = gen.cpu()
        t0 = time.perf_counter()
        feats_cpu = fid._features(ext_cpu, gen_cpu)
        res["pool3_cpu_s_100"] = time.perf_counter() - t0
        mu_c, cov_c = feats_cpu.mean(0), np.cov(feats_cpu, rowvar=False)
        fid_cpu = fid.frechet_distance(mu_c, cov_c, mu_r, cov_r)
        errs = {"features": _rel_err(feats, feats_cpu),
                "mu": _rel_err(mu_g, mu_c), "cov": _rel_err(cov_g, cov_c),
                "fid": abs(fid_card - fid_cpu) / abs(fid_cpu)}
        res["card_vs_cpu"] = {"rel_err": errs, "fid_cpu": fid_cpu,
                              "tol": {"others": TOL_POOL3,
                                      "fid": TOL_POOL3_FID}}
        if errs["fid"] > TOL_POOL3_FID or max(
                v for k, v in errs.items() if k != "fid") > TOL_POOL3:
            raise AssertionError(f"pool3 card and CPU disagree: {res}")

        # what cuDNN's default TF32 moves (the script runs with it off)
        torch.backends.cudnn.allow_tf32 = True
        try:
            feats_tf32 = fid._features(ext, gen)
            pool3_tf32_ms = cuda_ms(
                lambda: inception.inception_pool3(ext.params, x), POOL3_REPS)
        finally:
            torch.backends.cudnn.allow_tf32 = False
        res["cudnn_tf32"] = {
            "features_rel_moved": _rel_err(feats_tf32, feats),
            "mu_rel_moved": _rel_err(feats_tf32.mean(0), mu_g),
            "cov_rel_moved": _rel_err(np.cov(feats_tf32, rowvar=False),
                                      cov_g),
            "pool3_ms_100": pool3_tf32_ms}

        # fid_stats round trip at the conv config's 32 px, then conv
        # CGL-GAN train with the pool3 evaluator at one tick
        cfg_conv = FedGANConfig(algo="cglgan", epoch=1, **CGL_CONV)
        side_c = cfg_conv.img_size + 4
        real_c = ((part_conv.eval_pool[:n].astype(np.float32) / 255.0 - 0.5)
                  / 0.5).reshape(-1, 1, side_c, side_c)
        mu_s, cov_s = fid.activation_stats(ext, real_c)
        stats = os.path.join(tmp.name, "pool3_stats_32.npz")
        inception.save_fid_stats(stats, mu_s, cov_s, side=side_c)
        mu_l, cov_l = inception.load_fid_stats(stats, expect_side=side_c)
        if not (np.array_equal(mu_l, mu_s) and np.array_equal(cov_l, cov_s)):
            raise AssertionError("fid_stats changed in the .npz trip")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        evaluate = make_evaluator(cfg_conv, part_conv,
                                  inception_weights=path, fid_stats=stats)
        torch.cuda.synchronize()
        res["make_evaluator_s"] = time.perf_counter() - t0
        runner_c = build_runner(cfg_conv, part_conv)
        fused_dstep.launches = 0
        t0 = time.perf_counter()
        out = train(runner_c, 4, eval_every=4, evaluator=evaluate)
        torch.cuda.synchronize()
        res["train_s"] = time.perf_counter() - t0
        ticks = out["history"]
        if fused_dstep.launches != 0 or len(ticks) != 1 or not all(
                math.isfinite(t["fid"]) and math.isfinite(
                    t["inception_score"]) for t in ticks):
            raise AssertionError(f"conv train with the pool3 evaluator: "
                                 f"{fused_dstep.launches} launches, "
                                 f"ticks {ticks}")
        res["train_tick"] = {k: ticks[0][k] for k in (
            "round", "fid", "inception_score", "d_loss", "g_loss")}
        res["fused_dstep_launches"] = fused_dstep.launches
    finally:
        tmp.cleanup()
    res["seconds"] = time.perf_counter() - t_phase
    emit(res)


# The CLI phase: the main config and the FL-GAN 2DMG kernel path through
# ``python -m cglgan_tpu_torch.cli run``, called in process so that the
# wrappers' counts can be read; 40 rounds, a tick and a checkpoint every
# 20, then the same command resumed from its ckpt_20 in a second run dir.
CLI_RUN = ("--rounds", "40", "--num-plt", "20", "--ckpt-every", "20")
CLI_CAPGAN = ("run", "capgan", "--dataset", "synthetic-mnist",
              "--num-workers", "16", "--num-servers", "1", "--iid", "1",
              "--batch-size", "100", "--epoch", "5")
CLI_FLGAN = ("run", "flgan", "--dataset", "2dmg", "--num-workers", "16",
             "--num-class", "8", "--num-sample", "1000", "--batch-size",
             "100", "--iid", "1", "--epoch", "5", "--pallas-sweep", "on")


def cli_call(argv):
    """``cglgan_tpu_torch.cli.main(argv)`` in this process with its output
    kept; returns (output lines, seconds).  A non-zero exit raises, and
    any failure prints the command's output before it propagates."""
    import contextlib
    import io
    from cglgan_tpu_torch import cli

    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            rc = cli.main(list(argv))
    except BaseException:
        print(buf.getvalue()[-4000:], file=sys.stderr, flush=True)
        raise
    if rc != 0:
        print(buf.getvalue()[-4000:], file=sys.stderr, flush=True)
        raise AssertionError(f"tpufed-torch {' '.join(argv[:2])} exited "
                             f"{rc}")
    return buf.getvalue().splitlines(), time.perf_counter() - t0


def cli_run_and_resume(card, root, label, argv, counter):
    """``argv`` to round 40 in ``<root>/<label>-full`` (ticks at 20 and
    40, ``ckpt_20``, ``ckpt_40``, ``ckpt_final``); then the same command
    resumed from that run's ``ckpt_20`` to round 40 in a second run dir,
    ``<root>/<label>-resumed``.  ``counter``: the kernel module whose count,
    set to 0 just before each, the full run must raise by 40 and the
    resumed one by 20.  The two ckpt_final states, restored on the card,
    are held bit for bit, every leaf (BN buffers, Adam counts, ``lam``
    and ``t`` too); where they differ, the largest difference of the
    params and moments against each group's scale says by how much."""
    import json

    import numpy as np
    import torch
    from cglgan_tpu_torch.algos.registry import build_runner, load_partition
    from cglgan_tpu_torch.core.config import FedGANConfig
    from cglgan_tpu_torch.utils.checkpoint import (restore_checkpoint,
                                                   save_checkpoint)
    from cglgan_tpu_torch.utils.transplant import to_numpy
    from cglgan_tpu_torch.utils.tree import tree_leaves

    full = os.path.join(root, f"{label}-full")
    resumed = os.path.join(root, f"{label}-resumed")
    out = lambda d: ("--out", root, "--name", os.path.basename(d))
    counter.launches = 0
    _, full_s = cli_call((*argv, *CLI_RUN, *out(full)))
    launches = counter.launches
    counter.launches = 0
    _, resumed_s = cli_call((*argv, *CLI_RUN, "--resume",
                             os.path.join(full, "ckpt_20"), *out(resumed)))
    second = counter.launches
    if (launches, second) != (40, 20):
        raise AssertionError(f"{label}: {counter.__name__} launches "
                             f"{launches} (full), {second} (resumed); "
                             f"expected 40, 20")
    ticks = [[json.loads(line) for line in open(os.path.join(d,
                                                             "metrics.jsonl"))]
             for d in (full, resumed)]
    if [[t["round"] for t in ts] for ts in ticks] != [[20, 40], [40]]:
        raise AssertionError(f"{label}: tick rounds {ticks}")
    finite_metrics(ticks[0] + ticks[1])
    with open(os.path.join(full, "config.json")) as f:
        cfg = FedGANConfig(**json.load(f))
    runner = build_runner(cfg, load_partition(cfg))
    template = runner.init_state()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = restore_checkpoint(os.path.join(full, "ckpt_final"), template)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    got = restore_checkpoint(os.path.join(resumed, "ckpt_final"), template)
    t0 = time.perf_counter()
    save_checkpoint(os.path.join(root, f"{label}-timed"), ref)
    save_s = time.perf_counter() - t0
    size_mb = os.path.getsize(os.path.join(root, f"{label}-timed")) / 1e6

    # every leaf, BN buffers, Adam counts, lam and t included (bf16 as
    # float32, exactly)
    a = tree_leaves(to_numpy(got, bf16="float32"))
    b = tree_leaves(to_numpy(ref, bf16="float32"))
    bit_equal = got.t == ref.t == 40 and len(a) == len(b) and all(
        np.array_equal(x, y) for x, y in zip(a, b))
    errs = state_errs(got, ref)
    if not bit_equal:
        raise AssertionError(f"{label}: resumed state not bit-equal to the "
                             f"uninterrupted one (t {got.t} / {ref.t}; "
                             f"params, mu, nu off by {errs} of their "
                             f"group's scale)")
    tick = ticks[0][-1]
    res = {"phase": "cli", "path": label, "card": card, "argv": list(argv),
           "kernel": counter.__name__.rsplit(".", 1)[1],
           "launches_full": launches, "launches_resumed": second,
           "full_s": full_s, "resumed_s": resumed_s,
           "tick_rounds_per_s": tick["rounds_per_s"],
           "tick_wall_s": tick["wall_s"],
           "resumed_bit_equal": bit_equal,
           "resumed_errs_over_group_scale": errs,
           "ckpt_mb": size_mb, "ckpt_save_s": save_s,
           "ckpt_restore_s": restore_s, "last_tick": tick,
           "resumed_last_tick": ticks[1][-1]}
    emit(res)
    return res


def phase_cli(card):
    """The CLI's ``run`` at full width on the main config (``fused_dstep``)
    and on the FL-GAN 2DMG kernel path (``fused_sweep``), each with a
    resume held to the uninterrupted run; ``eval`` of the CAP-GAN
    ``ckpt_final``; ``compare`` over the four run dirs; ``doctor``, which
    must exit 0 naming the card.  Returns {path: launches of the full
    run}."""
    import json
    import shutil
    import tempfile

    import torch
    from cglgan_tpu_torch.ops import fused_dstep, fused_sweep

    root = tempfile.mkdtemp(prefix="cli-phase-")
    try:
        cap = cli_run_and_resume(card, root, "capgan", CLI_CAPGAN,
                                 fused_dstep)
        fl = cli_run_and_resume(card, root, "flgan", CLI_FLGAN, fused_sweep)
        lines, eval_s = cli_call(("eval", os.path.join(root, "capgan-full",
                                                       "ckpt_final"),
                                  "--n", "100"))
        report = json.loads(lines[-1])
        if report["round"] != 40 or not {"fid", "inception_score"} <= \
                set(report) or not all(math.isfinite(report[k])
                                       for k in ("fid", "inception_score")):
            raise AssertionError(f"eval: {report}")
        dirs = [os.path.join(root, f"{a}-{b}") for a in ("capgan", "flgan")
                for b in ("full", "resumed")]
        _, compare_s = cli_call(("compare", *dirs, "--out",
                                 os.path.join(root, "compare")))
        with open(os.path.join(root, "compare.csv")) as f:
            rows = f.read().strip().splitlines()
        if len(rows) != 5:
            raise AssertionError(f"compare: {rows}")
        lines, doctor_s = cli_call(("doctor",))
        doctor = json.loads("\n".join(lines))
        name = torch.cuda.get_device_name(0)
        if doctor["backend"].get("device_kind") != name:
            raise AssertionError(f"doctor: {doctor}")
        emit({"phase": "cli", "card": card, "eval": report,
              "eval_s": eval_s, "compare_rows": len(rows) - 1,
              "compare_s": compare_s, "doctor": doctor,
              "doctor_s": doctor_s})
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return {"capgan": cap["launches_full"], "flgan": fl["launches_full"]}


# The serve phase: a reference-layout MNIST generator ``.pt`` warm-starts
# the main config, trains 20 rounds through the CLI's ``run
# --init-from-torch`` (``fused_dstep``), and its ``ckpt_final`` is exported
# as ``torch.export`` programs and served on the card; then ``import-torch``
# of the same ``.pt`` with ``--export``.
SERVE_ROUNDS = 20
SERVE_N = (1, 100, 10000)
SERVE_TIMED_N = (100, 10000)
SERVE_REPS = 20


def reference_mnist_g():
    """A reference ``mnist-mlp`` G's layout (model/mnist_model.py:5-29, an
    ``nn.Sequential`` under ``model``), on the host."""
    import torch
    tnn = torch.nn

    def block(din, dout, bn=True):
        return [tnn.Linear(din, dout)] + \
            ([tnn.BatchNorm1d(dout, 0.8)] if bn else []) + \
            [tnn.LeakyReLU(0.2)]

    class Generator(tnn.Module):
        def __init__(self):
            super().__init__()
            self.model = tnn.Sequential(
                *block(100, 128, bn=False), *block(128, 256),
                *block(256, 512), *block(512, 1024),
                tnn.Linear(1024, 784), tnn.Tanh())

        def forward(self, z):
            return self.model(z)

    return Generator()


def serve_check(label, got, want):
    """(bit-equal, largest |difference|); raises unless bit-equal."""
    import torch
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"serve {label}: {tuple(got.shape)} "
                             f"{got.dtype} vs {tuple(want.shape)} "
                             f"{want.dtype}")
    err = (got.float() - want.float()).abs().max().item()
    if not torch.equal(got, want):
        raise AssertionError(f"serve {label}: not bit-equal, off by {err}")
    return True, err


def net_leaves(net):
    """Every tensor of a ``NetState``: params, BN state, Adam state."""
    from cglgan_tpu_torch.utils.tree import tree_leaves
    return tree_leaves([net.params, net.bn, net.opt.count, net.opt.mu,
                        net.opt.nu])


def phase_serve(card, part, dev="cuda"):
    """Serving and migration on the main config, on ``dev`` (the card; the
    host only to rehearse the phase).  Returns ``fused_dstep``'s launches
    in the ``run --init-from-torch`` call."""
    import shutil
    import tempfile

    import torch
    from cglgan_tpu_torch.algos.registry import build_runner
    from cglgan_tpu_torch.core import threefry
    from cglgan_tpu_torch.core.config import FedGANConfig
    from cglgan_tpu_torch.ops import fused_dstep
    from cglgan_tpu_torch.utils.checkpoint import restore_checkpoint
    from cglgan_tpu_torch.utils.export import load_generator
    from cglgan_tpu_torch.utils.torch_import import (import_generator_file,
                                                     warm_start_generators)
    from cglgan_tpu_torch.utils.tree import tree_leaves, tree_map

    root = tempfile.mkdtemp(prefix="serve-phase-")
    try:
        # 1. the reference's G, seeded, its BN statistics moved
        tg = reference_mnist_g()
        gen = torch.Generator().manual_seed(7)
        with torch.no_grad():
            for p in tg.parameters():
                p.copy_(torch.randn(p.shape, generator=gen) * 0.05)
            for _ in range(3):
                tg(torch.randn(100, 100, generator=gen))
        pt = os.path.join(root, "G.pt")
        torch.save(tg.state_dict(), pt)
        sd = tg.state_dict()

        # 2. warm start onto the main config's init on the card: G equal
        # to the file bit for bit (Linear weights transposed), D and the
        # optimiser state untouched
        cfg = FedGANConfig(algo="capgan", epoch=5, **MAIN)
        runner = build_runner(cfg, part, device=dev)
        init = runner.init_state()
        t0 = time.perf_counter()
        warm = warm_start_generators(init, [pt])
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        linears = [i for i, p in enumerate(warm.g.params)
                   if p is not None and "w" in p]
        bns = [i for i, s in enumerate(warm.g.bn) if s is not None]
        mods = [m for m in tg.model if not isinstance(
            m, (torch.nn.LeakyReLU, torch.nn.Tanh))]
        lin_mods = [m for m in mods if isinstance(m, torch.nn.Linear)]
        bn_mods = [m for m in mods if isinstance(m, torch.nn.BatchNorm1d)]
        g_equal = len(linears) == len(lin_mods) and \
            len(bns) == len(bn_mods) and all(
                torch.equal(warm.g.params[i]["w"][0].cpu(),
                            m.weight.detach().t()) and
                torch.equal(warm.g.params[i]["b"][0].cpu(),
                            m.bias.detach())
                for i, m in zip(linears, lin_mods)) and all(
                torch.equal(warm.g.bn[i]["mean"][0].cpu(), m.running_mean)
                and torch.equal(warm.g.bn[i]["var"][0].cpu(), m.running_var)
                and torch.equal(warm.g.params[i]["scale"][0].cpu(),
                                m.weight.detach())
                for i, m in zip(bns, bn_mods))
        same = lambda a, b: len(a) == len(b) and all(
            torch.equal(x, y) for x, y in zip(a, b))
        d_kept = same(net_leaves(warm.d), net_leaves(init.d)) and \
            same(tree_leaves([warm.g.opt.count, warm.g.opt.mu,
                              warm.g.opt.nu]),
                 tree_leaves([init.g.opt.count, init.g.opt.mu,
                              init.g.opt.nu])) and \
            torch.equal(warm.lam, init.lam) and warm.t == init.t
        if not (g_equal and d_kept):
            raise AssertionError(f"warm start: G equal {g_equal}, D and "
                                 f"optimiser kept {d_kept}")
        del init, warm

        # 3. the CLI's run --init-from-torch on the main config
        argv = (*CLI_CAPGAN, "--rounds", str(SERVE_ROUNDS),
                "--init-from-torch", pt, "--out", root, "--name", "init",
                "--device", dev)
        fused_dstep.launches = 0
        lines, run_s = cli_call(argv)
        launches = fused_dstep.launches
        if launches < SERVE_ROUNDS or not any(
                "warm-started from 1" in line for line in lines):
            raise AssertionError(f"run --init-from-torch: {launches} "
                                 f"fused_dstep launches; {lines[-5:]}")
        run_dir = os.path.join(root, "init")
        with open(os.path.join(run_dir, "metrics.jsonl")) as f:
            ticks = [json.loads(line) for line in f if line.strip()]
        finite_metrics(ticks)

        # 4. export ckpt_final at a fixed batch and batch-polymorphic; serve
        # both on the card against gen on the restored state
        ckpt = os.path.join(run_dir, "ckpt_final")
        state = restore_checkpoint(ckpt, runner.init_state())
        fixed, poly = (os.path.join(root, f"g{n}.pt2") for n in (100, 0))
        exports = {}
        for path, n in ((fixed, 100), (poly, 0)):
            lines, secs = cli_call(("export", ckpt, "--n", str(n),
                                    "--out", path, "--device", dev))
            exports[n] = {"manifest": json.loads(lines[-1]),
                          "export_s": secs}
        serve_fixed, _ = load_generator(fixed)
        serve_poly, manifest = load_generator(poly)
        if manifest["min_batch"] != 1 or \
                manifest["device"].split(":")[0] != dev:
            raise AssertionError(f"polymorphic export: {manifest}")
        zs = {n: threefry.normal(threefry.key(n, dev), (n, 100))
              for n in SERVE_N}
        checks = {}
        for n, z in zs.items():
            want = runner.gen(state, z)
            checks[f"poly n={n}"] = serve_check(f"n={n}", serve_poly(z),
                                                want)
            if n == 100:
                checks["fixed n=100"] = serve_check("fixed", serve_fixed(z),
                                                    want)
            if n == 1 and want.shape != (1, 1, 28, 28):
                raise AssertionError(f"n=1 served {tuple(want.shape)}")

        # 5. samples/s of the program against eager gen, in turns
        timing = {}
        for n in SERVE_TIMED_N:
            z = zs[n]
            with torch.no_grad():
                eager = [cuda_ms(lambda: runner.gen(state, z), SERVE_REPS)]
                prog = [cuda_ms(lambda: serve_poly(z), SERVE_REPS)]
                prog.append(cuda_ms(lambda: serve_poly(z), SERVE_REPS))
                eager.append(cuda_ms(lambda: runner.gen(state, z),
                                     SERVE_REPS))
            timing[f"n={n}"] = {
                "program_ms": prog, "eager_ms": eager,
                "program_samples_per_s": n / (min(prog) / 1e3),
                "eager_samples_per_s": n / (min(eager) / 1e3)}

        # 6. a consumer that imports torch only serves the program on cuda
        code = (
            "import json, sys, time\n"
            "for name in ('jax', 'cglgan_tpu', 'cglgan_tpu_torch'):\n"
            "    sys.modules[name] = None\n"
            "import torch\n"
            f"program = torch.export.load({poly!r}).module()\n"
            f"z = torch.randn(100, 100, device={dev!r},\n"
            f"                generator=torch.Generator({dev!r}).manual_seed(1))\n"
            "y = program(z)\n"
            f"assert y.device.type == {dev!r}, y.device\n"
            "assert tuple(y.shape) == (100, 1, 28, 28), y.shape\n"
            "assert torch.isfinite(y).all() and y.abs().max() <= 1\n"
            "print(json.dumps({'shape': list(y.shape),\n"
            "                  'max_abs': y.abs().max().item()}))\n")
        t0 = time.perf_counter()
        out = subprocess.run([sys.executable, "-c", code], cwd=root,
                             capture_output=True, text=True, timeout=300,
                             env={**os.environ, "PYTHONPATH": ""})
        consumer_s = time.perf_counter() - t0
        if out.returncode != 0:
            raise AssertionError(f"consumer: {out.stderr[-2000:]}")
        consumer = json.loads(out.stdout.strip().splitlines()[-1])

        # 7. import-torch of the .pt with --samples and --export; the
        # program against the imported model's eager forward
        imp = os.path.join(root, "imported.pt2")
        lines, import_s = cli_call(("import-torch", pt, "--samples",
                                    os.path.join(root, "s.png"), "--export",
                                    imp, "--device", dev))
        report = json.loads(lines[-1])
        if report["family"] != "mnist-mlp" or not os.path.getsize(
                os.path.join(root, "s.png")):
            raise AssertionError(f"import-torch: {report}")
        model, params, gstate, _ = import_generator_file(pt, device=dev)
        serve_imp, _ = load_generator(imp)
        up = lambda tree: tree_map(lambda x: x.unsqueeze(0), tree)
        with torch.no_grad():
            want, _ = model.apply(up(params), up(gstate),
                                  zs[100].unsqueeze(0), train=False)
        checks["import-torch n=100"] = serve_check(
            "import-torch", serve_imp(zs[100]), want[0])

        # 8. plot of the run dir: matplotlib where it imports, else an
        # exit that names it
        fig = os.path.join(root, "runs.png")
        try:
            cli_call(("plot", run_dir, "--out", fig))
            plot = f"png, {os.path.getsize(fig)} bytes"
        except SystemExit as e:
            if "matplotlib" not in str(e) or e.code in (0, None):
                raise
            plot = str(e)

        res = {"phase": "serve", "card": card, "device": dev,
               "config": {"algo": "capgan", "epoch": 5, **MAIN},
               "warm_start_s": warm_s, "g_equal_pt": g_equal,
               "d_and_opt_kept": d_kept,
               "run_rounds": SERVE_ROUNDS, "run_s": run_s,
               "dstep_launches": launches, "last_tick": ticks[-1],
               "exports": exports,
               "bit_equal": {k: v[0] for k, v in checks.items()},
               "max_abs_err": {k: v[1] for k, v in checks.items()},
               "timing": timing, "consumer": consumer,
               "consumer_s": consumer_s, "import_s": import_s,
               "import_report": report, "plot": plot}
        emit(res)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return launches


# The mesh phase: the federation's clients sharded over NCCL ranks, one
# process a card (``core/meshes.py``), at world = the card count, capped
# at 4.  The main config at epoch 1 (the autograd path: no TPU kernel runs
# on a mesh, as in the reference; ``threefry`` draws every latent), FL-GAN
# on 2DMG and MD-GAN with the ring D-swap every round on MNIST shapes:
# (name, config, warm-up rounds, timed rounds).
MESH_MAX_WORLD = 4
MESH_CASES = (
    ("main", dict(algo="capgan", epoch=1, num_communication=20000, **MAIN),
     2, 10),
    ("flgan 2dmg", dict(algo="flgan", **FEDAVG), 1, 5),
    ("mdgan ring", dict(algo="mdgan", epoch=1, E=1, **MDGAN_MNIST), 1, 5))
MESH_CLI_ROUNDS = 12
# world >= 2 against the unsharded run.  The dryrun's configs (2DMG, 1-2
# rounds) at the limits of the CPU tests (tests/test_torch_port_mesh.py,
# the reference's own for its sharded rounds): params rtol 1e-4 / atol 1e-6
# elementwise, moments 1e-4 of their group's largest entry, metrics rtol
# 1e-5 / atol 1e-6; the G's linear biases that feed a BatchNorm, and that
# BatchNorm's running mean, have an exactly-zero gradient, so each side
# moves them by up to lr a round on rounding noise alone (ROADMAP queue 3):
# 2 lr a round apart.  The MNIST and FL-GAN cases (6-12 rounds) at the
# card-against-CPU limits of the reference phase (TOL_SCALED of a group's
# largest entry, metrics 1e-4 absolute): the ranks' partial sums reorder
# the G's cotangent and the FedAvg sums, a batched product over fewer
# clients may round otherwise, and Adam carries it on over rounds, as it
# carries the card's and the CPU's sum orders apart (ROADMAP queue 3); the
# CPU tests' limits were set on 2DMG at 2-3 rounds.
TOL_MESH_PARAMS = (1e-4, 1e-6)
TOL_MESH_MOMENT = 1e-4
TOL_MESH_METRIC = (1e-5, 1e-6)
TOL_MESH_LONG_METRIC = 1e-4


def plain_leaves(tree, path=""):
    """(path, tensor) of every tensor of a plain (checkpoint) state."""
    import torch
    if isinstance(tree, torch.Tensor):
        yield path, tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from plain_leaves(tree[k], f"{path}.{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from plain_leaves(v, f"{path}[{i}]")


def bn_fed_paths(cfg):
    """The plain-state paths of a single-path G's linear biases that feed
    a BatchNorm, and of that BatchNorm's running mean."""
    from cglgan_tpu_torch.core.config import FedGANConfig
    from cglgan_tpu_torch.models.zoo import models_for_config
    g_model = models_for_config(FedGANConfig(**cfg))[0]
    if g_model.multipath:
        return set()
    spec = g_model.spec
    return {p for i, entry in enumerate(spec[:-1])
            if entry[0] == "linear" and spec[i + 1][0] == "bn"
            for p in (f".g.params[{i}].b", f".g.bn[{i + 1}].mean")}


def mesh_against_unsharded(got, ref, world, label, cfg, long_run=False):
    """A mesh run's result (``run_cases``: whole state and metrics) against
    the unsharded run's (``cfg``: the run's config fields).  World 1: the
    same bits, or it raises.  World >= 2: the CPU tests' limits, or with
    ``long_run`` the card-against-CPU ones (``TOL_MESH_*`` above).
    Returns (every leaf and metric equal, the largest difference a group
    over its largest entry)."""
    import numpy as np
    from cglgan_tpu_torch.core.config import FedGANConfig
    pairs = list(zip(plain_leaves(got["state"]), plain_leaves(ref["state"])))
    equal = len(pairs) > 0 and got["metrics"] == ref["metrics"] and \
        got["t"] == ref["t"] and all(
            pa == pb and a.dtype == b.dtype and a.shape == b.shape
            and bool((a == b).all()) for (pa, a), (pb, b) in pairs)
    group = lambda path: next((path.split(k)[0] + k for k in (
        ".params", ".bn", ".mu", ".nu") if k in path), path)
    scale, errs = {}, {}
    for _, (path, b) in pairs:
        if b.is_floating_point() and b.numel():
            scale[group(path)] = max(scale.get(group(path), 0.0),
                                     float(b.abs().max()))
    for (path, a), (_, b) in pairs:
        if not b.is_floating_point():
            if not bool((a == b).all()):
                raise AssertionError(f"mesh {label}: {path} differs")
        elif b.numel():
            d = float((a.float() - b.float()).abs().max())
            errs[group(path)] = max(errs.get(group(path), 0.0),
                                    d / max(scale[group(path)], 1e-30))
    if world == 1:
        if not equal:
            raise AssertionError(f"mesh {label}: world 1 not bit-equal to "
                                 f"the unsharded run ({errs} of a group's "
                                 "scale)")
        return equal, errs
    metric_err = max((abs(m[k] - r[k]) for m, r in zip(got["metrics"],
                                                       ref["metrics"])
                      for k in r), default=0.0)
    if long_run:
        if any(v > TOL_SCALED for v in errs.values()) or \
                metric_err > TOL_MESH_LONG_METRIC:
            raise AssertionError(f"mesh {label} x{world}: {errs} of a "
                                 f"group's scale, metrics {metric_err}")
        return equal, errs
    fed = bn_fed_paths(cfg)
    drift = 2 * FedGANConfig(**cfg).lr_g * ref["t"]
    for (path, a), (_, b) in pairs:
        if not b.is_floating_point() or not b.numel():
            continue
        d = float((a.float() - b.float()).abs().max())
        if group(path).endswith((".mu", ".nu")):
            ok = d <= TOL_MESH_MOMENT * scale[group(path)]
        elif path in fed:
            ok = d <= drift
        else:
            ok = np.allclose(a.numpy(), b.numpy(), rtol=TOL_MESH_PARAMS[0],
                             atol=TOL_MESH_PARAMS[1])
        if not ok:
            raise AssertionError(f"mesh {label} x{world}: {path} off the "
                                 "unsharded run")
    for m, r in zip(got["metrics"], ref["metrics"]):
        for k in r:
            if not math.isclose(m[k], r[k], rel_tol=TOL_MESH_METRIC[0],
                                abs_tol=TOL_MESH_METRIC[1]):
                raise AssertionError(f"mesh {label} x{world}: metric {k} "
                                     f"{m[k]} vs {r[k]}")
    return equal, errs


def per_round(log):
    """A round's collectives by kind and axis: count and bytes."""
    out = {}
    for kind, axis, sizes in log:
        entry = out.setdefault(f"{kind} {axis}", {"count": 0, "bytes": 0})
        entry["count"] += 1
        entry["bytes"] += sum(sizes)
    return out


def phase_mesh(card):
    """``MESH_CASES`` on an NCCL mesh of spawned ranks and unsharded on
    rank 0's card, in turns in the ranks' processes (unsharded, mesh,
    mesh, unsharded), with ``utils/dryrun.py``'s configs on the same ranks
    (and unsharded); at world 1 the mesh runs must be the unsharded ones
    bit for bit (state and metrics), at world >= 2 within the limits
    above.  Then ``run capgan --devices
    <world>`` through the CLI on the main config at epoch 1, its
    ``ckpt_final`` held the same way to the unsharded run of its
    ``config.json``.  Prints rounds/s of both, the collectives a round by
    kind and bytes and the threefry launches a round.  Returns the
    threefry launches of the main config's first timed mesh run (rank
    0)."""
    import json
    import shutil
    import tempfile

    import torch
    from cglgan_tpu_torch.utils import dryrun

    # the largest power of two the cards allow, at most 4: it divides the
    # main config's 16 clients
    world = 1 << (min(torch.cuda.device_count(), MESH_MAX_WORLD)
                  .bit_length() - 1)
    emit({"phase": "mesh", "card": card, "world": world,
          "cards": torch.cuda.device_count()})
    cases = []
    for name, cfg, warm, rounds in MESH_CASES:
        # a server's clients must divide over the ranks (the reference
        # refuses it too): MD-GAN's 10 clients become 12 on 4 ranks
        S = cfg.get("num_servers", 1)
        k = -(-cfg["num_workers"] // (S * world)) * world
        cases.append({"name": name, "cfg": {**cfg, "num_workers": S * k},
                      "warmup": warm, "rounds": rounds})
    # in turns in each rank's process (unsharded on rank 0's card, mesh,
    # mesh, unsharded), so that both time in a process of the same age;
    # the dryrun's configs unsharded too, to hold their mesh runs to
    turns = ("unsharded", "mesh", "mesh again", "unsharded again")
    dry = dryrun.multichip_cases(world)
    timed = [{**c, "name": f"{c['name']} | {turn}",
              "unsharded": turn.startswith("unsharded")}
             for turn in turns for c in cases]
    timed += [{**c, "name": f"{c['name']} | unsharded", "unsharded": True}
              for c in dry]
    t0 = time.perf_counter()
    on_mesh = dryrun.dryrun_multichip(world, "cuda", extra=timed)
    runs_s = time.perf_counter() - t0
    dry_res = {}
    for c in dry:
        equal, errs = mesh_against_unsharded(
            on_mesh[c["name"]], on_mesh[c["name"] + " | unsharded"], world,
            c["name"], c["cfg"])
        dry_res[c["name"]] = {"bit_equal_to_unsharded": equal,
                              "off_over_group_scale": errs,
                              "metrics": on_mesh[c["name"]]["metrics"][-1]}
    results = []
    for c in cases:
        name, rounds = c["name"], c["rounds"]
        run = {turn: on_mesh[f"{name} | {turn}"] for turn in turns}
        equal, errs = mesh_against_unsharded(
            run["mesh"], run["unsharded"], world, name, c["cfg"],
            long_run=True)
        results.append({
            "case": name, "config": c["cfg"], "rounds": rounds,
            "warmup": c["warmup"],
            "rounds_per_s_in_turns": {turn: rounds / run[turn]["seconds"]
                                      for turn in turns},
            "bit_equal_to_unsharded": equal,
            "off_over_group_scale": errs,
            "collectives_a_round": per_round(
                run["mesh"]["collectives"][-1]),
            "threefry_launches_a_round": {
                "mesh": run["mesh"]["threefry_launches"] / rounds,
                "unsharded": run["unsharded"]["threefry_launches"] / rounds}})
    root = tempfile.mkdtemp(prefix="mesh-phase-")
    try:
        argv = ("run", "capgan", "--dataset", "synthetic-mnist",
                "--num-workers", "16", "--num-servers", "1", "--iid", "1",
                "--batch-size", "100", "--epoch", "1", "--rounds",
                str(MESH_CLI_ROUNDS), "--num-plt", str(MESH_CLI_ROUNDS),
                "--ckpt-every", str(MESH_CLI_ROUNDS), "--devices",
                str(world), "--out", root, "--name", "mesh")
        _, cli_s = cli_call(argv)
        run_dir = os.path.join(root, "mesh")
        if sorted(os.listdir(root)) != ["mesh"]:
            raise AssertionError(f"mesh cli: run dirs {os.listdir(root)}")
        with open(os.path.join(run_dir, "config.json")) as f:
            cfg = json.load(f)
        ticks = [json.loads(line) for line in
                 open(os.path.join(run_dir, "metrics.jsonl"))]
        finite_metrics(ticks)
        ref = dryrun.run_cases(None, [{"name": "cli", "cfg": cfg,
                                       "rounds": MESH_CLI_ROUNDS}],
                               "cuda")["cli"]
        saved = torch.load(os.path.join(run_dir, "ckpt_final"),
                           map_location="cpu", weights_only=True)
        cli_equal, cli_errs = mesh_against_unsharded(
            {"state": saved, "metrics": [], "t": saved["t"]},
            {**ref, "metrics": []}, world, "cli", cfg, long_run=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    emit({"phase": "mesh", "card": card, "world": world,
          "cases": results,
          "dryrun": dry_res,
          "cli": {"argv": list(argv), "seconds": cli_s,
                  "tick": ticks[-1], "bit_equal_to_unsharded": cli_equal,
                  "off_over_group_scale": cli_errs},
          "runs_s": runs_s})
    return on_mesh["main | mesh"]["threefry_launches"]


# the tensor-parallel phase: (world, model shards, exact, cases) a spawn of
# shared-card ranks on a (world / ms, ms) mesh, each case (name, config,
# warm-up, rounds); ``exact``: the TP run must be the unsharded run bit for
# bit (at 3 shards the only split leaves of these Gs are the conv weights,
# each gathered whole before its conv).  With 4 cards also the main config
# over NCCL, one rank a card, on (2, 2) and (1, 4), and CAP-GAN conv on
# (1, 3), on three of the cards
TP_MAIN = dict(algo="capgan", epoch=1, num_communication=20000,
               model_shards=2, **MAIN)
TP_SPAWNS = (
    (2, 2, False, (("main", TP_MAIN, 2, 10),
                   ("capgan conv", dict(TP_MAIN, conv=True), 1, 5))),
    (4, 2, False, (("main", TP_MAIN, 2, 10),
                   ("cglgan mnist multipath",
                    dict(CGL_MNIST, algo="cglgan", epoch=1,
                         model_shards=2), 1, 5))),
    (3, 3, True, (("capgan conv", dict(TP_MAIN, conv=True), 1, 5),
                  ("mixgan conv", dict(TP_MAIN, algo="mixgan", conv=True),
                   1, 5))))


def tp_predicted_model_log(state, ms):
    """A round's collectives over ``model`` where the rule splits only
    conv weights (``ms`` = 3 here): each split leaf of the whole G
    (``state``, plain) all-gathered whole in each of the round's 2 G
    forwards, in the forward's order, and none in the backward."""
    from cglgan_tpu_torch.core import meshes
    params = state["g"]["params"]
    split = []
    meshes.map_paths(params, lambda path, x: split.append(
        (path, x.numel() * x.element_size()))
        if meshes.model_tp_spec(tuple(x.shape), ms, lead=1) != meshes.P()
        else None)
    # in the forward's order: c1, c2, then c3 or a multipath G's heads' c
    order = sorted(split, key=lambda px: ("heads" in px[0], px[0]))
    forward = [("all_gather", "model", [b]) for _, b in order]
    return forward + forward


def phase_tp(card):
    """``TP_SPAWNS``, and on 4 ranks the dryrun's "capgan dp x tp", each
    case on the spawn's ``(world / ms, ms)`` mesh of ranks sharing the
    card and unsharded on rank 0's card, in turns in the ranks' processes
    (as ``phase_mesh``); with 4 cards also the main config over NCCL, one
    rank a card, on ``(2, 2)`` and ``(1, 4)``, and CAP-GAN conv on ``(1,
    3)``; held within ``mesh_against_unsharded``'s world >= 2 limits (the
    dryrun's at the CPU tests', the 5-10-round MNIST cases at the
    card-against-CPU ones), and at 3 shards bit for bit, with the
    collectives over ``model`` the predicted ones
    (``tp_predicted_model_log``).  Prints rounds/s of both sides, the
    collectives a round by kind, axis and bytes and the threefry launches
    a round.  Returns {"<case> (c, m)": threefry launches of its first
    timed TP run (rank 0)}."""
    import torch
    from cglgan_tpu_torch.core import meshes
    from cglgan_tpu_torch.utils import dryrun

    mode = subprocess.run(
        ["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    emit({"phase": "tp", "card": card, "compute_mode": mode,
          "cards": torch.cuda.device_count()})
    turns = ("unsharded", "tp", "tp again", "unsharded again")
    # (world, model shards, exact, shared card, cases)
    spawns = [(world, ms, exact, True, table)
              for world, ms, exact, table in TP_SPAWNS]
    if torch.cuda.device_count() >= 4:
        spawns += [(4, ms, False, False, TP_SPAWNS[0][3][:1])
                   for ms in (2, 4)]
        spawns.append((3, 3, True, False, TP_SPAWNS[2][3][:1]))
    out, launches = [], {}
    for world, ms, exact, share, table in spawns:
        shape = f"({world // ms}, {ms})" + ("" if share else " nccl")
        cases = [{"name": name, "cfg": {**cfg, "model_shards": ms},
                  "warmup": warm, "rounds": rounds, "long_run": True}
                 for name, cfg, warm, rounds in table]
        if world == 4 and share:
            cases += [{**c, "long_run": False}
                      for c in dryrun.multichip_cases(world)
                      if c["cfg"].get("model_shards", 1) > 1]
        timed = [{**c, "name": f"{c['name']} | {turn}",
                  "unsharded": turn.startswith("unsharded")}
                 for turn in turns for c in cases]
        t0 = time.perf_counter()
        res = meshes.spawn(dryrun.run_cases, world, "cuda", timed,
                           model_shards=ms, share_cards=share)[0]
        spawn_s = time.perf_counter() - t0
        for c in cases:
            name, rounds = c["name"], c["rounds"]
            run = {turn: res[f"{name} | {turn}"] for turn in turns}
            label = f"tp {name} {shape}"
            equal, errs = mesh_against_unsharded(
                run["tp"], run["unsharded"], world, label, c["cfg"],
                long_run=c["long_run"])
            if not (run["tp"]["placed_init"] and run["tp"]["round_trip"]):
                raise AssertionError(f"{label}: placement")
            log = run["tp"]["collectives"][-1]
            entry = {}
            if exact:
                if not equal:
                    raise AssertionError(f"{label}: not bit-equal to the "
                                         f"unsharded run ({errs})")
                want = tp_predicted_model_log(run["unsharded"]["state"], ms)
                got = [e for e in log if e[1] == "model"]
                if got != want:
                    raise AssertionError(f"{label}: collectives over model "
                                         f"{got}, predicted {want}")
                entry["model_collectives_as_predicted"] = {
                    "all_gather": len(want),
                    "bytes": sum(sum(b) for _, _, b in want)}
            launches[label] = run["tp"]["threefry_launches"]
            out.append({
                "case": name, "mesh": shape, "config": c["cfg"],
                "rounds": rounds, "warmup": c.get("warmup", 0),
                "rounds_per_s_in_turns": {turn: rounds / run[turn]["seconds"]
                                          for turn in turns},
                "bit_equal_to_unsharded": equal,
                "off_over_group_scale": errs,
                "collectives_a_round": per_round(log), **entry,
                "threefry_launches_a_round": {
                    "tp": run["tp"]["threefry_launches"] / rounds,
                    "unsharded":
                        run["unsharded"]["threefry_launches"] / rounds}})
        emit({"phase": "tp", "card": card, "world": world, "mesh": shape,
              "spawn_s": spawn_s, "cases": out[-len(cases):]})
    return launches


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    all_phases = ("dstep", "dstep_bf16", "sweep", "adam", "threefry",
                  "reference", "main", "draws", "graph", "eval_image",
                  "fedavg",
                  "fedavg_image", "cgl", "mdgan", "bf16", "conv",
                  "conv_baselines", "conv_bf16", "inception", "cli",
                  "serve", "mesh", "tp")
    ap.add_argument("--phases", default=",".join(all_phases),
                    help="comma-separated subset of: " + " ".join(all_phases))
    phases = [p for p in ap.parse_args(argv).phases.split(",") if p]
    if any(p not in all_phases for p in phases):
        ap.error(f"unknown phase in {phases}")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to measure",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from cglgan_tpu_torch.algos.registry import load_partition
    from cglgan_tpu_torch.core.config import FedGANConfig
    from cglgan_tpu_torch.data import native
    from cglgan_tpu_torch.ops import (_build, fused_adam, fused_dstep,
                                      fused_sweep)
    from cglgan_tpu_torch.ops import threefry as tk

    started = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card, flush=True)
    name = torch.cuda.get_device_name(0)
    t0 = time.perf_counter()
    built = _build.build_all()
    build_s = time.perf_counter() - t0
    emit({"phase": "device", "card": card, "name": name,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "build_s": build_s,
          "built": {k: os.path.relpath(v[0], ROOT) for k, v in built.items()},
          "ptxas": {k: _build.ptxas_report(k).splitlines()
                    for k in _build.KERNELS}})

    def run(phase):
        """Whether ``phase`` runs; prints its name first, with the
        script's seconds so far, so that a failure's traceback follows the
        name of the phase it stopped."""
        if phase in phases:
            emit({"starting": phase,
                  "script_s": time.perf_counter() - started})
        return phase in phases

    done = {}
    if run("dstep"):
        done["dstep"] = phase_kernel(name)
    if run("dstep_bf16"):
        done["dstep_bf16"] = phase_kernel_bf16(name)
    if run("sweep"):
        done["sweep"] = phase_kernel_sweep(name)
    if run("adam"):
        done["adam"], done["adam_launches"] = phase_kernel_adam(name)
    parts = {}

    def part_of(algo, base):
        # 2DMG partitions depend on the algorithm (composition scale)
        key = (algo if base["dataset"] == "2dmg" else None,
               *sorted(base.items()))
        if key not in parts:
            t0 = time.perf_counter()
            parts[key] = load_partition(FedGANConfig(algo=algo, **base))
            emit({"phase": "data", "dataset": base["dataset"],
                  "seconds": time.perf_counter() - t0,
                  "glyph_backend": "native" if native.available()
                  else "numpy", "shards": list(parts[key].data.shape)})
        return parts[key]

    if run("threefry"):
        done["threefry"] = phase_kernel_threefry(
            name, part_of("flgan", FEDAVG_MNIST))
    if run("reference"):
        phase_reference()
        phase_reference_fedavg()
        seed_round()
    if run("main"):
        part = part_of("capgan", MAIN)
        res, done["dstep_launches"] = phase_rounds(
            "main", "capgan", "capgan", MAIN, 5, part)
        done["threefry_launches"] = res["threefry_launches"]
        res, _ = phase_rounds("autograd", "capgan", "capgan", MAIN, 1, part)
        done["threefry_launches capgan e1"] = res["threefry_launches"]
    if run("draws"):
        phase_draws(part_of("capgan", MAIN))
    if run("graph"):
        _, graph_launches = phase_graph(part_of)
        for label, n in graph_launches.items():
            if n and "bf16" in label:
                done[f"dstep_bf16_launches graph {label}"] = n
            elif n:
                done[f"dstep_launches graph {label}"] = n
    if run("eval_image"):
        done["dstep_launches capgan eval"] = phase_eval_image(
            card, part_of("capgan", MAIN))
    if run("fedavg"):
        res, done["sweep_launches"] = phase_fedavg("flgan", True)
        done["threefry_launches flgan 2dmg kernel"] = \
            res["threefry_launches"]
        phase_fedavg("flgan", False)
        phase_fedavg("fegan", True)
        phase_fedavg("fegan", False)
    if run("fedavg_image"):
        phase_fedavg_image(part_of("flgan", FEDAVG_MNIST))
    if run("cgl"):
        for label, algo, base, epoch in CGL_RUNS:
            _, n = phase_rounds("cgl", label, algo, base, epoch,
                                part_of(algo, base))
            if epoch > 1:
                done[f"dstep_launches {label}"] = n
    if run("mdgan"):
        for label, algo, base, epoch, extra in MDGAN_RUNS:
            _, n = phase_rounds("mdgan", label, algo, base, epoch,
                                part_of(algo, base), **extra)
            if epoch > 1:
                done[f"dstep_launches {label}"] = n
    if run("conv"):
        phase_conv(part_of)
    if run("conv_baselines"):
        phase_conv_baselines(part_of)
    if run("conv_bf16"):
        phase_conv_bf16(part_of)
    if run("inception"):
        phase_inception(card, part_of("capgan", MAIN),
                        part_of("cglgan", CGL_CONV))
    if run("bf16"):
        bf = dict(dtype="bfloat16")
        part = part_of("capgan", MAIN)
        # CAP-GAN main path: the forced bf16-state kernel, then what auto
        # runs in bf16 (autograd) at epoch=5 and epoch=1
        _, done["dstep_bf16_launches"] = phase_rounds(
            "bf16", "capgan", "capgan", MAIN, 5, part, pallas_dstep=True,
            **bf)
        phase_rounds("bf16", "capgan", "capgan", MAIN, 5, part, **bf)
        phase_rounds("bf16", "capgan", "capgan", MAIN, 1, part, **bf)
        _, done["dstep_bf16_launches cglgan"] = phase_rounds(
            "bf16", "cglgan", "cglgan", CGL_MNIST, 5,
            part_of("cglgan", CGL_MNIST), pallas_dstep=True, **bf)
        _, done["dstep_bf16_launches mdgan"] = phase_rounds(
            "bf16", "mdgan", "mdgan", MDGAN_MNIST, 5,
            part_of("mdgan", MDGAN_MNIST), pallas_dstep=True, **bf)
        phase_fedavg("flgan", False, phase="bf16", force_dtype=True, **bf)
        phase_reference_bf16()
    if run("cli"):
        cli_launches = phase_cli(card)
        done["dstep_launches cli capgan"] = cli_launches["capgan"]
        done["sweep_launches cli flgan"] = cli_launches["flgan"]
    if run("serve"):
        done["dstep_launches cli init-from-torch"] = phase_serve(
            card, part_of("capgan", MAIN))
    if run("mesh"):
        done["threefry_launches mesh capgan"] = phase_mesh(card)
    if run("tp"):
        for path, n in phase_tp(card).items():
            done[f"threefry_launches {path}"] = n
    emit({"phases_done": phases, "script_s": time.perf_counter() - started})
    if len(phases) != len(all_phases):
        print(card, flush=True)
        emit({"partial": phases})
        return 0

    worst = lambda rs: max(v["max_abs_err"] for r in rs
                           for v in r["errors"].values())
    entry = lambda mod, launches, rs, head, lib: {
        "name": mod.__name__.rsplit(".", 1)[1], "route": "cuda",
        "source": mod.SOURCE, "replaces": mod.REPLACES, "launches": launches,
        "max_abs_err": worst(rs), "ms": head["kernel_ms"],
        "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"], "library_ms": lib}
    adam_f32 = done["adam"][0]
    dstep = entry(fused_dstep, done["dstep_launches"], done["dstep"],
                  done["dstep"][0], None)
    # each path's own count, set to 0 just before it ran: the CAP-GAN main
    # path (``launches``), the CGL path's three kernel-path runs and the
    # MD-GAN family's four
    dstep["launches_by_path"] = {
        "capgan": done["dstep_launches"],
        **{k.split(" ", 1)[1]: v for k, v in done.items()
           if k.startswith("dstep_launches ")}}
    # bf16 state, the main path's shape; launches from the forced bf16
    # CAP-GAN run (and the CGL-GAN one beside it)
    dstep_bf16 = entry(fused_dstep, done["dstep_bf16_launches"],
                       done["dstep_bf16"], done["dstep_bf16"][0], None)
    dstep_bf16["name"] = "fused_dstep_bf16"
    dstep_bf16["replaces"] = fused_dstep.REPLACES_BF16
    dstep_bf16["launches_by_path"] = {
        "capgan bf16": done["dstep_bf16_launches"],
        "cglgan bf16": done["dstep_bf16_launches cglgan"],
        "mdgan bf16": done["dstep_bf16_launches mdgan"],
        **{k.split(" ", 1)[1]: v for k, v in done.items()
           if k.startswith("dstep_bf16_launches graph ")}}
    # the FL-GAN pair's shape; launches from its 20 kernel-path rounds, and
    # the CLI's FL-GAN 2DMG run beside them
    sweep = entry(fused_sweep, done["sweep_launches"], done["sweep"],
                  done["sweep"][0], None)
    sweep["launches_by_path"] = {
        "flgan": done["sweep_launches"],
        **{k.split(" ", 1)[1]: v for k, v in done.items()
           if k.startswith("sweep_launches ")}}
    kernels = [
        dstep, dstep_bf16,
        sweep,
        # float32 moments (the mode with a library call); launches from
        # the three init/step steps over a two-leaf tree (one launch a step)
        entry(fused_adam, done["adam_launches"], done["adam"], adam_f32,
              adam_f32["library_ms"])]
    # threefry: launches from the CAP-GAN main path (its count set to 0
    # just before), the largest draw's time; no PyTorch call computes
    # JAX's threefry (torch.randn is Philox: printed for scale only)
    tf = done["threefry"]
    kernels.append({
        "name": "threefry", "route": "cuda", "source": tk.SOURCE,
        "replaces": tk.REPLACES, "launches": done["threefry_launches"],
        "max_abs_err": max(v["max_abs_err"] for v in tf["errors"].values()),
        "ms": tf["kernel_ms"], "plain_ms": tf["plain_ms"],
        "bound_ms": tf["bound_ms"], "bound_by": tf["bound_by"],
        "library_ms": None,
        "launches_by_path": {
            "capgan": done["threefry_launches"],
            **{k.split(" ", 1)[1]: v for k, v in done.items()
               if k.startswith("threefry_launches ")}}})
    if any(k["launches"] < 1 for k in kernels) or \
            min(dstep["launches_by_path"].values()) < 1 or \
            min(sweep["launches_by_path"].values()) < 1 or \
            min(dstep_bf16["launches_by_path"].values()) < 1:
        raise AssertionError(f"a kernel was never launched: {kernels}")
    print(card, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

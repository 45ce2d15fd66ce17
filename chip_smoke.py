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
  reference a shrunk CAP-GAN, CGL-GAN (multipath and iid=0), Mix-G, 2DMG
            CGL-GAN, MD-GAN (shuffle D-swap), AC-GAN (delta gossip; and
            dropout, autograd), FL-GAN and FeGAN on the card (kernel path)
            against the same rounds on the CPU (plain path) from one init
            and one stream;
  main      16-client CAP-GAN on MNIST shapes at epoch=5 (the kernel path),
            20 rounds through ``build_runner`` and ``train``; the kernel's
            launch count must rise by exactly 20 and every metric be finite;
  autograd  the same configuration at epoch=1 (the autograd D path);
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
            path), 20 rounds each.
The round phases also profile a few further rounds (device time by kernel,
busy share; ``cglgan_tpu_torch/utils/profiling.py``).
Each phase prints ``{"starting": name}`` before it runs.  Then the card
line, the ``kernels`` line and, last, the ok line.  Any failure raises and
exits non-zero; without a card it exits 2 and prints no result.
``--phases a,b`` runs only the named phases (of ``dstep dstep_bf16 sweep
adam reference main eval_image fedavg fedavg_image cgl mdgan bf16 conv
inception``)
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
    starts = torch.randint(0, max_len - B + 1, (E,), generator=gen).tolist()
    if servers:
        fake = torch.tanh(torch.randn((servers, 1, B, din), generator=gen))
        fake = fake.expand(servers, W // servers, B, din).reshape(W, B, din)
    else:
        fake_shape = (W, B, din) if per_client else (B, din)
        fake = torch.tanh(torch.randn(fake_shape, generator=gen))
    return six, mu6, nu6, count, shards, starts, fake.contiguous().to(dev)


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

    params, bn = d_model.init(gen, W)
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
            params, bn = d_model.init(gen, w)
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
        params, bn = model.init(gen, W)
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


def device_kernels(fn):
    """Device kernels (and copies) one call of ``fn`` puts on the card, by
    ``torch.profiler``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(ev.count for ev in prof.key_averages()
               if ev.device_type == torch.autograd.DeviceType.CUDA)


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


def state_errs(card_state, cpu_state):
    """Card rounds against CPU rounds: per net and group (params, mu, nu)
    the largest |card - cpu| over the group's largest |cpu| entry (the G's
    pre-BN linear biases have an exactly-zero gradient, so their moments are
    rounding noise on both devices, as in the JAX reference; scaling by the
    group keeps them from deciding).  Adam counts must be equal."""
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
            pairs = list(zip(tree_leaves(a[net][group]),
                             tree_leaves(b[net][group])))
            errs[f"{net}.{group}"] = (
                max(float(np.abs(x - y).max()) for x, y in pairs)
                / max(float(np.abs(y).max()) for _, y in pairs))
    return errs


def over_limit(errs, tol):
    """Whether a state_errs result exceeds ``tol``: one limit for every
    group, or a limit by group kind (``params``, ``mu``, ``nu``)."""
    limit = (lambda k: tol) if not isinstance(tol, dict) else \
        (lambda k: tol[k.split(".", 1)[1]])
    return any(v > limit(k) for k, v in errs.items())


def reference_rounds(label, cfg, part, rounds, tol=TOL_SCALED,
                     tol_metrics=1e-4):
    """Card (kernel path) against CPU (plain path) from one init and one
    stream: ``rounds`` rounds of the CGL or MD-GAN family (with the latter's
    survival draw and swap permutation, drawn on the host, in the stream);
    the card must launch ``fused_dstep`` once a round where the config
    engages it, else never."""
    from cglgan_tpu_torch.algos.registry import build_runner
    from cglgan_tpu_torch.core import prng
    from cglgan_tpu_torch.ops import fused_dstep

    L = part.data.shape[1]
    W = cfg.num_workers
    gpu = build_runner(cfg, part)
    cpu = build_runner(cfg, part, device="cpu")
    sg, sc = gpu.init_state(), cpu.init_state()
    launched = fused_dstep.launches
    for t in range(rounds):
        streams = prng.round_streams(cfg, t, L, "cpu")
        if cfg.algo in ("acgan", "mdgan"):
            streams = (*streams, prng.survival(cfg, t, W, "cpu"),
                       prng.swap_permutation(cfg, t, W, "cpu"))
        sg, mg = gpu.round_fn(sg, streams)
        sc, mc = cpu.round_fn(sc, streams)
    launches = fused_dstep.launches - launched
    expect = rounds if fused_dstep.eligible(cfg) else 0
    errs = state_errs(sg, sc)
    merr = max(abs(float(mg[k]) - float(mc[k])) for k in mg)
    # same math on two devices, sums in another order: as in the kernel
    # phase, scaled by each tensor's max; float32 metrics 1e-4 absolute
    res = {"phase": "reference", "algo": label, "dtype": cfg.dtype,
           "rounds": rounds, "fused_dstep_launches": launches,
           "max_scaled_err": errs, "tol_scaled": tol,
           "metrics_max_abs_err": merr, "tol_metrics": tol_metrics}
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
    stay 0 elsewhere (the conv D); finite metrics and samples in [-1, 1].
    ``extra``: further config fields (``dtype``, ``pallas_dstep``)."""
    import torch
    from cglgan_tpu_torch.algos.registry import build_runner
    from cglgan_tpu_torch.algos.runner import train
    from cglgan_tpu_torch.core.config import FedGANConfig
    from cglgan_tpu_torch.evalx.evaluator import make_evaluator
    from cglgan_tpu_torch.models.zoo import models_for_config
    from cglgan_tpu_torch.ops import fused_dstep
    from cglgan_tpu_torch.utils.profiling import profile_rounds

    cfg = FedGANConfig(algo=algo, epoch=epoch, **base, **extra)
    runner = build_runner(cfg, part)
    # rounds/s leaves evaluation out: the evaluator is timed in eval_image
    state = train(runner, 2, eval_every=2,
                  evaluator=False)["state"]                # warm-up rounds
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fused_dstep.launches = 0
    t0 = time.perf_counter()
    out = train(runner, rounds, eval_every=10, state=state, evaluator=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fused_dstep.launches
    peak = torch.cuda.max_memory_allocated() / 1e9
    finite_metrics(out["history"])
    uses_kernel = fused_dstep.eligible(cfg)
    expect = rounds if uses_kernel else 0
    if launches != expect:
        raise AssertionError(f"{label} epoch={epoch} {extra}: fused_dstep "
                             f"launches {launches}, expected {expect}")
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
           "fused_dstep_launches": launches, "uses_kernel": uses_kernel,
           "last_tick": out["history"][-1], "peak_mem_gb": peak}
    if not cfg.is_image:
        # the evaluator's KL, DS and mode coverage (32 bins for MD-GAN)
        res.update(make_evaluator(cfg, part)(runner, out["state"],
                                             samples=samples))
    # after the counted run: where a round's time goes
    res["profile"] = profile_rounds(runner, out["state"], PROFILE_ROUNDS)
    emit(res)
    return res, launches


def fedavg_shrunk(algo, **extra):
    """The shrunk 2DMG FedAvg-family config of the reference phases."""
    from cglgan_tpu_torch.core.config import FedGANConfig
    return FedGANConfig(algo=algo, dataset="2dmg", num_workers=4,
                        num_class=4, num_sample=64, batch_size=16, iid=1,
                        epoch=2, num_communication=8, **extra)


def phase_reference_fedavg(cases=None, part=None):
    """Shrunk FL-GAN and FeGAN: card vs CPU from one init and one stream
    (by default on the kernel path, the CPU on its plain version).
    ``cases``: (config, scaled tolerance, metric tolerance) triples;
    ``part``: their partition (default: ``load_partition``).  The streams
    cover the largest local step count (the ragged "epochs" sweep)."""
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
        for t in range(3):
            streams = prng.sweep_streams(cfg, t, cpart.data.shape[1], steps,
                                         "cpu")
            if cfg.dropout_rate > 0.0:          # one survival draw for both
                streams = (*streams,
                           prng.survival(cfg, t, cfg.num_workers, "cpu"))
            sg, mg = gpu.round_fn(sg, streams)
            sc, mc = cpu.round_fn(sc, streams)
        launches = {"fused_sweep": fused_sweep.launches - launched[0],
                    "fused_dstep": fused_dstep.launches - launched[1]}
        expect = 3 if fused_sweep.eligible(cfg) else 0
        errs = state_errs(sg, sc)
        merr = max(abs(float(mg[k]) - float(mc[k])) for k in mg)
        res = {"phase": "reference", "algo": algo, "dtype": cfg.dtype,
               "dataset": cfg.dataset, "pallas_sweep": cfg.pallas_sweep,
               "frac_workers": cfg.frac_workers,
               "sweep": cfg.resolved_local_sweep, "steps": steps,
               "rounds": 3, "launches": launches,
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
    fused_sweep.launches = 0
    t0 = time.perf_counter()
    out = train(runner, ROUNDS, eval_every=10, state=state, evaluator=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fused_sweep.launches
    finite_metrics(out["history"])
    expect = ROUNDS if use_kernel else 0
    if launches != expect:
        raise AssertionError(f"{algo}: fused_sweep launches {launches}, "
                             f"expected {expect}")
    n = 10000
    pts = runner.sample(out["state"], n)
    if tuple(pts.shape) != (n, 2) or not bool(torch.isfinite(pts).all()) \
            or float(pts.abs().max()) > 1.0:
        raise AssertionError(f"bad samples {tuple(pts.shape)}")
    real = torch.from_numpy(part.eval_pool).to(pts.device)
    kl, ds = hist2d.kl_and_distribution_score(pts, real, 16)
    prof = profile_rounds(runner, out["state"], PROFILE_ROUNDS)
    sweep_calls = sum(k["calls_per_round"] for k in prof["top"]
                      if "sweep_kernel" in k["kernel"])
    if sweep_calls != (1.0 if use_kernel else 0.0):
        raise AssertionError(f"{algo}: {sweep_calls} sweep kernels a round "
                             f"in the profile")
    res = {"phase": phase, "path": "kernel" if use_kernel else "autograd",
           "config": {"algo": algo, **FEDAVG, **workers, **extra,
                      "pallas_sweep": cfg.pallas_sweep},
           "shards": list(part.data.shape), "setup_s": setup_s,
           "rounds": ROUNDS, "wall_s": wall, "rounds_per_s": ROUNDS / wall,
           "fused_sweep_launches": launches,
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


def fedavg_image_shrunk():
    """The shrunk image setup of ``tests/test_torch_port_fedavg_image.py``
    (800 synthetic 28x28 images, 4 workers, B=32, the full-width MNIST G and
    D) through the port's own ``synthetic_mnist`` and ``partition``."""
    from cglgan_tpu_torch.core.config import FedGANConfig
    from cglgan_tpu_torch.data.mnist import synthetic_mnist
    from cglgan_tpu_torch.data.partition import partition
    imgs, labels = synthetic_mnist(n=800, seed=3)
    part = partition(imgs.reshape(800, -1), labels, 4, 1, num_class=10,
                     num_sample=100, seed=FedGANConfig().seed)
    base = dict(dataset="synthetic-mnist", num_workers=4, num_class=10,
                num_sample=100, iid=1, batch_size=32, num_communication=8)
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
                           check_sums=False):
    """One archived configuration at full width through ``build_runner``
    and ``train``: at epoch=1 1 warm-up round (at epoch=5 none: the
    epoch=1 run before it has warmed the same kernels and shapes), then
    ``rounds`` timed rounds; no kernel may launch (``fused_sweep`` and
    ``fused_dstep`` counts, set to 0 just before, stay 0); finite metrics
    and samples in [-1, 1]; at epoch=1 a 1-round profile (launches a round
    and a step, busy share), and with ``check_sums`` its sums held to
    ``key_averages()`` on one more round."""
    import torch
    from cglgan_tpu_torch.algos.registry import build_runner
    from cglgan_tpu_torch.algos.runner import train
    from cglgan_tpu_torch.core.config import FedGANConfig
    from cglgan_tpu_torch.ops import fused_dstep, fused_sweep
    from cglgan_tpu_torch.utils.profiling import profile_rounds

    cfg = FedGANConfig(algo=algo, epoch=epoch, **FEDAVG_MNIST, **extra)
    t0 = time.perf_counter()
    runner = build_runner(cfg, part)
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    state = train(runner, 1, eval_every=1, evaluator=False)["state"] \
        if epoch == 1 else runner.init_state()           # warm-up round
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
    if tuple(samples.shape) != (16, 1, 28, 28) or \
            not bool(torch.isfinite(samples).all()) or \
            float(samples.abs().max()) > 1.0:
        raise AssertionError(f"{algo}: bad samples {tuple(samples.shape)}")
    res = {"phase": "fedavg_image", "path": "autograd",
           "config": {"algo": algo, **FEDAVG_MNIST, "epoch": epoch,
                      **extra},
           "shards": list(part.data.shape), "setup_s": setup_s,
           "warmup_round_s": warm_s, "rounds": rounds, "wall_s": wall,
           "rounds_per_s": rounds / wall, "s_per_round": wall / rounds,
           "plan": plan, "launches": launches,
           "last_tick": out["history"][-1], "peak_mem_gb": peak}
    if epoch == 1:
        t = out["state"].t
        t0 = time.perf_counter()
        prof = profile_rounds(runner, out["state"], 1)
        prof["profile_s"] = time.perf_counter() - t0
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
TOL_NORMAL_ULPS = 3
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


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    all_phases = ("dstep", "dstep_bf16", "sweep", "adam", "reference",
                  "main", "eval_image", "fedavg", "fedavg_image", "cgl",
                  "mdgan", "bf16", "conv", "inception")
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
        """Whether ``phase`` runs; prints its name first, so that a
        failure's traceback follows the name of the phase it stopped."""
        if phase in phases:
            emit({"starting": phase})
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
    if run("reference"):
        phase_reference()
        phase_reference_fedavg()
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

    if run("main"):
        part = part_of("capgan", MAIN)
        _, done["dstep_launches"] = phase_rounds("main", "capgan", "capgan",
                                                 MAIN, 5, part)
        phase_rounds("autograd", "capgan", "capgan", MAIN, 1, part)
    if run("eval_image"):
        done["dstep_launches capgan eval"] = phase_eval_image(
            card, part_of("capgan", MAIN))
    if run("fedavg"):
        _, done["sweep_launches"] = phase_fedavg("flgan", True)
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
        "mdgan bf16": done["dstep_bf16_launches mdgan"]}
    kernels = [
        dstep, dstep_bf16,
        # the FL-GAN pair's shape; launches from its 20 kernel-path rounds
        entry(fused_sweep, done["sweep_launches"], done["sweep"],
              done["sweep"][0], None),
        # float32 moments (the mode with a library call); launches from
        # the three init/step steps over a two-leaf tree (one launch a step)
        entry(fused_adam, done["adam_launches"], done["adam"], adam_f32,
              adam_f32["library_ms"])]
    if any(k["launches"] < 1 for k in kernels) or \
            min(dstep["launches_by_path"].values()) < 1 or \
            min(dstep_bf16["launches_by_path"].values()) < 1:
        raise AssertionError(f"a kernel was never launched: {kernels}")
    print(card, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

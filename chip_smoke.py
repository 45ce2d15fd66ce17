#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``cglgan_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line:
  device    the card (nvidia-smi name and power limit) and the kernel build;
  kernel    every ported kernel against its plain PyTorch version on the
            card at the main path's shapes (16 clients, E=5, B=100, 784-512-
            256-{2,1}), both heads, diverging per-client Adam counts; times
            of the kernel, the plain version and the autograd path beside
            the kernel's bound;
  reference a shrunk CAP-GAN on the card (kernel path) against the same
            rounds on the CPU (plain path) from one init and one stream;
  main      16-client CAP-GAN on MNIST shapes at epoch=5 (the kernel path),
            20 rounds through ``build_runner`` and ``train``; the kernel's
            launch count must rise by exactly 20 and every metric be finite;
  autograd  the same configuration at epoch=1 (the autograd D path).
Each of the last two also profiles 10 further rounds (device time by
kernel, busy share; ``cglgan_tpu_torch/utils/profiling.py``).
Then the card line, the ``kernels`` line and, last, the ok line.  Any
failure raises and exits non-zero; without a card it exits 2 and prints
no result.  Imports nothing of JAX.
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
# Kernel vs plain on the card, both full float32, same inputs.  Sums run in
# another order (tiled FMA vs cuBLAS).  When the order flips the sign of a
# pre-activation within ~1e-7 of 0 (8.2M of them per call), LeakyReLU's
# slope jumps 1 <-> 0.2 and that row's term of the weight gradient
# changes; Adam carries it over the E=5 steps.  Measured on an H100: mu
# within 7.8e-4 (logits2) and 5.3e-3 (sigmoid) of its scale, losses 1.7e-7.
# So each of the 18 state tensors must satisfy max|kernel - plain| <=
# 1e-2 * max|plain|, and the losses 1e-5 relative; a wrong index or a
# missing term gives O(1).
TOL_SCALED = 1e-2
TOL_LOSS = 1e-5


def emit(obj):
    print(json.dumps(obj), flush=True)


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def peaks(name):
    """(non-tensor f32 FLOP/s, HBM bytes/s) of the card, from NVIDIA's data
    sheets (SXM part unless the name says otherwise)."""
    if "H100" in name and "PCIe" in name:
        return 51.2e12, 2.0e12
    if "H100" in name and "NVL" in name:
        return 60e12, 3.9e12
    if "H200" in name:
        return 67e12, 4.8e12
    return 67e12, 3.35e12                        # H100 SXM


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


def dstep_work(W, E, B, din, h1, h2, dout):
    """(FLOP, bytes) one fused_d_epoch_steps call must do: forward, weight
    and input grads (the first layer's input grad is not needed) for every
    client-step; each input read once and each output written once."""
    R = 2 * B
    fwd = 2 * R * (din * h1 + h1 * h2 + h2 * dout)
    bwd = fwd + 2 * R * (h2 * dout + h1 * h2)
    flops = W * E * (fwd + bwd)
    n_state = din * h1 + h1 + h1 * h2 + h2 + h2 * dout + dout
    state = 3 * W * n_state * 4
    bytes_ = 2 * state + E * W * B * din + B * din * 4 + W * E * 2 * 4 \
        + W * 4 + W * 8
    return flops, bytes_


def compare(got, ref):
    """Per group (params, mu, nu, loss): the max abs error and the max of
    max|got - ref| / max|ref| over its tensors, and whether both are
    within tolerance."""
    import torch
    if not torch.equal(got[3].cpu(), ref[3].cpu()):
        raise AssertionError("Adam counts differ")
    out = {}
    for i, group in enumerate(("params", "mu", "nu", "loss")):
        a = got[i] if i < 3 else [got[4]]
        b = ref[i] if i < 3 else [ref[4]]
        abs_err = max(float((x - y).abs().max()) for x, y in zip(a, b))
        scaled = max(float((x - y).abs().max()
                           / y.abs().max().clamp_min(1e-30))
                     for x, y in zip(a, b))
        tol = TOL_LOSS if group == "loss" else TOL_SCALED
        out[group] = {"max_abs_err": abs_err, "max_scaled_err": scaled,
                      "tol_scaled": tol, "ok": scaled <= tol}
    return out


def phase_kernel(card_name):
    import torch
    from cglgan_tpu_torch.algos import common
    from cglgan_tpu_torch.models.zoo import build_discriminator
    from cglgan_tpu_torch.ops import fused_dstep

    dev = torch.device("cuda")
    results = []
    for head, dout, half in (("logits2", 2, True), ("sigmoid", 1, False)):
        gen = torch.Generator().manual_seed(1234 + dout)
        d_model = build_discriminator("mnist", dout, in_dim=DIN)
        params, bn = d_model.init(gen, W)
        six = [x.to(dev) for p in params if p is not None
               for x in (p["w"], p["b"])]
        mu6 = [(torch.randn(x.shape, generator=gen) * 1e-3).to(dev)
               for x in six]
        nu6 = [(torch.randn(x.shape, generator=gen).abs() * 1e-6).to(dev)
               for x in six]
        count = (torch.arange(W, dtype=torch.int64) * 3).to(dev)  # diverge
        shards = torch.randint(0, 256, (W, 1000, DIN), generator=gen,
                               dtype=torch.uint8).to(dev)
        starts = torch.randint(0, 1000 - B + 1, (E,),
                               generator=gen).tolist()
        fake = torch.tanh(torch.randn((B, DIN), generator=gen)).to(dev)
        kw = dict(head=head, d_loss_half=half, lr=2e-4, b1=0.5, b2=0.999)

        got = fused_dstep.fused_d_epoch_steps(six, mu6, nu6, count, shards,
                                              starts, fake, **kw)
        torch.cuda.synchronize()
        ref = fused_dstep.fused_d_epoch_steps_plain(six, mu6, nu6, count,
                                                    shards, starts, fake,
                                                    **kw)
        errs = compare(got, ref)

        # timings on the same inputs
        kernel_ms = cuda_ms(lambda: fused_dstep.fused_d_epoch_steps(
            six, mu6, nu6, count, shards, starts, fake, **kw), 20)
        plain_ms = cuda_ms(lambda: fused_dstep.fused_d_epoch_steps_plain(
            six, mu6, nu6, count, shards, starts, fake, **kw), 5)
        net = fused_dstep.repack_net(
            common.NetState(params, bn, common.AdamState(count, params,
                                                         params)),
            six, mu6, nu6, count)
        step = common.d_epoch_steps(common.d_step_fn(
            d_model, common.make_adv_loss(head), 2e-4, 0.5, 0.999, B, True,
            half), E)
        autograd_ms = cuda_ms(lambda: step(net, shards, starts, fake), 5)

        flops, nbytes = dstep_work(W, E, B, DIN, H1, H2, dout)
        f32_peak, hbm = peaks(card_name)
        t_ops, t_bytes = flops / f32_peak * 1e3, nbytes / hbm * 1e3
        res = {"phase": "kernel", "kernel": "fused_dstep", "head": head,
               "shape": {"W": W, "E": E, "B": B, "din": DIN, "h1": H1,
                         "h2": H2, "out": dout},
               "errors": errs,
               "kernel_ms": kernel_ms, "plain_ms": plain_ms,
               "autograd_ms": autograd_ms, "gflop": flops / 1e9,
               "mbytes": nbytes / 1e6, "bound_ms": max(t_ops, t_bytes),
               "bound_by": "operations" if t_ops >= t_bytes else "bytes",
               "launches_inside_call": E * 19}
        emit(res)
        results.append(res)
        if not all(v["ok"] for v in errs.values()):
            raise AssertionError(f"fused_dstep ({head}) disagrees with its "
                                 f"plain version: {errs}")
    return results


def finite_metrics(history):
    for tick in history:
        for key, v in tick.items():
            if not math.isfinite(float(v)):
                raise AssertionError(f"metric {key} = {v}")


def phase_reference():
    """Shrunk CAP-GAN: card (kernel path) vs CPU (plain path)."""
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
    for t in range(5):
        starts, z_d, z_g = prng.round_streams(cfg, t, L, "cpu")
        sg, mg = gpu.round_fn(sg, (starts, z_d, z_g))
        sc, mc = cpu.round_fn(sc, (starts, z_d, z_g))
    a, b = to_numpy(sg), to_numpy(sc)
    errs = {}
    for net in ("g", "d"):
        for part_name in ("params", "mu", "nu"):
            pairs = list(zip(tree_leaves(a[net][part_name]),
                             tree_leaves(b[net][part_name])))
            # scaled by the group's largest entry: the G's pre-BN linear
            # biases have an exactly-zero gradient, so their moments are
            # rounding noise on both devices (as in the JAX reference)
            errs[f"{net}.{part_name}"] = (
                max(float(np.abs(x - y).max()) for x, y in pairs)
                / max(float(np.abs(y).max()) for _, y in pairs))
    merr = max(abs(float(mg[k]) - float(mc[k])) for k in mg)
    # same float32 math on two devices, sums in another order: as in the
    # kernel phase, scaled by each tensor's max; metrics 1e-4 absolute
    res = {"phase": "reference", "rounds": 5, "max_scaled_err": errs,
           "tol_scaled": TOL_SCALED, "metrics_max_abs_err": merr,
           "tol_metrics": 1e-4}
    emit(res)
    if max(errs.values()) > TOL_SCALED or merr > 1e-4:
        raise AssertionError(f"card and CPU rounds disagree: {res}")
    return res


def phase_rounds(epoch, part, expect_launches):
    import torch
    from cglgan_tpu_torch.algos.registry import build_runner
    from cglgan_tpu_torch.algos.runner import train
    from cglgan_tpu_torch.core.config import FedGANConfig
    from cglgan_tpu_torch.ops import fused_dstep
    from cglgan_tpu_torch.utils.profiling import profile_rounds

    cfg = FedGANConfig(algo="capgan", dataset="synthetic-mnist",
                       num_workers=16, num_servers=1, iid=1, batch_size=100,
                       epoch=epoch)
    runner = build_runner(cfg, part)
    state = train(runner, 2, eval_every=2)["state"]      # warm-up rounds
    torch.cuda.synchronize()
    fused_dstep.launches = 0
    t0 = time.perf_counter()
    out = train(runner, ROUNDS, eval_every=10, state=state)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fused_dstep.launches
    finite_metrics(out["history"])
    if launches != expect_launches:
        raise AssertionError(f"fused_dstep launches {launches}, expected "
                             f"{expect_launches}")
    imgs = runner.sample(out["state"], 16)
    if tuple(imgs.shape) != (16, 1, 28, 28) or \
            not bool(torch.isfinite(imgs).all()) or \
            float(imgs.abs().max()) > 1.0:
        raise AssertionError(f"bad samples {tuple(imgs.shape)}")
    res = {"phase": "main" if expect_launches else "autograd",
           "config": {"algo": "capgan", "dataset": "synthetic-mnist",
                      "num_workers": 16, "num_servers": 1, "iid": 1,
                      "batch_size": 100, "epoch": epoch},
           "rounds": ROUNDS, "wall_s": wall, "rounds_per_s": ROUNDS / wall,
           "fused_dstep_launches": launches,
           "uses_kernel": fused_dstep.eligible(cfg),
           "last_tick": out["history"][-1],
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           # after the counted run: where a round's time goes
           "profile": profile_rounds(runner, out["state"], 10)}
    emit(res)
    return res, launches


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to measure",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from cglgan_tpu_torch.algos.registry import load_partition
    from cglgan_tpu_torch.core.config import FedGANConfig
    from cglgan_tpu_torch.data import native
    from cglgan_tpu_torch.ops import _build, fused_dstep

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
          "ptxas": _build.ptxas_report("fused_dstep").splitlines()})

    kernel_res = phase_kernel(name)
    phase_reference()

    t0 = time.perf_counter()
    cfg = FedGANConfig(algo="capgan", dataset="synthetic-mnist",
                       num_workers=16, num_servers=1, iid=1, batch_size=100)
    part = load_partition(cfg)
    emit({"phase": "data", "seconds": time.perf_counter() - t0,
          "glyph_backend": "native" if native.available() else "numpy",
          "shards": list(part.data.shape)})
    _, launches = phase_rounds(5, part, ROUNDS)
    phase_rounds(1, part, 0)

    head = kernel_res[0]
    kernels = [{
        "name": "fused_dstep", "route": "cuda", "source": fused_dstep.SOURCE,
        "replaces": fused_dstep.REPLACES, "launches": launches,
        "max_abs_err": max(r["errors"][g]["max_abs_err"] for r in kernel_res
                           for g in r["errors"]),
        "ms": head["kernel_ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": None}]
    print(card, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

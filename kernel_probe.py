#!/usr/bin/env python3
"""Where ``fused_dstep``'s tensor-core GEMM (``csrc/mma_tf32.cuh``) and the
``fused_sweep`` cluster kernel spend their time on the card: a probe for
whoever tunes them next, not part of any path.

    python3 kernel_probe.py [--only micro|variants|sweep]

micro     builds ``csrc/probe_mma_tf32.cu`` and prints what the GEMM's inner
          loop reaches with no memory traffic, ingredient by ingredient
          (the rate of ``mma.sync`` TF32 first).
variants  rebuilds ``fused_dstep.cu`` with ``mma_tf32.cuh`` edited in a copy
          (one substitution a variant: another tile shape, or a part of the
          loop taken out) and prints, for one call at the main-path shape,
          the device time of the call and of each kernel of its last step
          (``torch.profiler``).  Variants that still compute the product are
          held to the plain version; ablations compute something else and
          are timed only.
sweep     rebuilds ``fused_sweep.cu`` with ``-DSWEEP_PHASE_CLOCK`` (worker
          0's blocks read ``%globaltimer`` at the end of each phase's work
          and when its cluster barrier lets go) and prints, at the main-path
          shapes of both G widths, the time of a call and, phase by phase
          (mean over the E iterations), the span, the slowest and the mean
          block's work and the rest (barrier and skew); then the call time
          of variants of the source (cluster size, blocks an SM), each held
          to the plain version.
Prints JSON lines; needs a CUDA card and ``nvcc``; imports nothing of JAX.
"""
import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

TILES = "constexpr int WARPS_M = 2, WARPS_N = 4, MT = 2, NT = 4, PASS_MT = 2;"
BLOCKS = "constexpr int MIN_BLOCKS = 2;"
STAGES = "constexpr int BK = 32, STAGES = 3,"
NO_LOADS = ("if (kt + STAGES - 1 < nk) load((kt + STAGES - 1) % STAGES, "
            "kt + STAGES - 1);", "")
TERMS = "for (int term = 0; term < 3; ++term)"
SPLIT_HI = "*hi = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;"
SPLIT_LO = "*lo = __float_as_uint(__fsub_rn(x, __uint_as_float(*hi)));"


def tiles(wm, wn, mt, nt, pass_mt, blocks, stages=3):
    return [(TILES, f"constexpr int WARPS_M = {wm}, WARPS_N = {wn}, "
                    f"MT = {mt}, NT = {nt}, PASS_MT = {pass_mt};"),
            (BLOCKS, f"constexpr int MIN_BLOCKS = {blocks};"),
            (STAGES, f"constexpr int BK = 32, STAGES = {stages},")]


# name -> (substitutions in mma_tf32.cuh, still the same product?)
VARIANTS = {
    "as committed: 64x128 tile, 8 warps, 2 blocks an SM": ([], True),
    "128x64 tile (4x2 warps)": (tiles(4, 2, 2, 4, 2, 2), True),
    "64x64 tile, 4 warps, 4 blocks an SM": (tiles(2, 2, 2, 4, 2, 4), True),
    "128x128 tile, 64x32 a warp, 1 block an SM, 4 stages":
        (tiles(2, 4, 4, 4, 2, 1, 4), True),
    "ablation: no copies inside the k loop": ([NO_LOADS], False),
    "ablation: one of the three terms": (
        [(TERMS, TERMS.replace("term = 0", "term = 2"))], False),
    "ablation: no hi/lo split": (
        [(SPLIT_HI, "*hi = __float_as_uint(x);"),
         (SPLIT_LO, "*lo = __float_as_uint(x) ^ 3u;")], False),
    "ablation: no mma (copies and epilogues only)": (
        [(TERMS, TERMS.replace("term = 0", "term = 3"))], False),
}


def emit(obj):
    print(json.dumps(obj), flush=True)


def micro(build_dir):
    from cglgan_tpu_torch.ops import _build
    exe = os.path.join(build_dir, "probe_mma_tf32")
    subprocess.run([_build.nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                    "-O3", "-o", exe,
                    os.path.join(_build.CSRC, "probe_mma_tf32.cu")],
                   check=True)
    out = subprocess.run([exe], capture_output=True, text=True, check=True)
    for line in out.stdout.splitlines():
        emit({"probe": "micro", "line": line})


def variants(build_dir):
    import torch
    from torch.profiler import ProfilerActivity, profile
    import chip_smoke as cs
    from cglgan_tpu_torch.ops import _build, fused_dstep

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(1236)
    args = cs.dstep_inputs(gen, cs.W, cs.E, cs.B, cs.DIN, cs.H1, cs.H2, 2)
    kw = dict(head="logits2", d_loss_half=True, lr=2e-4, b1=0.5, b2=0.999)
    with open(os.path.join(_build.CSRC, "mma_tf32.cuh")) as f:
        header = f.read()
    committed = _build.target
    for name, (subs, same_product) in VARIANTS.items():
        text = header
        for old, new in subs:
            if old not in text:
                raise AssertionError(f"{name}: mma_tf32.cuh no longer has "
                                     f"{old!r}")
            text = text.replace(old, new)
        src = os.path.join(build_dir, "variant_src")
        shutil.rmtree(src, ignore_errors=True)
        shutil.copytree(_build.CSRC, src)
        with open(os.path.join(src, "mma_tf32.cuh"), "w") as f:
            f.write(text)
        so = os.path.join(build_dir, f"variant_{abs(hash(name))}.so")
        log = subprocess.run([_build.nvcc(), *_build.FLAGS, "-o", so,
                              os.path.join(src, "fused_dstep.cu")],
                             capture_output=True, text=True)
        if log.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log.stdout}"
                               f"{log.stderr}")
        regs = [l.split("Used ")[1].split(",")[0]
                for l in (log.stdout + log.stderr).splitlines()
                if "Used " in l][:3]
        # the wrapper loads whatever _build.target names
        fused_dstep._LIB = None
        _build._LIBS.pop("fused_dstep", None)
        _build.target = lambda n, so=so: so if n == "fused_dstep" \
            else committed(n)
        try:
            errs = cs.dstep_check(args, kw) if same_product else None
            call = lambda: fused_dstep.fused_d_epoch_steps(*args, **kw)
            call()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                call()
                torch.cuda.synchronize()
        finally:
            _build.target = committed
            fused_dstep._LIB = None
            _build._LIBS.pop("fused_dstep", None)
        events = sorted((e for e in prof.events() if e.device_type
                         == torch.autograd.DeviceType.CUDA
                         and "anonymous" in e.name),
                        key=lambda e: e.time_range.start)
        label = lambda n: ("X W" if "<true, true" in n else
                           "G W^T" if "<true, false" in n else
                           "A^T G + Adam" if "<false, true" in n else
                           n.replace("(anonymous namespace)::", "")
                           .split("(")[0])
        emit({"probe": "variant", "name": name, "registers": regs,
              "same_product": same_product,
              "ok": None if errs is None
              else all(v["ok"] for v in errs.values()),
              "call_device_us": sum(e.device_time for e in events),
              "last_step_us": [[label(e.name), round(e.device_time, 1)]
                               for e in events[-fused_dstep
                                               .LAUNCHES_PER_STEP:]]})


# name -> substitutions (file under csrc/, old, new)
SWEEP_VARIANTS = {
    "as committed": [],
    "clusters of 4": [("fused_sweep.cu", "constexpr int CLUSTER = 8;",
                       "constexpr int CLUSTER = 4;")],
    "1 block an SM": [("fused_sweep.cu",
                       "__launch_bounds__(TPB, 2) sweep_kernel",
                       "__launch_bounds__(TPB, 1) sweep_kernel")],
    "32-deep slabs": [("mlp_kernels.cuh", "BK = 16, TPB = 256;",
                       "BK = 32, TPB = 256;")],
    "slab loop unrolled by 4, not 16": [
        ("mlp_kernels.cuh", "#pragma unroll\n    for (int kk = 0; kk < BK;",
         "#pragma unroll 4\n    for (int kk = 0; kk < BK;")],
    "ablation: 1 of 16 slab steps summed (wrong product, timed only)": [
        ("mlp_kernels.cuh", "for (int kk = 0; kk < BK; ++kk) {",
         "for (int kk = 0; kk < 1; ++kk) {")],
    "ablation: no slab loads after the first (wrong product, timed only)": [
        ("mlp_kernels.cuh", "    if (t + 1 < nk) load((t + 1) * BK);\n",
         "")],
}


def sweep_phase_names(L_g):
    names = [f"G layer {i} on [z1; z2] (tiles)" for i in range(L_g - 1)]
    names += ["G tanh layer, D layer 0 (rows)", "D layer 1 (tiles)",
              "D head (rows)", "D layer-1 input grad (tiles); head grads, "
              "loss (extras)", "D layer-1 weight grad + Adam (tiles); "
              "layer 0 (extras)", "new D layer 0 on fake2 (rows)",
              "new D layer 1 (tiles)", "new D head (rows)",
              "new D layer-1 input grad (tiles); G loss",
              "dfake, G's last hidden dz (rows)"]
    for i in range(L_g - 2, -1, -1):
        up = f"G layer {i + 1} weight grad + Adam" + (
            " (extras)" if i + 1 == L_g - 1 else " (tiles)")
        names.append(up + (f"; G layer {i} input grad (tiles)" if i else
                           "; G layer 0 weight grad + Adam (tiles)"))
    return names


def sweep_build(build_dir, name, subs, flags=()):
    from cglgan_tpu_torch.ops import _build
    src = os.path.join(build_dir, "sweep_src")
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(_build.CSRC, src)
    for fname, old, new in subs:
        with open(os.path.join(src, fname)) as f:
            text = f.read()
        if old not in text:
            raise AssertionError(f"{name}: {fname} no longer has {old!r}")
        with open(os.path.join(src, fname), "w") as f:
            f.write(text.replace(old, new))
    so = os.path.join(build_dir, f"sweep_{abs(hash((name,) + flags))}.so")
    log = subprocess.run([_build.nvcc(), *_build.FLAGS, *flags, "-o", so,
                          os.path.join(src, "fused_sweep.cu")],
                         capture_output=True, text=True)
    if log.returncode:
        raise RuntimeError(f"{name}: nvcc failed\n{log.stdout}{log.stderr}")
    regs = [l.split("Used ")[1] for l in (log.stdout + log.stderr)
            .splitlines() if "Used " in l]
    return so, regs + [f"{sass_instructions(so)} SASS instructions"]


def sass_instructions(so):
    """Instructions in the library's machine code (``cuobjdump -sass``), or
    None where the toolkit has no cuobjdump."""
    from cglgan_tpu_torch.ops import _build
    tool = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        return None
    out = subprocess.run([tool, "-sass", so], capture_output=True,
                         text=True).stdout
    return sum(1 for l in out.splitlines() if l.strip().startswith("/*")
               and "*/" in l and ";" in l)


def sweep_with(so, fn):
    """fn() with the fused_sweep wrapper bound to the library at so."""
    from cglgan_tpu_torch.ops import _build, fused_sweep
    committed = _build.target
    fused_sweep._LIB = None
    _build._LIBS.pop("fused_sweep", None)
    _build.target = lambda n: so if n == "fused_sweep" else committed(n)
    try:
        return fn()
    finally:
        _build.target = committed
        fused_sweep._LIB = None
        _build._LIBS.pop("fused_sweep", None)


def sweep(build_dir):
    import ctypes
    import torch
    import chip_smoke as cs
    from cglgan_tpu_torch.models.zoo import (build_discriminator,
                                             build_generator)
    from cglgan_tpu_torch.ops import fused_sweep

    d_model = build_discriminator("2dmg")
    kw = dict(lr_g=2e-4, lr_d=2e-4, b1=0.5, b2=0.999)
    inputs = {}
    for algo, family in (("flgan", "2dmg-mlp"), ("fegan", "2dmg-small")):
        gen = torch.Generator().manual_seed(4321 + len(cs.G_DIMS[algo]))
        inputs[algo] = cs.sweep_inputs(gen, build_generator(family), d_model,
                                       cs.W, cs.E, cs.B,
                                       cs.G_DIMS[algo])[2]
    # phase by phase, with the clock on
    so, regs = sweep_build(build_dir, "clock", [], ("-DSWEEP_PHASE_CLOCK",))

    def clocked():
        lib = fused_sweep._library()
        lib.fused_sweep_phase_clock.argtypes = [ctypes.c_void_p]
        lib.fused_sweep_block_sm.argtypes = [ctypes.c_void_p]
        out = []
        for algo, args in inputs.items():
            call = lambda: fused_sweep.fused_sweep_steps(*args, **kw)
            ms = cs.cuda_ms(call, 20)
            call()
            torch.cuda.synchronize()
            n_ph = 2 * 3 + 8
            buf = (ctypes.c_ulonglong * (8 + 32 * n_ph * 16))()
            rc = lib.fused_sweep_phase_clock(buf)
            if rc:
                raise RuntimeError(f"phase clock read failed ({rc})")
            C = fused_sweep.cluster_occupancy()["cluster"]
            L_g = len(cs.G_DIMS[algo]) - 1
            names = sweep_phase_names(L_g)
            at = lambda e, p, r, k: buf[8 + ((e * n_ph + p) * 8 + r) * 2 + k]
            prev = [max(buf[r] for r in range(C))] * 1
            rows = [[0.0, 0.0, 0.0] for _ in names]
            for e in range(cs.E):
                for p in range(len(names)):
                    exit_ = max(at(e, p, r, 1) for r in range(C))
                    work = [at(e, p, r, 0) - prev[0] for r in range(C)]
                    rows[p][0] += (exit_ - prev[0]) / 1e3 / cs.E
                    rows[p][1] += max(work) / 1e3 / cs.E
                    rows[p][2] += sum(work) / C / 1e3 / cs.E
                    prev[0] = exit_
            first = min(buf[r] for r in range(C))
            sm = (ctypes.c_int * 4096)()
            if lib.fused_sweep_block_sm(sm):
                raise RuntimeError("block SM read failed")
            used = [sm[b] for b in range(cs.W * C)]
            per_sm = {x: used.count(x) for x in set(used)}
            out.append({"probe": "sweep phases", "algo": algo,
                        "call_ms_clocked": ms, "registers": regs,
                        "blocks": len(used), "sms_used": len(per_sm),
                        "most_blocks_on_one_sm": max(per_sm.values()),
                        "worker0_sms": used[:C],
                        "worker0_us": (prev[0] - first) / 1e3,
                        "phases_us": [
                            {"phase": n, "span": round(a, 2),
                             "slowest_block": round(b, 2),
                             "mean_block": round(c, 2),
                             "barrier_and_skew": round(a - b, 2)}
                            for n, (a, b, c) in zip(names, rows)]})
        return out
    for line in sweep_with(so, clocked):
        emit(line)
    # the committed source at fewer workers: does a worker slow down when
    # all 16 clusters share the card?
    gen = torch.Generator().manual_seed(99)
    by_w = {}
    for w in (1, 8, 16):
        args = cs.sweep_inputs(gen, build_generator("2dmg-mlp"), d_model, w,
                               cs.E, cs.B, cs.G_DIMS["flgan"])[2]
        by_w[w] = cs.cuda_ms(lambda: fused_sweep.fused_sweep_steps(
            *args, **kw), 20)
    emit({"probe": "sweep workers", "algo": "flgan", "ms_by_workers": by_w})
    # variants, without the clock
    for name, subs in SWEEP_VARIANTS.items():
        so, regs = sweep_build(build_dir, name, subs)

        def run():
            occ = fused_sweep.cluster_occupancy()
            res = {"probe": "sweep variant", "name": name,
                   "registers": regs, **occ}
            for algo, args in inputs.items():
                errs = cs.sweep_check(args, kw)
                res[algo] = {
                    "ok": all(v["ok"] for v in errs.values()),
                    "ms": cs.cuda_ms(lambda: fused_sweep.fused_sweep_steps(
                        *args, **kw), 20)}
            return res
        emit(sweep_with(so, run))


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", choices=("micro", "variants", "sweep"))
    only = ap.parse_args(argv).only
    import torch
    if not torch.cuda.is_available():
        print("kernel_probe: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from cglgan_tpu_torch.ops import _build
    print(cs.card_line(), flush=True)
    build_dir = os.path.join(_build.BUILD_DIR, "probe")
    os.makedirs(build_dir, exist_ok=True)
    if only in (None, "micro"):
        micro(build_dir)
    if only in (None, "variants"):
        variants(build_dir)
    if only in (None, "sweep"):
        sweep(build_dir)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Where ``fused_dstep``'s tensor-core GEMM (``csrc/mma_tf32.cuh``) spends its
time on the card: a probe for whoever tunes it next, not part of any path.

    python3 kernel_probe.py [--only micro|variants]

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


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", choices=("micro", "variants"))
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
    return 0


if __name__ == "__main__":
    sys.exit(main())

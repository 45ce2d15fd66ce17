"""tpufed-torch — the experiment harness CLI of the PyTorch/CUDA port.

Port of ``cglgan_tpu/cli.py``, with the same knob names, run dirs and
commands:

    tpufed-torch run capgan --dataset synthetic-mnist --num-workers 16 \
                            --iid 1 --epoch 5 --batch-size 100 --rounds 20000
    tpufed-torch run flgan --dataset 2dmg --pallas-sweep on ...
    tpufed-torch run capgan ... --resume logger/<run>/ckpt_10000

``run`` builds the partition and the runner, trains with an eval tick
every ``--num-plt`` rounds, and writes the reference's run dir:
``config.json``, ``metrics.jsonl`` / ``.csv`` / ``.xlsx``, per-device
previews, a sample artifact a tick, ``ckpt_<round>`` whenever a
``--ckpt-every`` multiple is crossed and ``ckpt_final``; the same command
with ``--resume`` continues a run bit for bit.  It runs on the card unless
``--device cpu`` asks for the host, and raises without a card.
``--devices N`` shards the federation's clients over N ranks, one process
a card (``core/meshes.py``; with ``--device cpu``, N gloo ranks on the
host), and ``--model-shards M`` splits the CGL family's generators over M
of them (a ``(N / M, M)`` mesh; without ``--devices``, every card); rank
0 owns the run dir, and its checkpoints are an unsharded run's.  The
reference's ``--platform`` is ``--device`` here, and ``--compile-cache``
names the directory the CUDA kernels are built into.  Also ``sweep``,
``eval``, ``compare``, ``plot``, ``doctor`` and ``fid-stats``, and the
serving and migration commands:

    tpufed-torch export logger/<run>/ckpt_final --n 0 --out g.pt2
    tpufed-torch import-torch G.pt --samples s.png --export g.pt2
    tpufed-torch run capgan ... --init-from-torch G0.pt,G1.pt

``export`` writes a ``torch.export`` program of the trained generator
(``utils/export.py``; the reference's ``--platform`` / ``--platforms``
are ``--device``: a program is traced for one device), ``import-torch``
reads a reference ``torch.save(net_g.state_dict())`` file
(``utils/torch_import.py``) and ``--init-from-torch`` starts a run from
such files.  ``bench`` is not ported yet.

The top-level imports load no torch, so ``doctor`` can probe a card whose
initialisation hangs.
"""
from __future__ import annotations

import argparse
import os
import sys

from cglgan_tpu_torch.core.config import (ALGOS, DATASETS, FedGANConfig,
                                          WEIGHTINGS)

PREFIX = "[tpufed-torch]"
# mirrors models.zoo.GEN_SPECS (asserted equal in the tests): the CLI's
# top-level imports load no torch
GEN_SPECS = ("2dmg-small", "2dmg-mlp", "2dmg-multipath", "mnist-mlp",
             "mnist-multipath", "conv", "conv-multipath")


def _add_run_args(p: argparse.ArgumentParser, with_algo: bool = True) -> None:
    if with_algo:
        p.add_argument("algo", choices=ALGOS)
    p.add_argument("--dataset", default="2dmg", choices=DATASETS)
    p.add_argument("--num-workers", type=int, default=10)
    p.add_argument("--num-servers", type=int, default=1)
    p.add_argument("--num-class", type=int, default=10)
    p.add_argument("--num-sample", type=int, default=1000)
    p.add_argument("--iid", type=int, default=1, choices=(0, 1, 2))
    p.add_argument("--batch-size", type=int, default=100)
    p.add_argument("--frac-workers", type=float, default=1.0)
    p.add_argument("--epoch", type=int, default=1)
    p.add_argument("-E", "--E", type=int, default=0, dest="E",
                   help="gossip/D-share period in rounds (0 = off)")
    p.add_argument("-c", "--cloud-epoch", type=int, default=1)
    p.add_argument("-s", "--segema", type=float, default=0.0)
    p.add_argument("--rounds", type=int, default=None,
                   help="num_communication override (default: 10000 for 2dmg, "
                        "20000 for images — the reference scales)")
    p.add_argument("--num-plt", type=int, default=None,
                   help="eval cadence (default: 100 for 2dmg, 500 for images)")
    p.add_argument("--lr-g", type=float, default=2e-4)
    p.add_argument("--lr-d", type=float, default=2e-4)
    p.add_argument("--b1", type=float, default=0.5, help="Adam beta1")
    p.add_argument("--b2", type=float, default=0.999, help="Adam beta2")
    p.add_argument("--lr-lambda", type=float, default=0.1,
                   help="SGD lr for the Lambda game variable")
    p.add_argument("--img-size", type=int, default=28)
    p.add_argument("--dtype", default="float32",
                   choices=("float32", "bfloat16"),
                   help="param/activation dtype (JAX's bfloat16 rounding "
                        "rules, core/dtypes.py)")
    p.add_argument("--force-dtype", action="store_true",
                   help="override the bfloat16+2dmg fidelity guard")
    p.add_argument("--seed", type=int, default=20211212)
    p.add_argument("--weighting", default=None, choices=WEIGHTINGS)
    p.add_argument("--gossip", default="mean", choices=("mean", "delta"),
                   help="AC-GAN every-E-rounds exchange: 'mean' = block "
                        "average of client Ds; 'delta' = the reference "
                        "sketch's delta-accumulating exchange "
                        "(ACGAN/MNIST/acgan.py:240-263)")
    p.add_argument("--d-swap", default="ring", choices=("ring", "shuffle"),
                   help="MD-GAN E-round D-swap: deterministic ring permute "
                        "or the reference's seeded random shuffle")
    p.add_argument("--dropout-rate", type=float, default=0.0,
                   help="P(client misses a round) — straggler simulation "
                        "(flgan/mdgan/acgan/fegan)")
    p.add_argument("--conv", action="store_true",
                   help="use the conv LSGAN G/D pair (model/lsgan.py parity)")
    p.add_argument("--data-dir", default=None,
                   help="directory with MNIST IDX files (else synthetic)")
    p.add_argument("--inception-weights", default=None,
                   help="torchvision inception_v3 state dict (.npz or .pth) "
                        "for reference-comparable FID (else: proxy features)")
    p.add_argument("--fid-stats", default=None,
                   help=".npz with precomputed real-image mu/sigma "
                        "activation stats (pytorch-fid format)")
    p.add_argument("--out", default="./logger", help="run-dir root")
    p.add_argument("--name", default=None, help="run-dir name")
    p.add_argument("--ckpt-every", type=int, default=5000,
                   help="checkpoint cadence in rounds (reference: 5000)")
    p.add_argument("--resume", default=None,
                   help="path to a checkpoint to resume from")
    p.add_argument("--init-from-torch", default=None,
                   help="comma list of reference .pt generator state_dicts "
                        "to warm-start from (one per stacked G, or one to "
                        "broadcast); optimizer state starts fresh")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; cpu runs on the host "
                        "only when asked)")
    p.add_argument("--devices", type=int, default=0,
                   help="shard clients over N ranks, one process a card "
                        "(with --device cpu: N gloo ranks on the host; "
                        "0 = single-device, no mesh)")
    p.add_argument("--model-shards", type=int, default=1,
                   help="tensor-parallel generator shards over a `model` "
                        "mesh axis, CGL family only (must divide --devices; "
                        "without --devices, every card; 1 = off)")
    p.add_argument("--pallas-dstep", default="auto",
                   choices=("auto", "on", "off"),
                   help="the fused local-D-epoch CUDA kernel "
                        "(ops/csrc/fused_dstep.cu; auto = on when eligible "
                        "and epoch>1)")
    p.add_argument("--pallas-sweep", default="auto",
                   choices=("auto", "on", "off"),
                   help="the fused local D/G-sweep CUDA kernel for 2DMG "
                        "flgan/fegan (ops/csrc/fused_sweep.cu; auto/off = "
                        "autograd path, on = force the kernel)")
    p.add_argument("--profile", action="store_true",
                   help="write a torch.profiler trace of one tick's rounds "
                        "under <run>/profile")
    p.add_argument("--tensorboard", action="store_true",
                   help="also stream per-tick metrics as TensorBoard "
                        "scalars under <run>/tb/")
    p.add_argument("--from-config", default=None, metavar="CONFIG_JSON",
                   help="load the full knob set verbatim from a run dir's "
                        "config.json for an exact rerun (other knob flags "
                        "are ignored; runtime flags --out/--name/--devices/"
                        "--resume/... still apply)")
    _add_cache_arg(p)


def _add_cache_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument("--compile-cache", default="auto", metavar="DIR|off",
                   help="directory the CUDA kernels are built into and "
                        "loaded from (auto = build/torch_kernels under the "
                        "repository; off = a fresh directory for this "
                        "process, removed at exit)")


def _enable_compile_cache(args) -> None:
    """Point the kernel build at ``--compile-cache`` before any build."""
    val = getattr(args, "compile_cache", "auto")
    if val == "auto":
        return
    from cglgan_tpu_torch.ops import _build
    if val.strip().lower() in ("off", "0", "none", ""):
        import atexit
        import shutil
        import tempfile
        path = tempfile.mkdtemp(prefix="torch_kernels-")
        atexit.register(shutil.rmtree, path, True)
        val = path
    _build.set_build_dir(val)


def cfg_from_args(args) -> FedGANConfig:
    fc = getattr(args, "from_config", None)
    if fc:
        # exact rerun of an archived run: every run dir saves its frozen
        # config as config.json
        import json
        with open(fc) as f:
            d = json.load(f)
        if args.algo != d.get("algo"):
            raise SystemExit(f"{PREFIX} --from-config holds a "
                             f"{d.get('algo')!r} config but the command "
                             f"says {args.algo!r}")
        print(f"{PREFIX} config loaded verbatim from {fc} "
              f"(other knob flags ignored; runtime flags still apply)")
        return FedGANConfig(**d)
    is_image = args.dataset != "2dmg"
    rounds = args.rounds if args.rounds is not None else (
        20000 if is_image else 10000)
    num_plt = args.num_plt if args.num_plt is not None else (
        500 if is_image else 100)
    return FedGANConfig(
        algo=args.algo, dataset=args.dataset, num_workers=args.num_workers,
        num_servers=args.num_servers, num_class=args.num_class,
        num_sample=args.num_sample, iid=args.iid, batch_size=args.batch_size,
        frac_workers=args.frac_workers, epoch=args.epoch,
        E=args.E, cloud_epoch=args.cloud_epoch, segema=args.segema,
        num_communication=rounds, num_plt=num_plt, lr_g=args.lr_g,
        lr_d=args.lr_d, b1=args.b1, b2=args.b2, lr_lambda=args.lr_lambda,
        img_size=args.img_size, seed=args.seed, weighting=args.weighting,
        conv=args.conv, data_dir=args.data_dir,
        dropout_rate=args.dropout_rate, dtype=args.dtype,
        model_shards=getattr(args, "model_shards", 1),
        d_swap=getattr(args, "d_swap", "ring"),
        gossip=getattr(args, "gossip", "mean"),
        force_dtype=getattr(args, "force_dtype", False),
        pallas_dstep={"auto": None, "on": True, "off": False}[
            getattr(args, "pallas_dstep", "auto")],
        pallas_sweep={"auto": None, "on": True, "off": False}[
            getattr(args, "pallas_sweep", "auto")])


def _device_name(dev) -> str:
    import torch
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def _host_samples(samples):
    """A sample tensor as float32 numpy (bfloat16 samples exactly)."""
    return samples.detach().float().cpu().numpy()


def cmd_run(args) -> int:
    _execute_run(args)
    return 0


def _mesh_rank(mesh, args) -> dict:
    """A rank of ``run --devices N`` (``meshes.spawn``)."""
    return _execute_run(args, mesh)


def _execute_run(args, mesh=None) -> dict:
    """One training run; returns {"run_dir": path, "final": last tick dict}
    (None on a mesh rank other than 0).  ``--devices N`` spawns N ranks,
    each of which comes back here with its ``mesh``."""
    import numpy as np

    from cglgan_tpu_torch.algos.common import check_supported
    from cglgan_tpu_torch.algos.registry import build_runner, load_partition
    from cglgan_tpu_torch.algos.runner import train
    from cglgan_tpu_torch.core import device as device_mod
    from cglgan_tpu_torch.utils.checkpoint import (restore_checkpoint,
                                                   save_checkpoint)
    from cglgan_tpu_torch.utils.imaging import save_image_grid, save_scatter_2d
    from cglgan_tpu_torch.utils.logging import RunDir

    init_pts = getattr(args, "init_from_torch", None)
    if init_pts and args.resume:
        raise SystemExit("--init-from-torch and --resume are mutually "
                         "exclusive (a checkpoint already has generators)")
    cfg = cfg_from_args(args)
    check_supported(cfg)
    if mesh is None and (args.devices or cfg.model_shards > 1):
        import torch

        from cglgan_tpu_torch.core import meshes
        n = args.devices
        if not n:
            # the reference's fed_mesh(None, M): every device present
            if args.device is not None and \
                    torch.device(args.device).type == "cpu":
                raise ValueError("--model-shards on --device cpu needs "
                                 "--devices N (gloo ranks on the host)")
            n = torch.cuda.device_count() or cfg.model_shards
        # raises where fewer cards than ranks are present, or where
        # --model-shards does not divide them
        return meshes.spawn(_mesh_rank, n, args.device, args,
                            model_shards=cfg.model_shards)[0]
    # rank 0 (or an unsharded run) owns the run dir, the logs, the
    # artifacts and the checkpoint files; the other ranks write nothing
    lead = mesh is None or mesh.lead
    dev = mesh.device if mesh else device_mod.resolve(args.device)
    say = print if lead else (lambda *a, **k: None)
    synthetic = cfg.dataset in ("mnist", "fashion-mnist") and not cfg.data_dir
    if synthetic:
        say(f"{PREFIX} WARNING: no --data-dir given for {cfg.dataset}; "
            "falling back to the deterministic synthetic glyph dataset "
            "(same shapes/cardinality, not handwriting)")
    if cfg.dtype == "bfloat16" and cfg.dataset == "2dmg":
        # construction only succeeds here with force_dtype=True
        say(f"{PREFIX} WARNING: --force-dtype bfloat16 on 2DMG; fidelity "
            "results from this run are not reference-comparable")
    part = load_partition(cfg)
    runner = build_runner(cfg, part, device=dev, mesh=mesh)
    # where the checkpoints' client stacks live
    on_mesh = dict(mesh=mesh, layout=runner.layout)
    state = runner.init_state()
    if init_pts:
        from cglgan_tpu_torch.utils.torch_import import warm_start_generators
        paths = [p.strip() for p in init_pts.split(",") if p.strip()]
        state = warm_start_generators(state, paths)
        say(f"{PREFIX} generators warm-started from {len(paths)} "
            f"reference checkpoint(s)")
    if args.resume:
        state = restore_checkpoint(args.resume, state, **on_mesh)
        say(f"{PREFIX} resumed from {args.resume} at round {state.t}")
    # a resume into the same run dir drops the ticks it will log again
    run_dir = RunDir(args.out, args.name, cfg,
                     tensorboard=getattr(args, "tensorboard", False),
                     resume_round=state.t if args.resume else None) \
        if lead else None
    # a file of rank 0's run dir; the other ranks write none
    lead_file = lambda name: run_dir.file(name) if lead else None
    if lead and synthetic:
        # a permanent marker, so that a run dir on the glyph bank is never
        # taken for a run on the real data
        with open(run_dir.file("DATA_SOURCE.txt"), "w") as f:
            f.write(
                f"dataset={cfg.dataset} trained on the DETERMINISTIC "
                "SYNTHETIC GLYPH BANK (cglgan_tpu_torch/data/mnist.py), not "
                "the real dataset.  Shapes, cardinality, label structure "
                "and Non-IID partitions match the real sets; pixel content "
                "does not.  Metrics are comparable across runs on the glyph "
                "bank, NOT to runs on the real data.  Pass --data-dir with "
                "the IDX files to train on real data.\n")
    say(f"{PREFIX} run dir: {run_dir.path if lead else None}")
    say(f"{PREFIX} device: {dev} ({_device_name(dev)})"
        + (f", mesh of {mesh.size} ranks" if mesh else "")
        + (f" x {mesh.model_size} model shards" if mesh and mesh.tp
           else ""))
    say(f"{PREFIX} shards: {part.lengths.tolist()}")

    # per-device distribution previews (CGLGAN/MNIST/main.py:499-501)
    img_side = cfg.img_size + 4 if cfg.conv else cfg.img_size
    for i in range(min(cfg.num_workers, 32) if lead else 0):
        L = int(part.lengths[i])
        sel = part.data[i, :min(L, 100)]
        if cfg.is_image:
            save_image_grid(sel.reshape(-1, img_side, img_side).astype(
                np.float32) / 255.0,
                            run_dir.file(f"device_{i}.png"), normalize=False)
        else:
            save_scatter_2d(run_dir.file(f"device_{i}.png"), sel)

    eval_pool = np.asarray(part.eval_pool)
    last_ckpt = [state.t]

    def on_tick(t, tick, cur_state):
        if lead:
            msg = " ".join(f"{k}={v:.4f}" for k, v in sorted(tick.items())
                           if isinstance(v, float))
            print(f"{PREFIX} round {t}: {msg}")
            run_dir.log(tick)
        # checkpoint whenever a ckpt_every multiple is crossed (exact
        # divisibility by the tick cadence not required); on a mesh every
        # rank takes part
        if args.ckpt_every and t // args.ckpt_every > \
                last_ckpt[0] // args.ckpt_every:
            save_checkpoint(lead_file(f"ckpt_{t}"), cur_state, **on_mesh)
            last_ckpt[0] = t

    result = lambda final: {"run_dir": run_dir.path, "final": final} \
        if lead else None
    remaining = cfg.num_communication - state.t
    if remaining <= 0:
        say(f"{PREFIX} nothing to do (state already past "
            "num_communication)")
        return result({})

    if args.profile:
        import contextlib

        from cglgan_tpu_torch.utils.profiling import trace
        with trace(run_dir.file("profile"), dev) if lead \
                else contextlib.nullcontext():
            train(runner, rounds=min(cfg.num_plt, remaining), state=state,
                  evaluator=False)
        say(f"{PREFIX} profile written to {lead_file('profile')}")
        return result({})

    # the single source of eval truth: library callers get the same
    # metrics; on a mesh rank 0 evaluates (``train`` turns the other
    # ranks' evaluator off), from the state with the whole G
    evaluator = None
    if lead:
        from cglgan_tpu_torch.evalx.evaluator import make_evaluator
        scores = make_evaluator(cfg, part, fid_stats=args.fid_stats,
                                inception_weights=args.inception_weights,
                                device=dev)

        def evaluator(run, seen):
            # and the tick's sample artifact
            samples = _host_samples(run.sample(seen,
                                               min(100, cfg.num_sample)))
            if cfg.is_image:
                save_image_grid(samples, run_dir.file(f"{seen.t}.png"))
            else:
                save_scatter_2d(run_dir.file(f"{seen.t}.png"),
                                eval_pool[:2000], samples)
            return scores(run, seen)
    if cfg.is_image:
        space = "inception-pool3" if args.inception_weights else "proxy-conv"
        say(f"{PREFIX} FID feature space: {space}"
            + (f", real stats from {args.fid_stats}" if args.fid_stats
               else ""))

    out = train(runner, rounds=remaining, state=state, on_tick=on_tick,
                evaluator=evaluator)
    state = out["state"]
    save_checkpoint(lead_file("ckpt_final"), state, **on_mesh)
    if lead:
        run_dir.close()
    hist = out["history"]
    say(f"{PREFIX} done: {state.t} rounds in {hist[-1]['wall_s']:.1f}s"
        if hist else f"{PREFIX} done")
    return result(hist[-1] if hist else {})


def cmd_sweep(args) -> int:
    """Sweep algos x datasets x iid in one invocation — the reference's
    ``__main__`` loops (CGLGAN/MNIST/main.py:459-535, fegan.py:454-554) —
    and write one comparison table (sweep_summary.xlsx/csv) across all
    runs, rewritten after every run."""
    import copy
    import time

    from cglgan_tpu_torch.utils.xlsx import write_xlsx

    if getattr(args, "from_config", None):
        # a frozen config would silently override the swept dataset/iid
        raise SystemExit(f"{PREFIX} --from-config is for single runs; "
                         "sweep builds each sub-run's config itself")
    algos = [a.strip() for a in args.algos.split(",") if a.strip()]
    datasets = [d.strip() for d in args.datasets.split(",") if d.strip()]
    iids = [int(x) for x in args.iids.split(",")]
    for a in algos:
        if a not in ALGOS:
            raise SystemExit(f"unknown algo {a!r}")
    root = os.path.join(
        args.out, time.strftime("%Y-%m-%d_%H-%M-%S") + "-sweep")
    os.makedirs(root, exist_ok=True)

    summaries = []
    for dataset in datasets:
        for iid in iids:
            for algo in algos:
                sub = copy.copy(args)
                sub.algo, sub.dataset, sub.iid = algo, dataset, iid
                sub.out = root
                sub.name = f"{algo}-{dataset}-iid{iid}"
                if algo == "mdgan" and args.num_servers != 1:
                    # mdgan has one central generator by definition
                    sub.num_servers = 1
                    print(f"{PREFIX} {sub.name}: num_servers forced to 1")
                print(f"{PREFIX} === sweep {sub.name} ===")
                res = _execute_run(sub)
                row = {"algo": algo, "dataset": dataset, "iid": iid,
                       "run_dir": res["run_dir"]}
                row.update({k: v for k, v in res["final"].items()
                            if isinstance(v, (int, float))})
                summaries.append(row)
                # partial table after every run: a crash loses nothing
                write_xlsx(os.path.join(root, "sweep_summary.xlsx"),
                           summaries)
                _write_summary_csv(os.path.join(root, "sweep_summary.csv"),
                                   summaries)

    _print_summary_table(summaries, "sweep summary")
    print(f"{PREFIX} table: {os.path.join(root, 'sweep_summary.xlsx')}")
    return 0


def _print_summary_table(rows, label: str) -> None:
    cols = []           # union across rows, first-appearance order
    for r in rows:
        cols += [k for k in r if k != "run_dir" and k not in cols]
    print(f"{PREFIX} {label}:")
    print("  " + " | ".join(cols))
    for row in rows:
        print("  " + " | ".join(
            f"{row.get(c):.4f}" if isinstance(row.get(c), float)
            else str(row.get(c, "")) for c in cols))


def cmd_compare(args) -> int:
    """Tabulate run dirs (the port's or the reference's: the same files)
    into one comparison table of each run's last tick, without retraining
    anything."""
    import json

    from cglgan_tpu_torch.utils.xlsx import write_xlsx

    rows = []
    for d in args.run_dirs:
        cfg_p = os.path.join(d, "config.json")
        met_p = os.path.join(d, "metrics.jsonl")
        if not (os.path.isfile(cfg_p) and os.path.isfile(met_p)):
            print(f"{PREFIX} skipping {d}: no config.json + metrics.jsonl")
            continue
        with open(cfg_p) as f:
            cfg = json.load(f)
        last = None
        with open(met_p) as f:
            for line in f:
                if line.strip():
                    last = json.loads(line)
        if last is None:
            print(f"{PREFIX} skipping {d}: empty metrics.jsonl")
            continue
        # data provenance: image runs without --data-dir train on the
        # glyph bank (the run dir carries DATA_SOURCE.txt)
        ds = cfg.get("dataset")
        if ds == "2dmg":
            src = "gmm"
        elif os.path.isfile(os.path.join(d, "DATA_SOURCE.txt")) \
                or ds == "synthetic-mnist" or not cfg.get("data_dir"):
            src = "glyphs"
        else:
            src = "idx"
        row = {"algo": cfg.get("algo"), "dataset": ds, "data": src,
               "iid": cfg.get("iid"), "run_dir": d}
        row.update({k: v for k, v in last.items()
                    if isinstance(v, (int, float))})
        rows.append(row)
    if not rows:
        raise SystemExit(f"{PREFIX} no usable run dirs")
    rows.sort(key=lambda r: (str(r["dataset"]), str(r["iid"]),
                             str(r["algo"])))
    _print_summary_table(rows, f"comparison ({len(rows)} runs)")
    if args.out:
        write_xlsx(args.out + ".xlsx", rows)
        _write_summary_csv(args.out + ".csv", rows)
        print(f"{PREFIX} table: {args.out}.xlsx / .csv")
    return 0


def _write_summary_csv(path: str, rows) -> None:
    import csv
    fields = []
    for r in rows:
        for k in r:
            if k not in fields:
                fields.append(k)
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=fields)
        w.writeheader()
        w.writerows(rows)


def cmd_eval(args) -> int:
    """Score a saved checkpoint: rebuild the runner from the run dir's
    config.json, restore, sample, and report the workload's metrics."""
    import json

    from cglgan_tpu_torch.algos.registry import build_runner, load_partition
    from cglgan_tpu_torch.core import device as device_mod
    from cglgan_tpu_torch.evalx.evaluator import make_evaluator
    from cglgan_tpu_torch.utils.checkpoint import restore_checkpoint
    from cglgan_tpu_torch.utils.imaging import save_image_grid, save_scatter_2d

    dev = device_mod.resolve(args.device)
    run_dir = os.path.dirname(os.path.abspath(args.checkpoint))
    with open(os.path.join(run_dir, "config.json")) as f:
        cfg = FedGANConfig(**json.load(f))
    part = load_partition(cfg)   # loaded once, shared with the runner
    runner = build_runner(cfg, part, device=dev)
    state = restore_checkpoint(args.checkpoint, runner.init_state())
    print(f"{PREFIX} checkpoint at round {state.t}")
    samples = runner.sample(state, args.n)
    host = _host_samples(samples)
    out = args.out or os.path.join(run_dir, f"eval_{state.t}")
    report = {"round": state.t, "n": args.n}
    if cfg.is_image:
        side = cfg.img_size + 4 if cfg.conv else cfg.img_size
        save_image_grid(host.reshape(-1, 1, side, side)[:100], out + ".png")
    else:
        save_scatter_2d(out + ".png", part.eval_pool[:2000], host)
    evaluator = make_evaluator(
        cfg, part, eval_n=args.n, fid_stats=args.fid_stats,
        inception_weights=args.inception_weights, device=dev)
    # reuse the samples already drawn for the artifact (same fixed-z draw)
    report.update(evaluator(runner, state, samples=samples))
    print(json.dumps(report))
    return 0


# Categorical series palette, fixed slot order assigned by run position —
# never cycled, never re-sorted (the ordering is the colorblind-safety
# mechanism).  Runs beyond 8 series must facet, not reuse hues; numeric
# values always remain available as the table view (``compare``).
_SERIES_PALETTE = ("#2a78d6", "#eb6834", "#1baf7a", "#eda100",
                   "#e87ba4", "#008300", "#4a3aa7", "#e34948")


def cmd_plot(args) -> int:
    """Render run dirs' metric trajectories into one comparison figure —
    the cross-run view of ``compare``, as curves (one line per run, one
    panel per metric).  Uses no device.

        tpufed-torch plot logger/mnist-iid2-* --out plots/iid2.png
    """
    import json

    try:
        import matplotlib
    except ImportError as e:
        raise SystemExit(f"{PREFIX} plot needs matplotlib, which this "
                         f"Python cannot import ({e})")
    matplotlib.use("Agg")
    from matplotlib import pyplot as plt

    runs = []
    for d in args.run_dirs:
        met_p = os.path.join(d, "metrics.jsonl")
        if not os.path.isfile(met_p):
            print(f"{PREFIX} skipping {d}: no metrics.jsonl")
            continue
        with open(met_p) as f:
            rows = [json.loads(line) for line in f if line.strip()]
        if not rows:
            print(f"{PREFIX} skipping {d}: empty metrics.jsonl")
            continue
        runs.append((os.path.basename(os.path.normpath(d)), rows))
    if not runs:
        raise SystemExit(f"{PREFIX} no usable run dirs")
    if len(runs) > len(_SERIES_PALETTE):
        raise SystemExit(
            f"{PREFIX} {len(runs)} runs exceed the {len(_SERIES_PALETTE)} "
            "validated series slots — facet into several plots instead")

    if args.metrics:
        metrics = [m.strip() for m in args.metrics.split(",") if m.strip()]
    else:
        last = runs[0][1][-1]
        metrics = (["kl_score", "mode_coverage"] if "kl_score" in last
                   else ["fid", "inception_score"])
    fig, axes = plt.subplots(1, len(metrics),
                             figsize=(6.4 * len(metrics), 4.6),
                             squeeze=False)
    plotted = 0
    for ax, metric in zip(axes[0], metrics):
        for slot, (label, rows) in enumerate(runs):
            xs = [r["round"] for r in rows if metric in r]
            ys = [r[metric] for r in rows if metric in r]
            if not xs:
                continue
            ax.plot(xs, ys, color=_SERIES_PALETTE[slot], linewidth=2,
                    label=label)
            plotted += 1
        if args.logy and metric in ("fid", "kl_score"):
            ax.set_yscale("log")
        ax.set_xlabel("round")
        ax.set_ylabel(metric)
        ax.grid(True, alpha=0.25, linewidth=0.5)
        for side in ("top", "right"):
            ax.spines[side].set_visible(False)
    if plotted == 0:
        plt.close(fig)
        raise SystemExit(f"{PREFIX} no run carries any of {metrics}")
    axes[0][0].legend(frameon=False, fontsize=8)
    if args.title:
        fig.suptitle(args.title)
    fig.tight_layout()
    out_dir = os.path.dirname(args.out)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    fig.savefig(args.out, dpi=140)
    plt.close(fig)
    print(f"{PREFIX} figure: {args.out} ({len(runs)} runs, "
          f"panels: {', '.join(metrics)})")
    return 0


def cmd_export(args) -> int:
    """Export the trained generator as a ``torch.export`` serving artifact
    (utils/export.py): eval-mode G forward, weights held, callable as
    z[n, latent] -> samples with no model code or checkpoint.  The program
    is traced for ``--device``."""
    import json

    from cglgan_tpu_torch.algos.registry import build_runner
    from cglgan_tpu_torch.core import device as device_mod
    from cglgan_tpu_torch.utils.checkpoint import restore_checkpoint
    from cglgan_tpu_torch.utils.export import (export_client_generator,
                                               export_generator,
                                               save_generator)

    dev = device_mod.resolve(args.device)
    run_dir = os.path.dirname(os.path.abspath(args.checkpoint))
    with open(os.path.join(run_dir, "config.json")) as f:
        cfg = FedGANConfig(**json.load(f))
    runner = build_runner(cfg, device=dev)
    state = restore_checkpoint(args.checkpoint, runner.init_state())
    n = args.n if args.n > 0 else None
    extra = {"algo": cfg.algo, "dataset": cfg.dataset, "round": state.t}
    if args.client is not None:
        ep = export_client_generator(runner, state, args.client, n)
        default_name = f"generator_{state.t}_client{args.client}.pt2"
        extra["client"] = args.client
    else:
        ep = export_generator(runner, state, n)
        default_name = f"generator_{state.t}.pt2"
    out = args.out or os.path.join(run_dir, default_name)
    manifest = save_generator(ep, out, extra)
    print(json.dumps({"out": out, **manifest}))
    return 0


def cmd_import_torch(args) -> int:
    """Import a reference ``torch.save(net_g.state_dict())`` checkpoint
    (the only artifact the reference trainers produce —
    CGLGAN/MNIST/main.py:191, capgan.py:186-198): detect the generator
    family from the state_dict, convert to the port's trees, and
    optionally draw samples, score them and/or export a ``torch.export``
    serving artifact.  Prints one JSON summary line."""
    import json

    import numpy as np

    from cglgan_tpu_torch.core import device as device_mod
    from cglgan_tpu_torch.core import threefry
    from cglgan_tpu_torch.utils.torch_import import import_generator_file
    from cglgan_tpu_torch.utils.tree import tree_leaves, tree_map

    dev = device_mod.resolve(args.device)
    model, params, state, info = import_generator_file(
        args.checkpoint, family=args.family,
        num_heads=args.num_heads,
        img_shape=((1, args.img_size, args.img_size)
                   if args.img_size else None), device=dev)
    n_params = sum(x.numel() for x in tree_leaves(params))
    report = {"checkpoint": args.checkpoint, **info, "params": n_params}
    up = lambda tree: tree_map(lambda x: x.unsqueeze(0), tree)

    def forward(seed):
        # the reference's jax.random.normal(jax.random.key(seed), (n, 100))
        z = threefry.normal(threefry.key(seed, dev), (args.n, 100))
        y, _ = model.apply(up(params), up(state), z.unsqueeze(0),
                           train=False)
        y = y[0]
        if model.multipath:
            # (heads, n, ...) -> (heads*n, ...) interleaved sample-major, so
            # that any truncation (grid [:100], evaluator [:n]) spans ALL
            # heads: the multi-path G's mode coverage lives in the head
            # mixture (mixed-gan.py:242-252)
            y = y.transpose(0, 1).reshape((-1,) + tuple(y.shape[2:]))
        return y

    if args.samples:
        y = _host_samples(forward(args.seed))
        out_path = args.samples
        if y.ndim >= 3:       # image families -> grid PNG
            from cglgan_tpu_torch.utils.imaging import save_image_grid
            save_image_grid(y.reshape(-1, *y.shape[-3:])[:100], out_path)
        else:                 # 2DMG points -> raw array (np.save appends
            # ".npy" to suffix-less paths; normalize first so the reported
            # path is the file that actually exists)
            if not out_path.endswith(".npy"):
                out_path += ".npy"
            np.save(out_path, y)
        report["samples"] = out_path

    if args.eval_dataset:
        # score the imported G with the workload's evaluator: FID /
        # Inception Score on images, KL / DS / mode coverage on 2DMG
        from cglgan_tpu_torch.algos.registry import load_partition
        from cglgan_tpu_torch.evalx.evaluator import make_evaluator
        img_shape = info["img_shape"]
        conv = info["family"].startswith("conv")
        cfg = FedGANConfig(
            algo="capgan", dataset=args.eval_dataset, conv=conv,
            img_size=(28 if conv else
                      (img_shape[-1] if len(img_shape) == 3 else 28)),
            data_dir=args.data_dir)
        part = load_partition(cfg)
        evaluator = make_evaluator(
            cfg, part, eval_n=args.n, fid_stats=args.fid_stats,
            inception_weights=args.inception_weights, device=dev)
        report.update(evaluator(None, None, samples=forward(args.seed + 1)))

    if args.export:
        from cglgan_tpu_torch.utils.export import (export_imported,
                                                   save_generator)
        ep = export_imported(model, params, state,
                             args.export_n if args.export_n > 0 else None)
        manifest = save_generator(ep, args.export,
                                  {"imported_from": args.checkpoint,
                                   "family": info["family"]})
        report["export"] = {"out": args.export, **manifest}

    print(json.dumps(report))
    return 0


def cmd_doctor(args) -> int:
    """Environment diagnosis: versions, a BOUNDED probe of the card (in a
    killable subprocess: a hung initialisation never hangs this one) with
    the count of cards, the kernel build directory and the native
    dataplane.  Prints one JSON
    object; exit 0 iff the device probed (the card, unless ``--device
    cpu``) answered."""
    import json
    import sys as _sys

    report = {"python": _sys.version.split()[0]}
    import torch
    report["torch"] = torch.__version__

    from cglgan_tpu_torch.utils import backend_probe
    status, info = backend_probe.probe(timeout=args.probe_timeout,
                                       device=args.device)
    if status == "ok":
        report["backend"] = info
        # the cards a mesh can take: ``run --devices N`` needs N of them
        report["cuda_devices"] = info["cuda_devices"]
    elif status == "timeout":
        report["backend"] = {
            "error": f"unresponsive (device init exceeded "
                     f"{args.probe_timeout}s)"}
    else:
        report["backend"] = {"error": info}

    from cglgan_tpu_torch.ops import _build
    build_dir = _build.BUILD_DIR
    entries = (sorted(os.listdir(build_dir)) if os.path.isdir(build_dir)
               else [])
    report["kernel_build"] = {"dir": build_dir, "entries": len(entries),
                              "libraries": [e for e in entries
                                            if e.endswith(".so")]}

    from cglgan_tpu_torch.data import native
    report["native_dataplane"] = native.load_library() is not None

    print(json.dumps(report, indent=1))
    return 0 if "error" not in report["backend"] else 1


def cmd_fid_stats(args) -> int:
    """Precompute real-image activation statistics for ``--fid-stats``:
    the dataset (IDX files via --data-dir, else the synthetic glyph bank)
    through the active feature extractor (InceptionV3 pool3 with
    --inception-weights, else the proxy conv embedding the evaluator
    defaults to) over --n images, written as pytorch-fid's ``.npz``
    (mu, sigma)."""
    import numpy as np

    from cglgan_tpu_torch.core import device as device_mod
    from cglgan_tpu_torch.data.mnist import load_image_dataset
    from cglgan_tpu_torch.evalx.fid import (activation_stats,
                                            conv_feature_extractor)
    from cglgan_tpu_torch.evalx.inception import save_fid_stats

    dev = device_mod.resolve(args.device)
    if args.data_dir is None and args.dataset in ("mnist", "fashion-mnist"):
        print(f"{PREFIX} WARNING: no --data-dir given for {args.dataset}; "
              "computing stats over the synthetic glyph bank — only valid "
              "against runs using the same synthetic fallback")
    data, _labels = load_image_dataset(args.dataset, args.data_dir)
    sel = np.random.default_rng(args.seed).permutation(len(data))[:args.n]
    if args.conv:
        # conv runs train and evaluate at the 2px-zero-padded resolution
        # (algos/registry.py load_partition); stats must be at that side
        data = np.pad(data, ((0, 0), (2, 2), (2, 2)))
    side = data.shape[-1]
    imgs = data[sel].astype(np.float32) / 255.0
    imgs = ((imgs - 0.5) / 0.5).reshape(-1, 1, side, side)
    if args.inception_weights:
        from cglgan_tpu_torch.evalx.inception import (inception_extractor,
                                                      load_inception_weights)
        extractor = inception_extractor(
            load_inception_weights(args.inception_weights, dev))
    else:
        extractor = conv_feature_extractor(side, device=dev)
    mu, sigma = activation_stats(extractor, imgs)
    save_fid_stats(args.out, mu, sigma, side=side)
    print(f"{PREFIX} wrote {args.out}: mu ({mu.shape[0]},), "
          f"sigma {sigma.shape}, {len(imgs)} images")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="tpufed-torch",
                                     description=__doc__.splitlines()[0])
    sub = parser.add_subparsers(dest="cmd", required=True)
    prun = sub.add_parser("run", help="train one algorithm")
    _add_run_args(prun)
    prun.set_defaults(fn=cmd_run)
    psweep = sub.add_parser(
        "sweep", help="run algos x datasets x iid in one invocation and "
                      "emit a comparison table (the reference __main__ loops)")
    _add_run_args(psweep, with_algo=False)
    psweep.add_argument("--algos", default="cglgan",
                        help="comma list, e.g. cglgan,capgan,flgan")
    psweep.add_argument("--datasets", default="2dmg",
                        help="comma list, e.g. 2dmg,mnist,fashion-mnist")
    psweep.add_argument("--iids", default="1,2",
                        help="comma list of iid settings, e.g. 1,2")
    psweep.set_defaults(fn=cmd_sweep)
    peval = sub.add_parser("eval", help="score a saved checkpoint")
    _add_cache_arg(peval)
    peval.add_argument("checkpoint", help="path to a checkpoint file inside "
                                          "a run dir")
    peval.add_argument("--n", type=int, default=1000)
    peval.add_argument("--out", default=None)
    peval.add_argument("--device", default=None,
                       help="torch device (default cuda)")
    peval.add_argument("--inception-weights", default=None)
    peval.add_argument("--fid-stats", default=None)
    peval.set_defaults(fn=cmd_eval)
    pcomp = sub.add_parser(
        "compare", help="tabulate run dirs into one comparison table "
                        "(final-tick metrics per run)")
    pcomp.add_argument("run_dirs", nargs="+",
                       help="run directories (each with config.json + "
                            "metrics.jsonl)")
    pcomp.add_argument("--out", default=None,
                       help="also write <out>.xlsx and <out>.csv")
    pcomp.set_defaults(fn=cmd_compare)
    pexport = sub.add_parser(
        "export", help="export the trained generator as a torch.export "
                       "serving artifact (z -> samples)")
    _add_cache_arg(pexport)
    pexport.add_argument("checkpoint", help="path to a checkpoint file "
                                            "inside a run dir")
    pexport.add_argument("--n", type=int, default=0,
                         help="serving batch size baked into the artifact; "
                              "0 (default) = batch-polymorphic (any "
                              "multiple of num_servers)")
    pexport.add_argument("--out", default=None,
                         help="output path (default "
                              "<run dir>/generator_<round>.pt2)")
    pexport.add_argument("--client", type=int, default=None, metavar="C",
                         help="export client C's PERSONALIZED generator "
                              "(CGL family: head C%%k of server C//k's G, "
                              "mixed-gan.py:242-252 routing) instead of "
                              "the painter blend; any batch size")
    pexport.add_argument("--device", default=None,
                         help="torch device the artifact is traced for "
                              "(default cuda)")
    pexport.set_defaults(fn=cmd_export)
    pimp = sub.add_parser(
        "import-torch",
        help="import a reference torch.save(net_g.state_dict()) .pt "
             "checkpoint: detect the generator family, convert to the "
             "port's trees, optionally sample and/or export")
    pimp.add_argument("checkpoint", help="path to a reference .pt file")
    pimp.add_argument("--family", default=None, choices=GEN_SPECS,
                      help="override the auto-detected generator family")
    pimp.add_argument("--num-heads", type=int, default=None,
                      help="override the detected multipath head count")
    pimp.add_argument("--img-size", type=int, default=None,
                      help="override the detected square image side")
    pimp.add_argument("--samples", default=None,
                      help="write an eval-mode sample artifact here "
                           "(PNG grid for image families, .npy for 2DMG)")
    pimp.add_argument("--n", type=int, default=100,
                      help="latents to draw for --samples")
    pimp.add_argument("--seed", type=int, default=0)
    pimp.add_argument("--eval-dataset", default=None, choices=DATASETS,
                      help="score the imported generator with the standard "
                           "workload evaluator against this dataset "
                           "(FID/IS for images, KL/DS/coverage for 2dmg)")
    pimp.add_argument("--data-dir", default=None,
                      help="IDX files for real MNIST (--eval-dataset)")
    pimp.add_argument("--fid-stats", default=None,
                      help="precomputed real-image (mu, sigma) .npz "
                           "(--eval-dataset)")
    pimp.add_argument("--inception-weights", default=None,
                      help="InceptionV3 weights .npz for reference FID "
                           "(--eval-dataset)")
    pimp.add_argument("--export", default=None,
                      help="also export a torch.export serving artifact "
                           "here")
    pimp.add_argument("--export-n", type=int, default=0,
                      help="serving batch baked into --export; 0 = "
                           "batch-polymorphic")
    pimp.add_argument("--device", default=None,
                      help="torch device (default cuda; --export is traced "
                           "for it)")
    pimp.set_defaults(fn=cmd_import_torch)
    pplot = sub.add_parser(
        "plot", help="render run dirs' metric trajectories into one "
                     "comparison figure (one line per run, one panel per "
                     "metric)")
    pplot.add_argument("run_dirs", nargs="+",
                       help="run directories with metrics.jsonl")
    pplot.add_argument("--metrics", default=None,
                       help="comma-separated metric keys (default: "
                            "kl_score,mode_coverage for 2DMG runs; "
                            "fid,inception_score for image runs)")
    pplot.add_argument("--out", required=True, help="output .png path")
    pplot.add_argument("--logy", action="store_true",
                       help="log y-scale on fid/kl_score panels")
    pplot.add_argument("--title", default=None)
    pplot.set_defaults(fn=cmd_plot)
    pdoc = sub.add_parser(
        "doctor", help="diagnose the environment: versions, bounded CUDA "
                       "probe, kernel build directory, native dataplane")
    _add_cache_arg(pdoc)
    pdoc.add_argument("--device", default=None,
                      help="probe this torch device, cuda or cpu (default "
                           "cuda)")
    pdoc.add_argument("--probe-timeout", type=int, default=60,
                      help="seconds before declaring the card unresponsive")
    pdoc.set_defaults(fn=cmd_doctor)
    pstats = sub.add_parser(
        "fid-stats", help="precompute real-image FID statistics "
                          "(.npz consumable via run/eval --fid-stats)")
    pstats.add_argument("--dataset", default="mnist",
                        choices=[d for d in DATASETS if d != "2dmg"])
    pstats.add_argument("--data-dir", default=None)
    pstats.add_argument("--n", type=int, default=10000)
    pstats.add_argument("--seed", type=int, default=20211212)
    pstats.add_argument("--inception-weights", default=None)
    pstats.add_argument("--conv", action="store_true",
                        help="compute stats at the 2px-padded resolution "
                             "conv runs evaluate at (pass iff the consuming "
                             "run uses --conv)")
    pstats.add_argument("--device", default=None,
                        help="torch device (default cuda)")
    pstats.add_argument("--out", required=True, help="output .npz path")
    pstats.set_defaults(fn=cmd_fid_stats)
    args = parser.parse_args(argv)
    _enable_compile_cache(args)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())

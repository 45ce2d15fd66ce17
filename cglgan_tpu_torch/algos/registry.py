"""Algorithm registry: config -> Runner, loading data and partitioning.

Port of ``cglgan_tpu/algos/registry.py`` for all seven algorithms on MLP
models, on the image datasets and on 2DMG: the CGL family (CGL-GAN,
CAP-GAN, Mix-G), the MD-GAN family (AC-GAN, MD-GAN) and the FedAvg family
(FL-GAN, FeGAN; the ragged "epochs" sweep on image data).  The conv LSGAN
pair runs on all seven in float32 and bfloat16, on images zero-padded
28 -> 32, on one device or sharded over a clients mesh
(``core/meshes.py``), and the CGL family's G also split over the mesh's
``model`` axis (``model_shards > 1``, ``models/tp.py``).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from cglgan_tpu_torch.algos.common import check_supported
from cglgan_tpu_torch.core import device as device_mod
from cglgan_tpu_torch.data.gmm import gmm_dataset
from cglgan_tpu_torch.data.mnist import load_image_dataset
from cglgan_tpu_torch.data.partition import Partition, partition


def load_partition(cfg) -> Partition:
    if cfg.dataset == "2dmg":
        data, labels = gmm_dataset(cfg.num_class, cfg.num_sample,
                                   seed=cfg.seed)
        num_sample = cfg.num_sample * cfg.num_class  # eval pool: full scale
        # 2DMG FL-GAN/MD-GAN draw composition sizes from num_workers*2
        # (FLGAN/2DMG/flgan.py:292-296); others use num_workers**2
        comp = cfg.num_workers * 2 if cfg.algo in ("flgan", "mdgan") else None
        run_sub = False   # 2DMG iid=2 hands out whole label runs
    else:
        data, labels = load_image_dataset(cfg.dataset, cfg.data_dir,
                                          seed=cfg.seed)
        if cfg.conv and data.shape[1] == 28:
            # the conv LSGAN pair works at 32x32 (model/lsgan.py:7); a 2px
            # zero pad keeps the content exactly
            data = np.pad(data, ((0, 0), (2, 2), (2, 2)))
        # shards are stored flat (N, H*W): one contiguous window per client
        data = data.reshape(len(data), -1)
        num_sample = cfg.num_sample
        comp = None
        run_sub = True    # dataset-object variant subsamples runs
    return partition(data, labels, cfg.num_workers, cfg.iid,
                     num_class=cfg.num_class, num_sample=num_sample,
                     seed=cfg.seed, composition_scale=comp,
                     run_subsample=run_sub)


def build_runner(cfg, part: Optional[Partition] = None, device=None,
                 mesh=None):
    """Runner for ``cfg`` on ``device`` (default ``cuda``; raises when no
    card is present unless ``device="cpu"`` is passed).  ``mesh``: an
    optional mesh (``core/meshes.py``); the runner's per-client state and
    data shards are this rank's block, on the mesh's device, and with
    ``model_shards > 1`` on a mesh with a ``model`` axis, its blocks of
    the CGL family's G.  Without such a mesh ``model_shards`` places
    nothing, as the reference's ``place_model_tp``."""
    dev = device_mod.resolve(mesh.device if device is None and mesh
                             else device)
    if cfg.dtype == "bfloat16" and dev.type == "cuda":
        # bfloat16 products accumulate in float32 and round once, as XLA's
        # do: cuBLAS may otherwise reduce partial sums in bfloat16 (the
        # conv G's l1 and the D's adv products).  A process-wide setting.
        torch.backends.cuda.matmul \
            .allow_bf16_reduced_precision_reduction = False
    if cfg.pallas_sweep is True:
        # validate the forced flag for EVERY algo: eligible() raises for a
        # config that cannot take the kernel instead of running without it
        from cglgan_tpu_torch.ops import fused_sweep
        fused_sweep.eligible(cfg, mesh)
    check_supported(cfg)
    if part is None:
        part = load_partition(cfg)
    if cfg.algo == "flgan":
        from cglgan_tpu_torch.algos.fedavg_family import build_flgan
        return build_flgan(cfg, part, dev, mesh)
    if cfg.algo == "fegan":
        from cglgan_tpu_torch.algos.fedavg_family import build_fegan
        return build_fegan(cfg, part, dev, mesh)
    if cfg.algo in ("acgan", "mdgan"):
        from cglgan_tpu_torch.algos.mdgan_family import build_mdgan_family
        return build_mdgan_family(cfg, part, dev, mesh)
    from cglgan_tpu_torch.algos.cgl_family import build_cgl_family
    return build_cgl_family(cfg, part, dev, mesh)

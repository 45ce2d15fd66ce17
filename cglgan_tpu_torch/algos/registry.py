"""Algorithm registry: config -> Runner, loading data and partitioning.

Port of ``cglgan_tpu/algos/registry.py`` for the image datasets and
CAP-GAN; everything else raises ``NotImplementedError`` naming its ROADMAP
item.
"""
from __future__ import annotations

from typing import Optional

from cglgan_tpu_torch.core import device as device_mod
from cglgan_tpu_torch.data.mnist import load_image_dataset
from cglgan_tpu_torch.data.partition import Partition, partition


def load_partition(cfg) -> Partition:
    if not cfg.is_image:
        raise NotImplementedError("the 2DMG dataset is not ported yet "
                                  "(ROADMAP queue 1 item 11)")
    if cfg.conv:
        raise NotImplementedError("conv=True is not ported yet (ROADMAP "
                                  "queue 1 item 12)")
    data, labels = load_image_dataset(cfg.dataset, cfg.data_dir,
                                      seed=cfg.seed)
    # shards are stored flat (N, H*W): one contiguous window per client
    data = data.reshape(len(data), -1)
    return partition(data, labels, cfg.num_workers, cfg.iid,
                     num_class=cfg.num_class, num_sample=cfg.num_sample,
                     seed=cfg.seed, composition_scale=None,
                     run_subsample=True)


def build_runner(cfg, part: Optional[Partition] = None, device=None):
    """Runner for ``cfg`` on ``device`` (default ``cuda``; raises when no
    card is present unless ``device="cpu"`` is passed)."""
    dev = device_mod.resolve(device)
    from cglgan_tpu_torch.algos.cgl_family import (build_cgl_family,
                                                   check_supported)
    check_supported(cfg)
    if part is None:
        part = load_partition(cfg)
    return build_cgl_family(cfg, part, dev)

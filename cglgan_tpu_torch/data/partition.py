"""Non-IID client partitioner.

Reproduces the reference ``allocate_dataset`` semantics (tensor variant:
CGLGAN/MNIST/main.py:401-457, ACGAN/2DMG/acgan.py:267-322; dataset-object
variant: capgan.py:358-424, fegan.py:312-380) for ``iid`` in {0, 1, 2}:

* ``iid == 0`` — shuffled equal split.
* ``iid == 1`` — label-sorted data; worker *i* samples a random-sized subset
  from the circular 3-class label window ``[(i-1) % C, (i+2) % C)``.  Subset
  sizes come from a random composition of ``num_workers**2`` (2DMG FL-GAN /
  MD-GAN use ``num_workers*2`` — expose via ``composition_scale``).
* ``iid == 2`` — one label-run per worker ("fully non-iid").  The tensor
  variant hands each worker the *whole* run (CGLGAN main.py:449-457); the
  dataset-object variant subsamples the run to ``min(sizes[i]*n, run)``
  (capgan.py:412-424).  Select with ``run_subsample``.

Partitioning runs host-side with ``random.Random(seed)`` (the reference's
generator, capgan.py:25-27) so shard structure matches the reference's
distributional behaviour exactly; the result is padded to a static shape for
XLA (clients have 10x+ unequal shard sizes under iid=1/2) with wrap-around
padding plus true lengths for masking.

The port's own copy of ``cglgan_tpu/data/partition.py`` (numpy only; the
arrays are byte-equal, ``tests/test_torch_port_modules.py``).
"""
from __future__ import annotations

import dataclasses
from random import Random
from typing import Optional

import numpy as np


@dataclasses.dataclass
class Partition:
    """Static-shaped per-client shards.

    data:    (num_workers, max_len, *dims) — wrap-padded beyond ``lengths``.
    labels:  (num_workers, max_len) int32
    lengths: (num_workers,) int32 — true shard sizes
    class_freq: (num_workers, num_class) int64 — per-class sample counts
    eval_pool: (num_sample, *dims) — the reference ``test_set`` subsample
    """
    data: np.ndarray
    labels: np.ndarray
    lengths: np.ndarray
    class_freq: np.ndarray
    eval_pool: np.ndarray

    @property
    def num_workers(self) -> int:
        return self.data.shape[0]

    def beta(self, client_ids) -> np.ndarray:
        """Data-size weights over a subset of clients, normalised to 1 —
        the reference's ``beta`` (CGLGAN/MNIST/main.py:160-164)."""
        w = self.lengths[np.asarray(client_ids)].astype(np.float64)
        return (w / w.sum()).astype(np.float32)


def _composition_sizes(rd: Random, num_workers: int, scale: int) -> list:
    """Random composition of ``scale`` into ``num_workers`` parts, as
    fractions (reference main.py:426-431)."""
    cuts = rd.sample(range(1, scale), k=num_workers - 1)
    cuts.append(0)
    cuts.append(scale)
    cuts = sorted(cuts)
    return [(cuts[i] - cuts[i - 1]) / scale for i in range(1, len(cuts))]


def partition(data: np.ndarray,
              labels: np.ndarray,
              num_workers: int,
              iid: int,
              num_class: int = 10,
              num_sample: int = 1000,
              seed: int = 20211212,
              composition_scale: Optional[int] = None,
              run_subsample: bool = True,
              max_len: Optional[int] = None) -> Partition:
    data = np.asarray(data)
    labels = np.asarray(labels).astype(np.int64)
    n = len(data)
    rd = Random(seed)

    # test_set subsample drawn first, same draw order as the reference
    # (capgan.py:365, main.py:413).
    eval_pool = data[rd.sample(range(n), min(num_sample, n))]

    shards: list = []
    if iid == 0:
        idx = list(range(n))
        rd.shuffle(idx)
        part = n // num_workers
        for i in range(num_workers):
            shards.append(np.asarray(idx[i * part:(i + 1) * part]))
    else:
        order = np.argsort(labels, kind="stable")
        data = data[order]
        labels = labels[order]
        scale = composition_scale if composition_scale else num_workers ** 2
        sizes = _composition_sizes(rd, num_workers, scale)
        if iid == 1:
            lab_list = labels.tolist()
            first = {}
            for pos, lab in enumerate(lab_list):
                if lab not in first:
                    first[lab] = pos
            for i in range(num_workers):
                cls_s = (i - 1 + num_class) % num_class
                cls_e = (i + 2) % num_class
                s = first[cls_s]
                e = first[cls_e]
                want = int(sizes[i] * n)
                if s < e:
                    take = min(want, e - s)
                    shards.append(np.asarray(rd.sample(range(s, e), take)))
                else:  # window wraps around the end of the sorted array
                    take = min(want, e + n - s)
                    pool = list(range(0, e)) + list(range(s, n))
                    shards.append(np.asarray(rd.sample(pool, take)))
        else:  # iid == 2: consecutive label runs
            runs = []
            start = 0
            for pos in range(1, n + 1):
                if pos == n or labels[pos] != labels[pos - 1]:
                    runs.append((start, pos))
                    start = pos
            for i in range(num_workers):
                s, e = runs[i % len(runs)]
                if run_subsample:
                    take = min(int(sizes[i] * n), e - s)
                    shards.append(np.asarray(rd.sample(range(s, e), take)))
                else:
                    shards.append(np.arange(s, e))

    lengths = np.asarray([len(s) for s in shards], dtype=np.int32)
    if max_len is None:
        max_len = int(lengths.max())
    out_data = np.zeros((num_workers, max_len) + data.shape[1:], dtype=data.dtype)
    out_labels = np.zeros((num_workers, max_len), dtype=np.int32)
    freq = np.zeros((num_workers, num_class), dtype=np.int64)
    for i, sh in enumerate(shards):
        if len(sh) == 0:
            continue
        reps = -(-max_len // len(sh))  # wrap-pad so every index is a real sample
        full = np.tile(sh, reps)[:max_len]
        out_data[i] = data[full]
        out_labels[i] = labels[full]
        binc = np.bincount(labels[sh], minlength=num_class)
        freq[i] = binc[:num_class]
    return Partition(out_data, out_labels, lengths, freq, eval_pool)

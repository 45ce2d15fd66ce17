"""FeGAN device scoring and balanced group sampling.

The port's own copy of ``cglgan_tpu/fed/sampling.py`` (numpy only; the
arrays are bit-equal, ``tests/test_torch_port_fedavg.py``).

* ``fegan_scores``: KL-divergence device scores
  ``sk = entropy(x_norm || y) * (sum(x_norm) / sum(y))`` where x is the
  worker's class histogram and y the global one (fegan.py:516-523).
* ``init_groups``: greedy class-balanced group schedule — each round picks
  ``max(1, frac_workers*size)`` workers by repeatedly choosing the class with
  the fewest samples taken so far and a worker holding that class, rotating
  per-class worker queues (fegan.py:383-452).  Host-side and seeded; the
  resulting (num_rounds, group_size) index array picks each round's lanes.
"""
from __future__ import annotations

from collections import deque

import numpy as np


def fegan_scores(class_freq: np.ndarray, global_freq: np.ndarray) -> np.ndarray:
    """Per-worker sk scores.  ``class_freq`` (W, C) counts, ``global_freq``
    (C,) counts."""
    y = np.asarray(global_freq, dtype=np.float64)
    y = y / y.sum()
    out = np.zeros(len(class_freq), dtype=np.float64)
    for i, x in enumerate(np.asarray(class_freq, dtype=np.float64)):
        xn = x / max(x.sum(), 1.0)
        mask = xn > 0
        # scipy.stats.entropy(x, y) = sum(x * log(x / y)) after normalising x
        kl = float(np.sum(xn[mask] * np.log(xn[mask] / y[mask])))
        out[i] = kl * (xn.sum() / 1.0)  # y is normalised: sum(y)=1
    return out.astype(np.float32)


def fegan_round_weights(sk: np.ndarray, group: np.ndarray) -> np.ndarray:
    """Aggregation weights for one group: the reference exponentiates sk,
    then normalises (fegan.py:145-146): w = exp(sk)/sum."""
    e = np.exp(np.asarray(sk, dtype=np.float64)[group])
    return (e / e.sum()).astype(np.float32)


def init_groups(size: int,
                cls_freq_wrk: np.ndarray,
                frac_workers: float,
                num_rounds: int = 20000,
                num_class: int = 10) -> np.ndarray:
    """Greedy balanced sampling schedule, shape (num_rounds, gp_size).

    Faithful to fegan.py:383-452: per-class FIFO queues of workers holding
    that class; every slot picks the globally least-represented class and the
    first unvisited worker from its queue (skipping visited ones by rotating),
    accumulating the chosen worker's full class histogram into taken_count.
    """
    cls_freq_wrk = np.asarray(cls_freq_wrk, dtype=np.int64)
    gp_size = max(1, int(frac_workers * size))
    wrk_cls = cls_freq_wrk > 0
    cls_q = [deque() for _ in range(num_class)]
    # reference fills queues iterating workers in reverse then re-reversing
    # (fegan.py:406-409) — net effect: ascending worker order per class.
    for w in range(size):
        for c in range(num_class):
            if wrk_cls[w, c]:
                cls_q[c].append(w)
    taken = np.zeros(num_class, dtype=np.int64)
    groups = np.zeros((num_rounds, gp_size), dtype=np.int32)
    for r in range(num_rounds):
        visited = np.zeros(size, dtype=bool)
        for slot in range(gp_size):
            c = int(np.argmin(taken))
            chosen = None
            q = cls_q[c]
            if len(q) == 0:
                # no worker holds the rarest class: fall back to any unvisited
                for w in range(size):
                    if not visited[w]:
                        chosen = w
                        break
            else:
                for _ in range(len(q)):
                    w = q.popleft()
                    q.append(w)
                    if not visited[w]:
                        chosen = w
                        break
            if chosen is None:            # group smaller than gp_size: repeat
                chosen = int(groups[r, slot - 1]) if slot else 0
            groups[r, slot] = chosen
            visited[chosen] = True
            taken += cls_freq_wrk[chosen]
    return groups

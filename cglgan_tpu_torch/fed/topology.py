"""Topology: block assignment of clients to edge servers.

Reference wiring: server *i* serves clients ``[i*k, (i+1)*k)`` with
``k = num_workers // num_servers`` (CGLGAN/MNIST/main.py:507-513,
capgan.py:513-519).  Because every server gets the same k, the stacked
(W, ...) client state reshapes losslessly to (S, k, ...) — the hierarchy is a
reshape, not a routing table.

The port's own copy of ``cglgan_tpu/fed/topology.py``.
"""
from __future__ import annotations

from typing import List

import numpy as np


def block_assignment(num_workers: int, num_servers: int) -> List[List[int]]:
    k = num_workers // num_servers
    return [list(range(i * k, (i + 1) * k)) for i in range(num_servers)]


def server_beta(lengths: np.ndarray, num_servers: int) -> np.ndarray:
    """Per-server, per-client data-size weights beta, shape (S, k),
    each row summing to 1 (CGLGAN/MNIST/main.py:160-164)."""
    k = len(lengths) // num_servers
    grouped = np.asarray(lengths, dtype=np.float64).reshape(num_servers, k)
    return (grouped / grouped.sum(axis=1, keepdims=True)).astype(np.float32)


def server_data_len(lengths: np.ndarray, num_servers: int) -> np.ndarray:
    """Total data size per server — the cloud's A weights before
    normalisation (CGLGAN/MNIST/main.py:93-98)."""
    k = len(lengths) // num_servers
    return np.asarray(lengths, dtype=np.float64).reshape(num_servers, k).sum(1)

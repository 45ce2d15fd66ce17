"""Torch on one thread in the port's test modules.

The suite runs under pytest-xdist, its workers sharing the host's cores.
A torch op on the CPU forks its intra-op threads, which spin for a while
after the op before they sleep; across the many small ops of a round,
every worker's threads then spin on cores the other workers need.  On one
thread the same checks take a fraction of the CPU.  Every
``tests/test_torch_port_*.py`` imports ``one_torch_thread``, a
module-scoped autouse fixture, so it runs before the module's own
fixtures and the ranks they spawn take one thread each
(``core/meshes.py`` ``spawn`` divides the caller's threads among them).
"""
import glob
import os

import pytest
import torch

IMPORT = "from test_torch_port_threads import one_torch_thread  # noqa: F401"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_every_port_test_module_runs_torch_on_one_thread():
    """Each port test module imports the fixture (this one defines it)."""
    here = os.path.dirname(os.path.abspath(__file__))
    paths = sorted(glob.glob(os.path.join(here, "test_torch_port_*.py")))
    paths.remove(os.path.abspath(__file__))
    assert paths
    for path in paths:
        with open(path) as f:
            assert IMPORT in f.read().splitlines(), path


def test_torch_runs_on_one_thread_here():
    assert torch.get_num_threads() == 1

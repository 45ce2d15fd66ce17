"""The CGL and MD-GAN families' round loop as CUDA-graph replays
(``algos/runner.py`` ``RoundProgram``) on the card.

N replays through ``train`` against N eager ``round_fn`` rounds from one
state: every state tensor and every round's metrics equal under
``torch.equal``, ``fused_dstep`` counted once a replay, and one capture a
runner across its ``train`` calls.  Small shapes (4 clients, 8x8 images,
batch 8); ``chip_smoke.py``'s ``graph`` phase runs the full widths.
Needs a CUDA card and skips without one; imports no JAX, so ``python -m
pytest --noconftest tests/test_torch_chip_scan.py`` runs it on the card.
"""
import numpy as np
import pytest
import torch

from cglgan_tpu_torch.algos import runner
from cglgan_tpu_torch.algos.registry import build_runner
from cglgan_tpu_torch.core.config import FedGANConfig
from cglgan_tpu_torch.data.partition import Partition
from cglgan_tpu_torch.ops import fused_dstep

N = 6
NW, L = 4, 48
CASES = {
    # the fused local-D phase, a shared fake batch, CAP-GAN's cadence sync
    "capgan_e2_kernel": dict(algo="capgan", num_servers=1, epoch=2,
                             num_communication=21),
    # autograd, multipath G, syncs at every other round, the E=2 share
    "cglgan_e1": dict(algo="cglgan", num_servers=2, epoch=1, cloud_epoch=2,
                      segema=0.5, num_communication=10),
    # the forced bf16-state kernel, a multipath G's fakes a client
    "mixgan_e2_bf16_kernel": dict(algo="mixgan", num_servers=2, epoch=2,
                                  cloud_epoch=2, segema=0.25,
                                  num_communication=10, dtype="bfloat16",
                                  pallas_dstep=True),
    # MD-GAN: autograd, the E=2 shuffle (a permutation drawn every round
    # from the device key, the swap kept on the rounds that exchange)
    "mdgan_e1_shuffle": dict(algo="mdgan", num_servers=1, epoch=1,
                             d_swap="shuffle"),
    # AC-GAN: the fused local-D phase, a server's batch to its clients,
    # the E=2 delta gossip and its anchors
    "acgan_e2_delta_kernel": dict(algo="acgan", num_servers=2, epoch=2,
                                  gossip="delta"),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a CUDA graph has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _runner(case, device):
    rng = np.random.default_rng(0)
    part = Partition(rng.integers(0, 256, (NW, L, 64)).astype(np.uint8),
                     np.zeros((NW, L), np.int32),
                     np.asarray([30, 48, 41, 36], np.int32),
                     np.ones((NW, 10), np.int64),
                     np.zeros((10, 64), np.uint8))
    cfg = FedGANConfig(dataset="synthetic-mnist", num_workers=NW, iid=1,
                       img_size=8, batch_size=8, E=2, **CASES[case])
    return build_runner(cfg, part, device=device)


def _leaves(state):
    return runner.state_leaves(state)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_replays_equal_eager_rounds(cuda, case):
    run = _runner(case, cuda)
    assert run.program is not None
    state0 = run.init_state()
    state, eager = state0, []
    for _ in range(N):
        state, m = run.round_fn(state)
        eager.append(m)
    captures, replays = runner.captures, runner.replays
    fused_dstep.launches = 0
    out = runner.train(run, N, eval_every=1, state=state0, evaluator=False)
    torch.cuda.synchronize()
    assert runner.captures == captures + 1
    assert runner.replays == replays + N
    assert fused_dstep.launches == (N if fused_dstep.eligible(run.cfg)
                                    else 0)
    assert out["state"].t == state.t == N
    for a, b in zip(_leaves(out["state"]), _leaves(state), strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b)
    for tick, m in zip(out["history"], eager, strict=True):
        assert all(tick[k] == float(m[k]) for k in m)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["cglgan_e1", "mdgan_e1_shuffle",
                                  "acgan_e2_delta_kernel"])
def test_one_capture_a_runner(cuda, case):
    """Two ``train`` calls of one runner capture once; a second runner
    captures its own; the first call's returned state does not move when
    the runner trains again."""
    run = _runner(case, cuda)
    captures = runner.captures
    first = runner.train(run, 3, 3, evaluator=False)["state"]
    kept = [x.clone() for x in _leaves(first)]
    second = runner.train(run, 4, 2, state=first, evaluator=False)["state"]
    assert runner.captures == captures + 1
    assert second.t == 7
    for a, b in zip(_leaves(first), kept, strict=True):
        assert torch.equal(a, b)
    runner.train(_runner(case, cuda), 1, 1, evaluator=False)
    assert runner.captures == captures + 2

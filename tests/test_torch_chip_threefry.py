"""The threefry kernel (``cglgan_tpu_torch/ops/csrc/threefry.cu``) against
its plain version (``ops/threefry.py`` ``draw_plain``) on the card.

Every mode on the same CUDA keys: bits equal, normals within 3 ulps of
their dtype (the kernel fuses its ``erf_inv`` multiply-adds in float32;
the plain version rounds them from float64).  Also the launch layout: a
batch of keys with a leading stride of 0, parts of size 0 between live
ones, more parts than one launch takes, counts from a base (``fold_in``
over a range), and one counted launch a call.  Needs a CUDA card and
skips without one; imports no JAX, so ``python -m pytest --noconftest
tests/test_torch_chip_threefry.py`` runs it on the card.
"""
import pytest
import torch

from cglgan_tpu_torch.core import threefry
from cglgan_tpu_torch.ops import threefry as tk

NORMAL_ULPS = 3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the threefry kernel has no CPU mode")
    return torch.device("cuda")


def _ulps(a, b):
    view = torch.int32 if a.dtype == torch.float32 else torch.int16
    return int((a.contiguous().view(view).long()
                - b.contiguous().view(view).long()).abs().max())


# the bounds as the public functions pass them: exact in the mode's dtype
MODES = [
    (tk.WORDS, {}), (tk.BITS32, {}), (tk.BITS16, {}), (tk.BITS8, {}),
    (tk.UNIFORM_F32, dict(lo=-0.25, span=0.5)),
    (tk.UNIFORM_BF16, dict(lo=-0.25, span=0.5)),
    (tk.BERNOULLI, dict(p=0.75)),
    (tk.NORMAL_F32, dict(lo=-1.0 + 2.0 ** -24, span=2.0)),
    (tk.NORMAL_BF16, dict(lo=-0.99609375, span=2.0)),
    (tk.RANDINT, dict(rand=(20000, 5136, -7)))]


@pytest.mark.cuda
@pytest.mark.parametrize("mode,kw", MODES, ids=[str(m) for m, _ in MODES])
def test_kernel_matches_plain(cuda, mode, kw):
    keys = threefry.split(threefry.split(threefry.key(11, cuda), 6), 3)
    shapes = [(64, 100), (7,), (3, 1, 5)]
    launched = tk.launches
    got = tk.draw(mode, keys, shapes, **kw)
    assert tk.launches == launched + 1
    ref = tk.draw_plain(mode, keys, shapes, **kw)
    torch.cuda.synchronize()
    for a, b in zip(got, ref, strict=True):
        assert a.dtype == b.dtype and a.shape == b.shape
        if mode in (tk.NORMAL_F32, tk.NORMAL_BF16):
            assert _ulps(a, b) <= NORMAL_ULPS
        else:
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_launch_layout(cuda):
    """Expanded keys (leading stride 0), empty parts between live ones,
    eleven parts (two launches), counts from a base; the public functions
    on the card against the same calls on the CPU."""
    key = threefry.key(5, cuda)
    expanded = key.expand(4, 2)
    got = threefry.bernoulli_parts(threefry.split(expanded, 3), 0.5,
                                   [(9, 2), (0,), (4,)])
    ref = threefry.bernoulli_parts(threefry.split(expanded.cpu(), 3), 0.5,
                                   [(9, 2), (0,), (4,)])
    for a, b in zip(got, ref, strict=True):
        assert torch.equal(a.cpu(), b)
    keys = threefry.split(key, 11)
    shapes = [(n + 1,) for n in range(11)]
    launched = tk.launches
    got = threefry.uniform_parts(keys, shapes, -1.0, 1.0)
    assert tk.launches == launched + 2
    ref = threefry.uniform_parts(keys.cpu(), shapes, -1.0, 1.0)
    for a, b in zip(got, ref, strict=True):
        assert torch.equal(a.cpu(), b)
    assert torch.equal(threefry.fold_in(key, range(3, 900)).cpu(),
                       threefry.fold_in(key.cpu(), range(3, 900)))
    assert torch.equal(threefry.permutation(key, 1700).cpu(),
                       threefry.permutation(key.cpu(), 1700))

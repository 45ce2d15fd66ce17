"""The port's fused local-D epoch against the JAX Pallas kernel.

``cglgan_tpu_torch.ops.fused_dstep.fused_d_epoch_steps`` on CPU tensors runs
its plain PyTorch version; it must match the reference kernel
``cglgan_tpu.ops.pallas.fused_dstep.fused_d_epoch_steps(interpret=True)``
on the same inputs, for both discriminator heads and per-client Adam
counts, at the tolerances of tests/test_pallas_dstep.py (float32; the sums
run in another order).  The CUDA kernel itself is held to the plain
version on the card by the ``cuda`` case, which skips without a card."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cglgan_tpu.algos import common as jcommon
from cglgan_tpu.models.zoo import build_discriminator
from cglgan_tpu.ops.pallas import fused_dstep as jfused
from cglgan_tpu_torch.ops import fused_dstep

W, E, B, DIN, L = 3, 2, 8, 64, 32
LR, B1, B2 = 2e-4, 0.5, 0.999
STARTS = [1, 17]

# (rtol, atol) per compared quantity, from tests/test_pallas_dstep.py
TOL_P = (1e-4, 1e-6)
TOL_MU = (1e-4, 1e-6)
TOL_NU = (1e-4, 1e-9)
TOL_LOSS = (1e-5, 1e-7)


def _inputs(out_dim, counts, seed=0):
    """Stacked D state from the JAX init (+ nonzero moments when counts
    are nonzero), a u8 shard, fakes and counts, as numpy."""
    d = build_discriminator("mnist", out_dim, in_dim=DIN)
    net = jcommon.init_net_stacked(d, jax.random.key(seed),
                                   optax.adam(LR, b1=B1, b2=B2), W)
    lin = [p for p in net.params if isinstance(p, dict)]
    six = [np.asarray(x) for p in lin for x in (p["w"], p["b"])]
    rng = np.random.default_rng(seed)
    started = np.asarray(counts) > 0
    mask = lambda x: started.reshape((W,) + (1,) * (x.ndim - 1))
    mu6 = [(rng.normal(size=x.shape) * 1e-3 * mask(x)).astype(np.float32)
           for x in six]
    nu6 = [(np.abs(rng.normal(size=x.shape)) * 1e-6 * mask(x))
           .astype(np.float32) for x in six]
    shard = rng.integers(0, 256, size=(W, L, DIN)).astype(np.uint8)
    fake = rng.normal(size=(B, DIN)).astype(np.float32)
    return six, mu6, nu6, np.asarray(counts, np.int32), shard, fake


def _jax_run(six, mu6, nu6, count, shard, fake, head, half):
    reals = jnp.stack([jnp.asarray(shard)[:, s:s + B] for s in STARTS],
                      axis=1)
    out = jfused.fused_d_epoch_steps(
        tuple(map(jnp.asarray, six)), tuple(map(jnp.asarray, mu6)),
        tuple(map(jnp.asarray, nu6)), jnp.asarray(count), reals,
        jnp.asarray(fake), head=head, d_loss_half=half, is_image=True,
        lr=LR, b1=B1, b2=B2, interpret=True)
    p, m, n, c, loss = out
    return ([np.asarray(x) for x in p], [np.asarray(x) for x in m],
            [np.asarray(x) for x in n], np.asarray(c), np.asarray(loss))


def _port_run(six, mu6, nu6, count, shard, fake, head, half, device):
    t = lambda x: torch.from_numpy(np.array(x)).to(device)
    p, m, n, c, loss = fused_dstep.fused_d_epoch_steps(
        [t(x) for x in six], [t(x) for x in mu6], [t(x) for x in nu6],
        t(count.astype(np.int64)), t(shard), STARTS, t(fake), head=head,
        d_loss_half=half, is_image=True, lr=LR, b1=B1, b2=B2)
    npy = lambda x: x.cpu().numpy()
    return ([npy(x) for x in p], [npy(x) for x in m], [npy(x) for x in n],
            npy(c), npy(loss))


def _assert_close(got, ref):
    for name, a, b, (rtol, atol) in (("params", got[0], ref[0], TOL_P),
                                     ("mu", got[1], ref[1], TOL_MU),
                                     ("nu", got[2], ref[2], TOL_NU)):
        for j, (x, y) in enumerate(zip(a, b)):
            np.testing.assert_allclose(x, y, rtol=rtol, atol=atol,
                                       err_msg=f"{name}[{j}]")
    np.testing.assert_array_equal(got[3], ref[3])
    np.testing.assert_allclose(got[4], ref[4], rtol=TOL_LOSS[0],
                               atol=TOL_LOSS[1])


@pytest.mark.parametrize("counts", [[0, 0, 0], [0, 7, 3]],
                         ids=["fresh", "per_client_counts"])
@pytest.mark.parametrize("head,out_dim,half", [
    ("sigmoid", 1, False),     # BCE family, unhalved
    ("logits2", 2, True),      # CE family (CAP/Mix MNIST), x0.5
])
def test_plain_matches_jax_kernel(head, out_dim, half, counts):
    args = _inputs(out_dim, counts)
    ref = _jax_run(*args, head, half)
    got = _port_run(*args, head, half, "cpu")
    _assert_close(got, ref)


def test_inputs_not_modified():
    """The port returns new tensors (the Pallas call aliases in place)."""
    six, mu6, nu6, count, shard, fake = _inputs(2, [0, 7, 3])
    t = lambda x: torch.from_numpy(np.array(x))
    p_in = [t(x) for x in six]
    fused_dstep.fused_d_epoch_steps(
        p_in, [t(x) for x in mu6], [t(x) for x in nu6],
        t(count.astype(np.int64)), t(shard), STARTS, t(fake),
        head="logits2", d_loss_half=True)
    for x, y in zip(p_in, six):
        np.testing.assert_array_equal(x.numpy(), y)


def test_bias_corrections_match_reference():
    counts = np.asarray([0, 7, 3], np.int32)
    ref = np.asarray(jfused._bias_corrections(jnp.asarray(counts), W, 5,
                                              B1, B2))
    got = fused_dstep.bias_corrections(torch.from_numpy(counts.astype(
        np.int64)), W, 5, B1, B2).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("head,out_dim,half", [("sigmoid", 1, False),
                                               ("logits2", 2, True)])
def test_cuda_kernel_matches_plain(head, out_dim, half):
    """The CUDA kernel against the plain version on the card, same inputs
    (TF32 off: both sides are full float32)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    launched = fused_dstep.launches
    args = _inputs(out_dim, [0, 7, 3])
    got = _port_run(*args, head, half, "cuda")
    assert fused_dstep.launches == launched + 1
    t = lambda x: torch.from_numpy(np.array(x)).cuda()
    six, mu6, nu6, count, shard, fake = args
    plain = fused_dstep.fused_d_epoch_steps_plain(
        [t(x) for x in six], [t(x) for x in mu6], [t(x) for x in nu6],
        t(count.astype(np.int64)), t(shard), STARTS, t(fake), head=head,
        d_loss_half=half, lr=LR, b1=B1, b2=B2)
    npy = lambda x: x.cpu().numpy()
    ref = ([npy(x) for x in plain[0]], [npy(x) for x in plain[1]],
           [npy(x) for x in plain[2]], npy(plain[3]), npy(plain[4]))
    _assert_close(got, ref)

"""The port's fused local-D epoch against the JAX Pallas kernel.

``cglgan_tpu_torch.ops.fused_dstep.fused_d_epoch_steps`` on CPU tensors runs
its plain PyTorch version; it must match the reference kernel
``cglgan_tpu.ops.pallas.fused_dstep.fused_d_epoch_steps(interpret=True)``
on the same inputs, for both discriminator heads and per-client Adam
counts, at the tolerances of tests/test_pallas_dstep.py (float32; the sums
run in another order).  The kernel's product arithmetic (3xTF32) is held
to float32 through its emulation in torch ops.  The CUDA kernel itself is
held to the plain version on the card by the ``cuda`` cases, which skip
without a card."""
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


# the kernel's five tensor-core products at the main-path shape, one client:
# (M, K, N) of z1, z2, dz1, dW2, dW1
PRODUCTS = {"z1": (200, 784, 512), "z2": (200, 512, 256),
            "dz1": (200, 256, 512), "dW2": (512, 200, 256),
            "dW1": (784, 200, 512)}
# max |product - float64 product| over the largest |entry|.  float32 sums of
# K <= 784 terms measure 5.6e-7..6.8e-7 here for torch.matmul and for the
# 3xTF32 emulation alike (the dropped a_lo b_lo term is 2^-22 of a product);
# one TF32 pass measures 2.5e-4..3.2e-4, far above the 1e-5 the losses are
# held to on the card.
TOL_F32_GRADE = 2e-6
TOL_LOSS_ON_CARD = 1e-5


@pytest.mark.parametrize("name", sorted(PRODUCTS))
def test_3xtf32_product_is_float32_grade(name):
    M, K, N = PRODUCTS[name]
    rng = np.random.default_rng(sorted(PRODUCTS).index(name))
    a = torch.from_numpy(rng.uniform(-1, 1, (M, K)).astype(np.float32))
    b = torch.from_numpy((0.05 * rng.normal(size=(K, N))).astype(np.float32))
    ref = a.double() @ b.double()
    err = lambda x: float((x.double() - ref).abs().max() / ref.abs().max())
    assert err(a @ b) <= TOL_F32_GRADE                 # the yardstick itself
    assert err(fused_dstep.matmul_3xtf32_plain(a, b)) <= TOL_F32_GRADE
    one_pass = fused_dstep.round_tf32(a) @ fused_dstep.round_tf32(b)
    assert err(one_pass) > TOL_LOSS_ON_CARD


def test_split_tf32_rounds_to_ten_bits():
    """hi and lo are TF32 values (13 low mantissa bits zero), hi is x rounded
    to nearest with ties away from zero, and hi + lo recovers x to 2^-22."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy((rng.normal(size=4096) * np.logspace(
        -6, 6, 4096)).astype(np.float32))
    hi, lo = fused_dstep.split_tf32(x)
    for part in (hi, lo):
        assert int((part.view(torch.int32) & 0x1FFF).abs().max()) == 0
    assert bool(((hi - x).abs() <= x.abs() * 2.0 ** -11).all())
    assert bool(((hi + lo - x).abs() <= x.abs() * 2.0 ** -21).all())
    tie = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11), 1.0, 0.0])
    want = torch.tensor([1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10), 1.0, 0.0])
    assert torch.equal(fused_dstep.round_tf32(tie), want)


def _ragged_inputs(out_dim, seed=5):
    """W=3, B=37, 50-24-40: no size a multiple of a tile or of 8, and rows
    of the first layer's input that are not 16-byte aligned."""
    rng = np.random.default_rng(seed)
    w, b, din, h1, h2, length = 3, 37, 50, 24, 40, 90
    dims = (din, h1, h2, out_dim)
    f32 = lambda a: np.asarray(a, np.float32)
    six = [x for i, o in zip(dims[:-1], dims[1:])
           for x in (f32(rng.normal(size=(w, i, o)) / np.sqrt(i)),
                     f32(0.1 * rng.normal(size=(w, o))))]
    mu6 = [f32(1e-3 * rng.normal(size=x.shape)) for x in six]
    nu6 = [f32(1e-6 * np.abs(rng.normal(size=x.shape))) for x in six]
    shard = rng.integers(0, 256, size=(w, length, din)).astype(np.uint8)
    fake = f32(np.tanh(rng.normal(size=(b, din))))
    return six, mu6, nu6, np.asarray([2, 7, 3], np.int32), shard, fake


def _on_card(args, starts, head, half):
    """(kernel result, plain result) on the card, as numpy."""
    t = lambda x: torch.from_numpy(np.array(x)).cuda()
    six, mu6, nu6, count, shard, fake = args
    targs = ([t(x) for x in six], [t(x) for x in mu6], [t(x) for x in nu6],
             t(count.astype(np.int64)), t(shard), starts, t(fake))
    kw = dict(head=head, d_loss_half=half, lr=LR, b1=B1, b2=B2)
    npy = lambda out: ([x.cpu().numpy() for x in out[0]],
                       [x.cpu().numpy() for x in out[1]],
                       [x.cpu().numpy() for x in out[2]],
                       out[3].cpu().numpy(), out[4].cpu().numpy())
    got = npy(fused_dstep.fused_d_epoch_steps(*targs, **kw))
    return got, npy(fused_dstep.fused_d_epoch_steps_plain(*targs, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["tiles", "ragged"])
@pytest.mark.parametrize("head,out_dim,half", [("sigmoid", 1, False),
                                               ("logits2", 2, True)])
def test_cuda_kernel_matches_plain(head, out_dim, half, shape):
    """The CUDA kernel against the plain version on the card, same inputs
    (TF32 off: the plain side is full float32, the kernel 3xTF32), at the
    file's small shape and at a ragged one (partial tiles in M, N and K)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    launched = fused_dstep.launches
    if shape == "tiles":
        args, starts = _inputs(out_dim, [0, 7, 3]), STARTS
    else:
        args, starts = _ragged_inputs(out_dim), [0, 53, 21]
    got, ref = _on_card(args, starts, head, half)
    assert fused_dstep.launches == launched + 1
    _assert_close(got, ref)


@pytest.mark.cuda
def test_cuda_cached_scratch_between_calls():
    """Two calls in a row with different window starts share the module's
    cached work space; each must give what it gives with a fresh one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    args = _inputs(2, [0, 7, 3])
    t = lambda x: torch.from_numpy(np.array(x)).cuda()
    six, mu6, nu6, count, shard, fake = args
    targs = lambda starts: (
        [t(x) for x in six], [t(x) for x in mu6], [t(x) for x in nu6],
        t(count.astype(np.int64)), t(shard), starts, t(fake))
    kw = dict(head="logits2", d_loss_half=True, lr=LR, b1=B1, b2=B2)
    flat = lambda out: [x.clone() for g in out[:3] for x in g] + [out[4]]
    fresh = []
    for starts in ([1, 17], [20, 3]):
        fused_dstep._SCRATCH.clear()
        fresh.append(flat(fused_dstep.fused_d_epoch_steps(*targs(starts),
                                                          **kw)))
    fused_dstep._SCRATCH.clear()
    first = fused_dstep.fused_d_epoch_steps(*targs([1, 17]), **kw)
    second = fused_dstep.fused_d_epoch_steps(*targs([20, 3]), **kw)
    assert len(fused_dstep._SCRATCH) == 1
    for got, want in ((flat(first), fresh[0]), (flat(second), fresh[1])):
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    assert not torch.equal(first[0][0], second[0][0])

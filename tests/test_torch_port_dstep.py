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
from test_torch_port_threads import one_torch_thread  # noqa: F401

W, E, B, DIN, L = 3, 2, 8, 64, 32
LR, B1, B2 = 2e-4, 0.5, 0.999
STARTS = [1, 17]

# (rtol, atol) per compared quantity, from tests/test_pallas_dstep.py
TOL_P = (1e-4, 1e-6)
TOL_MU = (1e-4, 1e-6)
TOL_NU = (1e-4, 1e-9)
TOL_LOSS = (1e-5, 1e-7)
# Params in the per-client-fake and float-row cases: where a weight's
# gradient nearly cancels between the two steps, Adam's m/sqrt(v) amplifies
# float32 sum noise.  On the per-client inputs (seed 1) one weight of 393 216
# lands 2.4e-6 apart; the JAX kernel is itself 1.5e-6 and the plain version
# 3.3e-6 from a float64 run there (1.6% of one lr step).  So params are held
# to a fortieth of one Adam step; mu and nu keep the tolerances above, and a
# wrong route moves a param by up to a whole step (lr) a step.
TOL_P_STEP = (1e-4, LR / 40)


def _inputs(out_dim, counts, seed=0, *, family="mnist", din=DIN,
            float_rows=False, per_client=False):
    """Stacked D state from the JAX init (+ nonzero moments when counts
    are nonzero), a shard (u8 images, or float32 rows as 2DMG's), fakes
    (shared (B, din) or per client (W, B, din)) and counts, as numpy."""
    d = build_discriminator(family, out_dim, in_dim=din)
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
    if float_rows:
        shard = rng.uniform(-1, 1, size=(W, L, din)).astype(np.float32)
    else:
        shard = rng.integers(0, 256, size=(W, L, din)).astype(np.uint8)
    fake_shape = (W, B, din) if per_client else (B, din)
    fake = rng.normal(size=fake_shape).astype(np.float32)
    return six, mu6, nu6, np.asarray(counts, np.int32), shard, fake


def _jax_run(six, mu6, nu6, count, shard, fake, head, half):
    reals = jnp.stack([jnp.asarray(shard)[:, s:s + B] for s in STARTS],
                      axis=1)
    out = jfused.fused_d_epoch_steps(
        tuple(map(jnp.asarray, six)), tuple(map(jnp.asarray, mu6)),
        tuple(map(jnp.asarray, nu6)), jnp.asarray(count), reals,
        jnp.asarray(fake), head=head, d_loss_half=half,
        is_image=shard.dtype == np.uint8, lr=LR, b1=B1, b2=B2,
        fake_per_client=fake.ndim == 3, interpret=True)
    p, m, n, c, loss = out
    return ([np.asarray(x) for x in p], [np.asarray(x) for x in m],
            [np.asarray(x) for x in n], np.asarray(c), np.asarray(loss))


def _port_run(six, mu6, nu6, count, shard, fake, head, half, device):
    t = lambda x: torch.from_numpy(np.array(x)).to(device)
    p, m, n, c, loss = fused_dstep.fused_d_epoch_steps(
        [t(x) for x in six], [t(x) for x in mu6], [t(x) for x in nu6],
        t(count.astype(np.int64)), t(shard), STARTS, t(fake), head=head,
        d_loss_half=half, is_image=shard.dtype == np.uint8, lr=LR, b1=B1,
        b2=B2)
    npy = lambda x: x.cpu().numpy()
    return ([npy(x) for x in p], [npy(x) for x in m], [npy(x) for x in n],
            npy(c), npy(loss))


def _assert_close(got, ref, tol_p=TOL_P):
    for name, a, b, (rtol, atol) in (("params", got[0], ref[0], tol_p),
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


@pytest.mark.parametrize("half", [False, True])
@pytest.mark.parametrize("head,out_dim", [("sigmoid", 1), ("logits2", 2)])
def test_plain_matches_jax_kernel_per_client_fakes(head, out_dim, half):
    """Distinct fakes a client (the CGL family's routing: a multipath G's
    head i to client i), both heads, both D-loss scales, diverging
    counts."""
    args = _inputs(out_dim, [0, 7, 3], seed=1, per_client=True)
    _assert_close(_port_run(*args, head, half, "cpu"),
                  _jax_run(*args, head, half), TOL_P_STEP)


@pytest.mark.parametrize("family,din,half,per_client", [
    ("2dmg", 2, False, True),     # CGL-GAN on 2DMG: 2-128-256-1, x1
    ("2dmg", 2, True, False),     # Mix-G on 2DMG: sigmoid head, x0.5
    ("mnist", 5, False, True),    # a ragged din: 5-512-256-1
], ids=["2dmg", "2dmg_half_shared", "din5"])
def test_plain_matches_jax_kernel_float_rows(family, din, half, per_client):
    """float32 real rows used as they are (``is_image=False``), the
    reference's 2DMG input, with diverging per-client counts."""
    args = _inputs(1, [0, 7, 3], seed=2, family=family, din=din,
                   float_rows=True, per_client=per_client)
    _assert_close(_port_run(*args, "sigmoid", half, "cpu"),
                  _jax_run(*args, "sigmoid", half), TOL_P_STEP)


# bf16 state, as tests/test_pallas_dstep.py:160-176 holds the reference's
# own bf16-state kernel to float32 math: params rtol 1e-2 / atol 1e-3,
# moments rtol 2e-2 / atol 3e-3 (nu atol 1e-6), losses rtol 2e-2 / atol
# 1e-3.  Here both sides compute the same float32 math on bf16-rounded
# operands and round once, so they part only where float32's sum order
# flips an operand's bf16 rounding.
TOL_BF16 = {"params": (1e-2, 1e-3), "mu": (2e-2, 3e-3), "nu": (2e-2, 1e-6),
            "loss": (2e-2, 1e-3)}


def _bf16_inputs(out_dim, per_client, **kw):
    """``_inputs`` with the 18 state tensors and the fakes rounded to bf16
    (``ml_dtypes.bfloat16`` numpy arrays, which both packages take)."""
    import ml_dtypes
    six, mu6, nu6, count, shard, fake = _inputs(out_dim, [0, 7, 3], seed=1,
                                               per_client=per_client, **kw)
    bf = lambda xs: [np.asarray(x).astype(ml_dtypes.bfloat16) for x in xs]
    return (bf(six), bf(mu6), bf(nu6), count, shard,
            np.asarray(fake).astype(ml_dtypes.bfloat16))


def _bf16_close(got, ref):
    """Port (torch tensors) against the reference (JAX arrays): bf16 state
    out, float32 losses, each group at TOL_BF16."""
    for name, a, b in (("params", got[0], ref[0]), ("mu", got[1], ref[1]),
                       ("nu", got[2], ref[2])):
        rtol, atol = TOL_BF16[name]
        for j, (x, y) in enumerate(zip(a, b)):
            assert x.dtype == torch.bfloat16 and y.dtype == jnp.bfloat16
            np.testing.assert_allclose(x.float().numpy(),
                                       np.asarray(y, np.float32), rtol=rtol,
                                       atol=atol, err_msg=f"{name}[{j}]")
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]))
    assert got[4].dtype == torch.float32
    np.testing.assert_allclose(got[4].numpy(), np.asarray(ref[4]),
                               rtol=TOL_BF16["loss"][0],
                               atol=TOL_BF16["loss"][1])


def _port_run_bf16(args, head, half, device="cpu"):
    from cglgan_tpu_torch.utils.transplant import tensor_from_numpy
    six, mu6, nu6, count, shard, fake = args
    t = lambda x: tensor_from_numpy(x, device)
    return fused_dstep.fused_d_epoch_steps(
        [t(x) for x in six], [t(x) for x in mu6], [t(x) for x in nu6],
        t(count.astype(np.int64)), t(shard), STARTS, t(fake), head=head,
        d_loss_half=half, is_image=shard.dtype == np.uint8, lr=LR, b1=B1,
        b2=B2)


@pytest.mark.parametrize("head,out_dim,half,per_client,rows", [
    ("logits2", 2, True, False, False),      # CAP-GAN's main path
    ("sigmoid", 1, False, True, False),      # CGL-GAN: a bf16 fake a client
    ("sigmoid", 1, False, True, True),       # CGL-GAN on 2DMG, din=2
], ids=["logits2", "sigmoid_per_client", "2dmg_per_client"])
def test_plain_bf16_matches_jax_kernel(head, out_dim, half, per_client,
                                       rows):
    """bf16 state and bf16 fakes: the plain version against
    ``_dstep_kernel`` with ``mxu_bf16`` in interpret mode (its products on
    bf16 operands, float32 elsewhere, the state rounded once); the outputs
    stay bf16."""
    kw = dict(family="2dmg", din=2, float_rows=True) if rows else {}
    args = _bf16_inputs(out_dim, per_client, **kw)
    ref = _jax_run(*args, head, half)
    got = _port_run_bf16(args, head, half)
    _bf16_close(got, ref)


def test_bf16_state_must_not_mix():
    """All 18 state tensors bf16, or all float32: a mix raises."""
    six, mu6, nu6, count, shard, fake = _inputs(1, [0, 0, 0])
    t = lambda x: torch.from_numpy(np.array(x))
    mixed = [t(x).bfloat16() if j == 2 else t(x) for j, x in enumerate(mu6)]
    with pytest.raises(ValueError, match="mixed dtypes"):
        fused_dstep.fused_d_epoch_steps(
            [t(x) for x in six], mixed, [t(x) for x in nu6],
            t(count.astype(np.int64)), t(shard), STARTS, t(fake))


def test_rows_must_match_is_image():
    """uint8 shards are images and float32 shards are rows; anything else
    is refused before a kernel or plain step runs."""
    six, mu6, nu6, count, shard, fake = _inputs(1, [0, 0, 0])
    t = lambda x: torch.from_numpy(np.array(x))
    state = ([t(x) for x in six], [t(x) for x in mu6], [t(x) for x in nu6],
             t(count.astype(np.int64)))
    for rows, is_image in ((shard, False),
                           (shard.astype(np.float32), True),
                           (shard.astype(np.float64), False)):
        with pytest.raises(ValueError, match="shards"):
            fused_dstep.fused_d_epoch_steps(*state, t(rows), STARTS, t(fake),
                                            is_image=is_image)


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
    got = npy(fused_dstep.fused_d_epoch_steps(
        *targs, is_image=shard.dtype == np.uint8, **kw))
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
@pytest.mark.parametrize("family,din,head,out_dim,half,float_rows", [
    ("2dmg", 2, "sigmoid", 1, False, True),    # CGL-GAN on 2DMG
    ("2dmg", 2, "sigmoid", 1, True, True),     # Mix-G on 2DMG
    ("mnist", DIN, "logits2", 2, True, False),  # Mix-G on images
    ("mnist", DIN, "sigmoid", 1, False, False),  # CGL-GAN on images
], ids=["2dmg_cgl", "2dmg_mix", "img_mix", "img_cgl"])
def test_cuda_kernel_per_client_fakes(family, din, head, out_dim, half,
                                      float_rows):
    """The CUDA kernel against the plain version on the card with distinct
    fakes a client, on image shards and on float rows at din=2 (the first
    layer's unaligned path)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    args = _inputs(out_dim, [0, 7, 3], seed=1, family=family, din=din,
                   float_rows=float_rows, per_client=True)
    launched = fused_dstep.launches
    got, ref = _on_card(args, STARTS, head, half)
    assert fused_dstep.launches == launched + 1
    _assert_close(got, ref, TOL_P_STEP)


@pytest.mark.cuda
@pytest.mark.parametrize("head,out_dim,half,per_client,rows", [
    ("logits2", 2, True, False, False),      # CAP-GAN's main path
    ("sigmoid", 1, False, True, False),      # CGL-GAN: a bf16 fake a client
    ("sigmoid", 1, False, True, True),       # 2DMG rows, din=2
], ids=["logits2", "sigmoid_per_client", "2dmg"])
def test_cuda_kernel_bf16_matches_plain(head, out_dim, half, per_client,
                                        rows):
    """The CUDA kernel with bf16 state (bf16-operand tensor-core products,
    one rounding at the store) against the plain version on the card, same
    inputs: bf16 out, each state tensor within 0.1 of its largest entry and
    losses 2e-4 relative, as ``chip_smoke.py`` holds it (float32 sum order
    can flip a product operand's bf16 rounding; the plain version against
    itself in float64 moves moments by up to 4e-2 of their scale)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    from cglgan_tpu_torch.utils.transplant import tensor_from_numpy
    kw = dict(family="2dmg", din=2, float_rows=True) if rows else {}
    six, mu6, nu6, count, shard, fake = _bf16_inputs(out_dim, per_client,
                                                     **kw)
    t = lambda x: tensor_from_numpy(x, "cuda")
    targs = ([t(x) for x in six], [t(x) for x in mu6], [t(x) for x in nu6],
             t(count.astype(np.int64)), t(shard), STARTS, t(fake))
    kwargs = dict(head=head, d_loss_half=half, lr=LR, b1=B1, b2=B2)
    launched = fused_dstep.launches
    got = fused_dstep.fused_d_epoch_steps(
        *targs, is_image=shard.dtype == np.uint8, **kwargs)
    assert fused_dstep.launches == launched + 1
    ref = fused_dstep.fused_d_epoch_steps_plain(*targs, **kwargs)
    for a, b in zip([x for g in got[:3] for x in g],
                    [x for g in ref[:3] for x in g]):
        assert a.dtype == b.dtype == torch.bfloat16
        err = float((a.float() - b.float()).abs().max())
        assert err <= 0.1 * float(b.float().abs().max())
    torch.testing.assert_close(got[4], ref[4], rtol=2e-4, atol=1e-7)


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

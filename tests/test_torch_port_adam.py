"""The port's fused Adam against the JAX Pallas kernel.

``cglgan_tpu_torch.ops.fused_adam.fused_adam(...).step`` on CPU tensors runs
its plain PyTorch version; it must match the reference
``cglgan_tpu.ops.pallas.fused_adam.fused_adam`` in interpret mode (which
stores bfloat16 moments rounded to nearest) on the same inputs, over two and
ten steps, on the ``(130, 170)`` + ``(170,)`` tree of
tests/test_pallas_ops.py (the second leaf's size is no multiple of 128).
Stochastic rounding cannot be compared bit for bit with a TPU's generator:
it is held to what it promises (only the two bfloat16 neighbours, unbiased).
The planning that cuts a tensor list into launches and blocks
(``plan_launches``) and the list call on CPU tensors are held here too.
The CUDA kernel is held to the plain version on the card by the ``cuda``
cases, which skip without a card."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cglgan_tpu.ops.pallas.fused_adam import fused_adam as jax_fused_adam
from cglgan_tpu_torch.ops import fused_adam as fa
from test_torch_port_threads import one_torch_thread  # noqa: F401

LR, B1, B2 = 2e-4, 0.5, 0.999

# float32 on both sides, the same formula in the same order; XLA's and
# PyTorch's exp, sqrt and divide may differ in the last place.
TOL_F32 = dict(rtol=2e-6, atol=1e-9)
BF16_STEP = 2.0 ** -7            # relative size of one bfloat16 step


def _tree(seed=0, steps=1):
    rng = np.random.default_rng(seed)
    params = {"w": rng.normal(size=(130, 170)).astype(np.float32),
              "b": rng.normal(size=(170,)).astype(np.float32)}
    grads = [{k: (0.1 * rng.normal(size=v.shape)).astype(np.float32)
              for k, v in params.items()} for _ in range(steps)]
    return params, grads


def _run_jax(params, grads, moment_dtype):
    opt = jax_fused_adam(LR, B1, B2, moment_dtype=moment_dtype,
                         stochastic=False, interpret=True)
    p = jax.tree.map(jnp.asarray, params)
    st = opt.init(p)
    for g in grads:
        p, st = opt.step(jax.tree.map(jnp.asarray, g), st, p)
    f32 = lambda t: {k: np.asarray(v.astype(jnp.float32))
                     for k, v in t.items()}
    return f32(p), f32(st.m), f32(st.v), int(st.count)


def _run_port(params, grads, moment_dtype, device="cpu", stochastic=False):
    t = lambda tree: {k: torch.from_numpy(np.array(v)).to(device)
                      for k, v in tree.items()}
    opt = fa.fused_adam(LR, B1, B2, moment_dtype=moment_dtype,
                        stochastic=stochastic)
    p = t(params)
    st = opt.init(p)
    assert st.m["w"].dtype == moment_dtype
    for g in grads:
        p, st = opt.step(t(g), st, p)
    f32 = lambda tree: {k: v.float().cpu().numpy() for k, v in tree.items()}
    return f32(p), f32(st.m), f32(st.v), int(st.count)


@pytest.mark.parametrize("steps", [2, 10])
def test_plain_matches_jax_f32(steps):
    params, grads = _tree(steps=steps)
    ref = _run_jax(params, grads, jnp.float32)
    got = _run_port(params, grads, torch.float32)
    assert got[3] == ref[3] == steps
    for a, b, name in zip(got[:3], ref[:3], ("p", "m", "v")):
        for k in params:
            np.testing.assert_allclose(a[k], b[k], err_msg=f"{name}.{k}",
                                       **TOL_F32)


@pytest.mark.parametrize("steps", [2, 10])
def test_plain_matches_jax_bf16_nearest(steps):
    """bfloat16 moments, rounded to nearest on both sides.  Where the two
    float32 values differ in the last place across a rounding boundary, the
    stored moments differ by one bfloat16 step; that feeds the next step, so
    a small share of elements may sit one step apart (never more), and the
    params move by at most that share of an lr step."""
    params, grads = _tree(steps=steps)
    ref = _run_jax(params, grads, jnp.bfloat16)
    got = _run_port(params, grads, torch.bfloat16)
    assert got[3] == ref[3] == steps
    for k in params:
        np.testing.assert_allclose(got[0][k], ref[0][k], rtol=0,
                                   atol=0.01 * LR, err_msg=f"p.{k}")
        for a, b, name in ((got[1], ref[1], "m"), (got[2], ref[2], "v")):
            np.testing.assert_allclose(a[k], b[k], rtol=1.01 * BF16_STEP,
                                       atol=0, err_msg=f"{name}.{k}")
            assert np.mean(a[k] != b[k]) <= 1e-3, (name, k)


def test_plain_moment_dtype_and_untouched_inputs():
    params, grads = _tree()
    t = lambda tree: {k: torch.from_numpy(np.array(v))
                      for k, v in tree.items()}
    opt = fa.fused_adam(LR, B1, B2, moment_dtype=torch.bfloat16,
                        stochastic=False)
    p, g = t(params), t(grads[0])
    st = opt.init(p)
    new_p, new_st = opt.step(g, st, p)
    assert new_st.m["b"].dtype == new_st.v["w"].dtype == torch.bfloat16
    assert new_p["w"].dtype == torch.float32
    assert int(st.count) == 0 and int(new_st.count) == 1
    for k in params:
        np.testing.assert_array_equal(p[k].numpy(), params[k])
        assert float(st.m[k].float().abs().max()) == 0.0
    with pytest.raises(ValueError, match="moment dtype"):
        fa.fused_adam(LR, moment_dtype=torch.float16)


def _neighbours(x):
    """The two bfloat16 neighbours (as float32) of float32 ``x``: the
    truncation and one bfloat16 step beyond it."""
    lo = x.view(torch.int32) & -65536
    return lo.view(torch.float32), (lo + 65536).view(torch.float32)


def test_plain_stochastic_rounding_neighbours_and_unbiased():
    """With bits from a seeded generator: every result is one of the two
    bfloat16 neighbours (exactly ``x`` where ``x`` is representable), the
    share rounded up equals the discarded fraction (so the mean signed error
    is within three standard errors of zero), extreme bits behave, and inf
    and NaN pass through."""
    gen = torch.Generator().manual_seed(5)
    x = torch.randn(200_000, generator=gen) * torch.logspace(
        -6, 2, 200_000)
    bits = torch.randint(0, 65536, x.shape, generator=gen)
    y = fa.stochastic_round_bf16(x, bits)
    assert y.dtype == torch.bfloat16
    y = y.float()
    lo, hi = _neighbours(x)
    assert bool(((y == lo) | (y == hi)).all())
    unit = ((y - x) / (hi - lo)).double()
    se = float(unit.std()) / np.sqrt(unit.numel())
    assert abs(float(unit.mean())) <= 3 * se
    # bits = 0 truncates; bits = 65535 rounds up whatever is not exact
    exact = torch.tensor([1.0, -2.5, 0.0, 3.140625])
    zeros = torch.zeros(4, dtype=torch.int64)
    assert torch.equal(fa.stochastic_round_bf16(exact, zeros + 65535).float(),
                       exact)
    z = torch.tensor([1.0 + 2.0 ** -20, -(1.0 + 2.0 ** -20)])
    assert torch.equal(fa.stochastic_round_bf16(z, zeros[:2]).float(),
                       torch.tensor([1.0, -1.0]))
    assert torch.equal(
        fa.stochastic_round_bf16(z, zeros[:2] + 65535).float(),
        torch.tensor([1.0 + 2.0 ** -7, -(1.0 + 2.0 ** -7)]))
    odd = torch.tensor([float("inf"), float("-inf"), float("nan")])
    got = fa.stochastic_round_bf16(odd, zeros[:3] + 65535).float()
    assert torch.equal(got[:2], odd[:2]) and bool(torch.isnan(got[2]))


def test_cpu_step_keeps_stochastic_mode():
    """On CPU tensors ``step`` with ``stochastic=True`` does round
    stochastically (bits from a generator seeded like the kernel's Philox
    key), reproducibly, and differs from round-to-nearest."""
    params, grads = _tree(steps=3)
    a = _run_port(params, grads, torch.bfloat16, stochastic=True)
    b = _run_port(params, grads, torch.bfloat16, stochastic=True)
    for k in params:
        np.testing.assert_array_equal(a[1][k], b[1][k])
    # after one step both modes round the same float32 moments: they differ
    # on a good share of elements, by one bfloat16 step at most
    one = _run_port(params, grads[:1], torch.bfloat16, stochastic=True)
    near = _run_port(params, grads[:1], torch.bfloat16, stochastic=False)
    for k in params:
        assert np.mean(one[1][k] != near[1][k]) > 0.2
        np.testing.assert_allclose(one[1][k], near[1][k],
                                   rtol=1.01 * BF16_STEP, atol=0)
    assert fa.round_seed(1) == 2654435761 & 0x7FFFFFFF
    assert fa.round_seed(3) == (3 * 2654435761 % 2 ** 32) & 0x7FFFFFFF


def _covered(sizes, max_tensors, chunk):
    """Per leaf, how often ``plan_launches`` touches each element."""
    seen = [np.zeros(n, np.int64) for n in sizes]
    plan = fa.plan_launches(sizes, max_tensors, chunk)
    for launch in plan:
        assert 1 <= len(launch.leaves) <= max_tensors
        assert len(launch.leaves) == len(launch.sizes) == len(launch.first)
        bounds = list(launch.first) + [launch.blocks]
        assert bounds[0] == 0 and bounds == sorted(bounds)
        for block in range(launch.blocks):
            # the kernel's scan: the last leaf whose first block is <= block
            s = max(i for i, f in enumerate(launch.first) if f <= block)
            leaf, n = launch.leaves[s], launch.sizes[s]
            assert n == sizes[leaf]
            lo = (block - launch.first[s]) * chunk
            assert lo < n, "a block with nothing to do"
            seen[leaf][lo:min(lo + chunk, n)] += 1
    return plan, seen


@pytest.mark.parametrize("sizes,max_tensors,chunk,n_launches", [
    ([22100, 170], fa.MAX_TENSORS, fa.CHUNK, 1),       # the test tree
    ([5, 0, 4097, 3, 8192, 1], 4, 4096, 2),            # tails, an empty leaf
    ([7, 100_003, 9, 2], 8, 64, 1),                    # one leaf dwarfs the rest
    ([3] * 50 + [0] * 7 + [130], fa.MAX_TENSORS, fa.CHUNK, 3),
    ([0, 0], fa.MAX_TENSORS, fa.CHUNK, 0),
], ids=["tree", "tails_and_empty", "one_large", "longer_than_a_launch",
        "all_empty"])
def test_plan_covers_every_element_once(sizes, max_tensors, chunk,
                                        n_launches):
    plan, seen = _covered(sizes, max_tensors, chunk)
    assert len(plan) == n_launches
    for j, hits in enumerate(seen):
        assert bool((hits == 1).all()), f"leaf {j}"
    live = [j for j, n in enumerate(sizes) if n]
    assert [j for launch in plan for j in launch.leaves] == live


def _leaf_lists(dt, seed=11):
    rng = np.random.default_rng(seed)
    shapes = [(13, 7), (0,), (170,), (3,), (64, 5)]
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    ps = [t(rng.normal(size=s)) for s in shapes]
    gs = [t(0.1 * rng.normal(size=s)) for s in shapes]
    ms = [t(1e-3 * rng.normal(size=s)).to(dt) for s in shapes]
    vs = [t(1e-6 * np.abs(rng.normal(size=s))).to(dt) for s in shapes]
    return gs, ps, ms, vs


@pytest.mark.parametrize("mode", ["f32", "bf16", "bf16_sr"])
def test_cpu_leaves_equal_plain_per_leaf(mode):
    """``fused_adam_leaves`` on CPU tensors is ``fused_adam_step_plain`` per
    leaf, bit for bit; in stochastic mode with the bits of a generator
    seeded by (round seed, leaf index), and it does round stochastically."""
    dt = torch.float32 if mode == "f32" else torch.bfloat16
    gs, ps, ms, vs = _leaf_lists(dt)
    count = torch.tensor(4, dtype=torch.int64)
    kw = dict(lr=LR, b1=B1, b2=B2, eps=1e-8)
    got = fa.fused_adam_leaves(gs, ps, ms, vs, count,
                               stochastic=mode == "bf16_sr", **kw)
    assert len(got) == len(ps)
    for j, (g, p, m, v) in enumerate(zip(gs, ps, ms, vs)):
        bits = {}
        if mode == "bf16_sr":
            gen = torch.Generator().manual_seed((fa.round_seed(4) << 20) + j)
            bits = dict(
                bits_m=torch.randint(0, 65536, p.shape, generator=gen),
                bits_v=torch.randint(0, 65536, p.shape, generator=gen))
        ref = fa.fused_adam_step_plain(g, p, m, v, count, **kw, **bits)
        one = fa.fused_adam_leaf(g, p, m, v, count, j,
                                 stochastic=mode == "bf16_sr", **kw)
        for a, b, c in zip(got[j], ref, one):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert torch.equal(a, b) and torch.equal(a, c)
    if mode == "bf16_sr":
        near = fa.fused_adam_leaves(gs, ps, ms, vs, count, stochastic=False,
                                    **kw)
        assert float((got[4][1] != near[4][1]).float().mean()) > 0.2


def test_mixed_list_raises():
    gs, ps, ms, vs = _leaf_lists(torch.float32)
    count = torch.tensor(1, dtype=torch.int64)
    kw = dict(lr=LR, b1=B1, b2=B2, eps=1e-8, stochastic=False)
    mixed_m = [m.bfloat16() if j == 2 else m for j, m in enumerate(ms)]
    mixed_v = [v.bfloat16() if j == 2 else v for j, v in enumerate(vs)]
    with pytest.raises(ValueError, match="mixed list"):
        fa.fused_adam_leaves(gs, ps, mixed_m, mixed_v, count, **kw)
    mixed_p = [p.bfloat16() if j == 3 else p for j, p in enumerate(ps)]
    with pytest.raises(ValueError, match="mixed list"):
        fa.fused_adam_leaves(gs, mixed_p, ms, vs, count, **kw)
    with pytest.raises(ValueError, match="one entry per leaf"):
        fa.fused_adam_leaves(gs[:-1], ps, ms, vs, count, **kw)
    assert fa.fused_adam_leaves([], [], [], [], count, **kw) == []


@pytest.mark.cuda
def test_cuda_list_is_one_launch_and_bit_equal():
    """A list longer than one launch takes, with an empty leaf and tails, on
    the card: the right number of launches, bit-equal to the plain version
    with float32 moments."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    rng = np.random.default_rng(5)
    sizes = [(5 * j + 1) % 997 for j in range(fa.MAX_TENSORS + 3)]
    sizes[4] = 0
    cu = lambda a: torch.from_numpy(np.asarray(a, np.float32)).cuda()
    ps = [cu(rng.normal(size=n)) for n in sizes]
    gs = [cu(0.1 * rng.normal(size=n)) for n in sizes]
    ms = [cu(1e-3 * rng.normal(size=n)) for n in sizes]
    vs = [cu(1e-6 * np.abs(rng.normal(size=n))) for n in sizes]
    count = torch.tensor(4, dtype=torch.int64, device="cuda")
    kw = dict(lr=LR, b1=B1, b2=B2, eps=1e-8)
    launched = fa.launches
    got = fa.fused_adam_leaves(gs, ps, ms, vs, count, stochastic=False, **kw)
    assert fa.launches == launched + len(fa.plan_launches(sizes)) \
        == launched + 2
    for o, g, p, m, v in zip(got, gs, ps, ms, vs):
        ref = fa.fused_adam_step_plain(g, p, m, v, count, **kw)
        for a, b in zip(o, ref):
            assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["f32", "bf16", "bf16_sr"])
def test_cuda_kernel_matches_plain(mode):
    """The CUDA kernel against the plain version on the card, per leaf."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    params, grads = _tree()
    dt = torch.float32 if mode == "f32" else torch.bfloat16
    rng = np.random.default_rng(3)
    count = torch.tensor(4, dtype=torch.int64, device="cuda")
    kw = dict(lr=LR, b1=B1, b2=B2, eps=1e-8)
    launched = fa.launches
    for j, k in enumerate(sorted(params)):
        cu = lambda a: torch.from_numpy(np.array(a, np.float32)).cuda()
        p, g = cu(params[k]), cu(grads[0][k])
        m = cu(rng.normal(size=p.shape) * 1e-3).to(dt)
        v = cu(np.abs(rng.normal(size=p.shape)) * 1e-6).to(dt)
        got = fa.fused_adam_leaf(g, p, m, v, count, j,
                                 stochastic=mode == "bf16_sr", **kw)
        if mode == "bf16_sr":
            ref = fa.fused_adam_step_plain(g, p, m.float(), v.float(), count,
                                           **kw)
            for a, b in ((got[1], ref[1]), (got[2], ref[2])):
                lo, hi = _neighbours(b)
                assert bool(((a.float() == lo) | (a.float() == hi)).all())
        else:
            ref = fa.fused_adam_step_plain(g, p, m, v, count, **kw)
            for a, b in zip(got[1:], ref[1:]):
                torch.testing.assert_close(a.float(), b.float(),
                                           rtol=1.01 * BF16_STEP
                                           if mode == "bf16" else 1e-6,
                                           atol=0)
        torch.testing.assert_close(got[0], ref[0], rtol=1e-6, atol=1e-9)
    assert fa.launches == launched + 2

"""The port's fused local D/G sweep against the JAX Pallas kernel.

``cglgan_tpu_torch.ops.fused_sweep.fused_sweep_steps`` on CPU tensors runs
its plain PyTorch version; it must match the reference kernel
``cglgan_tpu.ops.pallas.fused_sweep.fused_sweep_steps(interpret=True)`` on
the same inputs: both generator shapes (3 and 2 linear layers), E in {1, 3},
per-worker Adam counts that differ between workers and between G and D, and
one ragged shape (W=3, B=37: no size a multiple of the kernel's tiles).
The CUDA kernel itself is held to the plain version on the card by the
``cuda`` cases, at the same shapes, which skip without a card."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cglgan_tpu.core.config import FedGANConfig as JaxConfig
from cglgan_tpu.models import zoo as jzoo
from cglgan_tpu.ops.pallas import fused_sweep as jsweep
from cglgan_tpu_torch.core.config import FedGANConfig
from cglgan_tpu_torch.ops import fused_sweep
from test_torch_port_threads import one_torch_thread  # noqa: F401

W, B = 4, 16
LR_G, LR_D, B1, B2 = 2e-4, 3e-4, 0.5, 0.999
G_COUNTS = [0, 5, 2, 9]
D_COUNTS = [3, 0, 7, 1]

# One call, float32 on both sides; XLA's interpreter and PyTorch sum the
# products in another order.  The JAX package's own round test allows rtol
# 1e-4 / atol 1e-5 on params over rounds (tests/test_pallas_sweep.py); one
# call holds tighter.  An Adam update is lr * m/(sqrt(v)+eps); from zero
# moments that is lr * g/(|g|+eps), which is steep where a gradient entry is
# near zero, so the absolute part is 1e-6: half a percent of one lr step.
TOL_P = (1e-5, 1e-6)
TOL_MU = (1e-4, 1e-7)      # moments are (1-b) * grad: grad sums reordered
TOL_NU = (1e-4, 1e-10)
TOL_LOSS = (1e-5, 1e-7)


# (E, W, B) by case id; "ragged" is a shape the card's kernel tiles raggedly
CASES = {"1": (1, W, B), "3": (3, W, B), "ragged": (1, 3, 37)}


def _inputs(family, E, seed=0, W=W, B=B):
    """Stacked per-worker G and D state from the JAX inits (distinct per
    worker), non-zero moments where the count is non-zero, reals and
    latents, as numpy."""
    rng = np.random.default_rng(seed)
    counts = lambda cs: [cs[i % len(cs)] for i in range(W)]

    def net(model, key, counts):
        p, _ = jax.vmap(lambda k: model.init(k))(
            jax.random.split(jax.random.key(key), W))
        flat = [np.asarray(x) for q in p if isinstance(q, dict)
                for x in (q["w"], q["b"])]
        on = (np.asarray(counts) > 0)
        mask = lambda x: on.reshape((W,) + (1,) * (x.ndim - 1))
        mu = [(rng.normal(size=x.shape) * 1e-3 * mask(x)).astype(np.float32)
              for x in flat]
        nu = [(np.abs(rng.normal(size=x.shape)) * 1e-6 * mask(x))
              .astype(np.float32) for x in flat]
        return flat, mu, nu, np.asarray(counts, np.int32)

    g = net(jzoo.build_generator(family), 1, counts(G_COUNTS))
    d = net(jzoo.build_discriminator("2dmg"), 2, counts(D_COUNTS))
    reals = rng.uniform(-1, 1, size=(W, E, B, 2)).astype(np.float32)
    z1 = rng.normal(size=(W, E, B, 100)).astype(np.float32)
    z2 = rng.normal(size=(W, E, B, 100)).astype(np.float32)
    return g, d, reals, z1, z2


def _jax_run(g, d, reals, z1, z2):
    j = lambda xs: [jnp.asarray(x) for x in xs]
    out = jsweep.fused_sweep_steps(
        j(g[0]), j(g[1]), j(g[2]), jnp.asarray(g[3]), j(d[0]), j(d[1]),
        j(d[2]), jnp.asarray(d[3]), jnp.asarray(reals), jnp.asarray(z1),
        jnp.asarray(z2), lr_g=LR_G, lr_d=LR_D, b1=B1, b2=B2, interpret=True)
    return [[np.asarray(x) for x in o] for o in out[:6]] + \
        [np.asarray(out[6]), np.asarray(out[7])]


def _port_run(g, d, reals, z1, z2, device, fn=None):
    t = lambda x: torch.from_numpy(np.array(x)).to(device)
    ts = lambda xs: [t(x) for x in xs]
    fn = fn or fused_sweep.fused_sweep_steps
    out = fn(ts(g[0]), ts(g[1]), ts(g[2]), t(g[3].astype(np.int64)),
             ts(d[0]), ts(d[1]), ts(d[2]), t(d[3].astype(np.int64)),
             t(reals), t(z1), t(z2), lr_g=LR_G, lr_d=LR_D, b1=B1, b2=B2)
    npy = lambda x: x.cpu().numpy()
    return [[npy(x) for x in o] for o in out[:6]] + [npy(out[6]),
                                                    npy(out[7])]


def _assert_close(got, ref):
    names = ("g.params", "g.mu", "g.nu", "d.params", "d.mu", "d.nu")
    tols = (TOL_P, TOL_MU, TOL_NU) * 2
    for name, a, b, (rtol, atol) in zip(names, got[:6], ref[:6], tols):
        assert len(a) == len(b)
        for j, (x, y) in enumerate(zip(a, b)):
            np.testing.assert_allclose(x, y, rtol=rtol, atol=atol,
                                       err_msg=f"{name}[{j}]")
    for k, name in ((6, "d_loss"), (7, "g_loss")):
        np.testing.assert_allclose(got[k], ref[k], rtol=TOL_LOSS[0],
                                   atol=TOL_LOSS[1], err_msg=name)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("family", ["2dmg-mlp", "2dmg-small"],
                         ids=["Lg3", "Lg2"])
def test_plain_matches_jax_kernel(family, case):
    E, w, b = CASES[case]
    args = _inputs(family, E, W=w, B=b)
    _assert_close(_port_run(*args, "cpu"), _jax_run(*args))


def test_inputs_not_modified():
    """The port returns new tensors (the Pallas call aliases in place)."""
    g, d, reals, z1, z2 = _inputs("2dmg-small", 2)
    t = lambda x: torch.from_numpy(np.array(x))
    g_in = [[t(x) for x in part] for part in g[:3]]
    d_in = [[t(x) for x in part] for part in d[:3]]
    fused_sweep.fused_sweep_steps(
        *g_in, t(g[3].astype(np.int64)), *d_in, t(d[3].astype(np.int64)),
        t(reals), t(z1), t(z2), lr_g=LR_G, lr_d=LR_D, b1=B1, b2=B2)
    for got, ref in zip(g_in + d_in, list(g[:3]) + list(d[:3])):
        for x, y in zip(got, ref):
            np.testing.assert_array_equal(x.numpy(), y)


def test_wrapper_rejects_other_shapes_and_devices():
    g, d, reals, z1, z2 = _inputs("2dmg-small", 1)
    t = lambda x: torch.from_numpy(np.array(x))
    ts = lambda xs: [t(x) for x in xs]
    with pytest.raises(ValueError, match="3-layer D"):
        fused_sweep.fused_sweep_steps(
            ts(g[0]), ts(g[1]), ts(g[2]), t(g[3]), ts(d[0][:4]), ts(d[1]),
            ts(d[2]), t(d[3]), t(reals), t(z1), t(z2))
    with pytest.raises(ValueError, match="unsupported device"):
        fused_sweep.fused_sweep_steps(
            ts(g[0]), ts(g[1]), ts(g[2]), t(g[3]), ts(d[0]), ts(d[1]),
            ts(d[2]), t(d[3]), t(reals).to("meta"), t(z1), t(z2))


BASE = dict(algo="flgan", dataset="2dmg", num_workers=4, batch_size=16)
ELIGIBLE_CASES = [
    # (config overrides, expected: True / False / "raises")
    (dict(pallas_sweep=True, epoch=4), True),
    (dict(pallas_sweep=True, algo="fegan", frac_workers=0.5), True),
    (dict(epoch=1), False),                    # auto never engages
    (dict(epoch=2), False),
    (dict(epoch=10), False),
    (dict(pallas_sweep=False, epoch=5), False),
    (dict(pallas_sweep=True, dataset="synthetic-mnist"), "raises"),
    (dict(pallas_sweep=True, algo="cglgan", epoch=4), "raises"),
    (dict(pallas_sweep=True, epoch=33), "raises"),
    (dict(pallas_sweep=True, dropout_rate=0.1), "raises"),
    (dict(pallas_sweep=True, d_head="logits2"), "raises"),
]


@pytest.mark.parametrize("kw,expect", ELIGIBLE_CASES,
                         ids=[str(i) for i in range(len(ELIGIBLE_CASES))])
def test_eligible_matches_reference(kw, expect):
    """Accepts and rejects as ``cglgan_tpu.ops.pallas.fused_sweep.eligible``
    (tests/test_pallas_sweep.py: forced flag, auto never engages, the CGL
    family rejected)."""
    cfg, jcfg = FedGANConfig(**{**BASE, **kw}), JaxConfig(**{**BASE, **kw})
    if expect == "raises":
        with pytest.raises(ValueError, match="pallas_sweep"):
            jsweep.eligible(jcfg, None)
        with pytest.raises(ValueError, match="pallas_sweep"):
            fused_sweep.eligible(cfg)
    else:
        assert jsweep.eligible(jcfg, None) is expect
        assert fused_sweep.eligible(cfg) is expect


def test_force_flag_rejected_by_build_runner():
    from cglgan_tpu_torch.algos.registry import build_runner
    cfg = FedGANConfig(algo="capgan", dataset="synthetic-mnist",
                       num_workers=4, batch_size=16, pallas_sweep=True)
    with pytest.raises(ValueError, match="pallas_sweep"):
        build_runner(cfg, device="cpu")


def test_counts_shared_or_per_worker():
    """The wrapper hands the kernel int64 counts, one per worker or one
    shared, and rejects any other number."""
    per, flag = fused_sweep._counts(torch.arange(4, dtype=torch.int32), 4,
                                    torch.device("cpu"), "g_count")
    assert per.dtype == torch.int64 and per.tolist() == [0, 1, 2, 3]
    assert flag == 1
    shared, flag = fused_sweep._counts(torch.tensor(7), 4,
                                       torch.device("cpu"), "g_count")
    assert shared.tolist() == [7] and flag == 0
    with pytest.raises(ValueError, match="3 counts for 4 workers"):
        fused_sweep._counts(torch.zeros(3, dtype=torch.int64), 4,
                            torch.device("cpu"), "d_count")


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["3", "ragged"])
@pytest.mark.parametrize("family", ["2dmg-mlp", "2dmg-small"],
                         ids=["Lg3", "Lg2"])
def test_cuda_kernel_matches_plain(family, case):
    """The CUDA kernel against the plain version on the card, same inputs
    (TF32 off: both sides are full float32)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    launched = fused_sweep.launches
    E, w, b = CASES[case]
    args = _inputs(family, E, W=w, B=b)
    got = _port_run(*args, "cuda")
    assert fused_sweep.launches == launched + 1
    ref = _port_run(*args, "cuda", fn=fused_sweep.fused_sweep_steps_plain)
    _assert_close(got, ref)

"""Serving and migration in the port (``cglgan_tpu_torch/utils/torch_import.py``
and ``utils/export.py``) against the reference's on the CPU.

Every ``.pt`` is built here with the reference's torch layouts (the twins of
``tests/test_torch_import.py``: ``model`` / ``paths`` / ``l1`` /
``conv_blocks``), its BatchNorm statistics moved by a few train-mode
forwards, and ``torch.save``d.

Tolerances.  The imported trees and the warm-started states: bit for bit
(both sides copy the same float32 tensors onto the same init).  The imported model's eval forward against
JAX's: ``TOL_FWD`` = 1e-5 absolute, ``TOL_FWD_CONV`` = 1e-4 for the conv
families (XLA's and oneDNN's convolutions sum in different orders), as
``tests/test_torch_import.py``.  An artifact loaded from disk against the
port's own ``runner.gen`` on the same state and latents: bit for bit (the
program runs the same ATen ops); against the JAX artifact on the
transplanted state: ``TOL_FWD``.
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as tnn

from cglgan_tpu.algos.registry import build_runner as jax_build_runner
from cglgan_tpu.core.config import FedGANConfig as JaxConfig
from cglgan_tpu.data.partition import Partition as JaxPartition
from cglgan_tpu.utils import export as jexport
from cglgan_tpu.utils import torch_import as jti
from cglgan_tpu_torch.algos.registry import build_runner
from cglgan_tpu_torch.core.config import FedGANConfig
from cglgan_tpu_torch.data.partition import Partition
from cglgan_tpu_torch.utils import export as export_mod
from cglgan_tpu_torch.utils import torch_import as ti
from cglgan_tpu_torch.utils.transplant import (from_jax_numpy,
                                               tensor_from_numpy, to_numpy)
from cglgan_tpu_torch.utils.tree import tree_leaves, tree_map
from test_torch_port_threads import one_torch_thread  # noqa: F401

TOL_FWD = 1e-5
TOL_FWD_CONV = 1e-4


# ---------------------------------------------------------------------------
# reference-layout generators
# ---------------------------------------------------------------------------

def _block(din, dout, normalize=True):
    layers = [tnn.Linear(din, dout)]
    if normalize:
        layers.append(tnn.BatchNorm1d(dout, 0.8))
    layers.append(tnn.LeakyReLU(0.2))
    return layers


class SeqG(tnn.Module):
    """Reference single-path shape: everything under ``self.model``."""

    def __init__(self, seq):
        super().__init__()
        self.model = seq

    def forward(self, z):
        return self.model(z)


class PathG(tnn.Module):
    """Reference multipath shape: ``self.model`` trunk + ``self.paths``."""

    def __init__(self, trunk, heads):
        super().__init__()
        self.model = trunk
        self.paths = tnn.ModuleList(heads)

    def forward(self, z):
        h = self.model(z)
        return torch.stack([p(h) for p in self.paths])


class ConvG(tnn.Module):
    """model/lsgan.py:3-27 Generator (l1 + conv_blocks)."""

    def __init__(self):
        super().__init__()
        self.l1 = tnn.Sequential(tnn.Linear(100, 128 * 8 * 8))
        self.conv_blocks = tnn.Sequential(
            tnn.Upsample(scale_factor=2),
            tnn.Conv2d(128, 128, 3, stride=1, padding=1),
            tnn.BatchNorm2d(128, 0.8), tnn.LeakyReLU(0.2),
            tnn.Upsample(scale_factor=2),
            tnn.Conv2d(128, 64, 3, stride=1, padding=1),
            tnn.BatchNorm2d(64, 0.8), tnn.LeakyReLU(0.2),
            tnn.Conv2d(64, 1, 3, stride=1, padding=1), tnn.Tanh())

    def forward(self, z):
        return self.conv_blocks(self.l1(z).view(z.shape[0], 128, 8, 8))


class ConvMixG(tnn.Module):
    """model/lsgan.py:37-70 MixGenerator (its img_shape view fixed)."""

    def __init__(self, n):
        super().__init__()
        self.model = tnn.Sequential(
            tnn.Sequential(tnn.Linear(100, 128 * 8 * 8)),
            tnn.Unflatten(1, (128, 8, 8)), tnn.Upsample(scale_factor=2),
            tnn.Conv2d(128, 128, 3, stride=1, padding=1),
            tnn.BatchNorm2d(128, 0.8), tnn.LeakyReLU(0.2),
            tnn.Upsample(scale_factor=2),
            tnn.Conv2d(128, 64, 3, stride=1, padding=1))
        self.paths = tnn.ModuleList([
            tnn.Sequential(tnn.BatchNorm2d(64, 0.8), tnn.LeakyReLU(0.2),
                           tnn.Conv2d(64, 1, 3, stride=1, padding=1),
                           tnn.Tanh())
            for _ in range(n)])

    def forward(self, z):
        h = self.model(z)
        return torch.stack([p(h) for p in self.paths])


def mnist_mlp(out=784):
    return SeqG(tnn.Sequential(
        *_block(100, 128, normalize=False), *_block(128, 256),
        *_block(256, 512), *_block(512, 1024), tnn.Linear(1024, out),
        tnn.Tanh()))


def mnist_multipath(n, out=784):
    trunk = tnn.Sequential(*_block(100, 128, normalize=False),
                           *_block(128, 256), *_block(256, 512))
    return PathG(trunk, [tnn.Sequential(*_block(512, 1024),
                                        tnn.Linear(1024, out), tnn.Tanh())
                         for _ in range(n)])


def g2dmg_small():
    return SeqG(tnn.Sequential(tnn.Linear(100, 32), tnn.LeakyReLU(0.2),
                               tnn.Linear(32, 2), tnn.Tanh()))


def g2dmg_mlp():
    return SeqG(tnn.Sequential(tnn.Linear(100, 256), tnn.LeakyReLU(0.2),
                               tnn.Linear(256, 128), tnn.LeakyReLU(0.2),
                               tnn.Linear(128, 2), tnn.Tanh()))


def g2dmg_multipath(n):
    return PathG(tnn.Sequential(tnn.Linear(100, 32), tnn.LeakyReLU(0.2)),
                 [tnn.Sequential(tnn.Linear(32, 2), tnn.Tanh())
                  for _ in range(n)])


def save_pt(tg, path, seed=0, steps=3):
    """Seed the twin's weights, move its BN statistics with a few
    train-mode forwards, and save its state_dict."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in tg.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.1)
        tg.train()
        for _ in range(steps):
            tg(torch.randn(32, 100, generator=gen))
    torch.save(tg.state_dict(), path)
    return str(path)


def port_tree(jax_tree):
    """A JAX tree as the port lays it out, through ``utils/transplant.py``."""
    return tree_map(lambda x: tensor_from_numpy(np.asarray(x), "cpu"),
                    jax_tree)


def assert_trees_equal(got, want):
    assert tree_map(lambda _: 0, got) == tree_map(lambda _: 0, want)
    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        assert g.dtype == w.dtype and torch.equal(g, w)


# ---------------------------------------------------------------------------
# import: every family
# ---------------------------------------------------------------------------

IMPORT_CASES = {
    "mnist-mlp": (mnist_mlp, {"family": "mnist-mlp", "num_heads": 1,
                              "img_shape": (1, 28, 28)}),
    "mnist-mlp-16": (lambda: mnist_mlp(out=256),
                     {"family": "mnist-mlp", "num_heads": 1,
                      "img_shape": (1, 16, 16)}),
    "mnist-multipath": (lambda: mnist_multipath(3),
                        {"family": "mnist-multipath", "num_heads": 3,
                         "img_shape": (1, 28, 28)}),
    "2dmg-small": (g2dmg_small, {"family": "2dmg-small", "num_heads": 1,
                                 "img_shape": (2,)}),
    "2dmg-mlp": (g2dmg_mlp, {"family": "2dmg-mlp", "num_heads": 1,
                             "img_shape": (2,)}),
    "2dmg-multipath": (lambda: g2dmg_multipath(5),
                       {"family": "2dmg-multipath", "num_heads": 5,
                        "img_shape": (2,)}),
    "conv": (ConvG, {"family": "conv", "num_heads": 1,
                     "img_shape": (1, 32, 32)}),
    "conv-multipath": (lambda: ConvMixG(2),
                       {"family": "conv-multipath", "num_heads": 2,
                        "img_shape": (1, 32, 32)}),
}


def eval_forward(model, params, state, z):
    """The port's eval forward of an unstacked import, heads (k, n, ...)."""
    up = lambda tree: tree_map(lambda x: x.unsqueeze(0), tree)
    with torch.no_grad():
        y, _ = model.apply(up(params), up(state), z.unsqueeze(0),
                           train=False)
    return y[0]


@pytest.mark.parametrize("case", sorted(IMPORT_CASES))
def test_import_matches_reference(case, tmp_path):
    """One ``.pt`` through both importers: the same detection dict, the
    trees bit for bit, and the eval forward within TOL_FWD (conv
    TOL_FWD_CONV) of JAX's, and of the twin's own."""
    make, expect = IMPORT_CASES[case]
    tg = make()
    pt = save_pt(tg, tmp_path / "g.pt")
    jmodel, jparams, jstate, jinfo = jti.import_generator_file(pt)
    model, params, state, info = ti.import_generator_file(pt, device="cpu")
    assert info == jinfo == expect
    assert_trees_equal(params, port_tree(jparams))
    assert_trees_equal(state, port_tree(jstate))
    assert model.multipath == jmodel.multipath

    z = np.random.default_rng(3).normal(size=(16, 100)).astype(np.float32)
    got = eval_forward(model, params, state, torch.from_numpy(z)).numpy()
    want, _ = jmodel.apply(jparams, jstate, jnp.asarray(z), train=False)
    tol = TOL_FWD_CONV if case.startswith("conv") else TOL_FWD
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=tol)
    tg.eval()
    with torch.no_grad():
        twin = tg(torch.from_numpy(z)).numpy().reshape(got.shape)
    np.testing.assert_allclose(got, twin, rtol=0, atol=tol)


def test_import_places_and_casts(tmp_path):
    """The trees take the dtype asked for, through the template, and the
    device: an import with no device asks for the card."""
    pt = save_pt(g2dmg_small(), tmp_path / "g.pt")
    _, params, state, _ = ti.import_generator_file(
        pt, dtype=torch.bfloat16, device="cpu")
    _, f32, _, _ = ti.import_generator_file(pt, device="cpu")
    for x, y in zip(tree_leaves(params), tree_leaves(f32)):
        assert x.dtype == torch.bfloat16 and x.device.type == "cpu"
        assert torch.equal(x, y.to(torch.bfloat16))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ti.import_generator_file(pt)


# ---------------------------------------------------------------------------
# warm start
# ---------------------------------------------------------------------------

def cfg_2dmg(algo, **kw):
    base = dict(algo=algo, dataset="2dmg", num_workers=4, num_class=5,
                num_sample=200, iid=1, batch_size=32, num_communication=4,
                num_plt=2, epoch=1)
    base.update(kw)
    return base


def both_runners(kw, part=None):
    """The reference's runner and the port's from one config."""
    jr = jax_build_runner(JaxConfig(**kw), part[0] if part else None)
    cfg = FedGANConfig(**kw)
    return jr, build_runner(cfg, part[1] if part else None, device="cpu")


WARM_CASES = {
    "acgan-S2-two": (dict(algo="acgan", num_servers=2), g2dmg_small, 2),
    "acgan-S2-broadcast": (dict(algo="acgan", num_servers=2), g2dmg_small,
                           1),
    "flgan-shared": (dict(algo="flgan"), g2dmg_mlp, 1),
    "mixgan-S2": (dict(algo="mixgan", num_servers=2),
                  lambda: g2dmg_multipath(2), 2),
}


@pytest.mark.parametrize("case", sorted(WARM_CASES))
def test_warm_start_matches_reference(case, tmp_path):
    """``warm_start_generators`` on the reference's init, transplanted,
    equals the reference's on that init, bit for bit: G params and BN state
    from the files, D, the Adam state, ``lam`` and ``t`` as they were."""
    kw, make, files = WARM_CASES[case]
    kw = cfg_2dmg(**kw)
    paths = [save_pt(make(), tmp_path / f"g{i}.pt", seed=10 + i)
             for i in range(files)]
    jr, r = both_runners(kw)
    jinit = jax.jit(jr.init_state)()
    jstate = jti.warm_start_generators(jinit, paths)
    want = to_numpy(from_jax_numpy(jax.tree.map(np.asarray, jstate),
                                   r.cfg, "cpu"))
    # from the same init (Mix-G's DCGAN normals are the reference's within
    # ulps, not bit for bit)
    init = from_jax_numpy(jax.tree.map(np.asarray, jinit), r.cfg, "cpu")
    got = to_numpy(ti.warm_start_generators(init, paths))
    flat = lambda d: tree_leaves(tree_map(torch.from_numpy, d))
    assert got["t"] == want["t"] == 0
    for part in ("g", "d"):
        for key in ("params", "bn", "count", "mu", "nu"):
            a, b = flat(got[part][key]), flat(want[part][key])
            assert len(a) == len(b)
            assert all(torch.equal(x, y) for x, y in zip(a, b)), (part, key)
    assert torch.equal(torch.from_numpy(np.asarray(got["lam"])),
                       torch.from_numpy(np.asarray(want["lam"]))) \
        if got["lam"] is not None else want["lam"] is None
    # the D is the init's own; the first G leaf is the first .pt's
    d0 = to_numpy(init)["d"]["params"]
    assert all(np.array_equal(x, y) for x, y in
               zip(tree_leaves(got["d"]["params"]), tree_leaves(d0)))
    w = torch.load(paths[0])["model.0.weight"].numpy().T
    g = got["g"]["params"]
    g0 = (g["trunk"] if isinstance(g, dict) else g)[0]["w"]
    np.testing.assert_array_equal(g0 if g0.ndim == 2 else g0[0], w)


def test_warm_start_refusals(tmp_path):
    """The reference's messages: a shared G takes a single file, a stacked
    G one a server or one, and a file of another family is refused."""
    small = save_pt(g2dmg_small(), tmp_path / "s.pt")
    mlp = save_pt(g2dmg_mlp(), tmp_path / "m.pt")
    fl = build_runner(FedGANConfig(**cfg_2dmg("flgan")), device="cpu")
    with pytest.raises(ti.TorchImportError, match="single"):
        ti.warm_start_generators(fl.init_state(), [mlp, mlp])
    with pytest.raises(ti.TorchImportError):
        ti.warm_start_generators(fl.init_state(), [small])
    ac = build_runner(FedGANConfig(**cfg_2dmg("acgan", num_servers=4)),
                      device="cpu")
    with pytest.raises(ti.TorchImportError, match="4 stacked"):
        ti.warm_start_generators(ac.init_state(), [small, small])
    with pytest.raises(ti.TorchImportError, match="disagree"):
        ti.warm_start_generators(ac.init_state(), [small, mlp])


# ---------------------------------------------------------------------------
# import errors
# ---------------------------------------------------------------------------

def _refuse(tmp_path, module, match, **kw):
    pt = str(tmp_path / "x.pt")
    torch.save(module.state_dict() if hasattr(module, "state_dict")
               else module, pt)
    with pytest.raises(ti.TorchImportError, match=match):
        ti.import_generator_file(pt, device="cpu", **kw)
    with pytest.raises(jti.TorchImportError, match=match):
        jti.import_generator_file(pt, **kw)


def test_import_refuses_discriminators(tmp_path):
    """A reference D, MLP (fan-in 784) or conv (opens with a conv), gets
    the discriminator hint on both sides."""
    _refuse(tmp_path, SeqG(tnn.Sequential(
        tnn.Linear(784, 512), tnn.LeakyReLU(0.2), tnn.Linear(512, 256),
        tnn.LeakyReLU(0.2), tnn.Linear(256, 1), tnn.Sigmoid())),
        "discriminator")
    _refuse(tmp_path, SeqG(tnn.Sequential(
        tnn.Conv2d(1, 16, 3, 2, 1), tnn.LeakyReLU(0.2),
        tnn.Conv2d(16, 32, 3, 2, 1), tnn.LeakyReLU(0.2), tnn.Flatten(),
        tnn.Linear(32 * 8 * 8, 1))), "discriminator")


def test_import_refuses_mismatches(tmp_path):
    """A family override that does not fit, a head count that does not,
    and a file that holds no state_dict: the reference's messages."""
    _refuse(tmp_path, mnist_mlp(), "expected linear|unconsumed|ran out",
            family="2dmg-small")
    _refuse(tmp_path, g2dmg_multipath(3), "3 paths, expected 2",
            num_heads=2)
    _refuse(tmp_path, g2dmg_multipath(3), "single-path",
            family="2dmg-small")
    _refuse(tmp_path, [1, 2, 3], "state_dict")


# ---------------------------------------------------------------------------
# export
# ---------------------------------------------------------------------------

EXPORT_VARIANTS = [("flgan", {}), ("fegan", dict(frac_workers=0.5)),
                   ("mdgan", {}), ("cglgan", dict(num_servers=2))]


def transplanted(kw, part=None):
    """The reference's runner and init state, and the port's runner on
    that state transplanted."""
    jr, r = both_runners(kw, part)
    jstate = jax.jit(jr.init_state)()      # jitted: seconds less to trace
    state = from_jax_numpy(jax.tree.map(np.asarray, jstate), r.cfg, "cpu")
    return jr, jstate, r, state


def latents(n, seed=7):
    return np.random.default_rng(seed).normal(size=(n, 100)).astype(
        np.float32)


@pytest.mark.parametrize("algo,kw", EXPORT_VARIANTS,
                         ids=[a for a, _ in EXPORT_VARIANTS])
def test_export_round_trip(algo, kw, tmp_path):
    """A fixed-batch artifact loaded from disk: bit for bit the port's
    ``gen``, within TOL_FWD of the JAX artifact on the transplanted state;
    the JSON manifest beside it keeps the reference's keys but
    ``platforms`` (``device`` here).  A runner exports for its own device
    only."""
    jr, jstate, r, state = transplanted(cfg_2dmg(algo, **kw))
    path = str(tmp_path / "g.pt2")
    manifest = export_mod.save_generator(
        export_mod.export_generator(r, state, n=50), path,
        {"algo": algo, "round": 0})
    jpath = str(tmp_path / "g.stablehlo")
    jmanifest = jexport.save_generator(
        jexport.export_generator(jr, jstate, n=50), jpath)
    assert set(jmanifest) - set(manifest) == {"platforms"}
    assert manifest["in_shape"] == jmanifest["in_shape"] == [50, 100]
    assert manifest["out_shape"] == jmanifest["out_shape"]
    assert manifest["format"] == "torch.export"
    assert manifest["calling_convention_version"] is None
    assert manifest["in_dtype"] == manifest["out_dtype"] == "float32"
    assert manifest["bytes"] == os.path.getsize(path)
    assert manifest["device"] == "cpu" and manifest["algo"] == algo
    with open(path + ".json") as f:
        assert json.load(f) == manifest
    serve, loaded = export_mod.load_generator(path)
    assert loaded == manifest
    z = latents(50)
    got = serve(torch.from_numpy(z))
    assert torch.equal(got, r.gen(state, torch.from_numpy(z)))
    jserve, _ = jexport.load_generator(jpath)
    np.testing.assert_allclose(got.numpy(), np.asarray(jserve(z)), rtol=0,
                               atol=TOL_FWD)
    with pytest.raises(ValueError, match="serves a batch of 50"):
        serve(torch.zeros(10, 100))
    # another device: no card here, or the runner's own device elsewhere
    with pytest.raises(ValueError if torch.cuda.is_available()
                       else RuntimeError, match="lives on cpu|CUDA"):
        export_mod.export_generator(r, state, n=50, device="cuda")


@pytest.mark.parametrize("algo,kw", [("flgan", {}),
                                     ("cglgan", dict(num_servers=2))],
                         ids=["flgan", "cglgan"])
def test_export_batch_polymorphic(algo, kw, tmp_path):
    """``n=None``: one artifact serves n = S (one row a server), 10 and 60
    bit for bit as ``gen``, within TOL_FWD of the JAX polymorphic
    artifact, and refuses a batch that is no multiple of S."""
    jr, jstate, r, state = transplanted(cfg_2dmg(algo, **kw))
    S = r.gen_batch_multiple
    path = str(tmp_path / "g.pt2")
    manifest = export_mod.save_generator(
        export_mod.export_generator(r, state), path)
    assert manifest["in_shape"] == [f"{S}*b" if S > 1 else "b", 100]
    assert manifest["batch_multiple"] == manifest["min_batch"] == S
    serve, _ = export_mod.load_generator(path)
    jserve = jexport.export_generator(jr, jstate).call
    for n in (S, 10, 60):
        z = latents(n, seed=n)
        got = serve(torch.from_numpy(z))
        assert got.shape == (n, 2)
        assert torch.equal(got, r.gen(state, torch.from_numpy(z)))
        np.testing.assert_allclose(got.numpy(), np.asarray(jserve(z)),
                                   rtol=0, atol=TOL_FWD)
    if S > 1:
        with pytest.raises(ValueError, match="multiples of 2"):
            serve(torch.zeros(7, 100))


def test_export_client_routing(tmp_path):
    """Mix-G (2 servers, 2 heads each): every client's personalized
    artifact serves n = 1 and 12, bit for bit as ``gen_client`` and within
    TOL_FWD of the JAX client artifact; a FedAvg runner has none."""
    jr, jstate, r, state = transplanted(cfg_2dmg("mixgan", num_servers=2))
    outs = []
    for c in range(r.cfg.num_workers):
        path = str(tmp_path / f"client{c}.pt2")
        manifest = export_mod.save_generator(
            export_mod.export_client_generator(r, state, c), path,
            {"client": c})
        assert manifest["min_batch"] == 1 and manifest["client"] == c
        serve, _ = export_mod.load_generator(path)
        jserve = jexport.export_client_generator(jr, jstate, c).call
        for n in (1, 12):
            z = latents(n, seed=c)
            got = serve(torch.from_numpy(z))
            assert torch.equal(got, r.gen_client(state, torch.from_numpy(z),
                                                 c))
            np.testing.assert_allclose(got.numpy(), np.asarray(jserve(z)),
                                       rtol=0, atol=TOL_FWD)
        outs.append(got)
    assert not torch.equal(outs[0], outs[1])      # two heads of server 0
    fl = build_runner(FedGANConfig(**cfg_2dmg("flgan")), device="cpu")
    with pytest.raises(ValueError, match="gen_client"):
        export_mod.export_client_generator(fl, fl.init_state(), 0, n=8)
    with pytest.raises(ValueError, match="out of range"):
        export_mod.export_client_generator(r, state, 99, n=8)
    with pytest.raises(ValueError, match="divisible"):
        export_mod.export_generator(r, state, n=51)


def conv_partition(W=4, L=12, seed=0):
    """(W, L, 1024) u8 rows, as the conv tests hand both runners."""
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 256, (W, L, 1024)).astype(np.uint8)
    fields = (data, np.zeros((W, L), np.int32), np.full(W, L, np.int32),
              np.zeros((W, 10), np.int64), np.zeros((10, 1024), np.uint8))
    return JaxPartition(*fields), Partition(*fields)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_export_conv_mixg(dtype, tmp_path):
    """The conv Mix-G (CGL-GAN conv, 2 servers, 2 heads): the polymorphic
    artifact serves n = 2 and 6 bit for bit as ``gen``.  In float32 within
    TOL_FWD_CONV of the JAX artifact; in bfloat16 held to the port's own
    eager ``gen`` only (the reference's bf16 conv G refuses float32
    latents) and returning bfloat16."""
    kw = dict(algo="cglgan", dataset="synthetic-mnist", conv=True,
              num_workers=4, num_servers=2, batch_size=4, dtype=dtype)
    if dtype == "float32":
        jr, jstate, r, state = transplanted(kw, conv_partition())
    else:
        r = build_runner(FedGANConfig(**kw), conv_partition()[1],
                         device="cpu")
        state = r.init_state()
    path = str(tmp_path / "g.pt2")
    manifest = export_mod.save_generator(
        export_mod.export_generator(r, state), path)
    assert manifest["out_shape"] == ["2*b", 1, 32, 32]
    assert manifest["out_dtype"] == dtype and manifest["min_batch"] == 2
    serve, _ = export_mod.load_generator(path)
    for n in (2, 6):
        z = latents(n, seed=n)
        got = serve(torch.from_numpy(z))
        assert torch.equal(got, r.gen(state, torch.from_numpy(z)))
        if dtype == "float32":
            want = jexport.export_generator(jr, jstate, n=n).call(z)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=0, atol=TOL_FWD_CONV)


def test_export_conv_one_server(tmp_path):
    """The single-path conv G at one server (CAP-GAN conv): the
    polymorphic artifact serves n = 1 and 3 bit for bit as ``gen`` and
    within TOL_FWD_CONV of the JAX artifact."""
    kw = dict(algo="capgan", dataset="synthetic-mnist", conv=True,
              num_workers=4, num_servers=1, batch_size=4)
    jr, jstate, r, state = transplanted(kw, conv_partition())
    path = str(tmp_path / "g.pt2")
    manifest = export_mod.save_generator(
        export_mod.export_generator(r, state), path)
    assert manifest["out_shape"] == ["b", 1, 32, 32]
    assert manifest["min_batch"] == 1
    serve, _ = export_mod.load_generator(path)
    for n in (1, 3):
        z = latents(n, seed=n)
        got = serve(torch.from_numpy(z))
        assert torch.equal(got, r.gen(state, torch.from_numpy(z)))
        want = jexport.export_generator(jr, jstate, n=n).call(z)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=TOL_FWD_CONV)


@pytest.mark.parametrize("case", ["mnist-multipath", "conv-multipath"])
def test_export_imported(case, tmp_path):
    """An imported generator's artifact: heads onto the batch axis
    head-major, as the reference's; bit for bit the port's eager forward,
    within the forward tolerance of the JAX artifact; polymorphic from
    n = 1."""
    make, info = IMPORT_CASES[case]
    pt = save_pt(make(), tmp_path / "g.pt")
    model, params, state, _ = ti.import_generator_file(pt, device="cpu")
    jmodel, jparams, jstate, _ = jti.import_generator_file(pt)
    path = str(tmp_path / "g.pt2")
    manifest = export_mod.save_generator(
        export_mod.export_imported(model, params, state), path)
    k = info["num_heads"]
    assert manifest["min_batch"] == 1
    assert manifest["out_shape"][0] == (f"{k}*b" if k > 1 else "b")
    serve, _ = export_mod.load_generator(path)
    tol = TOL_FWD_CONV if case.startswith("conv") else TOL_FWD
    for n in (1, 5):
        z = latents(n, seed=n)
        got = serve(torch.from_numpy(z))
        eager = eval_forward(model, params, state, torch.from_numpy(z))
        assert torch.equal(got, eager.reshape((-1,) + eager.shape[2:])
                           if model.multipath else eager)
        want = jexport.export_imported(jmodel, jparams, jstate, n=n).call(z)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=tol)


@pytest.mark.parametrize("multiple", [1, 2])
def test_export_raises_where_b1_is_specialised(multiple):
    """A forward whose ``reshape`` must choose view or copy on the batch
    (a transposed stack merged) cannot serve b = 1: the polymorphic export
    raises (the trace refuses the range, or the program's guard its
    one-row-a-server call) rather than serve a narrower range.  At a
    fixed batch the same forward exports."""
    cpu = torch.device("cpu")
    merge = lambda tree, z: (z.reshape(2, -1, 50 * multiple)
                             .transpose(0, 1).reshape(-1, 100 * multiple)
                             * tree["w"])
    module = export_mod._Serve(merge, {"w": torch.ones(())}, cpu)
    with pytest.raises((torch._dynamo.exc.UserError, ValueError),
                       match="one row a server|Constraints violated"):
        export_mod._export(module, None, multiple, 100, cpu)
    ep = export_mod._export(module, 4, multiple, 100, cpu)
    z = torch.from_numpy(latents(4))
    assert torch.equal(ep.module()(z), merge({"w": torch.ones(())}, z))


def test_artifact_serves_without_the_port(tmp_path):
    """A consumer process that imports torch only (the port and JAX
    blocked) loads the artifact and serves it: the port's samples."""
    _, _, r, state = transplanted(cfg_2dmg("cglgan", num_servers=2))
    path = str(tmp_path / "g.pt2")
    export_mod.save_generator(export_mod.export_generator(r, state), path)
    z = torch.from_numpy(latents(10))
    np.save(str(tmp_path / "z.npy"), z.numpy())
    np.save(str(tmp_path / "want.npy"), r.gen(state, z).numpy())
    code = (
        "import sys\n"
        "for name in ('jax', 'cglgan_tpu', 'cglgan_tpu_torch'):\n"
        "    sys.modules[name] = None\n"
        "import numpy as np, torch\n"
        f"program = torch.export.load({path!r}).module()\n"
        f"z = torch.from_numpy(np.load({str(tmp_path / 'z.npy')!r}))\n"
        f"want = np.load({str(tmp_path / 'want.npy')!r})\n"
        "got = program(z).numpy()\n"
        "np.testing.assert_array_equal(got, want)\n"
        "assert got.shape == (10, 2) and np.abs(got).max() <= 1\n"
        "print('SELF-CONTAINED-OK')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": ""})
    assert "SELF-CONTAINED-OK" in out.stdout, out.stderr[-2000:]

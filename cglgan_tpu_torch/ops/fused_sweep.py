"""Fused local D/G sweep for the FedAvg family: E interleaved (D step, G
step) iterations for W workers in one call.

Port of ``cglgan_tpu/ops/pallas/fused_sweep.py``.  The Pallas TPU kernel
``_sweep_kernel`` becomes one hand-written CUDA C++ kernel,
``csrc/fused_sweep.cu`` (route: nvcc for sm_90a, plain C interface, ctypes),
launched once a call: one thread-block cluster of ``cluster_occupancy()
["cluster"]`` blocks per worker runs all E iterations, with a cluster
barrier between the layers' phases.  The call is bound by operations (~95
MFLOP per worker-iteration of f32 FMA at the main-path shapes); the design
takes the TPU kernel's one program per worker onto a cluster of SMs, so the
call costs one launch instead of a pipeline of small kernels a layer.  The
source's note has the phases and the bound.

Per local iteration, the reference worker loop (FLGAN/2DMG/flgan.py:229-256,
fegan.py:282-303):
1. fake  = G(z1)            (forward only, gradient to G discarded)
2. D Adam step on BCE(D(real),1) + BCE(D(fake),0), unhalved
3. fake2 = G(z2);  G Adam step on BCE(D_new(fake2), 1), backward through
   the UPDATED D (no D grads) into G.

Covers the 2DMG MLP pairs: G with 2 or 3 linear layers, LeakyReLU(0.2)
between them and tanh after the last; D with 3 linear layers and a sigmoid.

``fused_sweep_steps`` launches the kernel for CUDA tensors and runs the
plain PyTorch version (``fused_sweep_steps_plain``: the same hand-derived
forward, backward and Adam loop in torch ops, no autograd) for CPU tensors;
nothing else.  ``launches`` counts the kernel's launches (one per call).
As in the JAX package the kernel never engages by itself: ``eligible`` is
True only when ``pallas_sweep=True`` forces it.
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, Sequence, Tuple

import torch

from cglgan_tpu_torch.algos.common import NetState, adam_leaf
from cglgan_tpu_torch.ops.fused_dstep import (bias_corrections,
                                              repack_net_generic,
                                              unpack_net_generic)

SOURCE = "cglgan_tpu_torch/ops/csrc/fused_sweep.cu"
REPLACES = "cglgan_tpu/ops/pallas/fused_sweep.py:99"
EPS = 1e-8
P_LO, P_HI = 1e-12, 1.0 - 1e-7     # the reference's probability clip
MAX_EPOCH = 32

launches = 0          # kernel launches (wrapper calls that ran the kernel)


def eligible(cfg, mesh=None) -> bool:
    """The reference's engage rule (``fused_sweep.eligible``): auto and
    False never run the kernel; True forces it and raises for a config that
    cannot take it (2DMG flgan/fegan "batches" sweep, float32, sigmoid head,
    epoch <= 32, no mesh, no dropout)."""
    if cfg.pallas_sweep is not True:
        return False
    ok = (cfg.algo in ("flgan", "fegan") and cfg.dataset == "2dmg"
          and not cfg.conv and cfg.dtype == "float32" and mesh is None
          and cfg.dropout_rate == 0.0
          and cfg.resolved_local_sweep == "batches"
          # the kernel hardcodes a sigmoid+BCE loss
          and cfg.resolved_d_head == "sigmoid"
          and cfg.epoch <= MAX_EPOCH)
    if not ok:
        raise ValueError(
            "pallas_sweep=True requires a 2DMG flgan/fegan config with "
            "float32, a sigmoid D head, epoch <= 32, no --devices mesh and "
            "no dropout")
    return True


# ---------------------------------------------------------------------------
# the plain version: the kernel's arithmetic in torch ops
# ---------------------------------------------------------------------------

def _pairs(flat):
    return [(flat[2 * i], flat[2 * i + 1]) for i in range(len(flat) // 2)]


def _mlp_forward(x, wbs, last: str):
    """Forward through [(w (W,din,dout), b (W,dout)), ...] with
    LeakyReLU(0.2) between layers and ``last`` in {"tanh", "sigmoid"} after
    the final one.  Returns (preacts, inputs, out)."""
    pre, ins = [], []
    h = x
    for i, (w, b) in enumerate(wbs):
        ins.append(h)
        z = torch.bmm(h, w) + b.unsqueeze(1)
        pre.append(z)
        if i < len(wbs) - 1:
            h = torch.where(z >= 0, z, 0.2 * z)
        elif last == "tanh":
            h = torch.tanh(z)
        else:
            h = torch.sigmoid(z)
    return pre, ins, h


def _mlp_backward(dz_last, pre, ins, wbs, need_dx: bool):
    """Backprop from d(loss)/d(z_last) through the LeakyReLU MLP.  Returns
    (flat grads [dw0, db0, dw1, db1, ...], dx)."""
    grads = [None] * (2 * len(wbs))
    dz = dz_last
    for i in range(len(wbs) - 1, -1, -1):
        w, _ = wbs[i]
        grads[2 * i] = torch.bmm(ins[i].transpose(1, 2), dz)
        grads[2 * i + 1] = dz.sum(dim=1)
        if i > 0 or need_dx:
            dh = torch.bmm(dz, w.transpose(1, 2))
            dz = dh * torch.where(pre[i - 1] >= 0, 1.0, 0.2) if i > 0 else dh
    return grads, dz


def _adam_all(state, grads, c1, c2, lr, b1, b2):
    """In-place (on the python lists) optax-ordered Adam of every tensor."""
    W = c1.shape[0]
    for j, g in enumerate(grads):
        lead = (W,) + (1,) * (g.ndim - 1)
        state[0][j], state[1][j], state[2][j] = adam_leaf(
            state[0][j], g, state[1][j], state[2][j], c1.reshape(lead),
            c2.reshape(lead), lr, b1, b2, EPS)


def fused_sweep_steps_plain(g_p, g_mu, g_nu, g_count, d_p, d_mu, d_nu,
                            d_count, reals, z1, z2, *, lr_g: float = 2e-4,
                            lr_d: float = 2e-4, b1: float = 0.5,
                            b2: float = 0.999):
    """The kernel's arithmetic in torch ops (no autograd): the hand-derived
    forward/backward and Adam of ``_sweep_kernel``, on any device."""
    W, E, B, _ = reals.shape
    gs = [list(g_p), list(g_mu), list(g_nu)]
    ds = [list(d_p), list(d_mu), list(d_nu)]
    ccg = bias_corrections(g_count, W, E, b1, b2)
    ccd = bias_corrections(d_count, W, E, b1, b2)
    is_real = (torch.arange(2 * B, device=reals.device) < B).to(reals.dtype)
    is_real = is_real.reshape(1, 2 * B, 1)
    d_loss_sum = torch.zeros((W,), dtype=torch.float32, device=reals.device)
    g_loss_sum = torch.zeros_like(d_loss_sum)
    for e in range(E):
        # ---- 1. fake batch from the CURRENT G (gradient discarded) ----
        _, _, fake = _mlp_forward(z1[:, e], _pairs(gs[0]), "tanh")
        # ---- 2. D step on (real, fake) ----
        x = torch.cat([reals[:, e], fake], dim=1)              # (W, 2B, 2)
        d_wbs = _pairs(ds[0])
        d_pre, d_ins, p = _mlp_forward(x, d_wbs, "sigmoid")
        pc = torch.clamp(p, P_LO, P_HI)
        # loss = bce(real,1) + bce(fake,0): sum over 2B rows / B
        per = -(is_real * torch.log(pc) + (1 - is_real) * torch.log1p(-pc))
        d_loss = per.sum(dim=(1, 2)) / B
        dpc = (1.0 / B) * (is_real * (-1.0 / pc)
                           + (1 - is_real) * (1.0 / (1.0 - pc)))
        inside = ((p > P_LO) & (p < P_HI)).to(p.dtype)
        gz = dpc * inside * p * (1.0 - p)                  # d loss / d z_last
        d_grads, _ = _mlp_backward(gz, d_pre, d_ins, d_wbs, need_dx=False)
        _adam_all(ds, d_grads, ccd[:, e, 0], ccd[:, e, 1], lr_d, b1, b2)
        # ---- 3. G step through the UPDATED D ----
        g_wbs = _pairs(gs[0])
        g_pre, g_ins, fake2 = _mlp_forward(z2[:, e], g_wbs, "tanh")
        d_wbs = _pairs(ds[0])
        d2_pre, d2_ins, p2 = _mlp_forward(fake2, d_wbs, "sigmoid")
        pc2 = torch.clamp(p2, P_LO, P_HI)
        g_loss = -torch.log(pc2).sum(dim=(1, 2)) / B           # bce(p2, 1)
        dpc2 = (-1.0 / B) / pc2
        inside2 = ((p2 > P_LO) & (p2 < P_HI)).to(p2.dtype)
        gz2 = dpc2 * inside2 * p2 * (1.0 - p2)
        _, dfake = _mlp_backward(gz2, d2_pre, d2_ins, d_wbs, need_dx=True)
        # through the G tanh: d/dz = 1 - tanh(z)^2 = 1 - fake2^2
        gzg = dfake * (1.0 - fake2 * fake2)
        g_grads, _ = _mlp_backward(gzg, g_pre, g_ins, g_wbs, need_dx=False)
        _adam_all(gs, g_grads, ccg[:, e, 0], ccg[:, e, 1], lr_g, b1, b2)
        d_loss_sum = d_loss_sum + d_loss
        g_loss_sum = g_loss_sum + g_loss
    return (gs[0], gs[1], gs[2], ds[0], ds[1], ds[2], d_loss_sum / E,
            g_loss_sum / E)


# ---------------------------------------------------------------------------
# the wrapper
# ---------------------------------------------------------------------------

def fused_sweep_steps(g_p: Sequence[torch.Tensor], g_mu, g_nu,
                      g_count: torch.Tensor, d_p: Sequence[torch.Tensor],
                      d_mu, d_nu, d_count: torch.Tensor, reals: torch.Tensor,
                      z1: torch.Tensor, z2: torch.Tensor, *,
                      lr_g: float = 2e-4, lr_d: float = 2e-4,
                      b1: float = 0.5, b2: float = 0.999):
    """Run E interleaved (D step, G step) iterations for W workers.

    g_p/g_mu/g_nu: flat per-layer [w (W,din,dout), b (W,dout), ...] tensor
    lists; d_* likewise (always 3 layers).  g_count/d_count: (W,) or ()
    per-worker Adam counts, pre-increment.  reals: (W, E, B, 2) float32;
    z1/z2: (W, E, B, zdim).

    Returns (new_g_p, new_g_mu, new_g_nu, new_d_p, new_d_mu, new_d_nu,
    d_loss (W,), g_loss (W,)), the losses averaged over the E iterations;
    inputs are not modified.  CUDA tensors run the kernel, CPU tensors the
    plain version."""
    if len(d_p) != 6 or len(g_p) not in (4, 6):
        raise ValueError("fused_sweep takes a 3-layer D and a 2- or 3-layer "
                         f"G; got {len(d_p) // 2} and {len(g_p) // 2} layers")
    kw = dict(lr_g=lr_g, lr_d=lr_d, b1=b1, b2=b2)
    if reals.device.type == "cuda":
        return _launch(g_p, g_mu, g_nu, g_count, d_p, d_mu, d_nu, d_count,
                       reals, z1, z2, **kw)
    if reals.device.type == "cpu":
        return fused_sweep_steps_plain(g_p, g_mu, g_nu, g_count, d_p, d_mu,
                                       d_nu, d_count, reals, z1, z2, **kw)
    raise ValueError(f"unsupported device {reals.device}")


def _check(t: torch.Tensor, name: str, shape, dev):
    if t.device != dev:
        raise ValueError(f"{name} on {t.device}, expected {dev}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name}: dtype {t.dtype}, expected float32")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


_LIB = None
_SCRATCH: Dict[tuple, torch.Tensor] = {}


def _library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared (built on
    first use, never at import)."""
    global _LIB
    if _LIB is None:
        from cglgan_tpu_torch.ops import _build
        lib = _build.load("fused_sweep")
        vp, f, i = ctypes.c_void_p, ctypes.c_float, ctypes.c_int
        pp, ip = ctypes.POINTER(vp), ctypes.POINTER(i)
        lib.fused_sweep_f32.argtypes = [
            pp, pp, pp, pp, vp, vp, vp, vp, vp, i, vp, i, vp, vp,
            i, i, i, i, ip, i, i, f, f, f, f, f, f, f, vp]
        lib.fused_sweep_f32.restype = i
        lib.fused_sweep_scratch_floats.argtypes = [i, i, ip, i, i]
        lib.fused_sweep_scratch_floats.restype = ctypes.c_longlong
        lib.fused_sweep_max_active_clusters.argtypes = [i, ip]
        lib.fused_sweep_max_active_clusters.restype = i
        lib.fused_sweep_cluster_size.restype = i
        lib.fused_sweep_error_string.argtypes = [i]
        lib.fused_sweep_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _raise_on(lib, rc: int, what: str):
    if rc != 0:
        msg = lib.fused_sweep_error_string(rc).decode()
        raise RuntimeError(f"fused_sweep {what} failed: {msg} ({rc})")


def cluster_occupancy() -> dict:
    """The kernel's cluster size (a constant of the source) and how many
    such clusters the current card holds at once
    (``cudaOccupancyMaxActiveClusters``)."""
    lib = _library()
    size = lib.fused_sweep_cluster_size()
    n = ctypes.c_int(0)
    _raise_on(lib, lib.fused_sweep_max_active_clusters(size, ctypes.byref(n)),
              "occupancy query")
    return {"cluster": size, "max_active_clusters": n.value}


def _scratch(lib, dev, stream: int, W, B, gdims, dh1, dh2) -> torch.Tensor:
    """The call's work space (activations and dz of every layer, all
    workers), kept per device, stream and shape: every call on a stream
    overwrites it in stream order and nothing of it is returned."""
    key = (dev.index, stream, W, B, tuple(gdims), dh1, dh2)
    if key not in _SCRATCH:
        L_g = len(gdims) - 1
        n = lib.fused_sweep_scratch_floats(
            B, L_g, (ctypes.c_int * len(gdims))(*gdims), dh1, dh2)
        if n < 0:
            raise ValueError(
                f"fused_sweep takes samples at most 4 wide and layers into "
                f"its per-row stages at most 256 wide; got G widths {gdims}, "
                f"D hidden widths {dh1}, {dh2}")
        _SCRATCH[key] = torch.empty((W * n,), dtype=torch.float32,
                                    device=dev)
    return _SCRATCH[key]


def _counts(count: torch.Tensor, W: int, dev, name: str):
    """(int64 tensor on dev, 1 if it holds one count per worker else 0)."""
    c = count.to(device=dev, dtype=torch.int64).reshape(-1).contiguous()
    if c.numel() not in (1, W):
        raise ValueError(f"{name}: {c.numel()} counts for {W} workers")
    return c, int(c.numel() > 1)


def layer_shapes(dims: Sequence[int], W: int) -> List[Tuple[int, ...]]:
    """[(W,d0,d1), (W,d1), (W,d1,d2), (W,d2), ...] for an MLP's widths."""
    out: List[Tuple[int, ...]] = []
    for a, b in zip(dims[:-1], dims[1:]):
        out += [(W, a, b), (W, b)]
    return out


def _launch(g_p, g_mu, g_nu, g_count, d_p, d_mu, d_nu, d_count, reals, z1,
            z2, *, lr_g, lr_d, b1, b2):
    global launches
    dev = reals.device
    W, E, B, xdim = reals.shape
    L_g = len(g_p) // 2
    if not 1 <= E <= MAX_EPOCH:
        raise ValueError(f"E={E} outside [1, {MAX_EPOCH}]")
    gdims = [g_p[0].shape[1]] + [g_p[2 * i].shape[2] for i in range(L_g)]
    ddims = [d_p[0].shape[1]] + [d_p[2 * i].shape[2] for i in range(3)]
    if gdims[-1] != xdim or ddims[0] != xdim or ddims[-1] != 1:
        raise ValueError(f"G widths {gdims} / D widths {ddims} do not chain "
                         f"through {xdim}-wide samples to one output")
    _check(reals, "reals", (W, E, B, xdim), dev)
    _check(z1, "z1", (W, E, B, gdims[0]), dev)
    _check(z2, "z2", (W, E, B, gdims[0]), dev)
    g_in = list(g_p) + list(g_mu) + list(g_nu)
    d_in = list(d_p) + list(d_mu) + list(d_nu)
    g_shapes, d_shapes = layer_shapes(gdims, W), layer_shapes(ddims, W)
    for j, t in enumerate(g_in):
        _check(t, f"g_state[{j}]", g_shapes[j % (2 * L_g)], dev)
    for j, t in enumerate(d_in):
        _check(t, f"d_state[{j}]", d_shapes[j % 6], dev)
    gc, gc_per = _counts(g_count, W, dev, "g_count")
    dc, dc_per = _counts(d_count, W, dev, "d_count")
    g_out = [torch.empty_like(t) for t in g_in]
    d_out = [torch.empty_like(t) for t in d_in]
    d_loss = torch.empty((W,), dtype=torch.float32, device=dev)
    g_loss = torch.empty((W,), dtype=torch.float32, device=dev)
    lib = _library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    dh1, dh2 = ddims[1], ddims[2]
    scratch = _scratch(lib, dev, stream, W, B, gdims, dh1, dh2)

    ptrs = lambda ts: (ctypes.c_void_p * len(ts))(*[t.data_ptr() for t in ts])
    rc = lib.fused_sweep_f32(
        ptrs(g_in), ptrs(g_out), ptrs(d_in), ptrs(d_out), scratch.data_ptr(),
        reals.data_ptr(), z1.data_ptr(), z2.data_ptr(), gc.data_ptr(),
        gc_per, dc.data_ptr(), dc_per, d_loss.data_ptr(), g_loss.data_ptr(),
        W, E, B, L_g, (ctypes.c_int * len(gdims))(*gdims), dh1, dh2,
        -lr_g, -lr_d, b1, 1 - b1, b2, 1 - b2, EPS, stream)
    _raise_on(lib, rc, "launch")
    launches += 1
    m = 2 * L_g
    return (g_out[:m], g_out[m:2 * m], g_out[2 * m:], d_out[:6],
            d_out[6:12], d_out[12:], d_loss, g_loss)


# ---------------------------------------------------------------------------
# the local phase of a FedAvg-family round, on stacked NetStates
# ---------------------------------------------------------------------------

def kernel_sweep_phase(g_net: NetState, d_net: NetState, shards, starts,
                       z1, z2, cfg):
    """FedAvg-family local phase over FLAT (W, ...) stacked NetStates
    (params already broadcast per worker).

    shards: (W, L, 2) float32; starts: (E,) shared window offsets (host
    ints); z1/z2: (W, E, B, zdim).  Returns (new_g_net, new_d_net,
    d_loss (W,), g_loss (W,))."""
    B, E = cfg.batch_size, cfg.epoch
    reals = torch.stack([shards[:, int(starts[e]):int(starts[e]) + B]
                         for e in range(E)], dim=1).float()   # (W, E, B, 2)
    gp, gmu, gnu, gcount = unpack_net_generic(g_net)
    dp, dmu, dnu, dcount = unpack_net_generic(d_net)
    cont = lambda ts: [t.contiguous() for t in ts]
    new_gp, new_gmu, new_gnu, new_dp, new_dmu, new_dnu, dl, gl = \
        fused_sweep_steps(cont(gp), cont(gmu), cont(gnu), gcount, cont(dp),
                          cont(dmu), cont(dnu), dcount, reals.contiguous(),
                          z1.contiguous(), z2.contiguous(), lr_g=cfg.lr_g,
                          lr_d=cfg.lr_d, b1=cfg.b1, b2=cfg.b2)
    return (repack_net_generic(g_net, new_gp, new_gmu, new_gnu, gcount + E),
            repack_net_generic(d_net, new_dp, new_dmu, new_dnu, dcount + E),
            dl, gl)

"""Fused local-D epoch: E discriminator steps for W clients in one call.

Port of ``cglgan_tpu/ops/pallas/fused_dstep.py``.  The Pallas TPU kernel
``_dstep_kernel`` becomes the hand-written CUDA C++ kernel pipeline in
``csrc/fused_dstep.cu`` (route: nvcc for sm_90a, plain C interface, ctypes);
its note gives the bound at the main-path shapes and the design: the five
large products of a step run on the tensor cores in 3xTF32
(``csrc/mma_tf32.cuh``), Adam and the bias gradients are fused into the
weight-gradient products, ``LAUNCHES_PER_STEP`` CUDA launches a step.

``fused_d_epoch_steps`` launches the kernel for CUDA tensors and runs the
plain PyTorch version (``fused_d_epoch_steps_plain``: the same hand-derived
forward, backward and Adam loop in torch ops) for CPU tensors; nothing
else.  Both read the E window starts from an int32 device tensor, so a
call captured into a CUDA graph replays each round's own windows.
``launches`` counts the kernel's launches (one per call; a captured call
is counted once a replay by the graph's owner, ``algos/runner.py``).
``matmul_3xtf32_plain`` emulates the kernel's product arithmetic in torch
ops, so the choice of 3xTF32 over one TF32 pass is checked where no card is.

bfloat16 state (all 18 tensors bf16: ``--dtype bfloat16`` with
``pallas_dstep=True``) is the reference's ``mxu_bf16`` variant: the state
is upcast to float32 and stays float32 across the E steps, every product
takes operands rounded to bf16 with float32 sums, every elementwise step
and Adam run in float32 with float32 constants, and the state is rounded to
bf16 once, after step E.  The kernel does it in ``BF16_EXTRA_LAUNCHES``
more launches (upcast, downcast) around the same chain, with bf16-operand
tensor-core products; fakes may be bf16 or float32.
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, Sequence, Tuple

import torch

from cglgan_tpu_torch.algos.common import (AdamState, NetState, adam_leaf,
                                           bias_correction, device_starts,
                                           normalize_images)

SOURCE = "cglgan_tpu_torch/ops/csrc/fused_dstep.cu"
REPLACES = "cglgan_tpu/ops/pallas/fused_dstep.py:44"
# the bf16-state variant: the mxu_bf16 dots of the same kernel
REPLACES_BF16 = "cglgan_tpu/ops/pallas/fused_dstep.py:68"
HEADS = {"sigmoid": 0, "logits2": 1}
EPS = 1e-8

LAUNCHES_PER_STEP = 8  # CUDA launches per local step inside one call
BF16_EXTRA_LAUNCHES = 2  # with bf16 state: the upcast and the downcast
STATE_DTYPES = (torch.float32, torch.bfloat16)

launches = 0          # kernel launches (wrapper calls that ran the kernel)


def eligible(cfg, mesh=None) -> bool:
    """The reference's engage rule (``fused_dstep.eligible``): auto runs the
    kernel at epoch > 1 in float32; True forces it (raising when the config
    cannot take it); False disables it."""
    if cfg.pallas_dstep is False:
        return False
    ok = (not cfg.conv and cfg.dtype in ("float32", "bfloat16")
          and mesh is None and cfg.dropout_rate == 0.0
          and cfg.resolved_d_head in HEADS)
    if cfg.pallas_dstep is True:
        if not ok:
            raise ValueError(
                "pallas_dstep=True requires an MLP discriminator, float32 "
                "or bfloat16, no --devices mesh and no dropout")
        return True
    return ok and cfg.dtype == "float32" and cfg.epoch > 1


def bias_corrections(count: torch.Tensor, W: int, E: int, b1: float,
                     b2: float) -> torch.Tensor:
    """(W, E, 2) float32 per-client (1 - b1^t, 1 - b2^t) for the steps
    count+1 .. count+E, built on ``count``'s device."""
    counts = count.reshape(-1).expand(W)
    steps = counts[:, None] + torch.arange(1, E + 1, device=count.device)
    return torch.stack([bias_correction(steps, b1),
                        bias_correction(steps, b2)], dim=2).contiguous()


def fused_d_epoch_steps(params: Sequence[torch.Tensor],
                        mu: Sequence[torch.Tensor],
                        nu: Sequence[torch.Tensor], count: torch.Tensor,
                        shards: torch.Tensor, starts, fake: torch.Tensor,
                        *, head: str = "sigmoid",
                        d_loss_half: bool = False, is_image: bool = True,
                        lr: float = 2e-4, b1: float = 0.5, b2: float = 0.999):
    """Run E = ``len(starts)`` local D steps for W clients.

    params/mu/nu: 6-tuples (w1 (W,din,h1), b1 (W,h1), w2, b2, w3, b3), all
    float32 or all bfloat16 (then returned in bfloat16, rounded once).
    count: (W,) or () Adam step counts before the call.
    shards: (W, max_len, din), uint8 images (``is_image``: scaled to
    [-1, 1]) or float32 rows used as they are (2DMG); step e reads rows
    ``[starts[e], starts[e] + B)`` of every client's shard.
    starts: the E window starts, an int32 ``(E,)`` tensor on the shards'
    device (``common.device_starts``; host ints are copied there first).
    The kernel and the plain version read them on the device, never on the
    host, so a captured call replays with the starts the buffer holds then;
    a start outside ``[0, max_len - B]`` fails the run on the device.
    fake: (B, din) shared or (W, B, din) per-client fakes, float32 or
    bfloat16.

    Returns (new_params, new_mu, new_nu, new_count, losses (W,)); inputs
    are not modified.  CUDA tensors run the kernel, CPU tensors the plain
    version."""
    if head not in HEADS:
        raise ValueError(f"unsupported head {head!r}")
    want = torch.uint8 if is_image else torch.float32
    if shards.dtype != want:
        raise ValueError(f"is_image={is_image} takes {want} shards, got "
                         f"{shards.dtype}")
    starts = device_starts(starts, shards.device)
    if shards.device.type == "cuda":
        return _launch(params, mu, nu, count, shards, starts, fake, head,
                       d_loss_half, lr, b1, b2)
    if shards.device.type == "cpu":
        return fused_d_epoch_steps_plain(
            params, mu, nu, count, shards, starts, fake, head=head,
            d_loss_half=d_loss_half, lr=lr, b1=b1, b2=b2)
    raise ValueError(f"unsupported device {shards.device}")


def state_dtype(params, mu, nu) -> torch.dtype:
    """The one dtype of the 18 state tensors; a mix raises."""
    dtypes = {t.dtype for ts in (params, mu, nu) for t in ts}
    if len(dtypes) != 1:
        raise ValueError(f"fused_dstep state tensors of mixed dtypes "
                         f"{sorted(map(str, dtypes))}")
    return dtypes.pop()


def check_starts(starts: torch.Tensor, hi: int) -> None:
    """Fail the run where a window start lies outside ``[0, hi]``: an
    assertion queued on the starts' device (on a card it fails the stream
    without making the host wait; on the CPU it raises at once).  Nothing
    is clamped."""
    torch._assert_async(((starts >= 0) & (starts <= hi)).all(),
                        f"fused_dstep: a window start outside [0, {hi}]")


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bfloat16 (nearest even) and back: an operand of the
    kernel's bfloat16-input products."""
    return x.to(torch.bfloat16).to(x.dtype)


def fused_d_epoch_steps_plain(params, mu, nu, count, shards, starts, fake,
                              *, head: str, d_loss_half: bool,
                              lr: float = 2e-4, b1: float = 0.5,
                              b2: float = 0.999,
                              work_dtype: torch.dtype = torch.float32):
    """The kernel's arithmetic in torch ops (no autograd): the hand-derived
    forward/backward and Adam of ``_dstep_kernel``, on any device.  uint8
    shards are images, scaled to [-1, 1]; float shards are used as they
    are.  bfloat16 state: upcast to ``work_dtype`` (float32, as the kernel;
    float64 measures what float32's own rounding moves), every product on
    operands rounded to bfloat16 (their products are exact in float32, so
    the sums are float32 sums), everything else in the work dtype, the
    state rounded to bfloat16 once at the end."""
    starts = device_starts(starts, shards.device)
    W, E = shards.shape[0], starts.shape[0]
    B = fake.shape[-2]
    check_starts(starts, shards.shape[1] - B)
    rows = torch.arange(B, device=shards.device)
    out_dtype = state_dtype(params, mu, nu)
    low = out_dtype == torch.bfloat16
    work = lambda ts: [t.to(work_dtype) for t in ts] if low else list(ts)
    state = [work(params), work(mu), work(nu)]
    if low:
        bmm = lambda a, b: torch.bmm(round_bf16(a), round_bf16(b))
    else:
        bmm = torch.bmm
    cc = bias_corrections(count, W, E, b1, b2)
    fk = fake if fake.ndim == 3 else fake.unsqueeze(0).expand(W, -1, -1)
    mult = 1.0 if d_loss_half else 2.0
    dt = state[0][0].dtype
    is_real = (torch.arange(2 * B, device=shards.device) < B).to(dt)
    is_real = is_real.reshape(1, 2 * B, 1)
    lrelu_grad = lambda z: torch.where(z >= 0, 1.0, 0.2)
    loss = None
    for e in range(E):
        w1, bb1, w2, bb2, w3, bb3 = state[0]
        real = shards.index_select(1, starts[e] + rows)
        if real.dtype == torch.uint8:
            real = normalize_images(real)
        x = torch.cat([real.to(dt), fk.to(dt)], 1)
        z1 = bmm(x, w1) + bb1.unsqueeze(1)
        h1 = torch.where(z1 >= 0, z1, 0.2 * z1)
        z2 = bmm(h1, w2) + bb2.unsqueeze(1)
        h2 = torch.where(z2 >= 0, z2, 0.2 * z2)
        z3 = bmm(h2, w3) + bb3.unsqueeze(1)
        if head == "sigmoid":
            p = torch.sigmoid(z3)
            pc = torch.clamp(p, 1e-12, 1.0 - 1e-7)
            per = -(is_real * torch.log(pc)
                    + (1 - is_real) * torch.log1p(-pc))
            loss = (mult * 0.5) * per.sum(dim=(1, 2)) / B
            dpc = (mult * 0.5 / B) * (is_real * (-1.0 / pc)
                                      + (1 - is_real) * (1.0 / (1.0 - pc)))
            inside = ((p > 1e-12) & (p < 1.0 - 1e-7)).float()
            g3 = dpc * inside * p * (1.0 - p)
        else:
            zs = z3 - z3.amax(dim=-1, keepdim=True)
            logp = zs - torch.log(torch.exp(zs).sum(dim=-1, keepdim=True))
            tgt = torch.cat([1.0 - is_real, is_real], dim=2)
            loss = (mult * 0.5) * (-(tgt * logp).sum(dim=(1, 2)) / B)
            g3 = (mult * 0.5 / B) * (torch.exp(logp) - tgt)
        dw3 = bmm(h2.transpose(1, 2), g3)
        dz2 = bmm(g3, w3.transpose(1, 2)) * lrelu_grad(z2)
        dw2 = bmm(h1.transpose(1, 2), dz2)
        dz1 = bmm(dz2, w2.transpose(1, 2)) * lrelu_grad(z1)
        dw1 = bmm(x.transpose(1, 2), dz1)
        grads = [dw1, dz1.sum(1), dw2, dz2.sum(1), dw3, g3.sum(1)]
        c1, c2 = cc[:, e, 0], cc[:, e, 1]
        for j, g in enumerate(grads):
            lead = (W,) + (1,) * (g.ndim - 1)
            state[0][j], state[1][j], state[2][j] = adam_leaf(
                state[0][j], g, state[1][j], state[2][j],
                c1.reshape(lead), c2.reshape(lead), lr, b1, b2, EPS)
    store = lambda ts: tuple(t.to(out_dtype) for t in ts)
    return (store(state[0]), store(state[1]), store(state[2]), count + E,
            loss)


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (10 mantissa bits), ties away from
    zero, as ``cvt.rna.tf32.f32`` rounds; returned as float32."""
    u = x.contiguous().view(torch.int32)
    return ((u + 0x1000) & ~0x1FFF).view(torch.float32)


def split_tf32(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x = hi + lo up to 2^-21 |x|: hi = tf32(x); lo = the TF32 part of the
    exact remainder x - hi (its low 13 mantissa bits dropped, as the tensor
    cores read an operand)."""
    hi = round_tf32(x)
    lo = ((x - hi).view(torch.int32) & ~0x1FFF).view(torch.float32)
    return hi, lo


def matmul_3xtf32_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The kernel's product in torch ops: a_lo b_hi + a_hi b_lo + a_hi b_hi
    with float32 sums (TF32 x TF32 products are exact in float32); the
    a_lo b_lo term is dropped."""
    a_hi, a_lo = split_tf32(a)
    b_hi, b_lo = split_tf32(b)
    return (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi


def _check(t: torch.Tensor, name: str, shape, dtypes):
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name}: dtype {t.dtype}, expected one of "
                         f"{[str(d) for d in dtypes]}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must start at a 16-byte boundary")


_LIB = None
_SCRATCH: Dict[tuple, List[torch.Tensor]] = {}
_WORK: Dict[tuple, List[torch.Tensor]] = {}


def _scratch(dev, stream: int, W, B, din, h1, h2, dout) -> List[torch.Tensor]:
    """The call's work space (X, H1, H2, G3, PER, DZ2, DZ1), kept per device,
    stream and shape: every call on a stream overwrites it in stream order
    and nothing of it is returned.  A captured call (``algos/runner.py``
    ``RoundProgram``) records the buffers of its capture stream, which the
    warm-up calls on that stream made before capture; the module keeps
    them, so they outlive the graph, and only that stream's calls and the
    graph's replays use them."""
    key = (dev.index, stream, W, B, din, h1, h2, dout)
    if key not in _SCRATCH:
        R = 2 * B
        _SCRATCH[key] = [torch.empty((W, R, n), dtype=torch.float32,
                                     device=dev)
                         for n in (din, h1, h2, dout, 1, h2, h1)]
    return _SCRATCH[key]


def _work(dev, stream: int, shapes) -> List[torch.Tensor]:
    """With bfloat16 state, the 18 float32 buffers that hold the state during
    a call (upcast in, downcast out), kept like ``_scratch``."""
    key = (dev.index, stream, tuple(shapes))
    if key not in _WORK:
        _WORK[key] = [torch.empty(shapes[j % 6], dtype=torch.float32,
                                  device=dev) for j in range(18)]
    return _WORK[key]


def _library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared (built on
    first use, never at import)."""
    global _LIB
    if _LIB is None:
        from cglgan_tpu_torch.ops import _build
        lib = _build.load("fused_dstep")
        vp, f, i = ctypes.c_void_p, ctypes.c_float, ctypes.c_int
        pp = ctypes.POINTER(vp)
        lib.fused_dstep.argtypes = [
            pp, pp, pp, i, pp, vp, i, ctypes.c_longlong, vp, vp, i, i, vp,
            vp, i, i, i, i, i, i, i, i, f, f, f, f, f, f, f, f,
            vp]
        lib.fused_dstep.restype = i
        lib.fused_dstep_error_string.argtypes = [i]
        lib.fused_dstep_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _launch(params, mu, nu, count, shards, starts, fake, head, d_loss_half,
            lr, b1, b2):
    global launches
    W, max_len, din = shards.shape
    E = starts.shape[0]
    h1, h2, dout = params[0].shape[2], params[2].shape[2], params[4].shape[2]
    B = fake.shape[-2]
    dev = shards.device
    # uint8 images or float32 rows: the caller checked which
    _check(shards, "shards", (W, max_len, din), (shards.dtype,))
    shapes = [(W, din, h1), (W, h1), (W, h1, h2), (W, h2), (W, h2, dout),
              (W, dout)]
    state_in: List[torch.Tensor] = list(params) + list(mu) + list(nu)
    dtype = state_dtype(params, mu, nu)       # one dtype for all 18
    for j, t in enumerate(state_in):
        _check(t, f"state[{j}]", shapes[j % 6], STATE_DTYPES)
        if t.device != dev:
            raise ValueError("state and shards on different devices")
    per_client = fake.ndim == 3
    _check(fake, "fake", (W, B, din) if per_client else (B, din),
           STATE_DTYPES)
    if head == "logits2" and dout != 2 or head == "sigmoid" and dout != 1:
        raise ValueError(f"head {head!r} with {dout} outputs")
    # the starts' range is checked by the kernel, on the device
    if starts.ndim != 1 or not starts.is_contiguous():
        raise ValueError(f"starts: shape {tuple(starts.shape)}, expected "
                         f"a contiguous (E,)")
    state_out = [torch.empty_like(t) for t in state_in]
    stream = torch.cuda.current_stream(dev).cuda_stream
    scratch = _scratch(dev, stream, W, B, din, h1, h2, dout)
    bf16 = dtype == torch.bfloat16
    work = _work(dev, stream, shapes) if bf16 else state_out
    cc = bias_corrections(count.to(dev), W, E, b1, b2)
    loss = torch.empty((W,), dtype=torch.float32, device=dev)
    mult = 1.0 if d_loss_half else 2.0

    ptrs = lambda ts: (ctypes.c_void_p * len(ts))(*[t.data_ptr() for t in ts])
    lib = _library()
    rc = lib.fused_dstep(
        ptrs(state_in), ptrs(state_out), ptrs(work), int(bf16),
        ptrs(scratch), shards.data_ptr(),
        int(shards.dtype == torch.uint8), max_len, starts.data_ptr(),
        fake.data_ptr(), int(fake.dtype == torch.bfloat16), int(per_client),
        cc.data_ptr(), loss.data_ptr(),
        W, E, B, din, h1, h2, dout, HEADS[head], mult * 0.5, mult * 0.5 / B,
        -lr, b1, 1 - b1, b2, 1 - b2, EPS, stream)
    if rc != 0:
        msg = lib.fused_dstep_error_string(rc).decode()
        raise RuntimeError(f"fused_dstep launch failed: {msg} ({rc})")
    launches += 1
    return (tuple(state_out[:6]), tuple(state_out[6:12]),
            tuple(state_out[12:]), count + E, loss)


# ---------------------------------------------------------------------------
# the local-D phase of a round, on stacked NetStates
# ---------------------------------------------------------------------------

def unpack_net_generic(net: NetState):
    """Stacked MLP NetState (flat leading axis) -> (params, mu, nu, count)
    as flat per-layer [w, b, w, b, ...] tensor lists, for any number of
    linear layers."""
    flat = lambda tree: [x for p in tree if isinstance(p, dict)
                         for x in (p["w"], p["b"])]
    return flat(net.params), flat(net.opt.mu), flat(net.opt.nu), net.opt.count


def repack_net_generic(net: NetState, flat_p, flat_mu, flat_nu,
                       new_count) -> NetState:
    """Write flat per-layer tensor lists back into the NetState tree."""
    def put(tree, flat):
        out, j = [], 0
        for p in tree:
            if isinstance(p, dict):
                out.append({"w": flat[2 * j], "b": flat[2 * j + 1]})
                j += 1
            else:
                out.append(p)
        return out
    return NetState(put(net.params, flat_p), net.bn,
                    AdamState(new_count, put(net.opt.mu, flat_mu),
                              put(net.opt.nu, flat_nu)))


def unpack_net(net: NetState) -> Tuple[tuple, tuple, tuple, torch.Tensor]:
    """3-layer-MLP special case of ``unpack_net_generic`` (6-tuples)."""
    p, mu, nu, count = unpack_net_generic(net)
    return tuple(p), tuple(mu), tuple(nu), count


def repack_net(net: NetState, six, mu6, nu6, new_count) -> NetState:
    return repack_net_generic(net, list(six), list(mu6), list(nu6),
                              new_count)


def kernel_d_phase(net: NetState, shards, starts, fake, cfg):
    """Local-D phase over the flat (W, ...) D state; returns
    (new_net, d_loss (W,))."""
    six, mu6, nu6, count = unpack_net(net)
    new_p, new_mu, new_nu, new_count, losses = fused_d_epoch_steps(
        six, mu6, nu6, count, shards, starts, fake,
        head=cfg.resolved_d_head, d_loss_half=cfg.algo in ("capgan", "mixgan"),
        is_image=cfg.is_image, lr=cfg.lr_d, b1=cfg.b1, b2=cfg.b2)
    return repack_net(net, new_p, new_mu, new_nu, new_count), losses


def kernel_local_phase(cfg, g_model, g_net: NetState, d_net: NetState,
                       shards, starts, z_d):
    """Round prelude shared with the autograd path: the per-server Xd
    forward (train mode, no grad: advances the G BN buffers -> gbn1), the
    fakes routed to the clients (a multipath G's (S, k, B, ...): head i to
    client i of its server; a single-path G's (S, B, ...): the full batch to
    every client of its server), then the fused D phase.  Returns
    (new_d, d_loss (W,), gbn1)."""
    S, B = z_d.shape[0], cfg.batch_size
    W = shards.shape[0]
    with torch.no_grad():
        xd, gbn1 = g_model.apply(g_net.params, g_net.bn, z_d, train=True)
    if g_model.multipath:
        fake = xd.reshape(W, B, -1).contiguous()           # (W, B, din)
    elif S == 1:
        fake = xd.reshape(B, -1).contiguous()              # shared (B, din)
    else:
        xd = xd.reshape(S, B, -1)
        fake = xd.unsqueeze(1).expand(S, W // S, B, xd.shape[-1]) \
            .reshape(W, B, -1).contiguous()
    new_d, d_loss = kernel_d_phase(d_net, shards, starts, fake, cfg)
    return new_d, d_loss, gbn1

"""Fused Adam with low-precision moments and stochastic rounding.

Port of ``cglgan_tpu/ops/pallas/fused_adam.py``.  The Pallas TPU kernel
``_adam_kernel`` becomes the hand-written CUDA C++ kernel in
``csrc/fused_adam.cu`` (route: nvcc for sm_90a, plain C interface, ctypes):
parameter, moment update and step fused in ONE launch per tensor, so p, m, v
and g each cross device memory once per direction; moments stored in
float32, in bfloat16 rounded to nearest, or in bfloat16 with stochastic
rounding (unbiased, so the quantisation does not drift).

Numerics are the TPU kernel's own, not optax's: the bias corrections are
``1 - exp(t * log b)`` with ``log b`` taken in double on the host and the
rest in float32 (the rest of the port uses optax's ``1 - f32(b)**t``), and
``update = lr * (m2 / bc1) / (sqrt(v2 / bc2) + eps)``, ``p_out = p -
update``.  Random bits cannot match a TPU's on-core generator: the kernel
draws them from Philox 4x32-10 keyed by the TPU kernel's seed
``(count * 2654435761) & 0x7FFFFFFF`` and the leaf index, with the element
index as the counter.

``fused_adam(...).step`` launches the kernel for CUDA tensors and runs the
plain PyTorch version (``fused_adam_step_plain``) for CPU tensors; nothing
else.  The plain version takes the random bits as an argument, so a test
can feed it any bits; on CPU tensors ``step`` draws them from a
``torch.Generator`` seeded with the same (seed, leaf) pair — it never
changes mode silently.  ``launches`` counts kernel launches (one per
tensor).  As in the JAX package, no algorithm calls this module.
"""
from __future__ import annotations

import ctypes
import math
from typing import Any, NamedTuple, Optional

import torch

from cglgan_tpu_torch.utils.tree import tree_leaves, tree_map, tree_unflatten

SOURCE = "cglgan_tpu_torch/ops/csrc/fused_adam.cu"
REPLACES = "cglgan_tpu/ops/pallas/fused_adam.py:37"
MODE_F32, MODE_BF16_RN, MODE_BF16_SR = 0, 1, 2
_PARAM_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0          # kernel launches (one per tensor)


class FusedAdamState(NamedTuple):
    count: torch.Tensor    # () int64 step count
    m: Any
    v: Any


class _OptLike(NamedTuple):
    init: object
    step: object


def round_seed(count: int) -> int:
    """The TPU kernel's per-step seed: (count * 2654435761) mod 2^32, masked
    to 31 bits."""
    return ((int(count) * 2654435761) & 0xFFFFFFFF) & 0x7FFFFFFF


def stochastic_round_bf16(x: torch.Tensor, bits: torch.Tensor
                          ) -> torch.Tensor:
    """float32 -> bfloat16 with stochastic rounding: add 16 random bits
    (``bits`` in [0, 65536), any integer dtype) below the bfloat16 mantissa
    of the float32 pattern and truncate.  Inf and NaN pass through."""
    u = x.contiguous().view(torch.int32)
    r = (u + bits.to(torch.int32)) & -65536
    out = r.view(torch.float32).to(torch.bfloat16)          # exact
    return torch.where(torch.isfinite(x), out, x.to(torch.bfloat16))


def fused_adam_step_plain(g: torch.Tensor, p: torch.Tensor, m: torch.Tensor,
                          v: torch.Tensor, count, *, lr: float,
                          b1: float = 0.9, b2: float = 0.999,
                          eps: float = 1e-8,
                          bits_m: Optional[torch.Tensor] = None,
                          bits_v: Optional[torch.Tensor] = None):
    """The kernel's arithmetic in torch ops, on any device.  ``count`` is
    the step number t >= 1 (int or 0-dim tensor).  Moments are stored in
    ``m.dtype``; bfloat16 moments round to nearest unless ``bits_m`` and
    ``bits_v`` (16 random bits per element) are given.
    Returns (p_out, m_out, v_out)."""
    f32 = torch.float32
    t = torch.as_tensor(count, device=p.device).to(f32)
    g = g.to(f32)
    m2 = b1 * m.to(f32) + (1.0 - b1) * g
    v2 = b2 * v.to(f32) + (1.0 - b2) * g * g
    log_b = lambda b: torch.tensor(math.log(b), dtype=f32, device=p.device)
    bc1 = 1.0 - torch.exp(t * log_b(b1))
    bc2 = 1.0 - torch.exp(t * log_b(b2))
    update = lr * (m2 / bc1) / (torch.sqrt(v2 / bc2) + eps)
    p_out = (p.to(f32) - update).to(p.dtype)
    if m.dtype == torch.bfloat16 and bits_m is not None:
        return (p_out, stochastic_round_bf16(m2, bits_m),
                stochastic_round_bf16(v2, bits_v))
    return p_out, m2.to(m.dtype), v2.to(v.dtype)


_LIB = None


def _library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared (built on
    first use, never at import)."""
    global _LIB
    if _LIB is None:
        from cglgan_tpu_torch.ops import _build
        lib = _build.load("fused_adam")
        vp, f, i = ctypes.c_void_p, ctypes.c_float, ctypes.c_int
        lib.fused_adam_step.argtypes = [
            vp, vp, vp, vp, vp, vp, vp, vp, ctypes.c_longlong, i, i, i,
            f, f, f, f, f, f, f, f, vp]
        lib.fused_adam_step.restype = i
        lib.fused_adam_error_string.argtypes = [i]
        lib.fused_adam_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _mode(m: torch.Tensor, stochastic: bool) -> int:
    if m.dtype == torch.float32:
        return MODE_F32
    if m.dtype == torch.bfloat16:
        return MODE_BF16_SR if stochastic else MODE_BF16_RN
    raise ValueError(f"moment dtype {m.dtype}: float32 or bfloat16")


def fused_adam_leaf(g, p, m, v, count: torch.Tensor, leaf: int, *,
                    lr: float, b1: float, b2: float, eps: float,
                    stochastic: bool):
    """One Adam step of one tensor.  ``count`` is the 0-dim int64 step
    number t >= 1 on ``p``'s device.  Returns new (p, m, v); inputs are not
    modified.  CUDA tensors run the kernel, CPU tensors the plain version."""
    mode = _mode(m, stochastic)
    if v.dtype != m.dtype or m.shape != p.shape or v.shape != p.shape \
            or g.shape != p.shape:
        raise ValueError("g, p, m, v must share a shape and m, v a dtype")
    if p.device.type == "cuda":
        return _launch(g, p, m, v, count, leaf, mode, lr, b1, b2, eps)
    if p.device.type == "cpu":
        bits_m = bits_v = None
        if mode == MODE_BF16_SR:
            gen = torch.Generator().manual_seed(
                (round_seed(int(count)) << 20) + leaf)
            bits_m = torch.randint(0, 65536, p.shape, generator=gen)
            bits_v = torch.randint(0, 65536, p.shape, generator=gen)
        return fused_adam_step_plain(g, p, m, v, count, lr=lr, b1=b1, b2=b2,
                                     eps=eps, bits_m=bits_m, bits_v=bits_v)
    raise ValueError(f"unsupported device {p.device}")


def _launch(g, p, m, v, count, leaf, mode, lr, b1, b2, eps):
    global launches
    dev = p.device
    if p.dtype not in _PARAM_DTYPES:
        raise ValueError(f"param dtype {p.dtype}: float32 or bfloat16")
    if count.device != dev or count.dtype != torch.int64 or count.ndim != 0:
        raise ValueError("count must be a 0-dim int64 tensor on the params' "
                         "device")
    g = g.to(torch.float32)      # grads are cast outside, as in the reference
    for name, t in (("g", g), ("p", p), ("m", m), ("v", v)):
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, expected {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    # the kernel moves four elements per 16-byte access: a view that starts
    # inside its storage is copied to an aligned buffer
    g, p, m, v = (t if t.data_ptr() % 16 == 0 else t.clone()
                  for t in (g, p, m, v))
    p_out, m_out, v_out = (torch.empty_like(p), torch.empty_like(m),
                           torch.empty_like(v))
    n = p.numel()
    if n:
        lib = _library()
        rc = lib.fused_adam_step(
            g.data_ptr(), p.data_ptr(), m.data_ptr(), v.data_ptr(),
            p_out.data_ptr(), m_out.data_ptr(), v_out.data_ptr(),
            count.data_ptr(), n, _PARAM_DTYPES[p.dtype], mode, leaf,
            lr, b1, 1.0 - b1, b2, 1.0 - b2, eps, math.log(b1), math.log(b2),
            torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            msg = lib.fused_adam_error_string(rc).decode()
            raise RuntimeError(f"fused_adam launch failed: {msg} ({rc})")
        launches += 1
    return p_out, m_out, v_out


def fused_adam(lr: float, b1: float = 0.9, b2: float = 0.999,
               eps: float = 1e-8, moment_dtype=torch.bfloat16,
               stochastic: bool = True) -> _OptLike:
    """Returns an object with ``init(params)`` and
    ``step(grads, state, params) -> (new_params, new_state)`` over trees
    (lists/dicts) of tensors, one fused update per leaf."""
    if moment_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"moment dtype {moment_dtype}: float32 or bfloat16")

    def init(params) -> FusedAdamState:
        like = tree_leaves(params)[0]
        zeros = lambda x: torch.zeros(x.shape, dtype=moment_dtype,
                                      device=x.device)
        return FusedAdamState(
            torch.zeros((), dtype=torch.int64, device=like.device),
            tree_map(zeros, params), tree_map(zeros, params))

    def step(grads, state: FusedAdamState, params):
        count = state.count + 1
        outs = [fused_adam_leaf(g, p, m, v, count, j, lr=lr, b1=b1, b2=b2,
                                eps=eps, stochastic=stochastic)
                for j, (g, p, m, v) in enumerate(zip(
                    tree_leaves(grads), tree_leaves(params),
                    tree_leaves(state.m), tree_leaves(state.v)))]
        pick = lambda k: tree_unflatten(params, [o[k] for o in outs])
        return pick(0), FusedAdamState(count, pick(1), pick(2))

    return _OptLike(init, step)

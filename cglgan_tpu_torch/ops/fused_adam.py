"""Fused Adam with low-precision moments and stochastic rounding.

Port of ``cglgan_tpu/ops/pallas/fused_adam.py``.  The Pallas TPU kernel
``_adam_kernel`` becomes the hand-written CUDA C++ kernel in
``csrc/fused_adam.cu`` (route: nvcc for sm_90a, plain C interface, ctypes):
parameter, moment update and step fused, ONE launch for a whole list of up
to ``MAX_TENSORS`` tensors (the list's pointers and chunk offsets travel in
a table passed as a kernel parameter; ``plan_launches`` makes it), so p, m,
v and g each cross device memory once per direction; moments stored in
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
``MAX_TENSORS`` non-empty tensors of a list).  As in the JAX package, no
algorithm calls this module.
"""
from __future__ import annotations

import ctypes
import math
from typing import Any, List, NamedTuple, Optional, Sequence, Tuple

import torch

from cglgan_tpu_torch.utils.tree import tree_leaves, tree_map, tree_unflatten

SOURCE = "cglgan_tpu_torch/ops/csrc/fused_adam.cu"
REPLACES = "cglgan_tpu/ops/pallas/fused_adam.py:37"
MODE_F32, MODE_BF16_RN, MODE_BF16_SR = 0, 1, 2
_PARAM_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

MAX_TENSORS = 24      # leaves per launch (the kernel's table size)
CHUNK = 4096          # elements per thread block

launches = 0          # kernel launches (one per MAX_TENSORS non-empty leaves)


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


class Launch(NamedTuple):
    """One kernel launch: the non-empty leaves it covers, as parallel tuples
    of list index, element count and first block, and its grid size."""
    leaves: Tuple[int, ...]
    sizes: Tuple[int, ...]
    first: Tuple[int, ...]
    blocks: int


def plan_launches(sizes: Sequence[int], max_tensors: int = MAX_TENSORS,
                  chunk: int = CHUNK) -> List[Launch]:
    """Cut a list of leaf sizes into launches of at most ``max_tensors``
    non-empty leaves.  Inside a launch leaf ``s`` owns the blocks
    ``first[s] .. first[s] + ceil(n / chunk) - 1``; block ``b`` of a leaf
    updates its elements ``[b * chunk, min((b + 1) * chunk, n))``.  Empty
    leaves get no block and keep their index (the Philox key)."""
    live = [(j, int(n)) for j, n in enumerate(sizes) if n]
    out = []
    for lo in range(0, len(live), max_tensors):
        group = live[lo:lo + max_tensors]
        first, blocks = [], 0
        for _, n in group:
            first.append(blocks)
            blocks += -(-n // chunk)
        out.append(Launch(tuple(j for j, _ in group),
                          tuple(n for _, n in group), tuple(first), blocks))
    return out


_LIB = None


def _library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared (built on
    first use, never at import)."""
    global _LIB
    if _LIB is None:
        from cglgan_tpu_torch.ops import _build
        lib = _build.load("fused_adam")
        vp, f, i = ctypes.c_void_p, ctypes.c_float, ctypes.c_int
        arr = ctypes.POINTER(vp)
        lib.fused_adam_list.argtypes = [
            i, arr, arr, arr, arr, arr, arr, arr,
            ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(i),
            ctypes.POINTER(i), vp, i, i, f, f, f, f, f, f, f, f, vp]
        lib.fused_adam_list.restype = i
        lib.fused_adam_error_string.argtypes = [i]
        lib.fused_adam_error_string.restype = ctypes.c_char_p
        for fn in (lib.fused_adam_max_tensors, lib.fused_adam_chunk):
            fn.argtypes, fn.restype = [], i
        if (lib.fused_adam_max_tensors(), lib.fused_adam_chunk()) \
                != (MAX_TENSORS, CHUNK):
            raise RuntimeError("fused_adam.cu and fused_adam.py disagree on "
                               "MAX_TENSORS / CHUNK")
        _LIB = lib
    return _LIB


def _mode(m: torch.Tensor, stochastic: bool) -> int:
    if m.dtype == torch.float32:
        return MODE_F32
    if m.dtype == torch.bfloat16:
        return MODE_BF16_SR if stochastic else MODE_BF16_RN
    raise ValueError(f"moment dtype {m.dtype}: float32 or bfloat16")


def fused_adam_leaves(gs, ps, ms, vs, count: torch.Tensor, *, lr: float,
                      b1: float, b2: float, eps: float, stochastic: bool,
                      first_leaf: int = 0):
    """One Adam step of a list of tensors.  ``count`` is the 0-dim int64
    step number t >= 1 on the params' device; leaf ``j`` of the list has the
    random-bit key ``first_leaf + j``.  Returns a list of new (p, m, v);
    inputs are not modified.  CUDA tensors run the kernel (one launch per
    ``MAX_TENSORS`` non-empty leaves), CPU tensors the plain version."""
    gs, ps, ms, vs = list(gs), list(ps), list(ms), list(vs)
    if not len(gs) == len(ps) == len(ms) == len(vs):
        raise ValueError("gs, ps, ms, vs must have one entry per leaf")
    if not ps:
        return []
    mode = _mode(ms[0], stochastic)
    for g, p, m, v in zip(gs, ps, ms, vs):
        if v.dtype != m.dtype or m.shape != p.shape or v.shape != p.shape \
                or g.shape != p.shape:
            raise ValueError("g, p, m, v must share a shape and m, v a dtype")
        if p.dtype != ps[0].dtype or m.dtype != ms[0].dtype:
            raise ValueError(
                "mixed list: every leaf must have the first leaf's param "
                f"dtype {ps[0].dtype} and moment dtype {ms[0].dtype}")
        if p.device != ps[0].device:
            raise ValueError("the leaves must lie on one device")
    dev = ps[0].device
    if dev.type == "cuda":
        return _launch(gs, ps, ms, vs, count, first_leaf, mode, lr, b1, b2,
                       eps)
    if dev.type == "cpu":
        outs = []
        for j, (g, p, m, v) in enumerate(zip(gs, ps, ms, vs)):
            bits_m = bits_v = None
            if mode == MODE_BF16_SR:
                gen = torch.Generator().manual_seed(
                    (round_seed(int(count)) << 20) + first_leaf + j)
                bits_m = torch.randint(0, 65536, p.shape, generator=gen)
                bits_v = torch.randint(0, 65536, p.shape, generator=gen)
            outs.append(fused_adam_step_plain(
                g, p, m, v, count, lr=lr, b1=b1, b2=b2, eps=eps,
                bits_m=bits_m, bits_v=bits_v))
        return outs
    raise ValueError(f"unsupported device {dev}")


def fused_adam_leaf(g, p, m, v, count: torch.Tensor, leaf: int, *,
                    lr: float, b1: float, b2: float, eps: float,
                    stochastic: bool):
    """One Adam step of one tensor: the one-leaf case of
    ``fused_adam_leaves`` with the random-bit key ``leaf``.  Returns new
    (p, m, v)."""
    return fused_adam_leaves([g], [p], [m], [v], count, lr=lr, b1=b1, b2=b2,
                             eps=eps, stochastic=stochastic,
                             first_leaf=leaf)[0]


def _launch(gs, ps, ms, vs, count, first_leaf, mode, lr, b1, b2, eps):
    global launches
    dev = ps[0].device
    if ps[0].dtype not in _PARAM_DTYPES:
        raise ValueError(f"param dtype {ps[0].dtype}: float32 or bfloat16")
    if count.device != dev or count.dtype != torch.int64 or count.ndim != 0:
        raise ValueError("count must be a 0-dim int64 tensor on the params' "
                         "device")
    # grads are cast outside the kernel, as in the reference
    gs = [g if g.dtype == torch.float32 else g.to(torch.float32) for g in gs]
    keep, ptrs = [], []          # aligned copies kept alive; 7 pointer columns
    for name, ts in (("g", gs), ("p", ps), ("m", ms), ("v", vs)):
        col = []
        for t in ts:
            if t.device != dev:
                raise ValueError(f"{name} on {t.device}, expected {dev}")
            if not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous")
            ptr = t.data_ptr()
            if ptr % 16:
                # the kernel moves four elements per 16-byte access: a view
                # that starts inside its storage is copied to an aligned buffer
                t = t.clone()
                keep.append(t)
                ptr = t.data_ptr()
            col.append(ptr)
        ptrs.append(col)
    outs = [[torch.empty_like(t) for t in ts] for ts in (ps, ms, vs)]
    ptrs += [[t.data_ptr() for t in ts] for ts in outs]
    plan = plan_launches([p.numel() for p in ps])
    if plan:
        lib = _library()
        stream = torch.cuda.current_stream(dev).cuda_stream
    for launch in plan:
        k = len(launch.leaves)
        rc = lib.fused_adam_list(
            k, *[(ctypes.c_void_p * k)(*[col[j] for j in launch.leaves])
                 for col in ptrs],
            (ctypes.c_longlong * k)(*launch.sizes),
            (ctypes.c_int * (k + 1))(*launch.first, launch.blocks),
            (ctypes.c_int * k)(*[first_leaf + j for j in launch.leaves]),
            count.data_ptr(), _PARAM_DTYPES[ps[0].dtype], mode,
            lr, b1, 1.0 - b1, b2, 1.0 - b2, eps, math.log(b1), math.log(b2),
            stream)
        if rc != 0:
            msg = lib.fused_adam_error_string(rc).decode()
            raise RuntimeError(f"fused_adam launch failed: {msg} ({rc})")
        launches += 1
    return list(zip(*outs))


def fused_adam(lr: float, b1: float = 0.9, b2: float = 0.999,
               eps: float = 1e-8, moment_dtype=torch.bfloat16,
               stochastic: bool = True) -> _OptLike:
    """Returns an object with ``init(params)`` and
    ``step(grads, state, params) -> (new_params, new_state)`` over trees
    (lists/dicts) of tensors, one fused update over all leaves."""
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
        outs = fused_adam_leaves(
            tree_leaves(grads), tree_leaves(params), tree_leaves(state.m),
            tree_leaves(state.v), count, lr=lr, b1=b1, b2=b2, eps=eps,
            stochastic=stochastic)
        pick = lambda k: tree_unflatten(params, [o[k] for o in outs])
        return pick(0), FusedAdamState(count, pick(1), pick(2))

    return _OptLike(init, step)

"""threefry2x32 draws in one kernel launch: the hash and its epilogues.

``csrc/threefry.cu`` (route: nvcc for sm_90a, plain C interface, ctypes)
hashes a batch of keys, each over its own range of counts, and writes one
of the draws of ``jax.random`` in partitionable mode (``WORDS`` for
``split`` / ``fold_in``, 32-, 16- or 8-bit bits, float32 or bfloat16
``uniform``, ``bernoulli``, float32 or bfloat16 ``normal``, ``randint``).
It replaces no Pallas kernel: the JAX package's draws are XLA's own fused
threefry lowering, where the port's were ~170 elementwise int64 torch ops
a hash pass.

``draw(mode, keys, shapes, ...)``: ``keys`` ``(..., P, 2)`` int64 (the two
uint32 words of ``jax.random.key_data``), one key a part; part ``p`` is a
draw of shape ``shapes[p]`` under its key, counted from ``base`` (0 is
``iota_2x32_shape``; a part of ``n`` elements at ``base`` t hashes the
counts of ``fold_in`` of t .. t + n - 1).  Returns one tensor a part,
``keys.shape[:-2] + shapes[p]`` (``WORDS``: a trailing axis of 2).  CUDA
keys launch the kernel (one launch for up to ``MAX_PARTS`` parts, counted
in ``launches``); CPU keys run ``draw_plain``, the same arithmetic as
elementwise int64 torch ops (every 32-bit word carried in int64 and masked
after each add, shift and multiply: torch's ``uint32`` lacks most
arithmetic), which runs on any device.  ``core/threefry.py`` builds
``jax.random``'s functions on ``draw``.

Numerics: every mode but the normals gives JAX's bits.  The float32 normal
follows XLA's float32 ``erf_inv`` polynomial with ``log1p`` rounded once
from float64: within 3 ulps of JAX's on the CPU, and the kernel's fused
multiply-adds (rounded once) against the plain version's (float64, then
float32) may differ by as much in a few elements a million.
"""
from __future__ import annotations

import ctypes
import math
from typing import List, Sequence, Tuple

import numpy as np
import torch

SOURCE = "cglgan_tpu_torch/ops/csrc/threefry.cu"
REPLACES = ("none: XLA's threefry2x32 lowering of jax.random "
            "(jax/_src/prng.py _threefry2x32_lowering)")

(WORDS, BITS32, BITS16, BITS8, UNIFORM_F32, UNIFORM_BF16, BERNOULLI,
 NORMAL_F32, NORMAL_BF16, RANDINT) = range(10)
MAX_PARTS = 8
MASK = 0xFFFFFFFF
# 32-bit integer operations of one hash (csrc/threefry.cu: 20 rounds of
# add, rotate, xor; 5 injections of 3 adds; 2 initial adds; 2 xors of the
# third key word) and the words' xor
HASH_OPS = 80

launches = 0          # kernel launches (one per MAX_PARTS parts of a draw)

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_OUT_DTYPES = {WORDS: torch.int64, BITS32: torch.int64, BITS16: torch.int64,
               BITS8: torch.int64, UNIFORM_F32: torch.float32,
               UNIFORM_BF16: torch.bfloat16, BERNOULLI: torch.bool,
               NORMAL_F32: torch.float32, NORMAL_BF16: torch.bfloat16,
               RANDINT: torch.int32}


# ---------------------------------------------------------------------------
# the plain version: int64 torch ops on any device
# ---------------------------------------------------------------------------

def hash2x32(k1, k2, x1: torch.Tensor, x2: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The threefry2x32 block: 20 rounds, a key injection every 4.  ``k1``,
    ``k2``: key words (ints or tensors broadcasting against the counts);
    ``x1``, ``x2``: the count words.  In place on two fresh tensors of the
    broadcast shape: a new tensor an op would cost a large draw most of
    its time in allocation."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    a, b = (x1 + ks[0]).bitwise_and_(MASK), (x2 + ks[1]).bitwise_and_(MASK)
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            a.add_(b).bitwise_and_(MASK)
            high = (b << r).bitwise_and_(MASK)
            b.bitwise_right_shift_(32 - r).bitwise_or_(high).bitwise_xor_(a)
        a.add_(ks[(i + 1) % 3]).bitwise_and_(MASK)
        b.add_(ks[(i + 2) % 3]).add_(i + 1).bitwise_and_(MASK)
    return a, b


def unit_floats(bits: torch.Tensor) -> torch.Tensor:
    """23 random mantissa bits under the exponent of 1.0, minus 1: float32
    in [0, 1)."""
    bits = (bits >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0


def _unit_bf16(bits: torch.Tensor) -> torch.Tensor:
    """bfloat16 in [0, 1) from the low 8 bits: 7 mantissa bits under the
    exponent of 1.0, minus 1 (``_uniform``'s 8-bit draw for bfloat16)."""
    bits = ((bits & 0xFF) >> 1) | 0x3F80
    return bits.to(torch.int16).view(torch.bfloat16) - 1.0


def _f32(x: float) -> float:
    """``x`` rounded to float32, as a Python float."""
    return float(np.float32(x))


SQRT2 = _f32(np.sqrt(2))
SQRT2_BF16 = 1.4140625            # sqrt(2) rounded to bfloat16
# XLA's float32 erf_inv (M. Giles' single-precision approximation), one
# polynomial in w for w < 5 and one in sqrt(w) beyond
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 ``a * b + c`` as XLA's fused multiply-add: the product of two
    float32s is exact in float64, which then rounds to float32."""
    return (a.double() * b.double() + c.double()).float()


def erfinv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``erf_inv``, with its Horner steps fused as XLA fuses
    them on the CPU.  ``log1p`` runs in float64 and rounds once; JAX's
    differs from it by at most 2 ulps (its own float32 ``log1p``)."""
    w = -torch.log1p((x * -x).double()).float()
    small = w < 5.0
    w = torch.where(small, w - 2.5, torch.sqrt(w) - 3.0)
    coef = lambda i: torch.where(small, _f32(_ERFINV_LT5[i]),
                                 _f32(_ERFINV_GE5[i]))
    p = coef(0).expand_as(x)
    for i in range(1, len(_ERFINV_LT5)):
        p = _fma(p, w, coef(i))
    return torch.where(x.abs() == 1.0, x * float("inf"), p * x)


def _uniform_f32(bits, lo: float, span: float) -> torch.Tensor:
    return (unit_floats(bits).double() * span + lo).float().clamp_min(lo)


def _uniform_bf16(bits, lo: float, span: float) -> torch.Tensor:
    return (_unit_bf16(bits) * span + lo).clamp_min(lo)


_COUNTS = {}


def _part_counts(sizes: Tuple[int, ...], device):
    """Each element's part index and its count within its part, over the
    parts laid end to end; made once a device."""
    cache_key = (sizes, str(device))
    if cache_key not in _COUNTS:
        part = torch.repeat_interleave(torch.arange(len(sizes)),
                                       torch.tensor(sizes))
        count = torch.cat([torch.arange(n) for n in sizes])
        _COUNTS[cache_key] = (part.to(device), count.to(device))
    return _COUNTS[cache_key]


# On the CPU the plain version runs in blocks of about this many elements:
# each of its ~200 elementwise ops then stays below torch's parallel grain
# (32 768 elements) and in cache, where a multi-million-element op would
# fork threads once an op (and, with other processes on the cores, wait on
# them)
_CPU_BLOCK = 1 << 14


def draw_plain(mode: int, keys: torch.Tensor, shapes, base: int = 0,
               lo: float = 0.0, span: float = 1.0, p: float = 0.0,
               rand: Tuple[int, int, int] = (1, 0, 0)) -> List[torch.Tensor]:
    """``draw``'s arithmetic as int64 torch ops on ``keys``' device: one
    hash pass over all parts' counts (three for ``RANDINT``), on the CPU
    block by block (``_CPU_BLOCK``)."""
    shapes, sizes = _check(keys, shapes)
    lead = tuple(keys.shape[:-2])
    n = sum(sizes)
    tail = (2,) if mode == WORDS else ()
    out = torch.empty(lead + (n,) + tail, device=keys.device,
                      dtype=_OUT_DTYPES[mode])
    if n:
        part, count = _part_counts(sizes, keys.device)
        step = n if keys.device.type != "cpu" else \
            max(1, _CPU_BLOCK // max(math.prod(lead), 1))
        for j in range(0, n, step):
            block = slice(j, min(n, j + step))
            out[(..., block) + (slice(None),) * len(tail)] = _plain_block(
                mode, keys, len(sizes), part[block], count[block] + int(base),
                lo, span, p, rand)
    return _split_parts(out, mode, lead, shapes, sizes)


def _plain_block(mode, keys, n_parts, part, count, lo, span, p, rand):
    """The draw of the counts ``count`` of parts ``part`` under each lead
    member's keys: (lead..., len(count)[, 2])."""
    hi, lo_word = count >> 32, count & MASK
    if n_parts == 1:         # one key a lead member, broadcast
        k1, k2 = keys[..., 0, :1], keys[..., 0, 1:]
    else:                    # each element its part's key
        k1, k2 = keys[..., 0][..., part], keys[..., 1][..., part]
    if mode == RANDINT:
        zero = torch.zeros((), dtype=torch.int64, device=keys.device)
        ka = hash2x32(k1, k2, zero, zero)
        kb = hash2x32(k1, k2, zero, zero + 1)
        a1, a2 = hash2x32(*ka, hi, lo_word)
        b1, b2 = hash2x32(*kb, hi, lo_word)
        span_i, mult, minval = rand
        offset = ((((a1 ^ a2) % span_i) * mult) & MASK) + ((b1 ^ b2) % span_i)
        out = (((offset & MASK) % span_i) + minval) & MASK
        return torch.where(out > 0x7FFFFFFF, out - (1 << 32), out)
    a, b = hash2x32(k1, k2, hi, lo_word)
    bits = a ^ b
    if mode == WORDS:
        return torch.stack([a, b], dim=-1)
    if mode == BITS32:
        return bits
    if mode == BITS16:
        return bits & 0xFFFF
    if mode == BITS8:
        return bits & 0xFF
    if mode == UNIFORM_F32:
        return _uniform_f32(bits, lo, span)
    if mode == UNIFORM_BF16:
        return _uniform_bf16(bits, lo, span)
    if mode == BERNOULLI:
        return unit_floats(bits) < p
    if mode == NORMAL_F32:
        return erfinv(_uniform_f32(bits, lo, span)) * SQRT2
    if mode == NORMAL_BF16:
        u = _uniform_bf16(bits, lo, span)
        return erfinv(u.float()).to(torch.bfloat16) * SQRT2_BF16
    raise ValueError(f"unknown threefry mode {mode}")


def _check(keys: torch.Tensor, shapes):
    if keys.ndim < 2 or keys.shape[-1] != 2:
        raise ValueError(f"keys have shape (..., parts, 2), got "
                         f"{tuple(keys.shape)}")
    if keys.dtype != torch.int64:
        raise ValueError(f"keys are int64 key data, got {keys.dtype}")
    shapes = tuple(tuple(int(d) for d in s) for s in shapes)
    if keys.shape[-2] != len(shapes):
        raise ValueError(f"{len(shapes)} parts need keys (..., "
                         f"{len(shapes)}, 2), got {tuple(keys.shape)}")
    return shapes, tuple(math.prod(s) for s in shapes)


def _split_parts(out: torch.Tensor, mode: int, lead, shapes, sizes):
    """(lead..., sum(sizes)[, 2]) -> one tensor a part."""
    tail = (2,) if mode == WORDS else ()
    return [x.reshape(lead + s + tail)
            for x, s in zip(torch.split(out, list(sizes),
                                        dim=out.ndim - 1 - len(tail)),
                            shapes)]


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------

_LIB = None


def _library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared (built on
    first use, never at import)."""
    global _LIB
    if _LIB is None:
        from cglgan_tpu_torch.ops import _build
        lib = _build.load("threefry")
        vp, ll, f, u, i = (ctypes.c_void_p, ctypes.c_longlong,
                           ctypes.c_float, ctypes.c_uint, ctypes.c_int)
        lib.threefry_draw.argtypes = [
            i, vp, ll, ll, ll, i, ctypes.POINTER(ll), ctypes.c_ulonglong,
            f, f, f, u, u, i, vp, vp]
        lib.threefry_draw.restype = i
        lib.threefry_error_string.argtypes = [i]
        lib.threefry_error_string.restype = ctypes.c_char_p
        lib.threefry_max_parts.argtypes, lib.threefry_max_parts.restype = \
            [], i
        if lib.threefry_max_parts() != MAX_PARTS:
            raise RuntimeError("threefry.cu and threefry.py disagree on "
                               "MAX_PARTS")
        _LIB = lib
    return _LIB


def _launch(mode, keys, shapes, sizes, base, lo, span, p, rand):
    lead = tuple(keys.shape[:-2])
    n_lead = math.prod(lead)
    tail = 2 if mode == WORDS else 1
    out = torch.empty((n_lead * sum(sizes) * tail,), device=keys.device,
                      dtype=_OUT_DTYPES[mode])
    if n_lead and sum(sizes):
        k3 = keys.reshape(n_lead, len(shapes), 2)
        if k3.stride(2) != 1:
            k3 = k3.contiguous()
        lib = _library()
        stream = torch.cuda.current_stream(keys.device).cuda_stream
        esize = out.element_size() * tail
        # runs of consecutive non-empty parts, at most MAX_PARTS a launch;
        # the output is part-major, so each run's block follows the last
        runs, pos = [], 0
        for j, n in enumerate(sizes):
            if n and runs and runs[-1][-1] == j - 1 \
                    and len(runs[-1]) < MAX_PARTS:
                runs[-1].append(j)
            elif n:
                runs.append([j])
        for run in runs:
            _one(lib, mode, k3.data_ptr() + run[0] * k3.stride(1) * 8,
                 n_lead, k3.stride(0), k3.stride(1),
                 [sizes[j] for j in run], base, lo, span, p, rand,
                 out.data_ptr() + pos * esize, stream)
            pos += n_lead * sum(sizes[j] for j in run)
    parts, pos = [], 0
    for s, n in zip(shapes, sizes):
        block = out[pos * tail:(pos + n_lead * n) * tail]
        parts.append(block.view(lead + s + ((2,) if mode == WORDS else ())))
        pos += n_lead * n
    return parts


def _one(lib, mode, key_ptr, n_lead, lead_stride, part_stride, sizes, base,
         lo, span, p, rand, out_ptr, stream):
    global launches
    rc = lib.threefry_draw(
        mode, key_ptr, n_lead, lead_stride, part_stride, len(sizes),
        (ctypes.c_longlong * len(sizes))(*sizes), base, lo, span, p,
        rand[0], rand[1], rand[2], out_ptr, stream)
    if rc != 0:
        msg = lib.threefry_error_string(rc).decode()
        raise RuntimeError(f"threefry launch failed: {msg} ({rc})")
    launches += 1


def draw(mode: int, keys: torch.Tensor, shapes: Sequence[Sequence[int]],
         base: int = 0, lo: float = 0.0, span: float = 1.0, p: float = 0.0,
         rand: Tuple[int, int, int] = (1, 0, 0)) -> List[torch.Tensor]:
    """One draw a part (module docstring).  ``lo`` / ``span``: the uniform's
    (and the normal's) lower bound and width, exact in the mode's dtype;
    ``p``: the Bernoulli threshold, a float32; ``rand``: randint's span,
    multiplier and minval.  CUDA keys launch the kernel, CPU keys run
    ``draw_plain``; nothing else."""
    shapes, sizes = _check(keys, shapes)
    if int(base) < 0 or int(base) + max(sizes, default=0) > 1 << 64:
        raise ValueError(f"counts from base {base} leave 64 bits")
    if keys.device.type == "cuda":
        return _launch(mode, keys, shapes, sizes, int(base), lo, span, p,
                       rand)
    if keys.device.type == "cpu":
        return draw_plain(mode, keys, shapes, base, lo, span, p, rand)
    raise ValueError(f"unsupported device {keys.device}")

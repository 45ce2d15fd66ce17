// threefry.cu — JAX's threefry2x32 (partitionable mode) as one kernel: a
// batch of keys, each hashing its own range of counts, with an epilogue
// that writes the draw (Hopper).
//
// Replaces no Pallas kernel: the JAX package's draws are XLA's own fused
// threefry lowering (jax/_src/prng.py `_threefry2x32_lowering`,
// `_threefry_split_foldlike`, `_threefry_fold_in`,
// `_threefry_random_bits_partitionable`; jax/_src/random.py `_uniform`,
// `_normal_real`, `_randint`).  Without it each hash pass was ~170
// elementwise int64 launches (core/threefry.py's plain version), and a
// round's draws would have added ~1 500 launches to host-bound rounds.
//
// One launch covers `nparts` parts laid end to end, each with its own key
// and its own count range, for `lead` leading members.  Keys are read from
// device memory (int64 pairs holding the two uint32 words of
// `jax.random.key_data`), never passed as launch arguments, so a captured
// launch can later take keys computed on the device.  Element j of part p
// of member l hashes the count (hi, lo) of the 64-bit value base + j under
// the key at keys[l * lead_stride + p * part_stride]: `base` 0 is
// `iota_2x32_shape` (split, bits, uniform, ...); a part of n elements at
// base t is fold_in of t, t + 1, ..., t + n - 1.  Output is part-major:
// part p's (lead, size_p) elements follow part p - 1's.
//
// The 20 rounds use rotations (13, 15, 26, 6) and (17, 29, 16, 24) with a
// key injection every four, as JAX's; a rotate is one `__funnelshift_l`.
// Epilogues (MODE):
//   WORDS        both words (split, fold_in), int64 pairs
//   BITS32/16/8  (x1 ^ x2), its low 16 or 8 bits, as int64
//   UNIFORM_F32  23 mantissa bits under 1.0, minus 1, then
//                max(lo, fma(f, span, lo)) rounded once (XLA's contraction)
//   UNIFORM_BF16 the low 8 bits (bfloat16's 7 mantissa bits), the bf16
//                product and sum each rounded to nearest, max(lo, .)
//   BERNOULLI    the float32 unit value < p, as bool
//   NORMAL_F32   sqrt(2) * erf_inv(u), u uniform on (-1, 1): XLA's float32
//                erf_inv polynomial, Horner steps as fmaf, log1p in double
//                and rounded once (core/threefry.py `erfinv`)
//   NORMAL_BF16  u in bfloat16; erf_inv in float32 rounded to bf16, times
//                bf16(sqrt 2), rounded (XLA upcasts erf_inv to float32)
//   RANDINT      the key's two split halves, one 32-bit draw from each,
//                reduced with JAX's multiplier for the high word, int32
// The _rn intrinsics keep nvcc from contracting products into FMAs where
// the reference rounds them apart.
//
// Bound: integer operations.  A hash is 20 rounds of (add, rotate, xor),
// 5 key injections of 3 adds, the 2 initial adds and the third key word's 2
// xors: 79 32-bit integer operations, 80 with the words' xor, an element
// (RANDINT: 4 hashes).  A float32 normal writes 4
// bytes an element, so the operations bound it on a card with 16.7 T int32
// operations a second against 3.35 TB/s.  One thread an element, a
// grid-stride loop; the simple design first.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TPB = 256;
constexpr int MAX_PARTS = 8;
constexpr int WORDS = 0, BITS32 = 1, BITS16 = 2, BITS8 = 3,
              UNIFORM_F32 = 4, UNIFORM_BF16 = 5, BERNOULLI = 6,
              NORMAL_F32 = 7, NORMAL_BF16 = 8, RANDINT = 9;

struct Draw {
  const long long* keys;
  long long lead, lead_stride, part_stride;
  int nparts;
  long long size[MAX_PARTS];
  long long start[MAX_PARTS + 1];   // lead * running sizes: part offsets
  unsigned long long base;
  float lo, span, p;
  uint32_t rspan, rmult;
  int rmin;
  void* out;
};

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

__device__ __forceinline__ void hash(uint32_t k1, uint32_t k2, uint32_t& x1,
                                     uint32_t& x2) {
  const uint32_t k3 = k1 ^ k2 ^ 0x1BD11BDAu;
  x1 += k1;
  x2 += k2;
#define TF_ROUND(r) x1 += x2; x2 = rotl(x2, r) ^ x1;
#define TF_EVEN TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
#define TF_ODD TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  TF_EVEN x1 += k2; x2 += k3 + 1u;
  TF_ODD  x1 += k3; x2 += k1 + 2u;
  TF_EVEN x1 += k1; x2 += k2 + 3u;
  TF_ODD  x1 += k2; x2 += k3 + 4u;
  TF_EVEN x1 += k3; x2 += k1 + 5u;
#undef TF_ODD
#undef TF_EVEN
#undef TF_ROUND
}

__device__ __forceinline__ float unit_f32(uint32_t bits) {
  return __fsub_rn(__uint_as_float((bits >> 9) | 0x3F800000u), 1.0f);
}

__device__ __forceinline__ float rn_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// bfloat16 unit value from 8 random bits, minus 1 (exact), then the bf16
// product and sum, each rounded to nearest, clamped below at lo
__device__ __forceinline__ float uniform_bf16(uint32_t bits, float lo,
                                              float span) {
  const float f = __uint_as_float((((bits & 0xFFu) >> 1) | 0x3F80u) << 16);
  const float v = rn_bf16(__fadd_rn(rn_bf16(__fmul_rn(
      __fsub_rn(f, 1.0f), span)), lo));
  return fmaxf(lo, v);
}

__device__ __forceinline__ float erfinv_xla(float x) {
  const float w0 = (float)(-log1p((double)__fmul_rn(x, -x)));
  const bool small = w0 < 5.0f;
  const float w = small ? __fsub_rn(w0, 2.5f)
                        : __fsub_rn(__fsqrt_rn(w0), 3.0f);
  float p;
  if (small) {
    p = 2.81022636e-08f;
    p = __fmaf_rn(p, w, 3.43273939e-07f);
    p = __fmaf_rn(p, w, -3.5233877e-06f);
    p = __fmaf_rn(p, w, -4.39150654e-06f);
    p = __fmaf_rn(p, w, 0.00021858087f);
    p = __fmaf_rn(p, w, -0.00125372503f);
    p = __fmaf_rn(p, w, -0.00417768164f);
    p = __fmaf_rn(p, w, 0.246640727f);
    p = __fmaf_rn(p, w, 1.50140941f);
  } else {
    p = -0.000200214257f;
    p = __fmaf_rn(p, w, 0.000100950558f);
    p = __fmaf_rn(p, w, 0.00134934322f);
    p = __fmaf_rn(p, w, -0.00367342844f);
    p = __fmaf_rn(p, w, 0.00573950773f);
    p = __fmaf_rn(p, w, -0.0076224613f);
    p = __fmaf_rn(p, w, 0.00943887047f);
    p = __fmaf_rn(p, w, 1.00167406f);
    p = __fmaf_rn(p, w, 2.83297682f);
  }
  if (fabsf(x) == 1.0f) return __fmul_rn(x, __int_as_float(0x7F800000));
  return __fmul_rn(p, x);
}

template <int MODE>
__global__ void __launch_bounds__(TPB) threefry_kernel(const Draw d) {
  const long long total = d.start[d.nparts];
  for (long long e = (long long)blockIdx.x * TPB + threadIdx.x; e < total;
       e += (long long)gridDim.x * TPB) {
    int p = 0;
    while (e >= d.start[p + 1]) ++p;
    const long long r = e - d.start[p];
    const long long l = r / d.size[p];
    const long long j = r - l * d.size[p];
    const long long* key = d.keys + l * d.lead_stride + p * d.part_stride;
    const uint32_t k1 = (uint32_t)key[0], k2 = (uint32_t)key[1];
    const unsigned long long c = d.base + (unsigned long long)j;
    uint32_t x1 = (uint32_t)(c >> 32), x2 = (uint32_t)c;
    if (MODE == RANDINT) {
      // split(key): the counts (0, 0) and (0, 1), then one draw from each
      uint32_t a1 = 0u, a2 = 0u, b1 = 0u, b2 = 1u;
      hash(k1, k2, a1, a2);
      hash(k1, k2, b1, b2);
      uint32_t h1 = x1, h2 = x2, l1 = x1, l2 = x2;
      hash(a1, a2, h1, h2);
      hash(b1, b2, l1, l2);
      const uint32_t higher = h1 ^ h2, lower = l1 ^ l2;
      uint32_t off = (higher % d.rspan) * d.rmult + lower % d.rspan;
      off %= d.rspan;
      ((int*)d.out)[e] = (int)(off + (uint32_t)d.rmin);
      continue;
    }
    hash(k1, k2, x1, x2);
    const uint32_t bits = x1 ^ x2;
    if (MODE == WORDS) {
      ((long long*)d.out)[2 * e] = (long long)x1;
      ((long long*)d.out)[2 * e + 1] = (long long)x2;
    } else if (MODE == BITS32) {
      ((long long*)d.out)[e] = (long long)bits;
    } else if (MODE == BITS16) {
      ((long long*)d.out)[e] = (long long)(bits & 0xFFFFu);
    } else if (MODE == BITS8) {
      ((long long*)d.out)[e] = (long long)(bits & 0xFFu);
    } else if (MODE == UNIFORM_F32) {
      ((float*)d.out)[e] =
          fmaxf(d.lo, __fmaf_rn(unit_f32(bits), d.span, d.lo));
    } else if (MODE == UNIFORM_BF16) {
      ((__nv_bfloat16*)d.out)[e] =
          __float2bfloat16_rn(uniform_bf16(bits, d.lo, d.span));
    } else if (MODE == BERNOULLI) {
      ((bool*)d.out)[e] = unit_f32(bits) < d.p;
    } else if (MODE == NORMAL_F32) {
      const float u = fmaxf(d.lo, __fmaf_rn(unit_f32(bits), d.span, d.lo));
      ((float*)d.out)[e] = __fmul_rn(erfinv_xla(u), 1.41421354f);
    } else if (MODE == NORMAL_BF16) {
      const float u = uniform_bf16(bits, d.lo, d.span);
      ((__nv_bfloat16*)d.out)[e] = __float2bfloat16_rn(
          __fmul_rn(rn_bf16(erfinv_xla(u)), 1.4140625f));
    }
  }
}

template <int MODE>
int launch(const Draw& d, cudaStream_t st) {
  const long long total = d.start[d.nparts];
  long long blocks = (total + TPB - 1) / TPB;
  if (blocks > 65535LL * 32) blocks = 65535LL * 32;
  threefry_kernel<MODE><<<(unsigned)blocks, TPB, 0, st>>>(d);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* threefry_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int threefry_max_parts() { return MAX_PARTS; }

// One launch: `nparts` <= MAX_PARTS parts of sizes[p] > 0 elements for each
// of `lead` >= 1 members; keys: device int64, member l's key of part p at
// keys + l * lead_stride + p * part_stride (two adjacent words); counts
// base + j; out: device buffer of lead * sum(sizes) elements of the mode's
// type (WORDS: pairs of int64).  lo / span: the uniform's bounds (the
// normal's too), p: the Bernoulli threshold, rspan / rmult / rmin:
// randint's span, multiplier and minval.  Returns 0, the
// cudaGetLastError() code, or cudaErrorInvalidValue for a bad argument.
int threefry_draw(int mode, const long long* keys, long long lead,
                  long long lead_stride, long long part_stride, int nparts,
                  const long long* sizes, unsigned long long base, float lo,
                  float span, float p, unsigned int rspan, unsigned int rmult,
                  int rmin, void* out, void* stream) {
  if (nparts < 1 || nparts > MAX_PARTS || lead < 1 || rspan == 0u)
    return (int)cudaErrorInvalidValue;
  Draw d{};
  d.keys = keys;
  d.lead = lead;
  d.lead_stride = lead_stride;
  d.part_stride = part_stride;
  d.nparts = nparts;
  d.start[0] = 0;
  for (int i = 0; i < nparts; ++i) {
    if (sizes[i] < 1) return (int)cudaErrorInvalidValue;
    d.size[i] = sizes[i];
    d.start[i + 1] = d.start[i] + lead * sizes[i];
  }
  d.base = base;
  d.lo = lo;
  d.span = span;
  d.p = p;
  d.rspan = rspan;
  d.rmult = rmult;
  d.rmin = rmin;
  d.out = out;
  cudaStream_t st = (cudaStream_t)stream;
  switch (mode) {
    case WORDS: return launch<WORDS>(d, st);
    case BITS32: return launch<BITS32>(d, st);
    case BITS16: return launch<BITS16>(d, st);
    case BITS8: return launch<BITS8>(d, st);
    case UNIFORM_F32: return launch<UNIFORM_F32>(d, st);
    case UNIFORM_BF16: return launch<UNIFORM_BF16>(d, st);
    case BERNOULLI: return launch<BERNOULLI>(d, st);
    case NORMAL_F32: return launch<NORMAL_F32>(d, st);
    case NORMAL_BF16: return launch<NORMAL_BF16>(d, st);
    case RANDINT: return launch<RANDINT>(d, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"

// fused_adam.cu — one fused Adam step per tensor, with float32 or bfloat16
// moments and stochastic rounding (Hopper).
//
// Replaces the Pallas TPU kernel `_adam_kernel`
// (cglgan_tpu/ops/pallas/fused_adam.py:37-59, launched by `_flat_update`
// :62-88 from `fused_adam(...).step` :126).  Per element, in float32:
//   m2 = b1*m + (1-b1)*g;  v2 = b2*v + ((1-b2)*g)*g
//   bc1 = 1 - exp(t*log b1);  bc2 = 1 - exp(t*log b2)      (the TPU
//     kernel's own form, not optax's 1 - b^t; log b comes from the host)
//   update = lr*(m2/bc1) / (sqrt(v2/bc2) + eps);  p_out = p - update
// and m2, v2 are stored as float32, as bfloat16 rounded to nearest, or as
// bfloat16 with stochastic rounding: 16 random bits are added below the
// bfloat16 mantissa of the float32 pattern, which is then truncated; inf and
// NaN pass through.  The step number t is read from device memory (no host
// synchronisation).  The _rn intrinsics keep nvcc from contracting the
// update into FMAs, so it rounds as the unfused formula does.
//
// Random bits: the TPU seeds its on-core generator with
// (count*2654435761 & 0x7FFFFFFF) + block id; its bits cannot be matched.
// Here Philox 4x32-10 is keyed by (that seed, leaf index) and counted by
// the element index / 4: one call gives four elements their 32 bits each
// (low 16 for m, high 16 for v).
//
// Bound: bytes.  Per element the f32 mode reads g, p, m, v and writes p, m,
// v: 28 B; the bf16 modes 20 B.  One launch per tensor over the flat element
// range, four elements per thread as 16-byte loads and stores, a scalar
// path for the tail; no padding.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TPB = 256;
constexpr int MODE_F32 = 0, MODE_BF16_RN = 1, MODE_BF16_SR = 2;

struct Philox {
  uint32_t v[4];
};

__device__ __forceinline__ Philox philox4x32_10(uint32_t c0, uint32_t c1,
                                                uint32_t k0, uint32_t k1) {
  uint32_t c2 = 0u, c3 = 0u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return Philox{{c0, c1, c2, c3}};
}

__device__ __forceinline__ __nv_bfloat16 sr_bf16(float x, uint32_t bits16) {
  const uint32_t u = __float_as_uint(x);
  if ((u & 0x7F800000u) == 0x7F800000u) return __float2bfloat16_rn(x);
  const uint32_t r = (u + bits16) & 0xFFFF0000u;
  return __float2bfloat16_rn(__uint_as_float(r));     // exact
}

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(
    __nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(
    float x) {
  return __float2bfloat16_rn(x);
}

// four values of T as one aligned vector
template <typename T> struct Vec4;
template <> struct alignas(16) Vec4<float> { float x[4]; };
template <> struct alignas(8) Vec4<__nv_bfloat16> { __nv_bfloat16 x[4]; };

struct Consts {
  float lr, b1, omb1, b2, omb2, eps, bc1, bc2;
};

template <typename PT, typename MT, int MODE>
__device__ __forceinline__ void update_one(float g, PT p, MT m, MT v,
                                           const Consts& c, uint32_t bits,
                                           PT* po, MT* mo, MT* vo) {
  const float m2 = __fadd_rn(__fmul_rn(c.b1, to_f32(m)), __fmul_rn(c.omb1, g));
  const float v2 = __fadd_rn(__fmul_rn(c.b2, to_f32(v)),
                             __fmul_rn(__fmul_rn(c.omb2, g), g));
  const float upd = __fdiv_rn(
      __fmul_rn(c.lr, __fdiv_rn(m2, c.bc1)),
      __fadd_rn(__fsqrt_rn(__fdiv_rn(v2, c.bc2)), c.eps));
  *po = from_f32<PT>(__fsub_rn(to_f32(p), upd));
  if constexpr (MODE == MODE_BF16_SR) {
    *mo = sr_bf16(m2, bits & 0xFFFFu);
    *vo = sr_bf16(v2, bits >> 16);
  } else {
    *mo = from_f32<MT>(m2);
    *vo = from_f32<MT>(v2);
  }
}

template <typename PT, typename MT, int MODE>
__global__ void __launch_bounds__(TPB) fused_adam_kernel(
    const float* __restrict__ g, const PT* __restrict__ p,
    const MT* __restrict__ m, const MT* __restrict__ v, PT* __restrict__ po,
    MT* __restrict__ mo, MT* __restrict__ vo,
    const long long* __restrict__ count, long long n, uint32_t leaf, float lr,
    float b1, float omb1, float b2, float omb2, float eps, float log_b1,
    float log_b2) {
  const long long step = *count;
  const float t = (float)step;
  Consts c{lr, b1, omb1, b2, omb2, eps,
           __fsub_rn(1.f, expf(__fmul_rn(t, log_b1))),
           __fsub_rn(1.f, expf(__fmul_rn(t, log_b2)))};
  const uint32_t seed = ((uint32_t)step * 2654435761u) & 0x7FFFFFFFu;
  const long long groups = (n + 3) / 4;
  for (long long q = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       q < groups; q += (long long)gridDim.x * blockDim.x) {
    Philox r{};
    if (MODE == MODE_BF16_SR)
      r = philox4x32_10((uint32_t)q, (uint32_t)(q >> 32), seed, leaf);
    const long long i0 = q * 4;
    if (i0 + 3 < n) {
      const Vec4<float> gv = *reinterpret_cast<const Vec4<float>*>(g + i0);
      const Vec4<PT> pv = *reinterpret_cast<const Vec4<PT>*>(p + i0);
      const Vec4<MT> mv = *reinterpret_cast<const Vec4<MT>*>(m + i0);
      const Vec4<MT> vv = *reinterpret_cast<const Vec4<MT>*>(v + i0);
      Vec4<PT> pn;
      Vec4<MT> mn, vn;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        update_one<PT, MT, MODE>(gv.x[j], pv.x[j], mv.x[j], vv.x[j], c,
                                 r.v[j], &pn.x[j], &mn.x[j], &vn.x[j]);
      *reinterpret_cast<Vec4<PT>*>(po + i0) = pn;
      *reinterpret_cast<Vec4<MT>*>(mo + i0) = mn;
      *reinterpret_cast<Vec4<MT>*>(vo + i0) = vn;
    } else {
      for (int j = 0; j < 4 && i0 + j < n; ++j)
        update_one<PT, MT, MODE>(g[i0 + j], p[i0 + j], m[i0 + j], v[i0 + j],
                                 c, r.v[j], po + i0 + j, mo + i0 + j,
                                 vo + i0 + j);
    }
  }
}

template <typename PT, typename MT, int MODE>
int launch(const void* g, const void* p, const void* m, const void* v,
           void* po, void* mo, void* vo, const void* count, long long n,
           int leaf, float lr, float b1, float omb1, float b2, float omb2,
           float eps, float log_b1, float log_b2, cudaStream_t st) {
  const long long groups = (n + 3) / 4;
  long long blocks = (groups + TPB - 1) / TPB;
  if (blocks > 132 * 16) blocks = 132 * 16;
  fused_adam_kernel<PT, MT, MODE><<<(unsigned)blocks, TPB, 0, st>>>(
      (const float*)g, (const PT*)p, (const MT*)m, (const MT*)v, (PT*)po,
      (MT*)mo, (MT*)vo, (const long long*)count, n, (uint32_t)leaf, lr, b1,
      omb1, b2, omb2, eps, log_b1, log_b2);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* fused_adam_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// g: float32 grads; p/po: params (param_type 0 float32, 1 bfloat16); m, v,
// mo, vo: moments (mode 0 float32; 1 bfloat16 round-to-nearest; 2 bfloat16
// stochastic); count: device int64 step number t >= 1; n elements; every
// pointer 16-byte aligned.  Returns 0, the cudaGetLastError() code, or
// cudaErrorInvalidValue for an unknown param_type / mode.
int fused_adam_step(const void* g, const void* p, const void* m,
                    const void* v, void* po, void* mo, void* vo,
                    const void* count, long long n, int param_type, int mode,
                    int leaf, float lr, float b1, float omb1, float b2,
                    float omb2, float eps, float log_b1, float log_b2,
                    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
#define ARGS g, p, m, v, po, mo, vo, count, n, leaf, lr, b1, omb1, b2, omb2, \
             eps, log_b1, log_b2, st
  typedef __nv_bfloat16 bf16;
  if (param_type == 0 && mode == MODE_F32)
    return launch<float, float, MODE_F32>(ARGS);
  if (param_type == 0 && mode == MODE_BF16_RN)
    return launch<float, bf16, MODE_BF16_RN>(ARGS);
  if (param_type == 0 && mode == MODE_BF16_SR)
    return launch<float, bf16, MODE_BF16_SR>(ARGS);
  if (param_type == 1 && mode == MODE_F32)
    return launch<bf16, float, MODE_F32>(ARGS);
  if (param_type == 1 && mode == MODE_BF16_RN)
    return launch<bf16, bf16, MODE_BF16_RN>(ARGS);
  if (param_type == 1 && mode == MODE_BF16_SR)
    return launch<bf16, bf16, MODE_BF16_SR>(ARGS);
#undef ARGS
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"

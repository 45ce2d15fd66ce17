// fused_adam.cu — one fused Adam step over a whole list of tensors in ONE
// launch, with float32 or bfloat16 moments and stochastic rounding (Hopper).
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
// Here Philox 4x32-10 is keyed by (that seed, the leaf's index in the list)
// and counted by the element index / 4 inside the leaf: one call gives four
// elements their 32 bits each (low 16 for m, high 16 for v).
//
// Bound: bytes.  Per element the f32 mode reads g, p, m, v and writes p, m,
// v: 28 B; the bf16 modes 20 B.  A launch per tensor made the call's time
// the host's dispatch, not the bytes.  So the list's pointers, sizes and
// chunk offsets travel in a table passed by value as a kernel parameter
// (no device allocation, no copy), the grid has one block per CHUNK elements
// of any leaf, and a block finds its (leaf, chunk) by a short scan of the
// table's running chunk counts.  Four elements per thread move as 16-byte
// loads and stores (8-byte for bfloat16), streaming (__ldcs / __stcs: every
// byte is touched once), with a scalar path for a leaf's tail; no padding.

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

// Up to MAX_TENSORS leaves of one launch.  first[s] is the index of leaf s's
// first block; first[k] the grid size.  The planning (sizes -> chunks) is the
// wrapper's (`plan_launches` in fused_adam.py); these two constants mirror
// its MAX_TENSORS and CHUNK.
constexpr int MAX_TENSORS = 24;
constexpr int CHUNK = 4096;            // elements per block
constexpr int GROUPS = CHUNK / 4 / TPB;  // 4-element groups per thread

struct Table {
  const void *g[MAX_TENSORS], *p[MAX_TENSORS], *m[MAX_TENSORS],
      *v[MAX_TENSORS];
  void *po[MAX_TENSORS], *mo[MAX_TENSORS], *vo[MAX_TENSORS];
  long long n[MAX_TENSORS];
  int first[MAX_TENSORS + 1];
  int leaf[MAX_TENSORS];
  int k;
};

// four values of T moved as one streaming access
template <typename T> __device__ __forceinline__ Vec4<T> load4(const T* p);
template <> __device__ __forceinline__ Vec4<float> load4<float>(
    const float* p) {
  const float4 x = __ldcs(reinterpret_cast<const float4*>(p));
  return Vec4<float>{{x.x, x.y, x.z, x.w}};
}
template <> __device__ __forceinline__ Vec4<__nv_bfloat16>
load4<__nv_bfloat16>(const __nv_bfloat16* p) {
  const uint2 x = __ldcs(reinterpret_cast<const uint2*>(p));
  Vec4<__nv_bfloat16> out;
  *reinterpret_cast<uint2*>(&out) = x;
  return out;
}
__device__ __forceinline__ void store4(float* p, const Vec4<float>& x) {
  __stcs(reinterpret_cast<float4*>(p),
         make_float4(x.x[0], x.x[1], x.x[2], x.x[3]));
}
__device__ __forceinline__ void store4(__nv_bfloat16* p,
                                       const Vec4<__nv_bfloat16>& x) {
  __stcs(reinterpret_cast<uint2*>(p), *reinterpret_cast<const uint2*>(&x));
}

template <typename PT, typename MT, int MODE>
__global__ void __launch_bounds__(TPB) fused_adam_kernel(
    __grid_constant__ const Table tab, const long long* __restrict__ count,
    float lr, float b1, float omb1, float b2, float omb2, float eps,
    float log_b1, float log_b2) {
  int s = 0;
  while (s + 1 < tab.k && (int)blockIdx.x >= tab.first[s + 1]) ++s;
  const long long n = tab.n[s];
  const float* g = (const float*)tab.g[s];
  const PT* p = (const PT*)tab.p[s];
  const MT* m = (const MT*)tab.m[s];
  const MT* v = (const MT*)tab.v[s];
  PT* po = (PT*)tab.po[s];
  MT* mo = (MT*)tab.mo[s];
  MT* vo = (MT*)tab.vo[s];
  const uint32_t leaf = (uint32_t)tab.leaf[s];

  const long long step = *count;
  const float t = (float)step;
  Consts c{lr, b1, omb1, b2, omb2, eps,
           __fsub_rn(1.f, expf(__fmul_rn(t, log_b1))),
           __fsub_rn(1.f, expf(__fmul_rn(t, log_b2)))};
  const uint32_t seed = ((uint32_t)step * 2654435761u) & 0x7FFFFFFFu;
  const long long q0 =
      (long long)((int)blockIdx.x - tab.first[s]) * (CHUNK / 4);
#pragma unroll
  for (int it = 0; it < GROUPS; ++it) {
    const long long q = q0 + it * TPB + threadIdx.x;
    const long long i0 = q * 4;
    if (i0 >= n) break;
    Philox r{};
    if (MODE == MODE_BF16_SR)
      r = philox4x32_10((uint32_t)q, (uint32_t)(q >> 32), seed, leaf);
    if (i0 + 3 < n) {
      const Vec4<float> gv = load4(g + i0);
      const Vec4<PT> pv = load4(p + i0);
      const Vec4<MT> mv = load4(m + i0);
      const Vec4<MT> vv = load4(v + i0);
      Vec4<PT> pn;
      Vec4<MT> mn, vn;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        update_one<PT, MT, MODE>(gv.x[j], pv.x[j], mv.x[j], vv.x[j], c,
                                 r.v[j], &pn.x[j], &mn.x[j], &vn.x[j]);
      store4(po + i0, pn);
      store4(mo + i0, mn);
      store4(vo + i0, vn);
    } else {
      for (int j = 0; j < 4 && i0 + j < n; ++j)
        update_one<PT, MT, MODE>(g[i0 + j], p[i0 + j], m[i0 + j], v[i0 + j],
                                 c, r.v[j], po + i0 + j, mo + i0 + j,
                                 vo + i0 + j);
    }
  }
}

template <typename PT, typename MT, int MODE>
int launch(const Table& tab, const void* count, float lr, float b1,
           float omb1, float b2, float omb2, float eps, float log_b1,
           float log_b2, cudaStream_t st) {
  fused_adam_kernel<PT, MT, MODE><<<(unsigned)tab.first[tab.k], TPB, 0, st>>>(
      tab, (const long long*)count, lr, b1, omb1, b2, omb2, eps, log_b1,
      log_b2);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* fused_adam_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int fused_adam_max_tensors() { return MAX_TENSORS; }
int fused_adam_chunk() { return CHUNK; }

// One launch over k <= MAX_TENSORS non-empty leaves.  g: float32 grads;
// p/po: params (param_type 0 float32, 1 bfloat16); m, v, mo, vo: moments
// (mode 0 float32; 1 bfloat16 round-to-nearest; 2 bfloat16 stochastic), the
// same types for every leaf; n[s] elements, first[s] the leaf's first block
// (first[k] the grid size), leaf[s] its index in the caller's list (the
// Philox key); count: device int64 step number t >= 1; every pointer
// 16-byte aligned.  Returns 0, the cudaGetLastError() code, or
// cudaErrorInvalidValue for k out of range or an unknown param_type / mode.
int fused_adam_list(int k, void* const* g, void* const* p, void* const* m,
                    void* const* v, void* const* po, void* const* mo,
                    void* const* vo, const long long* n, const int* first,
                    const int* leaf, const void* count, int param_type,
                    int mode, float lr, float b1, float omb1, float b2,
                    float omb2, float eps, float log_b1, float log_b2,
                    void* stream) {
  if (k < 1 || k > MAX_TENSORS) return (int)cudaErrorInvalidValue;
  Table tab{};
  for (int s = 0; s < k; ++s) {
    tab.g[s] = g[s]; tab.p[s] = p[s]; tab.m[s] = m[s]; tab.v[s] = v[s];
    tab.po[s] = po[s]; tab.mo[s] = mo[s]; tab.vo[s] = vo[s];
    tab.n[s] = n[s]; tab.first[s] = first[s]; tab.leaf[s] = leaf[s];
  }
  tab.first[k] = first[k];
  tab.k = k;
  cudaStream_t st = (cudaStream_t)stream;
#define ARGS tab, count, lr, b1, omb1, b2, omb2, eps, log_b1, log_b2, st
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

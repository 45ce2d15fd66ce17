// mlp_kernels.cuh — the device code the port's fused MLP pipelines share:
// one strided, batched, tiled SIMT GEMM with fused epilogues, a column sum
// and an optax-ordered Adam pass (fused_sweep.cu), and the per-element Adam
// update and the head's constants that fused_dstep.cu and mma_tf32.cuh use
// too.  No tensor cores here (mma_tf32.cuh has them), no library GEMM.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64, BN = 64, BK = 16, TPB = 256;
// GEMM epilogues: plain store | + bias | + bias, C = z and H = lrelu(z) |
// * lrelu'(Zaux) | + bias, C = tanh(z) | * (1 - Zaux^2) (tanh derivative
// from the tanh's output)
constexpr int EPI_STORE = 0, EPI_BIAS = 1, EPI_BIAS_LRELU = 2,
              EPI_LRELU_GRAD = 3, EPI_BIAS_TANH = 4, EPI_TANH_GRAD = 5;
// the reference clips probabilities to [1e-12, 1 - 1e-7] in float32
constexpr float P_LO = 1e-12f;
constexpr float P_HI = (float)(1.0 - 1e-7);

// C[b] (M x N, row-major, ld N) = A[b] (M x K) * B[b] (K x N) + epilogue.
// Operands are addressed through strides, so one kernel serves X W
// (NN), A^T G (TN) and G W^T (NT).  A_K_CONTIG / B_N_CONTIG say which index
// is contiguous in memory, so tile loads stay coalesced.
template <bool A_K_CONTIG, bool B_N_CONTIG, int EPI>
__global__ void __launch_bounds__(TPB) gemm_kernel(
    int M, int N, int K,
    const float* __restrict__ A, long long sAb, long long sAm, long long sAk,
    const float* __restrict__ Bm, long long sBb, long long sBk, long long sBn,
    float* __restrict__ C, long long sCb,
    const float* __restrict__ bias, long long sBiasb,
    float* __restrict__ H, const float* __restrict__ Zaux) {
  __shared__ float As[BK][BM + 4];
  __shared__ float Bs[BK][BN + 4];
  const int b = blockIdx.z;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  A += b * sAb;
  Bm += b * sBb;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int i = tid; i < BM * BK; i += TPB) {
      int kk, mm;
      if (A_K_CONTIG) { kk = i % BK; mm = i / BK; }
      else            { mm = i % BM; kk = i / BM; }
      const int gm = m0 + mm, gk = k0 + kk;
      As[kk][mm] = (gm < M && gk < K) ? A[gm * sAm + gk * sAk] : 0.f;
    }
    for (int i = tid; i < BN * BK; i += TPB) {
      int kk, nn;
      if (B_N_CONTIG) { nn = i % BN; kk = i / BN; }
      else            { kk = i % BK; nn = i / BK; }
      const int gn = n0 + nn, gk = k0 + kk;
      Bs[kk][nn] = (gn < N && gk < K) ? Bm[gk * sBk + gn * sBn] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  const long long cb = b * sCb;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n >= N) continue;
      const long long o = cb + (long long)m * N + n;
      float v = acc[i][j];
      if (EPI == EPI_BIAS || EPI == EPI_BIAS_LRELU || EPI == EPI_BIAS_TANH)
        v += bias[b * sBiasb + n];
      if (EPI == EPI_LRELU_GRAD) v *= (Zaux[o] >= 0.f ? 1.f : 0.2f);
      if (EPI == EPI_TANH_GRAD) v *= 1.f - Zaux[o] * Zaux[o];
      if (EPI == EPI_BIAS_TANH) v = tanhf(v);
      C[o] = v;
      if (EPI == EPI_BIAS_LRELU) H[o] = v >= 0.f ? v : 0.2f * v;
    }
  }
}

// out[w][n] = sum_r G[w][r][n]: grid (ceil(N/TPB), W).
__global__ void colsum_kernel(const float* __restrict__ G,
                              float* __restrict__ out, int R, int N) {
  const int w = blockIdx.y, n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const float* g = G + (long long)w * R * N + n;
  float s = 0.f;
  for (int r = 0; r < R; ++r) s += g[(long long)r * N];
  out[(long long)w * N + n] = s;
}

// The constants of one optax-ordered Adam step (lr negated; omb = 1 - b).
struct AdamConsts {
  float neg_lr, b1, omb1, b2, omb2, eps;
};

// One element's optax-ordered Adam update with the bias corrections
// c1 = 1 - b1^t, c2 = 1 - b2^t.  The _rn intrinsics keep nvcc from
// contracting into FMAs, so the update rounds exactly as the unfused
// formula does.
__device__ __forceinline__ void adam_one(float p, float m, float v, float gg,
                                         float c1, float c2,
                                         const AdamConsts& k, float* po,
                                         float* mo, float* vo) {
  const float mu2 = __fadd_rn(__fmul_rn(k.b1, m), __fmul_rn(k.omb1, gg));
  const float nu2 = __fadd_rn(__fmul_rn(k.b2, v),
                              __fmul_rn(k.omb2, __fmul_rn(gg, gg)));
  const float upd = __fdiv_rn(__fdiv_rn(mu2, c1),
                              __fadd_rn(__fsqrt_rn(__fdiv_rn(nu2, c2)), k.eps));
  *po = __fadd_rn(p, __fmul_rn(k.neg_lr, upd));
  *mo = mu2;
  *vo = nu2;
}

// One Adam update of a (W, n_per) tensor; p/m/v may alias po/mo/vo (each
// element reads, then writes, only its own index).
__global__ void adam_kernel(const float* p, const float* m, const float* v,
                            const float* __restrict__ g, float* po, float* mo,
                            float* vo, long long n_per, int W,
                            const float* __restrict__ cc, int E, int e,
                            float neg_lr, float b1, float omb1, float b2,
                            float omb2, float eps) {
  const long long total = n_per * W;
  const AdamConsts k{neg_lr, b1, omb1, b2, omb2, eps};
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    const int w = (int)(i / n_per);
    const float c1 = cc[(w * E + e) * 2], c2 = cc[(w * E + e) * 2 + 1];
    float pn, mn, vn;
    adam_one(p[i], m[i], v[i], g[i], c1, c2, k, &pn, &mn, &vn);
    po[i] = pn;
    mo[i] = mn;
    vo[i] = vn;
  }
}

inline dim3 gemm_grid(int M, int N, int W) {
  return dim3((N + BN - 1) / BN, (M + BM - 1) / BM, W);
}

}  // namespace

#define CHECK_LAUNCH()                         \
  do {                                         \
    cudaError_t err_ = cudaGetLastError();     \
    if (err_ != cudaSuccess) return (int)err_; \
  } while (0)

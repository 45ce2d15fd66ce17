// mlp_kernels.cuh — the device code the port's fused MLP kernels share: one
// block's 64x64 tile of a strided SIMT matrix product (fused_sweep.cu), and
// the per-element Adam update and the head's constants that fused_dstep.cu
// and mma_tf32.cuh use too.  No tensor cores here (mma_tf32.cuh has them),
// no library GEMM.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64, BN = 64, BK = 16, TPB = 256;
// the reference clips probabilities to [1e-12, 1 - 1e-7] in float32
constexpr float P_LO = 1e-12f;
constexpr float P_HI = (float)(1.0 - 1e-7);

// A load through L2 only.  A kernel that runs a whole pipeline in one launch
// reads what other blocks wrote earlier in the same launch; the read-only
// path (LDG.NC) and L1 need not see those writes, L2 does once a barrier
// has ordered them.
__device__ __forceinline__ float ld(const float* p) { return __ldcg(p); }

// One product C (M x N) = A (M x K) * B (K x N), addressed through strides
// so that one loop serves X W (NN), G W^T (NT) and A^T G (TN): element (m, k)
// of A is at a[m * sam + k * sak], except that rows m >= split come from a2
// (row m - split), so that two inputs of one layer go through in one pass;
// element (k, n) of B is at b[k * sbk + n * sbn].
struct Gemm {
  int M, N, K;
  const float *a, *a2;
  int split;
  long long sam, sak;
  const float* b;
  long long sbk, sbn;
};

// Two 16-deep slabs of A and B: one is summed while the next is stored.
struct TileSmem {
  __align__(16) float As[2][BK][BM + 4];
  __align__(16) float Bs[2][BK][BN + 4];
};

__device__ __forceinline__ int tile_count(int M, int N) {
  return ((M + BM - 1) / BM) * ((N + BN - 1) / BN);
}

// The block's 256 threads sum tile (m0, n0) of g into acc: thread (ty, tx)
// = (tid / 16, tid % 16) holds rows m0 + 4 ty + i and columns n0 + 4 tx + j.
// Edges are masked (zero-filled loads).  Each 16-deep slab of A and B is
// loaded into registers while the previous one is summed from shared memory
// (two buffers, one barrier a slab); a thread reads its 4 rows and 4 columns
// of a slab step as two 16-byte loads.  A_K_CONTIG / B_N_CONTIG say which
// index is contiguous in memory, so that neighbouring threads load
// neighbouring addresses.
template <bool A_K_CONTIG, bool B_N_CONTIG>
__device__ __forceinline__ void tile_product(const Gemm& g, int m0, int n0,
                                             TileSmem& s,
                                             float (&acc)[4][4]) {
  constexpr int PER = BM * BK / TPB;     // elements of a slab a thread loads
  static_assert(BM == 64 && BN == 64 && PER * TPB == BM * BK,
                "64x64 tiles, whole slabs a thread");
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  // Element q of a thread's share of a slab: A at (am[q], k0 + ak[q]), B at
  // (k0 + bk[q], bn[q]).  The row / column start is fixed for the tile, so
  // only the k offset moves from slab to slab.
  int am[PER], ak[PER], bn[PER], bk[PER];
  const float* arow[PER];
  const float* bcol[PER];
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    const int i = tid + q * TPB;
    if (A_K_CONTIG) { ak[q] = i % BK; am[q] = i / BK; }
    else            { am[q] = i % BM; ak[q] = i / BM; }
    if (B_N_CONTIG) { bn[q] = i % BN; bk[q] = i / BN; }
    else            { bk[q] = i % BK; bn[q] = i / BK; }
    const int gm = m0 + am[q], gn = n0 + bn[q];
    arow[q] = gm >= g.M ? nullptr
              : gm < g.split ? g.a + gm * g.sam
                             : g.a2 + (gm - g.split) * g.sam;
    bcol[q] = gn < g.N ? g.b + gn * g.sbn : nullptr;
  }
  float ra[PER], rb[PER];
  auto load = [&](int k0) {
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      const int ka = k0 + ak[q], kb = k0 + bk[q];
      ra[q] = arow[q] && ka < g.K ? ld(arow[q] + ka * g.sak) : 0.f;
      rb[q] = bcol[q] && kb < g.K ? ld(bcol[q] + kb * g.sbk) : 0.f;
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      s.As[buf][ak[q]][am[q]] = ra[q];
      s.Bs[buf][bk[q]][bn[q]] = rb[q];
    }
  };

  const int nk = (g.K + BK - 1) / BK;
  load(0);
  store(0);
  __syncthreads();
  for (int t = 0; t < nk; ++t) {
    const int buf = t & 1;
    if (t + 1 < nk) load((t + 1) * BK);
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a4 = *reinterpret_cast<const float4*>(&s.As[buf][kk][4 * ty]);
      const float4 b4 = *reinterpret_cast<const float4*>(&s.Bs[buf][kk][4 * tx]);
      const float a[4] = {a4.x, a4.y, a4.z, a4.w};
      const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    if (t + 1 < nk) store(buf ^ 1);
    __syncthreads();
  }
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

}  // namespace

#define CHECK_LAUNCH()                         \
  do {                                         \
    cudaError_t err_ = cudaGetLastError();     \
    if (err_ != cudaSuccess) return (int)err_; \
  } while (0)

// mma_tf32.cuh — a batched float32-grade GEMM on Hopper's tensor cores for
// the fused MLP pipelines (fused_dstep.cu), with the epilogues a training
// step needs: bias + LeakyReLU, x LeakyReLU', and Adam on the tile; and its
// bfloat16-operand variant (template flag BF), for the bf16-state mode.
//
// Arithmetic: 3xTF32.  Each float32 operand is split in registers as
//   hi = tf32(x) (round to nearest, ties away), lo = the TF32 part of x - hi
// and a product a*b is accumulated in float32 as a_lo*b_hi + a_hi*b_lo +
// a_hi*b_hi; the a_lo*b_lo term (2^-22 of the product) is dropped.  One
// TF32 pass alone keeps ~3 digits; three passes keep float32's.  Each
// 32-deep slab is summed on the tensor cores from zero and then added to
// the running sum with a rounded float32 add (the tensor cores' own
// accumulation truncates).
// bfloat16 operands (BF = true; replaces the Pallas kernel's mxu_bf16 dots,
// cglgan_tpu/ops/pallas/fused_dstep.py:68-74): the shared-memory tiles stay
// float32 as they are, each A and B fragment is rounded to bfloat16 in
// registers (cvt.rn.bf16x2.f32, round to nearest even, two values to a
// register), and one mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32
// takes a 16-deep step where the float32 path takes two 8-deep steps of
// three TF32 passes.  A product of two bfloat16 values is exact in float32,
// so this is a bfloat16-input product with float32 sums, as on the TPU's
// MXU; the slab-by-slab float32 summation below is the same.
//
// Instruction: mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32.  Its
// fragments are read from shared memory with plain 32-bit loads, so the same
// kernel serves all three products of a dense layer without a transposing
// copy:  X W (A k-contiguous, B n-contiguous),  G W^T (B k-contiguous) and
// A^T G (A m-contiguous).  (wgmma takes 32-bit operands k-major only.)
//
// Tiling: a block of 8 warps owns a 64 x 128 tile of C[w] (blockIdx.z = w);
// a warp a 32 x 32 part (2 x 4 mma tiles, 32 + 32 accumulators a thread).  The
// k-slabs are 32 deep and come through a ring of three shared-memory stages
// filled by cp.async (16 bytes, .cg); tiles keep their global layout, with
// row strides of 36 or 72 / 136 floats so that the fragment loads of a warp
// hit 32 different banks.  Ragged sizes: loads beyond M, N or K are
// zero-filled (cp.async's src-size), stores are masked, 16-row mma tile rows
// that lie wholly outside C and 8-deep k-steps beyond K are skipped (columns
// beyond N inside a warp's part are computed on zeros); an operand whose
// rows are not 16-byte aligned is copied 4 bytes at a time.  With M = 200
// (12.5 x 16) four 64-row tiles run 13 of their 16 mma rows: 4% of the
// tensor work is padding, not 22%.
//
// What bounds it (measured with kernel_probe.py on an NVIDIA H100 80GB HBM3
// at a 700 W power limit): mma.sync runs at 65% of the card's dense TF32
// rate, and an mma holds its scheduler's dispatch slot while it runs, so the
// operand loads, the splits and the mma of a warp add up instead of
// overlapping.  The inner loop is
// therefore straight-line code (compile-time shapes, no test around an mma)
// and does as little as it can beside the mma; it runs within 10% of what
// the same loop reaches with no memory traffic.  What is left beside it:
// the cp.async copies (a quarter of X W's time: they do not hide behind the
// mma either) and, in the weight-gradient kernel, the Adam traffic.
//
// EPI_ADAM (the weight gradient A^T G): the block that holds a dW tile in
// its accumulators passes it through shared memory (so that a warp reads
// and writes whole rows, 16 bytes a thread), reads p, m, v of that tile,
// applies the optax-ordered update with the client's bias corrections and
// writes p, m, v; dW never reaches device memory.  The bias gradient is the
// column sum of the same G slabs as they pass through shared memory: the
// blocks of the first m-tile add them up (one thread a column, fixed order,
// no atomics) and update the bias.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "mlp_kernels.cuh"

namespace {
namespace tc {

// a block's warps (WARPS_M x WARPS_N), a warp's mma tiles (MT of 16 rows x NT
// of 8 columns) and how many of its MT tile rows share one pass over a slab
constexpr int WARPS_M = 2, WARPS_N = 4, MT = 2, NT = 4, PASS_MT = 2;
constexpr int MIN_BLOCKS = 2;         // blocks an SM should hold
constexpr int BM = WARPS_M * MT * 16, BN = WARPS_N * NT * 8;
constexpr int BK = 32, STAGES = 3, THREADS = 32 * WARPS_M * WARPS_N;
static_assert(MT % PASS_MT == 0, "passes must divide a warp's tile rows");
static_assert(THREADS >= BN, "one thread a column sums the bias gradient");
constexpr int EPI_BIAS_LRELU = 0, EPI_LRELU_GRAD = 1, EPI_ADAM = 2;

struct GemmArgs {
  int M, N, K;
  // operands of client w start at A + w*sA, B + w*sB; ld = row stride;
  // vec = rows are 16-byte aligned
  const float* A;
  long long sA;
  int ldA, vecA;
  const float* B;
  long long sB;
  int ldB, vecB;
  // EPI_BIAS_LRELU: out = lrelu(acc + bias[w][n]);
  // EPI_LRELU_GRAD: out = acc * lrelu'(aux)   (aux = the layer's output h:
  //   lrelu keeps the sign, so h >= 0 exactly where its pre-activation is)
  float* out;
  const float* bias;
  const float* aux;
  // EPI_ADAM: weight (W, M, N) and bias (W, N) state; in may alias out
  const float *p, *m, *v;
  float *po, *mo, *vo;
  const float *bp, *bm, *bv;
  float *bpo, *bmo, *bvo;
  const float* cc;   // (W, E, 2) bias corrections
  int E, e;
  AdamConsts k;
};

template <bool A_KC, bool B_NC> struct Smem {
  static constexpr int AS = A_KC ? BK + 4 : BM + 8;      // row strides
  static constexpr int BS = B_NC ? BN + 8 : BK + 4;
  static constexpr int AT = (A_KC ? BM : BK) * AS;       // floats per tile
  static constexpr int BT = (B_NC ? BK : BN) * BS;
  static constexpr int STAGE = AT + BT;
  static constexpr int BYTES = STAGES * STAGE * (int)sizeof(float);
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int bytes) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x = hi + lo + O(2^-22 x): hi = x rounded to TF32 (nearest, ties away, as
// cvt.rna.tf32.f32 rounds a finite value; done as an integer add and mask
// on the bit pattern, because the conversion instruction runs at a
// fraction of the integer rate);
// lo = x - hi, exact in float32, handed to the tensor cores as it is: they
// read only the TF32 part of an operand (sign, exponent, 10 mantissa bits).
__device__ __forceinline__ void split_tf32(float x, uint32_t* hi,
                                           uint32_t* lo) {
  *hi = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  *lo = __float_as_uint(__fsub_rn(x, __uint_as_float(*hi)));
}

// two float32 values rounded to nearest-even bfloat16 and packed, `lo` in
// the low half (the lower k index of an mma fragment register)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t d;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(d) : "f"(hi), "f"(lo));
  return d;
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Copy ROWS x COLS floats (COLS contiguous in device memory, row stride ld)
// starting at (r0, c0) of an nrows x ncols matrix into shared memory with
// row stride STRIDE; what lies outside the matrix becomes 0.
template <int ROWS, int COLS, int STRIDE>
__device__ __forceinline__ void load_tile(float* s, const float* g, int ld,
                                          int r0, int c0, int nrows,
                                          int ncols, bool vec, int tid) {
  constexpr int CH = COLS / 4;
  static_assert((ROWS * CH) % THREADS == 0, "tile must divide over threads");
#pragma unroll
  for (int i = tid; i < ROWS * CH; i += THREADS) {
    const int r = i / CH, c = (i % CH) * 4;
    float* dst = s + r * STRIDE + c;
    const int gr = r0 + r, gc = c0 + c;
    const float* src = g + (long long)gr * ld + gc;
    if (vec) {
      const int n = gr < nrows ? min(max(ncols - gc, 0), 4) : 0;
      cp_async16(dst, n ? src : g, n * 4);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = gr < nrows && gc + j < ncols;
        cp_async4(dst + j, ok ? src + j : g, ok ? 4 : 0);
      }
    }
  }
}

// The first KS k-steps (of 8) of one slab: the products of NR of a warp's
// tile rows, from row i0 on, added to its accumulators.  Straight-line code:
// KS and NR are compile-time, because a test around an mma makes the
// compiler guard each one with a warp synchronisation and a branch, and
// those cost more than the mma.
//
// The tensor cores add into their float32 accumulator with truncation; over
// a long k that bias is several times float32's own rounding.  So a slab's
// products are summed on the tensor cores from zero and the slab's sum is
// added to the running sum by a rounded float32 add.
template <bool A_KC, bool B_NC, int KS, int NR, bool BF>
__device__ __forceinline__ void slab_mma(const float* As, const float* Bs,
                                         int i0, int wm, int wn, int g, int t,
                                         float (&acc)[MT][NT][4]) {
  using S = Smem<A_KC, B_NC>;
  float part[NR][NT][4];
#pragma unroll
  for (int i = 0; i < NR; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) part[i][j][c] = 0.f;
  // element (r, k) of A and (k, n) of B in the slab's float32 tiles
  auto a_at = [&](int r, int k) {
    return A_KC ? As[r * S::AS + k] : As[k * S::AS + r];
  };
  auto b_at = [&](int k, int n) {
    return B_NC ? Bs[k * S::BS + n] : Bs[n * S::BS + k];
  };
  if constexpr (BF) {
    // 16-deep steps; k beyond the KS 8-deep steps inside K is zero in the
    // slab (zero-filled loads), so an odd KS ends on a half-empty step.
    // Registers: A {row g | g+8} x {k 2t, 2t+1 | 2t+8, 2t+9}, B {k 2t,
    // 2t+1 | 2t+8, 2t+9} x column g, the lower k in the low half.
#pragma unroll
    for (int kk = 0; kk < KS * 8; kk += 16) {
      uint32_t a[NR][4], b[NT][2];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int n = wn + j * 8 + g;
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int k = kk + 2 * t + c * 8;
          b[j][c] = pack_bf16(b_at(k, n), b_at(k + 1, n));
        }
      }
#pragma unroll
      for (int i = 0; i < NR; ++i) {
        const int r = wm + (i0 + i) * 16 + g;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int mm = r + (c & 1) * 8, k = kk + 2 * t + (c >> 1) * 8;
          a[i][c] = pack_bf16(a_at(mm, k), a_at(mm, k + 1));
        }
      }
#pragma unroll
      for (int i = 0; i < NR; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_bf16(part[i][j], a[i], b[j]);
    }
  } else {
#pragma unroll
    for (int kk = 0; kk < KS * 8; kk += 8) {
      uint32_t ah[NR][4], al[NR][4], bh[NT][2], bl[NT][2];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int n = wn + j * 8 + g;
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int k = kk + t + c * 4;
          const float x = B_NC ? Bs[k * S::BS + n] : Bs[n * S::BS + k];
          split_tf32(x, &bh[j][c], &bl[j][c]);
        }
      }
#pragma unroll
      for (int i = 0; i < NR; ++i) {
        const int r = wm + (i0 + i) * 16 + g;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int mm = r + (c & 1) * 8, k = kk + t + (c >> 1) * 4;
          const float x = A_KC ? As[mm * S::AS + k] : As[k * S::AS + mm];
          split_tf32(x, &ah[i][c], &al[i][c]);
        }
      }
      // term by term over the tiles, small terms first: the three mma of one
      // tile depend on each other, those of a term do not
#pragma unroll
      for (int term = 0; term < 3; ++term)
#pragma unroll
        for (int i = 0; i < NR; ++i)
#pragma unroll
          for (int j = 0; j < NT; ++j)
            mma_tf32(part[i][j], term == 0 ? al[i] : ah[i],
                     term == 1 ? bl[j] : bh[j]);
    }
  }
#pragma unroll
  for (int i = 0; i < NR; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i0 + i][j][c] += part[i][j][c];
}

// A warp's share of one slab: `rows` of its MT tile rows lie inside C and
// `ks` of the slab's k-steps inside K (both warp-uniform).  All rows:
// PASS_MT at a time; fewer (the last tile row of C): one at a time.
template <bool A_KC, bool B_NC, bool BF, int KS = BK / 8>
__device__ __forceinline__ void warp_slab(const float* As, const float* Bs,
                                          int ks, int rows, int wm, int wn,
                                          int g, int t,
                                          float (&acc)[MT][NT][4]) {
  if (ks != KS) {
    if constexpr (KS > 1)
      warp_slab<A_KC, B_NC, BF, KS - 1>(As, Bs, ks, rows, wm, wn, g, t, acc);
    return;
  }
  if (rows == MT) {
#pragma unroll
    for (int i0 = 0; i0 < MT; i0 += PASS_MT)
      slab_mma<A_KC, B_NC, KS, PASS_MT, BF>(As, Bs, i0, wm, wn, g, t, acc);
  } else {
#pragma unroll
    for (int i0 = 0; i0 < MT - 1; ++i0)
      if (i0 < rows)
        slab_mma<A_KC, B_NC, KS, 1, BF>(As, Bs, i0, wm, wn, g, t, acc);
  }
}

// C[w] (M x N, row-major) = op(A[w]) op(B[w]) followed by the epilogue.
//   A_KC: A[w] is M x K, k contiguous;  else K x M, m contiguous (A^T G).
//   B_NC: B[w] is K x N, n contiguous;  else N x K, k contiguous (G W^T).
//   BF: bfloat16 operands (rounded in registers), else 3xTF32.
template <bool A_KC, bool B_NC, int EPI, bool BF>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    gemm3x_kernel(__grid_constant__ const GemmArgs a) {
  extern __shared__ __align__(16) float smem[];
  using S = Smem<A_KC, B_NC>;
  const int w = blockIdx.z, m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp / WARPS_N) * (MT * 16), wn = (warp % WARPS_N) * (NT * 8);
  const float* A = a.A + w * a.sA;
  const float* B = a.B + w * a.sB;
  const int nk = (a.K + BK - 1) / BK;

  auto load = [&](int stage, int kt) {
    float* As = smem + stage * S::STAGE;
    float* Bs = As + S::AT;
    const int k0 = kt * BK;
    if constexpr (A_KC)
      load_tile<BM, BK, S::AS>(As, A, a.ldA, m0, k0, a.M, a.K, a.vecA, tid);
    else
      load_tile<BK, BM, S::AS>(As, A, a.ldA, k0, m0, a.K, a.M, a.vecA, tid);
    if constexpr (B_NC)
      load_tile<BK, BN, S::BS>(Bs, B, a.ldB, k0, n0, a.K, a.N, a.vecB, tid);
    else
      load_tile<BN, BK, S::BS>(Bs, B, a.ldB, n0, k0, a.N, a.K, a.vecB, tid);
  };

  // the warp's tile rows that lie inside C (none if its columns lie outside;
  // columns beyond N inside a warp's part are computed on zeros and masked)
  const int rows =
      n0 + wn < a.N ? min(max((a.M - m0 - wm + 15) / 16, 0), MT) : 0;

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;
  float bsum = 0.f;                 // EPI_ADAM: column sum of B (bias grad)

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();    // slab kt has landed
    __syncthreads();                // ... for every thread; slab kt-1 is free
    if (kt + STAGES - 1 < nk) load((kt + STAGES - 1) % STAGES, kt + STAGES - 1);
    cp_async_commit();

    const float* As = smem + (kt % STAGES) * S::STAGE;
    const float* Bs = As + S::AT;
    const int kleft = a.K - kt * BK;
    if (rows > 0)
      warp_slab<A_KC, B_NC, BF>(As, Bs, min(BK, kleft + 7) / 8, rows, wm, wn,
                                g, t, acc);
    if (EPI == EPI_ADAM && B_NC && blockIdx.y == 0 && tid < BN) {
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) bsum += Bs[kk * S::BS + tid];
    }
  }

  // ---- epilogue: a thread holds two adjacent columns of four rows ----
  float c1 = 0.f, c2 = 0.f;
  if (EPI == EPI_ADAM) {
    c1 = a.cc[(w * a.E + a.e) * 2];
    c2 = a.cc[(w * a.E + a.e) * 2 + 1];
  }
  const bool pair = a.N % 2 == 0;   // then every (row, even col) is 8-byte aligned
  const long long cb = (long long)w * a.M * a.N;
  // element (i, j, h): rows g, g+8 of mma tile i, columns 2t, 2t+1 of tile j
  auto offset = [&](int i, int j, int h, int* col) -> long long {
    const int row = m0 + wm + i * 16 + g + h * 8;
    *col = n0 + wn + j * 8 + 2 * t;
    if (row >= a.M || *col >= a.N) return -1;
    return cb + (long long)row * a.N + *col;
  };
  if (EPI == EPI_ADAM) {
    // The dW tile goes through shared memory (the slabs' stages are free
    // now), so that a warp reads and writes whole rows of p, m, v: 512
    // contiguous bytes an access instead of eight 32-byte pieces of eight
    // rows.  The update moves 24 bytes per element of W and is the larger
    // part of this kernel's time.
    constexpr int CS = BN + 8;             // row stride: conflict-free float2
    static_assert(BM * CS <= STAGES * S::STAGE, "C tile fits the stages");
    cp_async_wait<0>();
    __syncthreads();                       // every warp has left the slabs
    float* Cs = smem;
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<float2*>(
              Cs + (wm + i * 16 + g + h * 8) * CS + wn + j * 8 + 2 * t) =
              make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
    __syncthreads();
    if (a.N % 4 == 0) {                    // rows are 16-byte aligned
      constexpr int PER = BM * BN / 4 / THREADS, BATCH = 4;
      static_assert(PER % BATCH == 0, "tile divides into batches");
      // a batch's loads are started before its first store: p, m, v may
      // alias po, mo, vo, so the compiler cannot move them up itself
#pragma unroll
      for (int b0 = 0; b0 < PER; b0 += BATCH) {
        long long o[BATCH];
        float4 p4[BATCH], m4[BATCH], v4[BATCH];
#pragma unroll
        for (int b = 0; b < BATCH; ++b) {
          const int idx = tid + (b0 + b) * THREADS;
          const int row = idx / (BN / 4), col = (idx % (BN / 4)) * 4;
          o[b] = m0 + row < a.M && n0 + col < a.N
                     ? cb + (long long)(m0 + row) * a.N + n0 + col : -1;
          if (o[b] < 0) continue;
          p4[b] = *reinterpret_cast<const float4*>(a.p + o[b]);
          m4[b] = *reinterpret_cast<const float4*>(a.m + o[b]);
          v4[b] = *reinterpret_cast<const float4*>(a.v + o[b]);
        }
#pragma unroll
        for (int b = 0; b < BATCH; ++b) {
          if (o[b] < 0) continue;
          const int idx = tid + (b0 + b) * THREADS;
          const float4 g4 = *reinterpret_cast<const float4*>(
              Cs + (idx / (BN / 4)) * CS + (idx % (BN / 4)) * 4);
          float4 pn, mn, vn;
          adam_one(p4[b].x, m4[b].x, v4[b].x, g4.x, c1, c2, a.k, &pn.x, &mn.x,
                   &vn.x);
          adam_one(p4[b].y, m4[b].y, v4[b].y, g4.y, c1, c2, a.k, &pn.y, &mn.y,
                   &vn.y);
          adam_one(p4[b].z, m4[b].z, v4[b].z, g4.z, c1, c2, a.k, &pn.z, &mn.z,
                   &vn.z);
          adam_one(p4[b].w, m4[b].w, v4[b].w, g4.w, c1, c2, a.k, &pn.w, &mn.w,
                   &vn.w);
          *reinterpret_cast<float4*>(a.po + o[b]) = pn;
          *reinterpret_cast<float4*>(a.mo + o[b]) = mn;
          *reinterpret_cast<float4*>(a.vo + o[b]) = vn;
        }
      }
    } else {
      for (int idx = tid; idx < BM * BN; idx += THREADS) {
        const int row = idx / BN, col = idx % BN;
        if (m0 + row >= a.M || n0 + col >= a.N) continue;
        const long long o = cb + (long long)(m0 + row) * a.N + n0 + col;
        float pn, mn, vn;
        adam_one(a.p[o], a.m[o], a.v[o], Cs[row * CS + col], c1, c2, a.k, &pn,
                 &mn, &vn);
        a.po[o] = pn;
        a.mo[o] = mn;
        a.vo[o] = vn;
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < MT; ++i) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          int col;
          const long long o = offset(i, j, h, &col);
          if (o < 0) continue;
          float v[2] = {acc[i][j][2 * h], acc[i][j][2 * h + 1]};
          const int cnt = pair ? 2 : (col + 1 < a.N ? 2 : 1);
          if (EPI == EPI_BIAS_LRELU) {
            for (int q = 0; q < cnt; ++q) {
              const float z = v[q] + a.bias[(long long)w * a.N + col + q];
              v[q] = z >= 0.f ? z : 0.2f * z;
            }
          } else {
            float x[2];
            if (pair) {
              const float2 x2 = *reinterpret_cast<const float2*>(a.aux + o);
              x[0] = x2.x;
              x[1] = x2.y;
            } else {
              for (int q = 0; q < cnt; ++q) x[q] = a.aux[o + q];
            }
            for (int q = 0; q < cnt; ++q) v[q] *= x[q] >= 0.f ? 1.f : 0.2f;
          }
          if (pair) {
            *reinterpret_cast<float2*>(a.out + o) = make_float2(v[0], v[1]);
          } else {
            for (int q = 0; q < cnt; ++q) a.out[o + q] = v[q];
          }
        }
      }
    }
  }
  if (EPI == EPI_ADAM && blockIdx.y == 0 && tid < BN && n0 + tid < a.N) {
    const long long o = (long long)w * a.N + n0 + tid;
    float pn, mn, vn;
    adam_one(a.bp[o], a.bm[o], a.bv[o], bsum, c1, c2, a.k, &pn, &mn, &vn);
    a.bpo[o] = pn;
    a.bmo[o] = mn;
    a.bvo[o] = vn;
  }
}

inline bool rows_aligned(const float* p, long long batch_stride, int ld) {
  return (uintptr_t)p % 16 == 0 && batch_stride % 4 == 0 && ld % 4 == 0;
}

// Enqueue one batched product over W clients (bfloat16 operands with BF).
// Returns a cudaError_t code.
template <bool A_KC, bool B_NC, int EPI, bool BF = false>
int launch_gemm3x(GemmArgs a, int W, cudaStream_t st) {
  using S = Smem<A_KC, B_NC>;
  static bool configured[64] = {};      // per device: > 48 KB of dynamic smem
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!configured[dev]) {
    err = cudaFuncSetAttribute(gemm3x_kernel<A_KC, B_NC, EPI, BF>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               S::BYTES);
    if (err != cudaSuccess) return (int)err;
    configured[dev] = true;
  }
  a.vecA = rows_aligned(a.A, a.sA, a.ldA);
  a.vecB = rows_aligned(a.B, a.sB, a.ldB);
  const dim3 grid((a.N + BN - 1) / BN, (a.M + BM - 1) / BM, W);
  gemm3x_kernel<A_KC, B_NC, EPI, BF><<<grid, THREADS, S::BYTES, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace tc
}  // namespace

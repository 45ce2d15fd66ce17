// fused_sweep.cu — E interleaved (D step, G step) local iterations for W
// FedAvg-family workers in one kernel launch (Hopper, f32).
//
// Replaces the Pallas TPU kernel `_sweep_kernel`
// (cglgan_tpu/ops/pallas/fused_sweep.py:99-193, launched by
// `fused_sweep_steps` :247-332).  Per worker and local iteration e:
//   1. fake = G(z1[e])                       (forward only)
//   2. X = concat(real[e], fake) (2B, 2); D forward (LeakyReLU 0.2, sigmoid),
//      loss = sum over the 2B rows of the clipped BCE / B, hand-derived
//      backward (no input grad), six Adam updates with the D corrections;
//   3. fake2 = G(z2[e]); p2 = D_new(fake2) through the UPDATED D;
//      loss = -sum log(clip p2) / B; backward through D for dx only (no D
//      grads), through tanh with 1 - fake2^2, through G; 2*L_g Adam updates
//      with the G corrections.
// Where the clip [1e-12, 1 - 1e-7] is active the gradient is zero.  Adam is
// in optax order with per-worker bias corrections (1 - b1^t, 1 - b2^t),
// t = count[w] + e + 1, separately for G and D, computed here from the
// counts.  State (params, mu, nu of both nets) is read from `*_in` and the
// result written to `*_out` (iteration 0 reads the inputs, later iterations
// update the outputs in place); d_loss[w] and g_loss[w] hold the mean over
// the E iterations.
//
// Bound at the main-path shapes (W=16, E=5, B=100; G 100-256-128-2, D
// 2-128-256-1): ~95 MFLOP per worker-iteration, 7.6 GFLOP per call, all f32
// FMA: ~0.11 ms at the H100 SXM's 67 TFLOP/s of non-tensor f32.  The least
// traffic is one read and one write of the 16 workers' state plus the
// latents (~42 MB, ~0.013 ms at 3.35 TB/s), so the call is bound by
// operations.
//
// Design.  The TPU kernel kept one worker's 1.1 MB of state resident in VMEM
// across the E iterations and ran the iteration's layers back to back.  Here
// one thread-block cluster runs one worker: CLUSTER blocks of 256 threads,
// all co-scheduled by the hardware, in ONE launch for the whole call.  An
// iteration is a fixed list of phases; every phase ends in a cluster barrier
// (barrier.cluster arrive.release / wait.acquire), and inside a phase the
// blocks share the layer's work:
//   - a product is cut into 64x64 output tiles dealt round-robin to the
//     blocks (SIMT, the tile loop of mlp_kernels.cuh); a weight-gradient
//     tile is summed over all its rows inside one block, which applies Adam
//     to that tile of (p, mu, nu) at once, and the block of the tile row at
//     0 sums dz's columns for the bias: no gradient reaches device memory,
//     every sum runs in a fixed order, no atomics;
//   - the layers with 1 or 2 outputs or inputs (D's first layer, K=2; D's
//     head, N=1; G's last layer, N=2) get no tile: one warp a row, fused with
//     their neighbours (G's tanh layer with D's first layer; the head with
//     its loss term, dL/dz and the dz of the layer below);
//   - G runs z1 and z2 through the same (current) weights as one 2B-row
//     pass, so the G step's forward costs no phases of its own.
// A product with W_l^T always runs one phase before the phase that updates
// W_l.  State and activations stay in device memory (17.8 MB for 16 workers,
// inside the 50 MB L2); everything written inside the launch is read back
// through L2 (`ld`), never through L1 or the read-only path.  Phases an
// iteration: 2 L_g + 8 (14 for FL-GAN's G, 12 for FeGAN's).  Weights held
// in distributed shared memory, tensor cores and TMA are later work.

#include <cooperative_groups.h>

#include "mlp_kernels.cuh"

namespace cg = cooperative_groups;

namespace {

// Blocks in a worker's cluster (at most 8, the portable limit).  With 256
// threads, 128 registers and 28.7 KB of shared memory a block, an SM holds
// two, and cudaOccupancyMaxActiveClusters gives 30 clusters of 8 on an H100
// 80GB HBM3 (chip_smoke.py prints it), so W=16 workers run in one wave.
// Measured there with kernel_probe.py at the main-path shape (FL-GAN pair):
// 1.44 ms with clusters of 8; 2.05 ms with clusters of 4 (62 resident);
// 2.10 ms with one block an SM (255 registers, 15 resident: two waves).
constexpr int CLUSTER = 8;
constexpr int MAX_LG = 3;       // G has 2 or 3 linear layers
constexpr int MAX_X = 4;        // sample width (2 on 2DMG)
constexpr int ROW_MAX = 256;    // widest layer a warp holds as one row
constexpr int RPL = ROW_MAX / 32;
// shared memory for the weights of a per-row phase: two (ROW_MAX x MAX_X)
// matrices, a ROW_MAX bias and a MAX_X bias
constexpr int WSM = 2 * ROW_MAX * MAX_X + ROW_MAX + MAX_X;
constexpr int WARPS = TPB / 32;
constexpr unsigned FULL = 0xFFFFFFFFu;

// Offsets (floats) of the scratch arrays inside one worker's slice.
struct Layout {
  long long GH[MAX_LG - 1];   // (2B, g_{i+1}) G hidden outputs, z1 then z2 rows
  long long GDZ[MAX_LG - 1];  // (B, g_{i+1}) dL/dz of G's hidden layers (z2)
  long long X, FAKE2, DFAKE;  // (2B, x), (B, x), (B, x)
  long long DH1, DH2;         // (2B, dh1), (2B, dh2) D hidden outputs
  long long G3, PER;          // (2B) dL/dz of the head, the rows' loss terms
  long long DDZ2, DDZ1;       // (2B, dh2), (2B, dh1) dL/dz of D's hidden layers
  long long total;
};

Layout layout(int B, int L_g, const int* gdims, int dh1, int dh2) {
  Layout l{};
  long long o = 0;
  auto take = [&](long long n) {
    const long long at = o;
    o += (n + 3) / 4 * 4;
    return at;
  };
  const long long R = 2LL * B, x = gdims[L_g];
  for (int i = 0; i < L_g - 1; ++i) {
    l.GH[i] = take(R * gdims[i + 1]);
    l.GDZ[i] = take((long long)B * gdims[i + 1]);
  }
  l.X = take(R * x);
  l.FAKE2 = take(B * x);
  l.DFAKE = take(B * x);
  l.DH1 = take(R * dh1);
  l.DH2 = take(R * dh2);
  l.G3 = take(R);
  l.PER = take(R);
  l.DDZ2 = take(R * dh2);
  l.DDZ1 = take(R * dh1);
  l.total = o;
  return l;
}

struct Args {
  // g: 6 L_g pointers (w0 b0 .. | mu of the same | nu of the same); d: 18
  float* g_in[6 * MAX_LG];
  float* g_out[6 * MAX_LG];
  float* d_in[18];
  float* d_out[18];
  long long g_n[2 * MAX_LG], d_n[6];    // elements of a worker's tensor
  float* scratch;                       // W slices of lay.total floats
  Layout lay;
  const float *reals, *z1, *z2;
  const long long *g_count, *d_count;   // Adam counts before the call
  int g_count_step, d_count_step;       // 1: per worker, 0: shared
  float *d_loss, *g_loss;
  int E, B, L_g, gdims[MAX_LG + 1], dh1, dh2;
  AdamConsts kg, kd;
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) x += __shfl_xor_sync(FULL, x, s);
  return x;
}

__device__ __forceinline__ float lrelu(float v) {
  return v >= 0.f ? v : 0.2f * v;
}

// lrelu'(z) from h = lrelu(z): lrelu keeps the sign
__device__ __forceinline__ float slope(float h) {
  return h >= 0.f ? 1.f : 0.2f;
}

// The (p, mu, nu) a tensor is read from and written to.
struct AdamT {
  const float *p, *m, *v;
  float *po, *mo, *vo;
};

__device__ __forceinline__ void adam_at(const AdamT& t, long long o, float g,
                                        float c1, float c2,
                                        const AdamConsts& k) {
  float pn, mn, vn;
  adam_one(ld(t.p + o), ld(t.m + o), ld(t.v + o), g, c1, c2, k, &pn, &mn,
           &vn);
  t.po[o] = pn;
  t.mo[o] = mn;
  t.vo[o] = vn;
}

__device__ __forceinline__ void tile_origin(const Gemm& g, int j, int& m0,
                                            int& n0) {
  const int tn = (g.N + BN - 1) / BN;
  m0 = (j / tn) * BM;
  n0 = (j % tn) * BN;
}

// out (M x N) = lrelu(A B + bias)
__device__ __forceinline__ void fwd_tile(const Gemm& g, int j,
                                         const float* bias, float* out,
                                         TileSmem& s) {
  int m0, n0;
  tile_origin(g, j, m0, n0);
  float acc[4][4];
  tile_product<true, true>(g, m0, n0, s, acc);
  const int n = n0 + 4 * (threadIdx.x % 16), m = m0 + 4 * (threadIdx.x / 16);
  float bv[4];
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) bv[jj] = n + jj < g.N ? ld(bias + n + jj) : 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
      if (m + i < g.M && n + jj < g.N)
        out[(long long)(m + i) * g.N + n + jj] = lrelu(acc[i][jj] + bv[jj]);
}

// out (M x N) = (G W^T) * lrelu'(aux), aux (M x N) the layer's input h
__device__ __forceinline__ void xgrad_tile(const Gemm& g, int j, float* out,
                                           const float* aux, TileSmem& s) {
  int m0, n0;
  tile_origin(g, j, m0, n0);
  float acc[4][4];
  tile_product<true, false>(g, m0, n0, s, acc);
  const int n = n0 + 4 * (threadIdx.x % 16), m = m0 + 4 * (threadIdx.x / 16);
  float h[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
      h[i][jj] = m + i < g.M && n + jj < g.N
                     ? ld(aux + (long long)(m + i) * g.N + n + jj) : 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
      if (m + i < g.M && n + jj < g.N)
        out[(long long)(m + i) * g.N + n + jj] = acc[i][jj] * slope(h[i][jj]);
}

// For the 64 columns n = n0 + (tid % 64) of M (R rows, row stride ldm, N
// columns), in one pass over M: out[c] = sum over the rows of M[r][n] *
// v[r * ldv + c] for c < nv, then, when with_sum, out[nv] = the plain column
// sum.  Four groups of 64 threads take every fourth row; their partial sums
// are added in order, and the threads of group 0 get the totals.
__device__ void col_dots(const float* M, long long ldm, int N, int n0, int R,
                         const float* v, long long ldv, int nv, bool with_sum,
                         float (&out)[MAX_X + 1], float (&part)[4][BN]) {
  const int col = threadIdx.x % BN, grp = threadIdx.x / BN, n = n0 + col;
  float s[MAX_X + 1];
#pragma unroll
  for (int c = 0; c <= MAX_X; ++c) s[c] = 0.f;
  if (n < N) {
#pragma unroll 4
    for (int r = grp; r < R; r += TPB / BN) {
      const float m = ld(M + r * ldm + n);
#pragma unroll
      for (int c = 0; c < MAX_X; ++c)
        if (c < nv) s[c] = fmaf(m, ld(v + r * ldv + c), s[c]);
      s[MAX_X] += m;
    }
  }
  const int nout = nv + (with_sum ? 1 : 0);
#pragma unroll
  for (int c = 0; c <= MAX_X; ++c) {
    if (c >= nout) break;
    part[grp][col] = c < nv ? s[c] : s[MAX_X];
    __syncthreads();
    float t = part[0][col];
#pragma unroll
    for (int q = 1; q < TPB / BN; ++q) t += part[q][col];
    out[c] = t;
    __syncthreads();
  }
}

// dW (M x N) = A^T dz over the K rows, then Adam on that tile of W (a row
// of the thread's 4 x 4 at a time: its p, mu, nu loads go out together);
// the tile row at m0 = 0 also sums dz's columns and updates the bias.
__device__ __forceinline__ void wgrad_tile(const Gemm& g, int j,
                                           const AdamT& tw, const AdamT& tb,
                                           float c1, float c2,
                                           const AdamConsts& k, TileSmem& s,
                                           float (&part)[4][BN]) {
  int m0, n0;
  tile_origin(g, j, m0, n0);
  float acc[4][4];
  tile_product<false, true>(g, m0, n0, s, acc);
  const int tid = threadIdx.x;
  const int n = n0 + 4 * (tid % 16), m = m0 + 4 * (tid / 16);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (m + i >= g.M) continue;
    const long long o = (long long)(m + i) * g.N + n;
    float p[4], mu[4], nu[4];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const bool in = n + jj < g.N;
      p[jj] = in ? ld(tw.p + o + jj) : 0.f;
      mu[jj] = in ? ld(tw.m + o + jj) : 0.f;
      nu[jj] = in ? ld(tw.v + o + jj) : 0.f;
    }
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      if (n + jj >= g.N) continue;
      float pn, mn, vn;
      adam_one(p[jj], mu[jj], nu[jj], acc[i][jj], c1, c2, k, &pn, &mn, &vn);
      tw.po[o + jj] = pn;
      tw.mo[o + jj] = mn;
      tw.vo[o + jj] = vn;
    }
  }
  if (m0 != 0) return;
  float t[MAX_X + 1];
  col_dots(g.b, g.sbk, g.N, n0, g.K, nullptr, 0, 0, true, t, part);
  if (tid < BN && n0 + tid < g.N) adam_at(tb, n0 + tid, t[0], c1, c2, k);
}

// Extra job s of a phase (a job that is no tile) falls to this block?
// Tiles are dealt from the first block up, extras from the last one down.
__device__ __forceinline__ bool extra_mine(int s, int rank, int C) {
  return C - 1 - s % C == rank;
}

// Sum of x[0..n) over the block in a fixed order; every thread gets it.
__device__ float block_sum(const float* x, int n, float* red) {
  const int tid = threadIdx.x;
  float s = 0.f;
  for (int i = tid; i < n; i += TPB) s += ld(x + i);
  red[tid] = s;
  __syncthreads();
  for (int st = TPB / 2; st > 0; st >>= 1) {
    if (tid < st) red[tid] += red[tid + st];
    __syncthreads();
  }
  const float total = red[0];
  __syncthreads();
  return total;
}

// loss[w] += sum(PER) / B over the iterations, / E at the last one
__device__ void loss_step(const float* per, int rows, int B, int e, int E,
                          float* loss, float* red) {
  const float s = block_sum(per, rows, red);
  if (threadIdx.x == 0) {
    float v = s / (float)B;
    if (e > 0) v += *loss;
    *loss = e == E - 1 ? v / (float)E : v;
  }
}

// v[j] = p[lane + 32 j] where that is < n, else 0: a warp's row of up to
// ROW_MAX values in registers, all its loads issued together.
__device__ __forceinline__ void load_row(const float* p, int n,
                                         float (&v)[RPL]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < RPL; ++j) {
    const int k = lane + 32 * j;
    v[j] = k < n ? ld(p + k) : 0.f;
  }
}

// The block copies n floats of device memory into shared memory (the
// weights a per-row phase reads for every row); the caller synchronises.
__device__ __forceinline__ void stage(float* dst, const float* src, int n) {
  for (int i = threadIdx.x; i < n; i += TPB) dst[i] = ld(src + i);
}

// One warp: x = tanh(h Wl + bl) for one row h (K wide) of G's last hidden
// output; Wl (K x xdim) and bl in shared memory.
__device__ __forceinline__ void g_last_row(const float* h, int K,
                                           const float* Wl, const float* bl,
                                           int xdim, float (&x)[MAX_X]) {
  const int lane = threadIdx.x & 31;
  float hv[RPL];
  load_row(h, K, hv);
  float s[MAX_X];
#pragma unroll
  for (int i = 0; i < MAX_X; ++i) s[i] = 0.f;
#pragma unroll
  for (int j = 0; j < RPL; ++j) {
    const int k = lane + 32 * j;
    if (k < K) {
#pragma unroll
      for (int i = 0; i < MAX_X; ++i)
        if (i < xdim) s[i] = fmaf(hv[j], Wl[k * xdim + i], s[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < MAX_X; ++i)
    x[i] = i < xdim ? tanhf(warp_sum(s[i]) + bl[i]) : 0.f;
}

// One warp: out = lrelu(x W0 + b0) for one row of D's first layer (K = xdim,
// N <= ROW_MAX outputs); W0 (xdim x N) and b0 in shared memory.
__device__ __forceinline__ void d_first_row(const float (&x)[MAX_X], int xdim,
                                            const float* W0, const float* b0,
                                            int N, float* out) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < RPL; ++j) {
    const int n = lane + 32 * j;
    if (n < N) {
      float z = 0.f;
#pragma unroll
      for (int i = 0; i < MAX_X; ++i)
        if (i < xdim) z = fmaf(x[i], W0[i * N + n], z);
      out[n] = lrelu(z + b0[n]);
    }
  }
}

// One warp, row q: the sigmoid head z3 = h2 W3 + b3, the row's clipped-BCE
// term, g3 = dL/dz3 and dz2 = (g3 W3^T) * lrelu'(h2).  D step (g_step = 0):
// rows < B are real (target 1), the rest fake (target 0); G step: target 1.
// w3 (dh2) and b3 in shared memory.
__device__ __forceinline__ void head_row(int q, const float* H2, int dh2,
                                         const float* w3, float b3, int B,
                                         bool g_step, float* G3, float* PER,
                                         float* DDZ2) {
  const int lane = threadIdx.x & 31;
  float hv[RPL];
  load_row(H2 + (long long)q * dh2, dh2, hv);
  float z = 0.f;
#pragma unroll
  for (int j = 0; j < RPL; ++j) {
    const int k = lane + 32 * j;
    if (k < dh2) z = fmaf(hv[j], w3[k], z);
  }
  z = warp_sum(z) + b3;
  const float p = 1.f / (1.f + expf(-z));
  const float pc = fminf(fmaxf(p, P_LO), P_HI);
  const float inside = (p > P_LO && p < P_HI) ? 1.f : 0.f;
  float per, dpc;
  if (g_step) {
    per = -logf(pc);
    dpc = (float)(-1.0 / (double)B) / pc;
  } else {
    const float is_real = q < B ? 1.f : 0.f;
    per = -(is_real * logf(pc) + (1.f - is_real) * log1pf(-pc));
    dpc = (float)(1.0 / (double)B)
          * (is_real * (-1.f / pc) + (1.f - is_real) * (1.f / (1.f - pc)));
  }
  const float g = dpc * inside * p * (1.f - p);
  if (lane == 0) {
    G3[q] = g;
    PER[q] = per;
  }
  float* dz = DDZ2 + (long long)q * dh2;
#pragma unroll
  for (int j = 0; j < RPL; ++j) {
    const int k = lane + 32 * j;
    if (k < dh2) dz[k] = (g * w3[k]) * slope(hv[j]);
  }
}

// One warp, row q of the G step: dfake = (dz1 W0^T) * (1 - fake2^2) (W0 of
// the updated D, xdim x dh1), then G's last hidden dz = (dfake Wl^T) *
// lrelu'(h) (Wl: Kl x xdim, h: the row's G hidden output).  W0 and Wl in
// shared memory.
__device__ __forceinline__ void dfake_row(int q, const float* DDZ1, int dh1,
                                          const float* W0, const float* FAKE2,
                                          int xdim, const float* Wl,
                                          const float* Hz2, int Kl,
                                          float* DFAKE, float* GDZ) {
  const int lane = threadIdx.x & 31;
  float dv[RPL], hv[RPL];
  load_row(DDZ1 + (long long)q * dh1, dh1, dv);
  load_row(Hz2 + (long long)q * Kl, Kl, hv);
  float s[MAX_X];
#pragma unroll
  for (int i = 0; i < MAX_X; ++i) {
    s[i] = 0.f;
    if (i < xdim) {
      float t = 0.f;
#pragma unroll
      for (int j = 0; j < RPL; ++j) {
        const int n = lane + 32 * j;
        if (n < dh1) t = fmaf(dv[j], W0[i * dh1 + n], t);
      }
      const float f = ld(FAKE2 + (long long)q * xdim + i);
      s[i] = warp_sum(t) * (1.f - f * f);
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < MAX_X; ++i)
      if (i < xdim) DFAKE[(long long)q * xdim + i] = s[i];
  }
#pragma unroll
  for (int j = 0; j < RPL; ++j) {
    const int k = lane + 32 * j;
    if (k < Kl) {
      float v = 0.f;
#pragma unroll
      for (int i = 0; i < MAX_X; ++i)
        if (i < xdim) v = fmaf(s[i], Wl[k * xdim + i], v);
      GDZ[(long long)q * Kl + k] = v * slope(hv[j]);
    }
  }
}

#ifdef SWEEP_PHASE_CLOCK
// Probe build only (kernel_probe.py): %globaltimer (ns) of worker 0's
// blocks when each phase's work ends and when its barrier lets go, at
// [((e * CLOCK_PHASES + p) * 8 + rank) * 2 + {0, 1}].
constexpr int CLOCK_PHASES = 2 * MAX_LG + 8;
__device__ unsigned long long phase_clock[32 * CLOCK_PHASES * 8 * 2];
__device__ unsigned long long phase_start[8];   // kernel start, by rank
constexpr int MAX_PROBE_BLOCKS = 4096;
__device__ int block_sm[MAX_PROBE_BLOCKS];      // %smid, by block

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#endif

// End of a phase: the cluster barrier (all threads of all the worker's
// blocks; release, then acquire), then the next phase's number.
__device__ __forceinline__ void phase_end(int w, int rank, int e, int& p) {
#ifdef SWEEP_PHASE_CLOCK
  __syncthreads();
  const long long at = ((long long)(e * CLOCK_PHASES + p) * 8 + rank) * 2;
  if (w == 0 && threadIdx.x == 0) phase_clock[at] = global_ns();
#endif
  cg::this_cluster().sync();
#ifdef SWEEP_PHASE_CLOCK
  if (w == 0 && threadIdx.x == 0) phase_clock[at + 1] = global_ns();
#endif
  ++p;
}

__global__ void __launch_bounds__(TPB, 2) sweep_kernel(const __grid_constant__
                                                       Args a) {
  __shared__ TileSmem ts;
  __shared__ float red[TPB];
  __shared__ float part[TPB / BN][BN];
  __shared__ float wsm[WSM];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int w = blockIdx.x / C;
  const int tid = threadIdx.x;
  const int lane = tid & 31, gwarp = rank * WARPS + tid / 32;
  const int row_step = C * WARPS;

  const int E = a.E, B = a.B, R = 2 * B, Lg = a.L_g, dh1 = a.dh1,
            dh2 = a.dh2;
  const int zdim = a.gdims[0], xdim = a.gdims[Lg], nG = 2 * Lg;
  const int Kl = a.gdims[Lg - 1];      // width into G's last (tanh) layer
  float* const S = a.scratch + (long long)w * a.lay.total;
  // G's hidden outputs and their dz, by layer (offsets read from the
  // kernel parameter: no array of pointers in local memory)
  auto GH = [&](int i) { return S + a.lay.GH[i]; };
  auto GDZ = [&](int i) { return S + a.lay.GDZ[i]; };
  float *X = S + a.lay.X, *FAKE2 = S + a.lay.FAKE2, *DFAKE = S + a.lay.DFAKE;
  float *DH1 = S + a.lay.DH1, *DH2 = S + a.lay.DH2, *G3 = S + a.lay.G3;
  float *PER = S + a.lay.PER, *DDZ2 = S + a.lay.DDZ2, *DDZ1 = S + a.lay.DDZ1;
  const float* Hz2 = GH(Lg - 2) + (long long)B * Kl;   // its z2 rows
#ifdef SWEEP_PHASE_CLOCK
  if (w == 0 && tid == 0) phase_start[rank] = global_ns();
  if (tid == 0 && blockIdx.x < MAX_PROBE_BLOCKS) {
    int sm;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
    block_sm[blockIdx.x] = sm;
  }
#endif
  const long long g_cnt = a.g_count[w * a.g_count_step];
  const long long d_cnt = a.d_count[w * a.d_count_step];

  for (int e = 0; e < E; ++e) {
    int phase = 0;
    float* const* gcur = e == 0 ? a.g_in : a.g_out;
    float* const* dcur = e == 0 ? a.d_in : a.d_out;
    auto gp = [&](int j) -> const float* {
      return gcur[j] + w * a.g_n[j];
    };
    auto dp = [&](int j) -> const float* {
      return dcur[j] + w * a.d_n[j];
    };
    auto dnew = [&](int j) -> const float* {
      return a.d_out[j] + w * a.d_n[j];
    };
    auto g_adam = [&](int j) {
      const long long o = w * a.g_n[j];
      return AdamT{gcur[j] + o,    gcur[nG + j] + o,    gcur[2 * nG + j] + o,
                   a.g_out[j] + o, a.g_out[nG + j] + o, a.g_out[2 * nG + j] + o};
    };
    auto d_adam = [&](int j) {
      const long long o = w * a.d_n[j];
      return AdamT{dcur[j] + o,    dcur[6 + j] + o,    dcur[12 + j] + o,
                   a.d_out[j] + o, a.d_out[6 + j] + o, a.d_out[12 + j] + o};
    };
    // optax's 1 - f32(b)^t in float32
    const float tg = (float)(g_cnt + e + 1), td = (float)(d_cnt + e + 1);
    const float c1g = 1.f - powf(a.kg.b1, tg), c2g = 1.f - powf(a.kg.b2, tg);
    const float c1d = 1.f - powf(a.kd.b1, td), c2d = 1.f - powf(a.kd.b2, td);
    const float* z1e = a.z1 + ((long long)w * E + e) * B * zdim;
    const float* z2e = a.z2 + ((long long)w * E + e) * B * zdim;
    const float* reals_e = a.reals + ((long long)w * E + e) * B * xdim;

    // ---- G's hidden layers on [z1; z2] (2B rows, current G) ----
    for (int i = 0; i < Lg - 1; ++i) {
      const int K = a.gdims[i], N = a.gdims[i + 1];
      const Gemm g{R, N, K, i == 0 ? z1e : GH(i - 1), z2e, i == 0 ? B : R,
                   K, 1, gp(2 * i), N, 1};
      for (int j = rank; j < tile_count(R, N); j += C)
        fwd_tile(g, j, gp(2 * i + 1), GH(i), ts);
      phase_end(w, rank, e, phase);
    }

    // ---- per row: G's tanh layer -> samples; X = (real, fake) and D's
    // first layer on X (current D); fake2 kept for the G step ----
    {
      float *Wl = wsm, *W0 = wsm + ROW_MAX * MAX_X;
      float *b0 = W0 + ROW_MAX * MAX_X, *bl = b0 + ROW_MAX;
      stage(Wl, gp(2 * (Lg - 1)), Kl * xdim);
      stage(bl, gp(2 * (Lg - 1) + 1), xdim);
      stage(W0, dp(0), xdim * dh1);
      stage(b0, dp(1), dh1);
      __syncthreads();
      for (int q = gwarp; q < 3 * B; q += row_step) {
        float x[MAX_X];
        if (q < B) {
#pragma unroll
          for (int i = 0; i < MAX_X; ++i)
            x[i] = i < xdim ? ld(reals_e + (long long)q * xdim + i) : 0.f;
        } else {
          g_last_row(GH(Lg - 2) + (long long)(q - B) * Kl, Kl, Wl, bl, xdim,
                     x);
        }
        float* dst = q < 2 * B ? X + (long long)q * xdim
                               : FAKE2 + (long long)(q - 2 * B) * xdim;
        if (lane == 0) {
#pragma unroll
          for (int i = 0; i < MAX_X; ++i)
            if (i < xdim) dst[i] = x[i];
        }
        if (q < 2 * B)
          d_first_row(x, xdim, W0, b0, dh1, DH1 + (long long)q * dh1);
      }
      phase_end(w, rank, e, phase);
    }

    // ---- D step ----
    {  // D's second layer on the 2B rows
      const Gemm g{R, dh2, dh1, DH1, nullptr, R, dh1, 1, dp(2), dh2, 1};
      for (int j = rank; j < tile_count(R, dh2); j += C)
        fwd_tile(g, j, dp(3), DH2, ts);
      phase_end(w, rank, e, phase);
    }
    stage(wsm, dp(4), dh2);
    __syncthreads();
    {
      const float b3 = ld(dp(5));
      for (int q = gwarp; q < R; q += row_step)
        head_row(q, DH2, dh2, wsm, b3, B, false, G3, PER, DDZ2);
      phase_end(w, rank, e, phase);
    }
    {  // dz1 = (dz2 W1^T) * lrelu'(h1); extras: the head's weight grads +
       // Adam by 64 columns, its bias and the loss
      const Gemm g{R, dh1, dh2, DDZ2, nullptr, R, dh2, 1, dp(2), 1, dh2};
      for (int j = rank; j < tile_count(R, dh1); j += C)
        xgrad_tile(g, j, DDZ1, DH1, ts);
      const int chunks = (dh2 + BN - 1) / BN;
      for (int s = 0; s <= chunks; ++s) {
        if (!extra_mine(s, rank, C)) continue;
        if (s < chunks) {
          float t[MAX_X + 1];
          col_dots(DH2, dh2, dh2, s * BN, R, G3, 1, 1, false, t, part);
          if (tid < BN && s * BN + tid < dh2)
            adam_at(d_adam(4), s * BN + tid, t[0], c1d, c2d, a.kd);
        } else {
          if (tid < 32) {
            float t = 0.f;
            for (int r = lane; r < R; r += 32) t += ld(G3 + r);
            t = warp_sum(t);
            if (lane == 0) adam_at(d_adam(5), 0, t, c1d, c2d, a.kd);
          }
          loss_step(PER, R, B, e, E, a.d_loss + w, red);
        }
      }
      phase_end(w, rank, e, phase);
    }
    {  // dW1 = h1^T dz2 + Adam (tiles); extras: dW0 = X^T dz1, db0 + Adam
       // by 64 columns
      const Gemm g{dh1, dh2, R, DH1, nullptr, dh1, 1, dh1, DDZ2, dh2, 1};
      for (int j = rank; j < tile_count(dh1, dh2); j += C)
        wgrad_tile(g, j, d_adam(2), d_adam(3), c1d, c2d, a.kd, ts, part);
      const int chunks = (dh1 + BN - 1) / BN;
      for (int s = 0; s < chunks; ++s) {
        if (!extra_mine(s, rank, C)) continue;
        const int n = s * BN + tid;
        float t[MAX_X + 1];
        col_dots(DDZ1, dh1, dh1, s * BN, R, X, xdim, xdim, true, t, part);
        if (tid < BN && n < dh1) {
#pragma unroll
          for (int i = 0; i < MAX_X; ++i)
            if (i < xdim)
              adam_at(d_adam(0), (long long)i * dh1 + n, t[i], c1d, c2d,
                      a.kd);
          adam_at(d_adam(1), n, t[xdim], c1d, c2d, a.kd);
        }
      }
      phase_end(w, rank, e, phase);
    }

    // ---- G step, through the updated D (d_out) ----
    {
      float *W0 = wsm, *b0 = wsm + ROW_MAX * MAX_X;
      stage(W0, dnew(0), xdim * dh1);
      stage(b0, dnew(1), dh1);
      __syncthreads();
      for (int q = gwarp; q < B; q += row_step) {
        float x[MAX_X];
#pragma unroll
        for (int i = 0; i < MAX_X; ++i)
          x[i] = i < xdim ? ld(FAKE2 + (long long)q * xdim + i) : 0.f;
        d_first_row(x, xdim, W0, b0, dh1, DH1 + (long long)q * dh1);
      }
      phase_end(w, rank, e, phase);
    }
    {
      const Gemm g{B, dh2, dh1, DH1, nullptr, B, dh1, 1, dnew(2), dh2, 1};
      for (int j = rank; j < tile_count(B, dh2); j += C)
        fwd_tile(g, j, dnew(3), DH2, ts);
      phase_end(w, rank, e, phase);
    }
    stage(wsm, dnew(4), dh2);
    __syncthreads();
    {
      const float b3 = ld(dnew(5));
      for (int q = gwarp; q < B; q += row_step)
        head_row(q, DH2, dh2, wsm, b3, B, true, G3, PER, DDZ2);
      phase_end(w, rank, e, phase);
    }
    {  // dz1 on the B rows; extra: the G loss
      const Gemm g{B, dh1, dh2, DDZ2, nullptr, B, dh2, 1, dnew(2), 1, dh2};
      for (int j = rank; j < tile_count(B, dh1); j += C)
        xgrad_tile(g, j, DDZ1, DH1, ts);
      if (extra_mine(0, rank, C)) loss_step(PER, B, B, e, E, a.g_loss + w, red);
      phase_end(w, rank, e, phase);
    }
    {  // per row: dfake = (dz1 W0^T) * (1 - fake2^2); G's last hidden dz
      float *W0 = wsm, *Wl = wsm + ROW_MAX * MAX_X;
      stage(W0, dnew(0), xdim * dh1);
      stage(Wl, gp(2 * (Lg - 1)), Kl * xdim);
      __syncthreads();
      for (int q = gwarp; q < B; q += row_step)
        dfake_row(q, DDZ1, dh1, W0, FAKE2, xdim, Wl, Hz2, Kl, DFAKE,
                  GDZ(Lg - 2));
      phase_end(w, rank, e, phase);
    }
    // G backward, layer by layer: the phase for i runs the weight grads +
    // Adam of layer i + 1, the input grad of layer i (i > 0) and, at i = 0,
    // the weight grads + Adam of layer 0.  G's last layer (N = xdim) is no
    // tile: its weight grads go as extras by 64 rows of W, its bias with the
    // first.
    for (int i = Lg - 2; i >= 0; --i) {
      int n1 = 0, n2 = 0, n3 = 0;
      Gemm g1{}, g2{}, g3{};
      const int up = i + 1;                 // layer whose W is updated
      if (up < Lg - 1) {
        const int M = a.gdims[up], N = a.gdims[up + 1];
        g1 = Gemm{M, N, B, GH(up - 1) + (long long)B * M, nullptr, M, 1, M,
                  GDZ(up), N, 1};
        n1 = tile_count(M, N);
      }
      if (i > 0) {
        const int N = a.gdims[i], K = a.gdims[i + 1];
        g2 = Gemm{B, N, K, GDZ(i), nullptr, B, K, 1, gp(2 * i), 1, K};
        n2 = tile_count(B, N);
      } else {
        const int M = a.gdims[0], N = a.gdims[1];
        g3 = Gemm{M, N, B, z2e, nullptr, M, 1, zdim, GDZ(0), N, 1};
        n3 = tile_count(M, N);
      }
      for (int j = rank; j < n1 + n2 + n3; j += C) {
        if (j < n1)
          wgrad_tile(g1, j, g_adam(2 * up), g_adam(2 * up + 1), c1g, c2g,
                     a.kg, ts, part);
        else if (j < n1 + n2)
          xgrad_tile(g2, j - n1, GDZ(i - 1),
                     GH(i - 1) + (long long)B * a.gdims[i], ts);
        else
          wgrad_tile(g3, j - n1 - n2, g_adam(0), g_adam(1), c1g, c2g, a.kg,
                     ts, part);
      }
      if (up == Lg - 1) {
        const int chunks = (Kl + BN - 1) / BN;
        for (int s = 0; s < chunks; ++s) {
          if (!extra_mine(s, rank, C)) continue;
          const int k = s * BN + tid;
          float t[MAX_X + 1];
          col_dots(Hz2, Kl, Kl, s * BN, B, DFAKE, xdim, xdim, false, t, part);
          if (tid < BN && k < Kl) {
#pragma unroll
            for (int c = 0; c < MAX_X; ++c)
              if (c < xdim)
                adam_at(g_adam(2 * up), (long long)k * xdim + c, t[c], c1g,
                        c2g, a.kg);
          }
          if (s == 0) {
            col_dots(DFAKE, xdim, xdim, 0, B, nullptr, 0, 0, true, t, part);
            if (tid < xdim)
              adam_at(g_adam(2 * up + 1), tid, t[0], c1g, c2g, a.kg);
          }
        }
      }
      phase_end(w, rank, e, phase);
    }
  }
}

cudaLaunchConfig_t launch_config(int W, cudaStream_t st,
                                 cudaLaunchAttribute* attr, int cluster) {
  cudaLaunchConfig_t cfg{};
  cfg.gridDim = dim3((unsigned)(W * cluster));
  cfg.blockDim = dim3(TPB);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// G with 2 or 3 layers; samples at most MAX_X wide; the layers a warp
// holds as one row (D's hidden widths, G's last hidden width) at most
// ROW_MAX wide.
bool supported(int L_g, const int* gdims, int dh1, int dh2) {
  return L_g >= 2 && L_g <= MAX_LG && gdims[L_g] >= 1 &&
         gdims[L_g] <= MAX_X && gdims[L_g - 1] <= ROW_MAX &&
         dh1 <= ROW_MAX && dh2 <= ROW_MAX;
}

}  // namespace

extern "C" {

const char* fused_sweep_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int fused_sweep_cluster_size() { return CLUSTER; }

#ifdef SWEEP_PHASE_CLOCK
// The probe build's clock of the last call: 8 start times, then the
// phase_clock array; n = 8 + 32 * CLOCK_PHASES * 16 values.
int fused_sweep_phase_clock(unsigned long long* host) {
  cudaError_t err = cudaMemcpyFromSymbol(host, phase_start, sizeof(phase_start));
  if (err == cudaSuccess)
    err = cudaMemcpyFromSymbol(host + 8, phase_clock, sizeof(phase_clock));
  return (int)err;
}

// The SM each block of the last call ran on (its first MAX_PROBE_BLOCKS).
int fused_sweep_block_sm(int* host) {
  return (int)cudaMemcpyFromSymbol(host, block_sm, sizeof(block_sm));
}
#endif

// Clusters of `cluster` blocks of this kernel that the card holds at once
// (cudaOccupancyMaxActiveClusters), into *out.  Returns 0 or the error code.
int fused_sweep_max_active_clusters(int cluster, int* out) {
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = launch_config(16, nullptr, attr, cluster);
  return (int)cudaOccupancyMaxActiveClusters(out, sweep_kernel, &cfg);
}

// Floats of scratch one worker needs, or -1 for an unsupported shape (see
// `supported`).
long long fused_sweep_scratch_floats(int B, int L_g, const int* gdims, int dh1,
                                     int dh2) {
  if (!supported(L_g, gdims, dh1, dh2)) return -1;
  return layout(B, L_g, gdims, dh1, dh2).total;
}

// g_in/g_out: 6*L_g device pointers each, in the order
//   w0 b0 .. w(L-1) b(L-1) | mu of the same | nu of the same;
// d_in/d_out: 18 each, likewise for the 3-layer D.
// scratch: W * fused_sweep_scratch_floats(...) floats.
// reals (W,E,B,xdim), z1/z2 (W,E,B,gdims[0]); g_count/d_count int64 Adam
// counts before the call, one per worker (*_per_worker = 1) or one shared;
// losses (W,).  gdims: L_g+1 host ints (G widths); D widths are
// xdim-dh1-dh2-1 with xdim = gdims[L_g].  One launch; returns 0 or the
// launch's error code (cudaErrorInvalidValue for an unsupported shape).
int fused_sweep_f32(void* const* g_in, void* const* g_out, void* const* d_in,
                    void* const* d_out, float* scratch, const float* reals,
                    const float* z1, const float* z2,
                    const long long* g_count, int g_count_per_worker,
                    const long long* d_count, int d_count_per_worker,
                    float* d_loss, float* g_loss, int W, int E, int B,
                    int L_g, const int* gdims, int dh1, int dh2,
                    float neg_lr_g, float neg_lr_d, float b1, float omb1,
                    float b2, float omb2, float eps, void* stream) {
  if (!supported(L_g, gdims, dh1, dh2) || W < 1 || E < 1 || B < 1)
    return (int)cudaErrorInvalidValue;
  Args a{};
  const int nG = 2 * L_g;
  for (int j = 0; j < 3 * nG; ++j) {
    a.g_in[j] = (float*)g_in[j];
    a.g_out[j] = (float*)g_out[j];
  }
  for (int j = 0; j < 18; ++j) {
    a.d_in[j] = (float*)d_in[j];
    a.d_out[j] = (float*)d_out[j];
  }
  for (int i = 0; i < L_g; ++i) {
    a.g_n[2 * i] = (long long)gdims[i] * gdims[i + 1];
    a.g_n[2 * i + 1] = gdims[i + 1];
  }
  const int xdim = gdims[L_g];
  const long long d_n[6] = {(long long)xdim * dh1, dh1, (long long)dh1 * dh2,
                            dh2, dh2, 1};
  for (int j = 0; j < 6; ++j) a.d_n[j] = d_n[j];
  a.scratch = scratch;
  a.lay = layout(B, L_g, gdims, dh1, dh2);
  a.reals = reals;
  a.z1 = z1;
  a.z2 = z2;
  a.g_count = g_count;
  a.d_count = d_count;
  a.g_count_step = g_count_per_worker ? 1 : 0;
  a.d_count_step = d_count_per_worker ? 1 : 0;
  a.d_loss = d_loss;
  a.g_loss = g_loss;
  a.E = E;
  a.B = B;
  a.L_g = L_g;
  for (int i = 0; i <= L_g; ++i) a.gdims[i] = gdims[i];
  a.dh1 = dh1;
  a.dh2 = dh2;
  a.kg = AdamConsts{neg_lr_g, b1, omb1, b2, omb2, eps};
  a.kd = AdamConsts{neg_lr_d, b1, omb1, b2, omb2, eps};

  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      launch_config(W, (cudaStream_t)stream, attr, CLUSTER);
  const cudaError_t err = cudaLaunchKernelEx(&cfg, sweep_kernel, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"

// fused_sweep.cu — E interleaved (D step, G step) local iterations for W
// FedAvg-family workers (Hopper, f32).
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
// in optax order with per-worker bias corrections ccg/ccd[w][e] =
// (1 - b1^t, 1 - b2^t), separately for G and D.  State (params, mu, nu of
// both nets) is read from `*_in` and the result written to `*_out` (iteration
// 0 reads the inputs, later iterations update the outputs in place);
// d_loss[w] and g_loss[w] hold the mean over the E iterations.
//
// Bound at the main-path shapes (W=16, E=5, B=100; G 100-256-128-2, D
// 2-128-256-1): ~95 MFLOP per worker-iteration, 7.6 GFLOP per call, all f32
// FMA: ~0.11 ms at the H100 SXM's 67 TFLOP/s of non-tensor f32.  The least
// traffic is one read and one write of the 16 workers' state plus the
// latents (~42 MB, ~0.013 ms at 3.35 TB/s), so the call is bound by
// operations on paper and by launch overhead in practice.
//
// Design (simple and right first): the TPU kernel kept one worker's 1.1 MB
// of state resident in VMEM across the E iterations; an SM has 227 KB of
// shared memory, so here every iteration is a pipeline of small kernels on
// one stream (about 40 launches) that re-reads the state, which stays in the
// 50 MB L2 (17.8 MB for 16 workers).  One C call enqueues all E iterations.
// The products are the shared batched tiled SIMT GEMM of mlp_kernels.cuh
// (blockIdx.z = worker, guarded partial tiles: D's first layer has K=2, G's
// last N=2); no tensor cores, no library GEMM.  Fusing an iteration into one
// persistent kernel per worker is later work.

#include "mlp_kernels.cuh"

namespace {

// X[w][0:B] = reals[w][e]: grid (W,).
__global__ void reals_kernel(const float* __restrict__ reals, long long sRb,
                             float* __restrict__ X, int B, int xdim) {
  const int w = blockIdx.x;
  const float* src = reals + w * sRb;
  float* dst = X + (long long)w * 2 * B * xdim;
  for (int i = threadIdx.x; i < B * xdim; i += blockDim.x) dst[i] = src[i];
}

// Sigmoid head with the clipped BCE, its loss and dL/dz per worker: grid
// (W,), one block.  D step (g_step = 0): R = 2B rows, the first B are real
// (target 1), the rest fake (target 0).  G step (g_step = 1): R = B rows,
// all target 1.  loss[w] accumulates over the iterations (first = 1 starts
// it) and is divided by E_final when that is > 0 (the last iteration).
__global__ void sweep_head_kernel(const float* __restrict__ Z3,
                                  float* __restrict__ G3,
                                  float* __restrict__ loss, int R, int B,
                                  int g_step, int first, int E_final) {
  __shared__ float red[TPB];
  const int w = blockIdx.x;
  const float* z = Z3 + (long long)w * R;
  float* g = G3 + (long long)w * R;
  const float inv_B = (float)(1.0 / (double)B);
  const float neg_inv_B = (float)(-1.0 / (double)B);
  float part = 0.f;
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    const float p = 1.f / (1.f + expf(-z[r]));
    const float pc = fminf(fmaxf(p, P_LO), P_HI);
    const float inside = (p > P_LO && p < P_HI) ? 1.f : 0.f;
    float dpc;
    if (g_step) {
      part += -logf(pc);
      dpc = neg_inv_B / pc;
    } else {
      const float is_real = r < B ? 1.f : 0.f;
      part += -(is_real * logf(pc) + (1.f - is_real) * log1pf(-pc));
      dpc = inv_B * (is_real * (-1.f / pc)
                     + (1.f - is_real) * (1.f / (1.f - pc)));
    }
    g[r] = dpc * inside * p * (1.f - p);
  }
  red[threadIdx.x] = part;
  __syncthreads();
  for (int s = TPB / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    float sum = red[0] / (float)B;
    if (!first) sum += loss[w];
    loss[w] = E_final > 0 ? sum / (float)E_final : sum;
  }
}

// Y = epilogue(X W + b): X (R x K) rows, ld K, batch stride sXb; W (K x N).
template <int EPI>
int fwd(cudaStream_t st, int Wn, int R, int K, int N, const float* X,
        long long sXb, const float* Wt, const float* bias, float* C,
        long long sCb, float* H) {
  gemm_kernel<true, true, EPI><<<gemm_grid(R, N, Wn), TPB, 0, st>>>(
      R, N, K, X, sXb, K, 1, Wt, (long long)K * N, N, 1, C, sCb, bias, N, H,
      nullptr);
  return (int)cudaGetLastError();
}

// dW (M x N) = A^T G: A (R x M) rows, ld M, batch stride sAb; G (R x N).
int wgrad(cudaStream_t st, int Wn, int R, int M, int N, const float* A,
          long long sAb, const float* G, float* dW) {
  gemm_kernel<false, true, EPI_STORE><<<gemm_grid(M, N, Wn), TPB, 0, st>>>(
      M, N, R, A, sAb, 1, M, G, (long long)R * N, N, 1, dW, (long long)M * N,
      nullptr, 0, nullptr, nullptr);
  return (int)cudaGetLastError();
}

// dX (R x K) = (G W^T) * epilogue(Zaux): G (R x N), W (K x N).
template <int EPI>
int xgrad(cudaStream_t st, int Wn, int R, int K, int N, const float* G,
          const float* Wt, float* dX, const float* Zaux) {
  gemm_kernel<true, false, EPI><<<gemm_grid(R, K, Wn), TPB, 0, st>>>(
      R, K, N, G, (long long)R * N, N, 1, Wt, (long long)K * N, 1, N, dX,
      (long long)R * K, nullptr, 0, nullptr, Zaux);
  return (int)cudaGetLastError();
}

int colsum(cudaStream_t st, int Wn, const float* G, float* out, int R,
           int N) {
  colsum_kernel<<<dim3((N + TPB - 1) / TPB, Wn), TPB, 0, st>>>(G, out, R, N);
  return (int)cudaGetLastError();
}

// One Adam pass per tensor of a net: cur = where params/mu/nu are read.
int adam_net(cudaStream_t st, int Wn, int n_tensors, float* const* cur,
             float* const* out, float* const* grads, const long long* n_per,
             const float* cc, int E, int e, float neg_lr, float b1,
             float omb1, float b2, float omb2, float eps) {
  for (int j = 0; j < n_tensors; ++j) {
    const long long total = n_per[j] * Wn;
    long long blocks = (total + TPB - 1) / TPB;
    if (blocks > 4096) blocks = 4096;
    adam_kernel<<<(unsigned)blocks, TPB, 0, st>>>(
        cur[j], cur[n_tensors + j], cur[2 * n_tensors + j], grads[j], out[j],
        out[n_tensors + j], out[2 * n_tensors + j], n_per[j], Wn, cc, E, e,
        neg_lr, b1, omb1, b2, omb2, eps);
    CHECK_LAUNCH();
  }
  return 0;
}

constexpr int MAX_LG = 3;

}  // namespace

#define TRY(call)               \
  do {                          \
    int rc_ = (call);           \
    if (rc_ != 0) return rc_;   \
  } while (0)

extern "C" {

const char* fused_sweep_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// g_in/g_out: 6*L_g device pointers each, in the order
//   w0 b0 .. w(L-1) b(L-1) | mu of the same | nu of the same;
// d_in/d_out: 18 each, likewise for the 3-layer D.
// scratch: X FAKE2 DFAKE | DZ1 DH1 DZ2 DH2 DZ3 G3 DDZ2 DDZ1 | 6 D grads |
//   (GZ[i] GH[i] GDZ[i]) for i < L_g-1 | 2*L_g G grads.
// reals (W,E,B,xdim), z1/z2 (W,E,B,gdims[0]), ccg/ccd (W,E,2), losses (W,).
// gdims: L_g+1 host ints (G widths); D widths are xdim-dh1-dh2-1 with
// xdim = gdims[L_g].  Returns 0 or the first cudaGetLastError() code
// (cudaErrorInvalidValue for an unsupported L_g).
int fused_sweep_f32(void* const* g_in_, void* const* g_out_,
                    void* const* d_in_, void* const* d_out_,
                    void* const* scratch, const float* reals,
                    const float* z1, const float* z2, const float* ccg,
                    const float* ccd, float* d_loss, float* g_loss, int W,
                    int E, int B, int L_g, const int* gdims, int dh1, int dh2,
                    float neg_lr_g, float neg_lr_d, float b1, float omb1,
                    float b2, float omb2, float eps, void* stream) {
  if (L_g < 1 || L_g > MAX_LG) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  float* const* g_in = (float* const*)g_in_;
  float* const* g_out = (float* const*)g_out_;
  float* const* d_in = (float* const*)d_in_;
  float* const* d_out = (float* const*)d_out_;
  float* const* s = (float* const*)scratch;
  const int xdim = gdims[L_g], zdim = gdims[0];
  const int nG = 2 * L_g;
  float *X = s[0], *FAKE2 = s[1], *DFAKE = s[2];
  float *DZ1 = s[3], *DH1 = s[4], *DZ2 = s[5], *DH2 = s[6], *DZ3 = s[7],
        *G3 = s[8], *DDZ2 = s[9], *DDZ1 = s[10];
  float* const* dgrads = s + 11;
  float *GZ[MAX_LG], *GH[MAX_LG], *GDZ[MAX_LG];
  for (int i = 0; i < L_g - 1; ++i) {
    GZ[i] = s[17 + 3 * i];
    GH[i] = s[18 + 3 * i];
    GDZ[i] = s[19 + 3 * i];
  }
  float* const* ggrads = s + 17 + 3 * (L_g - 1);

  long long g_n[2 * MAX_LG];
  for (int i = 0; i < L_g; ++i) {
    g_n[2 * i] = (long long)gdims[i] * gdims[i + 1];
    g_n[2 * i + 1] = gdims[i + 1];
  }
  const long long d_n[6] = {(long long)xdim * dh1, dh1, (long long)dh1 * dh2,
                            dh2, dh2, 1};
  const long long sZb = (long long)E * B * zdim;     // z1/z2 worker stride
  const long long sRb = (long long)E * B * xdim;     // reals worker stride
  const int R2 = 2 * B;

  // G forward on latents zin (this iteration's (B, zdim) block of every
  // worker) with the params at gp; the tanh output goes to out.
  auto g_forward = [&](float* const* gp, const float* zin, float* out,
                       long long sOutb) -> int {
    const float* h = zin;
    long long sh = sZb;
    for (int i = 0; i < L_g; ++i) {
      const int K = gdims[i], N = gdims[i + 1];
      if (i < L_g - 1) {
        TRY(fwd<EPI_BIAS_LRELU>(st, W, B, K, N, h, sh, gp[2 * i],
                                gp[2 * i + 1], GZ[i], (long long)B * N,
                                GH[i]));
        h = GH[i];
        sh = (long long)B * N;
      } else {
        TRY(fwd<EPI_BIAS_TANH>(st, W, B, K, N, h, sh, gp[2 * i],
                               gp[2 * i + 1], out, sOutb, nullptr));
      }
    }
    return 0;
  };
  // D forward on R rows of xin with the params at dp; logits to DZ3.
  auto d_forward = [&](float* const* dp, const float* xin, int R) -> int {
    TRY(fwd<EPI_BIAS_LRELU>(st, W, R, xdim, dh1, xin, (long long)R * xdim,
                            dp[0], dp[1], DZ1, (long long)R * dh1, DH1));
    TRY(fwd<EPI_BIAS_LRELU>(st, W, R, dh1, dh2, DH1, (long long)R * dh1,
                            dp[2], dp[3], DZ2, (long long)R * dh2, DH2));
    TRY(fwd<EPI_BIAS>(st, W, R, dh2, 1, DH2, (long long)R * dh2, dp[4],
                      dp[5], DZ3, (long long)R, nullptr));
    return 0;
  };

  for (int e = 0; e < E; ++e) {
    float* const* gcur = e == 0 ? g_in : g_out;
    float* const* dcur = e == 0 ? d_in : d_out;
    const float* z1e = z1 + (long long)e * B * zdim;
    const float* z2e = z2 + (long long)e * B * zdim;
    const int last = e == E - 1 ? E : 0;

    // ---- 1. X = concat(real, G(z1)) ----
    reals_kernel<<<W, TPB, 0, st>>>(reals + (long long)e * B * xdim, sRb, X,
                                    B, xdim);
    CHECK_LAUNCH();
    TRY(g_forward(gcur, z1e, X + (long long)B * xdim,
                  (long long)R2 * xdim));

    // ---- 2. D step ----
    TRY(d_forward(dcur, X, R2));
    sweep_head_kernel<<<W, TPB, 0, st>>>(DZ3, G3, d_loss, R2, B, 0, e == 0,
                                         last);
    CHECK_LAUNCH();
    TRY(wgrad(st, W, R2, dh2, 1, DH2, (long long)R2 * dh2, G3, dgrads[4]));
    TRY(colsum(st, W, G3, dgrads[5], R2, 1));
    TRY(xgrad<EPI_LRELU_GRAD>(st, W, R2, dh2, 1, G3, dcur[4], DDZ2, DZ2));
    TRY(wgrad(st, W, R2, dh1, dh2, DH1, (long long)R2 * dh1, DDZ2,
              dgrads[2]));
    TRY(colsum(st, W, DDZ2, dgrads[3], R2, dh2));
    TRY(xgrad<EPI_LRELU_GRAD>(st, W, R2, dh1, dh2, DDZ2, dcur[2], DDZ1,
                              DZ1));
    TRY(wgrad(st, W, R2, xdim, dh1, X, (long long)R2 * xdim, DDZ1,
              dgrads[0]));
    TRY(colsum(st, W, DDZ1, dgrads[1], R2, dh1));
    TRY(adam_net(st, W, 6, dcur, d_out, dgrads, d_n, ccd, E, e, neg_lr_d, b1,
                 omb1, b2, omb2, eps));

    // ---- 3. G step through the updated D (d_out) ----
    TRY(g_forward(gcur, z2e, FAKE2, (long long)B * xdim));
    TRY(d_forward(d_out, FAKE2, B));
    sweep_head_kernel<<<W, TPB, 0, st>>>(DZ3, G3, g_loss, B, B, 1, e == 0,
                                         last);
    CHECK_LAUNCH();
    TRY(xgrad<EPI_LRELU_GRAD>(st, W, B, dh2, 1, G3, d_out[4], DDZ2, DZ2));
    TRY(xgrad<EPI_LRELU_GRAD>(st, W, B, dh1, dh2, DDZ2, d_out[2], DDZ1,
                              DZ1));
    TRY(xgrad<EPI_TANH_GRAD>(st, W, B, xdim, dh1, DDZ1, d_out[0], DFAKE,
                             FAKE2));
    const float* dz = DFAKE;
    for (int i = L_g - 1; i >= 0; --i) {
      const int K = gdims[i], N = gdims[i + 1];
      const float* ins = i == 0 ? z2e : GH[i - 1];
      const long long sIb = i == 0 ? sZb : (long long)B * K;
      TRY(wgrad(st, W, B, K, N, ins, sIb, dz, ggrads[2 * i]));
      TRY(colsum(st, W, dz, ggrads[2 * i + 1], B, N));
      if (i > 0) {
        TRY(xgrad<EPI_LRELU_GRAD>(st, W, B, K, N, dz, gcur[2 * i],
                                  GDZ[i - 1], GZ[i - 1]));
        dz = GDZ[i - 1];
      }
    }
    TRY(adam_net(st, W, nG, gcur, g_out, ggrads, g_n, ccg, E, e, neg_lr_g,
                 b1, omb1, b2, omb2, eps));
  }
  return 0;
}

}  // extern "C"

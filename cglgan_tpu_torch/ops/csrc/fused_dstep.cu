// fused_dstep.cu — E local discriminator steps for W clients (Hopper;
// float32 state, or bfloat16 state with bfloat16-input products).
//
// Replaces the Pallas TPU kernel `_dstep_kernel`
// (cglgan_tpu/ops/pallas/fused_dstep.py:44-157, launched by
// `fused_d_epoch_steps` :315-402).  Per client and local step e:
//   X = concat(real window at starts[e], fake)                     (2B, din)
//   real: u8 images scaled /255 -> [-1, 1], or float32 rows (2DMG) as they
//   are (the reference's is_image switch, fused_dstep.py:86-91)
//   z1 = X W1 + b1, h1 = lrelu(z1); z2 = h1 W2 + b2, h2 = lrelu(z2);
//   z3 = h2 W3 + b3; head (sigmoid + clipped BCE | 2 logits + CE, x0.5 when
//   d_loss_half); hand-derived backward; six Adam updates in optax order
//   with per-client bias corrections cc[w][e] = (1 - b1^t, 1 - b2^t).
// The 18 state tensors (params, mu, nu) are read from `state_in` and the
// result written to `state_out` (step 0 reads the inputs, later steps update
// the outputs in place); `loss[w]` holds the last step's loss.
//
// Bound at the main-path shapes (W=16, E=5, B=100, din=784, 512, 256, 2):
// forward + backward are ~479 MFLOP per client-step, 38.3 GFLOP per call.
// At float32 accuracy the card's fastest way is three TF32 tensor-core
// passes (3 x 38.3 GFLOP at 495 TFLOP/s = 0.232 ms; the non-tensor f32 rate
// of 67 TFLOP/s gives 0.572 ms).  The least traffic is one read and one
// write of the 16 clients' state plus the shards' windows (~212 MB, 0.063 ms
// at 3.35 TB/s), so the call is bound by operations.
//
// Design.  The TPU kernel kept one client's 6.4 MB of state resident in VMEM
// across the E steps; an SM has 227 KB of shared memory, so every step is a
// pipeline of kernels on one stream, batched over clients, and re-reads the
// state from device memory (L2 holds part of it).  What held the first
// version back was, in order: no tensor cores; every weight gradient written
// out and read back by a separate Adam pass; 19 launches a step.  Now a
// step is 8 launches:
//   prep        real window (u8 or f32) + fake -> X
//   z1, z2      X W1, h1 W2 on the tensor cores (mma_tf32.cuh, 3xTF32),
//               bias + LeakyReLU in the epilogue; only h is stored (its sign
//               is the pre-activation's, which is all the backward needs)
//   head        one warp a row: z3 = h2 W3 + b3, the row's loss term,
//               g3 = dL/dz3 and dz2 = (g3 W3^T) * lrelu'(h2); SIMT, the
//               layers with 1 or 2 outputs have almost no work
//   small       dW3 = h2^T g3, db3, their Adam updates and the loss; SIMT
//   dz1         dz2 W2^T * lrelu'(h1) on the tensor cores
//   dW2, dW1    h1^T dz2, X^T dz1 on the tensor cores; the block that holds
//               a tile of dW applies Adam to that tile of (p, mu, nu) and
//               the first row of blocks sums dz's columns for the bias
//               gradient: no gradient reaches device memory, no Adam pass,
//               no column-sum pass
// Order: every product with W_l^T is enqueued before the kernel that
// updates W_l (head before small, dz1 before dW2).  wgmma + TMA, and keeping
// a client's layer on chip across steps, are later work.
//
// bfloat16 state (the reference's --dtype bfloat16 with pallas_dstep=True:
// _dstep_kernel with mxu_bf16, fused_dstep.py:44-87,161-164).  The TPU
// kernel loads bf16 state, keeps it in float32 across the E steps, feeds
// every product bf16 operands with float32 sums, and rounds the state to
// bf16 once, at the store.  Here: one launch upcasts the 18 bf16 state
// tensors into float32 work buffers; the E-step chain above runs on them in
// place, its GEMMs with bfloat16 operands (mma_tf32.cuh, BF) and the SIMT
// products of the head and small kernels on operands rounded to bf16 in
// registers; its Adam epilogues write float32, so nothing rounds between
// steps; one launch rounds the work buffers to the bf16 outputs (nearest
// even).  Two launches more a call; fakes may be bf16 (the bf16 G's) or
// float32.  Bound at the main-path shapes: the same 38.3 GFLOP at the dense
// bf16 rate (989 TFLOP/s) is 0.039 ms; the bf16 state read and written once
// is ~102 MB, 0.031 ms at 3.35 TB/s: bound by operations, ~6x below the
// float32 (3xTF32) bound.

#include <cuda_bf16.h>

#include <cstdio>

#include "mma_tf32.cuh"

namespace {

constexpr int HEAD_SIGMOID = 0, HEAD_LOGITS2 = 1;
constexpr int MAX_OUT = 2;          // the heads have 1 or 2 outputs
constexpr unsigned FULL = 0xFFFFFFFFu;

// a real row's element: u8 images scaled to [-1, 1], float rows as they are
__device__ __forceinline__ float real_value(uint8_t x) {
  return ((float)x / 255.0f - 0.5f) / 0.5f;
}
__device__ __forceinline__ float real_value(float x) { return x; }
__device__ __forceinline__ float as_float(float x) { return x; }
__device__ __forceinline__ float as_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// x rounded to bfloat16 (nearest even) and back when `bf`: the operand of a
// bf16-input product, whose float32 sum is then exact term by term
__device__ __forceinline__ float operand(float x, bool bf) {
  return bf ? __bfloat162float(__float2bfloat16_rn(x)) : x;
}

// X[w] = concat(real window, fake): grid (2B, W).  T: the real rows' type;
// F: the fakes' (float32, or bf16 from a bf16 G).  The window starts at
// starts[e], read from device memory, so that a replayed graph reads the
// round's own windows; a start outside [0, max_len - B] stops the kernel
// (__trap: the launch, and the run, fail) rather than read another row.
template <typename T, typename F>
__global__ void prep_kernel(const T* __restrict__ shards, long long max_len,
                            const int* __restrict__ starts, int e,
                            const F* __restrict__ fake, long long fake_sw,
                            float* __restrict__ X, int B, int din) {
  const int w = blockIdx.y, r = blockIdx.x;
  const long long start = starts[e];
  if (start < 0 || start > max_len - B) {
    if (threadIdx.x == 0 && w == 0 && r == 0)
      printf("fused_dstep: window start %lld outside [0, %lld]\n", start,
             max_len - B);
    __trap();
  }
  float* xr = X + ((long long)w * 2 * B + r) * din;
  if (r < B) {
    const T* src = shards + ((long long)w * max_len + start + r) * din;
    for (int c = threadIdx.x; c < din; c += blockDim.x)
      xr[c] = real_value(src[c]);
  } else {
    const F* src = fake + w * fake_sw + (long long)(r - B) * din;
    for (int c = threadIdx.x; c < din; c += blockDim.x)
      xr[c] = as_float(src[c]);
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) x += __shfl_xor_sync(FULL, x, s);
  return x;
}

// One warp a row r of client w: z3, the row's loss term PER[w][r], G3 =
// dL/dz3 and DZ2 = (g3 W3^T) * lrelu'(h2), all from the W3 of before this
// step's update.  grid (ceil(2B / 8), W), 256 threads.
__global__ void __launch_bounds__(256) head_kernel(
    const float* __restrict__ H2, const float* __restrict__ W3,
    const float* __restrict__ b3, float* __restrict__ G3,
    float* __restrict__ PER, float* __restrict__ DZ2, int B, int h2, int dout,
    int head, float grad_scale, bool bf) {
  const int w = blockIdx.y, R = 2 * B;
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * 8 + (threadIdx.x >> 5);
  if (r >= R) return;
  const float* h = H2 + ((long long)w * R + r) * h2;
  const float* w3 = W3 + (long long)w * h2 * dout;
  float z[MAX_OUT] = {0.f, 0.f};
  for (int k = lane; k < h2; k += 32) {
    const float hv = operand(h[k], bf);
    for (int j = 0; j < dout; ++j)
      z[j] = fmaf(hv, operand(w3[k * dout + j], bf), z[j]);
  }
  for (int j = 0; j < dout; ++j) z[j] = warp_sum(z[j]) + b3[w * dout + j];

  const float is_real = r < B ? 1.f : 0.f;
  float g[MAX_OUT] = {0.f, 0.f}, per;
  if (head == HEAD_SIGMOID) {
    const float p = 1.f / (1.f + expf(-z[0]));
    const float pc = fminf(fmaxf(p, P_LO), P_HI);
    per = -(is_real * logf(pc) + (1.f - is_real) * log1pf(-pc));
    const float dpc = grad_scale * (is_real * (-1.f / pc)
                                    + (1.f - is_real) * (1.f / (1.f - pc)));
    const float inside = (p > P_LO && p < P_HI) ? 1.f : 0.f;
    g[0] = dpc * inside * p * (1.f - p);
  } else {
    const float zmax = fmaxf(z[0], z[1]);
    const float s0 = z[0] - zmax, s1 = z[1] - zmax;
    const float lse = logf(expf(s0) + expf(s1));
    const float lp0 = s0 - lse, lp1 = s1 - lse;
    const float t0 = 1.f - is_real, t1 = is_real;     // real rows: class 1
    per = t0 * lp0 + t1 * lp1;
    g[0] = grad_scale * (expf(lp0) - t0);
    g[1] = grad_scale * (expf(lp1) - t1);
  }
  if (lane == 0) {
    PER[(long long)w * R + r] = per;
    for (int j = 0; j < dout; ++j) G3[((long long)w * R + r) * dout + j] = g[j];
  }
  float* dz = DZ2 + ((long long)w * R + r) * h2;
  float gop[MAX_OUT] = {operand(g[0], bf), operand(g[1], bf)};
  for (int k = lane; k < h2; k += 32) {
    float s = 0.f;
    for (int j = 0; j < dout; ++j)
      s = fmaf(gop[j], operand(w3[k * dout + j], bf), s);
    dz[k] = s * (h[k] >= 0.f ? 1.f : 0.2f);
  }
}

// dW3 = h2^T g3 and its Adam update: a block owns 32 rows of W3, its 8
// warps each sum every 8th row of the batch and the partial sums are added
// in a fixed order.  In the first block of a client, warp 0 also sums g3's
// columns (db3) and updates b3, and warp 1 sums the rows' loss terms.
// grid (ceil(h2 / 32), W), 256 threads.
__global__ void __launch_bounds__(256) small_grads_kernel(
    const float* __restrict__ H2, const float* __restrict__ G3,
    const float* __restrict__ PER, const float* p, const float* m,
    const float* v, float* po, float* mo, float* vo, const float* bp,
    const float* bm, const float* bv, float* bpo, float* bmo, float* bvo,
    float* __restrict__ loss, const float* __restrict__ cc, int E, int e,
    int B, int h2, int dout, int head, float loss_scale, AdamConsts kc,
    bool bf) {
  __shared__ float part[8][32][MAX_OUT];
  const int w = blockIdx.y, R = 2 * B;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int k = blockIdx.x * 32 + lane;
  const float c1 = cc[(w * E + e) * 2], c2 = cc[(w * E + e) * 2 + 1];
  const float* g3 = G3 + (long long)w * R * dout;
  float acc[MAX_OUT] = {0.f, 0.f};
  if (k < h2) {
    const float* h = H2 + (long long)w * R * h2 + k;
#pragma unroll 4
    for (int r = warp; r < R; r += 8) {
      const float hv = operand(h[(long long)r * h2], bf);
      for (int j = 0; j < dout; ++j)
        acc[j] = fmaf(hv, operand(g3[r * dout + j], bf), acc[j]);
    }
  }
  for (int j = 0; j < MAX_OUT; ++j) part[warp][lane][j] = acc[j];
  __syncthreads();
  if (warp == 0 && k < h2) {
    for (int j = 0; j < dout; ++j) {
      float s = 0.f;
      for (int q = 0; q < 8; ++q) s += part[q][lane][j];
      const long long o = ((long long)w * h2 + k) * dout + j;
      float pn, mn, vn;
      adam_one(p[o], m[o], v[o], s, c1, c2, kc, &pn, &mn, &vn);
      po[o] = pn;
      mo[o] = mn;
      vo[o] = vn;
    }
  }
  if (blockIdx.x != 0) return;
  if (warp == 0) {
    for (int j = 0; j < dout; ++j) {
      float s = 0.f;
      for (int r = lane; r < R; r += 32) s += g3[r * dout + j];
      s = warp_sum(s);
      if (lane == 0) {
        const long long o = (long long)w * dout + j;
        float pn, mn, vn;
        adam_one(bp[o], bm[o], bv[o], s, c1, c2, kc, &pn, &mn, &vn);
        bpo[o] = pn;
        bmo[o] = mn;
        bvo[o] = vn;
      }
    }
  } else if (warp == 1) {
    float s = 0.f;
    for (int r = lane; r < R; r += 32) s += PER[(long long)w * R + r];
    s = warp_sum(s);
    if (lane == 0)
      loss[w] = head == HEAD_SIGMOID ? loss_scale * s / (float)B
                                     : loss_scale * (-s / (float)B);
  }
}

constexpr int N_STATE = 18;

// The 18 state tensors' bf16 and float32 copies and their sizes, passed by
// value.
struct CastTable {
  const void* src[N_STATE];
  void* dst[N_STATE];
  long long n[N_STATE];
};

// UP: bf16 -> float32 (exact); else float32 -> bf16, nearest even.  One
// launch for all 18 tensors: blockIdx.y picks the tensor, the blocks of a
// row stride over it.
template <bool UP>
__global__ void __launch_bounds__(256) cast_kernel(
    __grid_constant__ const CastTable t) {
  const int j = blockIdx.y;
  const long long n = t.n[j];
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    if (UP)
      ((float*)t.dst[j])[i] =
          __bfloat162float(((const __nv_bfloat16*)t.src[j])[i]);
    else
      ((__nv_bfloat16*)t.dst[j])[i] =
          __float2bfloat16_rn(((const float*)t.src[j])[i]);
  }
}

int launch_cast(bool up, void* const* src, void* const* dst, int W,
                int din, int h1, int h2, int dout, cudaStream_t st) {
  const long long sizes[6] = {(long long)W * din * h1, (long long)W * h1,
                              (long long)W * h1 * h2,  (long long)W * h2,
                              (long long)W * h2 * dout, (long long)W * dout};
  CastTable t;
  long long most = 0;
  for (int j = 0; j < N_STATE; ++j) {
    t.src[j] = src[j];
    t.dst[j] = dst[j];
    t.n[j] = sizes[j % 6];
    most = most > t.n[j] ? most : t.n[j];
  }
  const long long blocks = (most + 255) / 256;
  const dim3 grid((unsigned)(blocks < 1024 ? blocks : 1024), N_STATE);
  if (up)
    cast_kernel<true><<<grid, 256, 0, st>>>(t);
  else
    cast_kernel<false><<<grid, 256, 0, st>>>(t);
  return (int)cudaGetLastError();
}

// The E-step chain on float32 state: step 0 reads `in`, every step writes
// `out` (in may be out).  BF: products with bfloat16 operands.
template <bool BF>
int run_steps(float* const* in, float* const* out, void* const* scratch,
              const void* shards, int real_u8, long long max_len,
              const int* starts, const void* fake, int fake_bf16,
              int fake_per_client, const float* cc, float* loss, int W,
              int E, int B, int din, int h1, int h2, int dout, int head,
              float loss_scale, float grad_scale, AdamConsts kc,
              cudaStream_t st) {
  float* const* s = (float* const*)scratch;
  float *X = s[0], *H1 = s[1], *H2 = s[2], *G3 = s[3], *PER = s[4],
        *DZ2 = s[5], *DZ1 = s[6];
  const int R = 2 * B;
  const long long fake_sw = fake_per_client ? (long long)B * din : 0;
  int rc;

  for (int e = 0; e < E; ++e) {
    float* const* cur = e == 0 ? in : out;

    const dim3 pgrid((unsigned)R, W);
    if (real_u8 && fake_bf16)
      prep_kernel<<<pgrid, 256, 0, st>>>(
          (const uint8_t*)shards, max_len, starts, e,
          (const __nv_bfloat16*)fake, fake_sw, X, B, din);
    else if (real_u8)
      prep_kernel<<<pgrid, 256, 0, st>>>(
          (const uint8_t*)shards, max_len, starts, e, (const float*)fake,
          fake_sw, X, B, din);
    else if (fake_bf16)
      prep_kernel<<<pgrid, 256, 0, st>>>(
          (const float*)shards, max_len, starts, e,
          (const __nv_bfloat16*)fake, fake_sw, X, B, din);
    else
      prep_kernel<<<pgrid, 256, 0, st>>>(
          (const float*)shards, max_len, starts, e, (const float*)fake,
          fake_sw, X, B, din);
    CHECK_LAUNCH();

    // ---- forward: h_l = lrelu(h_{l-1} W_l + b_l) ----
    auto forward = [&](const float* A, int K, const float* Wl,
                       const float* bl, int N, float* H) {
      tc::GemmArgs a{};
      a.M = R; a.N = N; a.K = K;
      a.A = A; a.sA = (long long)R * K; a.ldA = K;
      a.B = Wl; a.sB = (long long)K * N; a.ldB = N;
      a.out = H; a.bias = bl;
      return tc::launch_gemm3x<true, true, tc::EPI_BIAS_LRELU, BF>(a, W, st);
    };
    if ((rc = forward(X, din, cur[0], cur[1], h1, H1)) != 0) return rc;
    if ((rc = forward(H1, h1, cur[2], cur[3], h2, H2)) != 0) return rc;

    head_kernel<<<dim3((R + 7) / 8, W), 256, 0, st>>>(
        H2, cur[4], cur[5], G3, PER, DZ2, B, h2, dout, head, grad_scale, BF);
    CHECK_LAUNCH();
    small_grads_kernel<<<dim3((h2 + 31) / 32, W), 256, 0, st>>>(
        H2, G3, PER, cur[4], cur[10], cur[16], out[4], out[10], out[16],
        cur[5], cur[11], cur[17], out[5], out[11], out[17], loss, cc, E, e, B,
        h2, dout, head, loss_scale, kc, BF);
    CHECK_LAUNCH();

    // ---- dz1 = (dz2 W2^T) * lrelu'(h1), from the W2 of before its update
    {
      tc::GemmArgs a{};
      a.M = R; a.N = h1; a.K = h2;
      a.A = DZ2; a.sA = (long long)R * h2; a.ldA = h2;
      a.B = cur[2]; a.sB = (long long)h1 * h2; a.ldB = h2;
      a.out = DZ1; a.aux = H1;
      rc = tc::launch_gemm3x<true, false, tc::EPI_LRELU_GRAD, BF>(a, W,
                                                                 st);
      if (rc != 0) return rc;
    }

    // ---- dW_l = h_{l-1}^T dz_l with Adam on (W_l, b_l) in the epilogue ----
    auto weight_grad = [&](const float* A, int M, const float* DZ, int N,
                           int j) {
      tc::GemmArgs a{};
      a.M = M; a.N = N; a.K = R;
      a.A = A; a.sA = (long long)R * M; a.ldA = M;
      a.B = DZ; a.sB = (long long)R * N; a.ldB = N;
      a.p = cur[j]; a.m = cur[6 + j]; a.v = cur[12 + j];
      a.po = out[j]; a.mo = out[6 + j]; a.vo = out[12 + j];
      a.bp = cur[j + 1]; a.bm = cur[7 + j]; a.bv = cur[13 + j];
      a.bpo = out[j + 1]; a.bmo = out[7 + j]; a.bvo = out[13 + j];
      a.cc = cc; a.E = E; a.e = e; a.k = kc;
      return tc::launch_gemm3x<false, true, tc::EPI_ADAM, BF>(a, W, st);
    };
    if ((rc = weight_grad(H1, h1, DZ2, h2, 2)) != 0) return rc;
    if ((rc = weight_grad(X, din, DZ1, h1, 0)) != 0) return rc;
  }
  return 0;
}


}  // namespace

extern "C" {

const char* fused_dstep_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// state_in/state_out: 18 device pointers each, in the order
//   w1 b1 w2 b2 w3 b3 | mu of the same | nu of the same;
//   float32 (state_bf16 = 0) or bf16 (state_bf16 = 1).
// work: with bf16 state, 18 float32 buffers of the same shapes (the state
//   during the call); unused otherwise.
// scratch: 7 device pointers: X (W,2B,din) H1 (W,2B,h1) H2 (W,2B,h2)
//   G3 (W,2B,dout) PER (W,2B) DZ2 (W,2B,h2) DZ1 (W,2B,h1).
// shards: (W, max_len, din), uint8 images (real_u8 = 1) or float32 rows.
// fake: (B, din) or, fake_per_client, (W, B, din); float32 or bf16
//   (fake_bf16 = 1).
// starts: E device int32 window starts, each checked on the device.
// cc: (W, E, 2) device.  loss: (W,).  dout <= 2.  Every pointer, starts
// included, is read by the kernels, never by the host: a captured call
// replays with whatever the buffers hold then.
// Returns 0 or the first cudaGetLastError() code.
int fused_dstep(void* const* state_in, void* const* state_out,
                void* const* work, int state_bf16, void* const* scratch,
                const void* shards, int real_u8, long long max_len,
                const int* starts, const void* fake, int fake_bf16,
                int fake_per_client, const float* cc, float* loss, int W,
                int E, int B, int din, int h1, int h2, int dout, int head,
                float loss_scale, float grad_scale, float neg_lr, float b1,
                float omb1, float b2, float omb2, float eps, void* stream) {
  if (dout < 1 || dout > MAX_OUT) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const AdamConsts kc{neg_lr, b1, omb1, b2, omb2, eps};
  if (!state_bf16)
    return run_steps<false>(
        (float* const*)state_in, (float* const*)state_out, scratch, shards,
        real_u8, max_len, starts, fake, fake_bf16, fake_per_client, cc, loss,
        W, E, B, din, h1, h2, dout, head, loss_scale, grad_scale, kc, st);
  int rc = launch_cast(true, state_in, work, W, din, h1, h2, dout, st);
  if (rc != 0) return rc;
  rc = run_steps<true>(
      (float* const*)work, (float* const*)work, scratch, shards, real_u8,
      max_len, starts, fake, fake_bf16, fake_per_client, cc, loss, W, E, B,
      din, h1, h2, dout, head, loss_scale, grad_scale, kc, st);
  if (rc != 0) return rc;
  return launch_cast(false, work, state_out, W, din, h1, h2, dout, st);
}

}  // extern "C"

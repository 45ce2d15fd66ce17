// fused_dstep.cu — E local discriminator steps for W clients (Hopper, f32).
//
// Replaces the Pallas TPU kernel `_dstep_kernel`
// (cglgan_tpu/ops/pallas/fused_dstep.py:44-157, launched by
// `fused_d_epoch_steps` :315-402).  Per client and local step e:
//   X = concat((u8 window at starts[e]) / 255 -> [-1, 1], fake)   (2B, din)
//   z1 = X W1 + b1, h1 = lrelu(z1); z2 = h1 W2 + b2, h2 = lrelu(z2);
//   z3 = h2 W3 + b3; head (sigmoid + clipped BCE | 2 logits + CE, x0.5 when
//   d_loss_half); hand-derived backward; six Adam updates in optax order
//   with per-client bias corrections cc[w][e] = (1 - b1^t, 1 - b2^t).
// The 18 state tensors (params, mu, nu) are read from `state_in` and the
// result written to `state_out` (step 0 reads the inputs, later steps update
// the outputs in place); `loss[w]` holds the last step's loss.
//
// Bound at the main-path shapes (W=16, E=5, B=100, din=784, 512, 256, 2):
// forward + backward are ~479 MFLOP per client-step, 38.3 GFLOP per call,
// all f32 FMA: ~0.57 ms at the H100 SXM's 67 TFLOP/s of non-tensor f32.
// The least traffic is one read and one write of the 16 clients' state
// (~102 MB, ~0.06 ms at 3.35 TB/s), so the call is compute-bound.
//
// Design (simple and right first): the TPU kernel kept one client's 6.4 MB
// of state resident in VMEM across the E steps; an SM has 227 KB of shared
// memory, so here every step is a pipeline of small kernels on one stream
// and re-reads the state from device memory (L2 holds part of it):
//   prep (u8 window + fake -> X) | 3 forward GEMMs with bias/LeakyReLU
//   epilogues | head (loss, dL/dz3) | 3 weight-grad GEMMs (A^T B) and
//   2 input-grad GEMMs (A B^T, LeakyReLU-derivative epilogue) | 3 column
//   sums (bias grads) | 6 Adam passes.
// The GEMM is one batched tiled SIMT kernel (blockIdx.z = client, 64x64
// tiles, 16-deep k slabs in shared memory, 4x4 f32 FMA accumulators per
// thread); no tensor cores, no library GEMM.  wgmma/TMA and keeping state
// on chip across steps are later work.

#include "mlp_kernels.cuh"

namespace {

constexpr int HEAD_SIGMOID = 0, HEAD_LOGITS2 = 1;

// X[w] = concat(normalised u8 window, fake): grid (2B, W).
__global__ void prep_kernel(const uint8_t* __restrict__ shards,
                            long long max_len, int start,
                            const float* __restrict__ fake, long long fake_sw,
                            float* __restrict__ X, int B, int din) {
  const int w = blockIdx.y, r = blockIdx.x;
  float* xr = X + ((long long)w * 2 * B + r) * din;
  if (r < B) {
    const uint8_t* src = shards + ((long long)w * max_len + start + r) * din;
    for (int c = threadIdx.x; c < din; c += blockDim.x)
      xr[c] = ((float)src[c] / 255.0f - 0.5f) / 0.5f;
  } else {
    const float* src = fake + w * fake_sw + (long long)(r - B) * din;
    for (int c = threadIdx.x; c < din; c += blockDim.x) xr[c] = src[c];
  }
}

// Loss and dL/dz3 per client: grid (W,), one block of TPB threads.
__global__ void head_kernel(const float* __restrict__ Z3,
                            float* __restrict__ G3, float* __restrict__ loss,
                            int B, int dout, int head, float loss_scale,
                            float grad_scale) {
  __shared__ float red[TPB];
  const int w = blockIdx.x, R = 2 * B;
  const float* z = Z3 + (long long)w * R * dout;
  float* g = G3 + (long long)w * R * dout;
  float part = 0.f;
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    const float is_real = r < B ? 1.f : 0.f;
    if (head == HEAD_SIGMOID) {
      const float p = 1.f / (1.f + expf(-z[r]));
      const float pc = fminf(fmaxf(p, P_LO), P_HI);
      part += -(is_real * logf(pc) + (1.f - is_real) * log1pf(-pc));
      const float dpc = grad_scale * (is_real * (-1.f / pc)
                                      + (1.f - is_real) * (1.f / (1.f - pc)));
      const float inside = (p > P_LO && p < P_HI) ? 1.f : 0.f;
      g[r] = dpc * inside * p * (1.f - p);
    } else {
      const float z0 = z[2 * r], z1 = z[2 * r + 1];
      const float zmax = fmaxf(z0, z1);
      const float s0 = z0 - zmax, s1 = z1 - zmax;
      const float lse = logf(expf(s0) + expf(s1));
      const float lp0 = s0 - lse, lp1 = s1 - lse;
      const float t0 = 1.f - is_real, t1 = is_real;   // real rows: class 1
      part += t0 * lp0 + t1 * lp1;
      g[2 * r] = grad_scale * (expf(lp0) - t0);
      g[2 * r + 1] = grad_scale * (expf(lp1) - t1);
    }
  }
  red[threadIdx.x] = part;
  __syncthreads();
  for (int s = TPB / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    const float tot = red[0];
    loss[w] = head == HEAD_SIGMOID ? loss_scale * tot / (float)B
                                   : loss_scale * (-tot / (float)B);
  }
}

}  // namespace

extern "C" {

const char* fused_dstep_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// state_in/state_out: 18 device pointers each, in the order
//   w1 b1 w2 b2 w3 b3 | mu of the same | nu of the same.
// scratch: 15 device pointers: X Z1 H1 Z2 H2 Z3 G3 DZ2 DZ1 dW1 db1 dW2 db2
//   dW3 db3.  starts: E host ints.  cc: (W, E, 2) device.  loss: (W,).
// Returns 0 or the first cudaGetLastError() code.
int fused_dstep_f32(void* const* state_in, void* const* state_out,
                    void* const* scratch, const uint8_t* shards,
                    long long max_len, const int* starts, const float* fake,
                    int fake_per_client, const float* cc, float* loss, int W,
                    int E, int B, int din, int h1, int h2, int dout, int head,
                    float loss_scale, float grad_scale, float neg_lr,
                    float b1, float omb1, float b2, float omb2, float eps,
                    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  float* const* s = (float* const*)scratch;
  float *X = s[0], *Z1 = s[1], *H1 = s[2], *Z2 = s[3], *H2 = s[4],
        *Z3 = s[5], *G3 = s[6], *DZ2 = s[7], *DZ1 = s[8];
  float* grads[6] = {s[9], s[10], s[11], s[12], s[13], s[14]};
  const long long R = 2LL * B;
  const long long n_per[6] = {(long long)din * h1, h1, (long long)h1 * h2,
                              h2, (long long)h2 * dout, dout};
  float* const* out = (float* const*)state_out;
  float* const* in = (float* const*)state_in;
  const long long fake_sw = fake_per_client ? (long long)B * din : 0;

  for (int e = 0; e < E; ++e) {
    float* const* cur = e == 0 ? in : out;
    const float *W1 = cur[0], *bb1 = cur[1], *W2 = cur[2], *bb2 = cur[3],
                *W3 = cur[4], *bb3 = cur[5];

    prep_kernel<<<dim3((unsigned)R, W), 256, 0, st>>>(
        shards, max_len, starts[e], fake, fake_sw, X, B, din);
    CHECK_LAUNCH();
    // ---- forward ----
    gemm_kernel<true, true, EPI_BIAS_LRELU><<<gemm_grid(R, h1, W), TPB, 0, st>>>(
        R, h1, din, X, R * din, din, 1, W1, (long long)din * h1, h1, 1,
        Z1, R * h1, bb1, h1, H1, nullptr);
    CHECK_LAUNCH();
    gemm_kernel<true, true, EPI_BIAS_LRELU><<<gemm_grid(R, h2, W), TPB, 0, st>>>(
        R, h2, h1, H1, R * h1, h1, 1, W2, (long long)h1 * h2, h2, 1,
        Z2, R * h2, bb2, h2, H2, nullptr);
    CHECK_LAUNCH();
    gemm_kernel<true, true, EPI_BIAS><<<gemm_grid(R, dout, W), TPB, 0, st>>>(
        R, dout, h2, H2, R * h2, h2, 1, W3, (long long)h2 * dout, dout, 1,
        Z3, R * dout, bb3, dout, nullptr, nullptr);
    CHECK_LAUNCH();
    head_kernel<<<W, TPB, 0, st>>>(Z3, G3, loss, B, dout, head, loss_scale,
                                   grad_scale);
    CHECK_LAUNCH();
    // ---- backward ----
    // dW3 = h2^T g3
    gemm_kernel<false, true, EPI_STORE><<<gemm_grid(h2, dout, W), TPB, 0, st>>>(
        h2, dout, R, H2, R * h2, 1, h2, G3, R * dout, dout, 1,
        grads[4], (long long)h2 * dout, nullptr, 0, nullptr, nullptr);
    CHECK_LAUNCH();
    colsum_kernel<<<dim3((dout + TPB - 1) / TPB, W), TPB, 0, st>>>(
        G3, grads[5], (int)R, dout);
    CHECK_LAUNCH();
    // dz2 = (g3 W3^T) * lrelu'(z2)
    gemm_kernel<true, false, EPI_LRELU_GRAD><<<gemm_grid(R, h2, W), TPB, 0, st>>>(
        R, h2, dout, G3, R * dout, dout, 1, W3, (long long)h2 * dout, 1, dout,
        DZ2, R * h2, nullptr, 0, nullptr, Z2);
    CHECK_LAUNCH();
    // dW2 = h1^T dz2
    gemm_kernel<false, true, EPI_STORE><<<gemm_grid(h1, h2, W), TPB, 0, st>>>(
        h1, h2, R, H1, R * h1, 1, h1, DZ2, R * h2, h2, 1,
        grads[2], (long long)h1 * h2, nullptr, 0, nullptr, nullptr);
    CHECK_LAUNCH();
    colsum_kernel<<<dim3((h2 + TPB - 1) / TPB, W), TPB, 0, st>>>(
        DZ2, grads[3], (int)R, h2);
    CHECK_LAUNCH();
    // dz1 = (dz2 W2^T) * lrelu'(z1)
    gemm_kernel<true, false, EPI_LRELU_GRAD><<<gemm_grid(R, h1, W), TPB, 0, st>>>(
        R, h1, h2, DZ2, R * h2, h2, 1, W2, (long long)h1 * h2, 1, h2,
        DZ1, R * h1, nullptr, 0, nullptr, Z1);
    CHECK_LAUNCH();
    // dW1 = x^T dz1
    gemm_kernel<false, true, EPI_STORE><<<gemm_grid(din, h1, W), TPB, 0, st>>>(
        din, h1, R, X, R * din, 1, din, DZ1, R * h1, h1, 1,
        grads[0], (long long)din * h1, nullptr, 0, nullptr, nullptr);
    CHECK_LAUNCH();
    colsum_kernel<<<dim3((h1 + TPB - 1) / TPB, W), TPB, 0, st>>>(
        DZ1, grads[1], (int)R, h1);
    CHECK_LAUNCH();
    // ---- Adam (one count per client, shared by the six tensors) ----
    for (int j = 0; j < 6; ++j) {
      const long long total = n_per[j] * W;
      long long blocks = (total + TPB - 1) / TPB;
      if (blocks > 4096) blocks = 4096;
      adam_kernel<<<(unsigned)blocks, TPB, 0, st>>>(
          cur[j], (e == 0 ? in : out)[6 + j], (e == 0 ? in : out)[12 + j],
          grads[j], out[j], out[6 + j], out[12 + j], n_per[j], W, cc, E, e,
          neg_lr, b1, omb1, b2, omb2, eps);
      CHECK_LAUNCH();
    }
  }
  return 0;
}

}  // extern "C"

// probe_mma_tf32.cu — what the inner loop of mma_tf32.cuh can reach on the
// card: a stand-alone program (built and run by kernel_probe.py) that times
// that loop's ingredients one on top of the other, with no device memory
// traffic: 24 mma.sync m16n8k8 TF32 a k-step on fixed operands (the
// instruction's own rate), + the hi/lo split of the 24 operand values,
// + their 16 loads from shared memory, + the per-slab partial sums, + a
// block barrier per slab.  Two blocks of 8 warps an SM, as the kernel runs.
// Prints one line a level.
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3]) : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
__device__ __forceinline__ void split_tf32(float x, uint32_t* hi, uint32_t* lo) {
  *hi = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  *lo = __float_as_uint(__fsub_rn(x, __uint_as_float(*hi)));
}
// LEVEL 1: mma only (operands fixed). 2: + split each iter. 3: + LDS each iter. 4: + part/acc per 4 iters. 5: + syncthreads per 4 iters
template <int LEVEL>
__global__ void __launch_bounds__(256, 2) bench(float* out, int iters, int zero) {
  __shared__ float As[64 * 36], Bs[32 * 136];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 2) * 32, wn = (warp & 3) * 32;
  for (int i = tid; i < 64 * 36; i += 256) As[i] = 1.0f + i * 1e-4f;
  for (int i = tid; i < 32 * 136; i += 256) Bs[i] = 0.5f + i * 1e-4f;
  __syncthreads();
  float acc[2][4][4], part[2][4][4];
  for (int i = 0; i < 2; ++i) for (int j = 0; j < 4; ++j) for (int c = 0; c < 4; ++c) { acc[i][j][c] = 0.f; part[i][j][c] = 0.f; }
  float av[2][4], bv[4][2];
  for (int i = 0; i < 2; ++i) for (int c = 0; c < 4; ++c) av[i][c] = As[(wm + i * 16 + g + (c & 1) * 8) * 36 + t + (c >> 1) * 4];
  for (int j = 0; j < 4; ++j) for (int c = 0; c < 2; ++c) bv[j][c] = Bs[(t + c * 4) * 136 + wn + j * 8 + g];
  uint32_t ah[2][4], al[2][4], bh[4][2], bl[4][2];
  for (int i = 0; i < 2; ++i) for (int c = 0; c < 4; ++c) split_tf32(av[i][c], &ah[i][c], &al[i][c]);
  for (int j = 0; j < 4; ++j) for (int c = 0; c < 2; ++c) split_tf32(bv[j][c], &bh[j][c], &bl[j][c]);
  for (int it = 0; it < iters; ++it) {
    const int kk = (it & 3) * 8 * zero;   // 0 at run time, unknown to the compiler
    if (LEVEL >= 3) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) av[i][c] = As[(wm + i * 16 + g + (c & 1) * 8) * 36 + kk + t + (c >> 1) * 4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) bv[j][c] = Bs[(kk + t + c * 4) * 136 + wn + j * 8 + g];
    }
    if (LEVEL >= 2) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) { if (LEVEL == 2) av[i][c] = __int_as_float(__float_as_int(av[i][c]) + zero); split_tf32(av[i][c], &ah[i][c], &al[i][c]); }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) { if (LEVEL == 2) bv[j][c] = __int_as_float(__float_as_int(bv[j][c]) + zero); split_tf32(bv[j][c], &bh[j][c], &bl[j][c]); }
    }
#pragma unroll
    for (int term = 0; term < 3; ++term)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_tf32(LEVEL >= 4 ? part[i][j] : acc[i][j], term == 0 ? al[i] : ah[i], term == 1 ? bl[j] : bh[j]);
    if (LEVEL >= 4 && (it & 3) == 3) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) { acc[i][j][c] += part[i][j][c]; part[i][j][c] = 0.f; }
      if (LEVEL >= 5) __syncthreads();
    }
  }
  float s = 0.f;
  for (int i = 0; i < 2; ++i) for (int j = 0; j < 4; ++j) for (int c = 0; c < 4; ++c) s += acc[i][j][c] + part[i][j][c];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
template <int LEVEL> void run(const char* name) {
  float* out; cudaMalloc(&out, 1 << 24);
  const int iters = 4000, blocks = 264;
  bench<LEVEL><<<blocks, 256>>>(out, 16, 0);
  cudaEvent_t e0, e1; cudaEventCreate(&e0); cudaEventCreate(&e1);
  cudaEventRecord(e0);
  bench<LEVEL><<<blocks, 256>>>(out, iters, 0);
  cudaEventRecord(e1); cudaEventSynchronize(e1);
  float ms; cudaEventElapsedTime(&ms, e0, e1);
  double mma = (double)blocks * 8 * iters * 24;
  printf("level %d (%s): %.3f ms; %.1f TFLOP/s tf32; %.1f ns per k8-step of a warp (4 warps a scheduler)\n", LEVEL, name, ms, mma * 2048 / (ms * 1e-3) / 1e12, ms * 1e6 / iters);
  cudaFree(out);
}
int main() {
  run<1>("24 mma, fixed operands");
  run<2>("+ split of 24 values");
  run<3>("+ 16 LDS");
  run<4>("+ slab partial sums");
  run<5>("+ __syncthreads per 4 steps");
  return 0;
}

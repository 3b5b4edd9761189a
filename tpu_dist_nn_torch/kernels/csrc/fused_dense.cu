// fused_dense: one layer, out = act(x @ W + b), f32 in, f32 out.
//
// Replaces the Pallas kernel tpu_dist_nn/kernels/fused_dense.py::_dense_kernel
// (pallas_call at fused_dense.py:100), which tiles the output over an
// (M/bm, N/bn) grid with K resident in VMEM and applies bias and
// activation before the tile leaves VMEM.
//
// Bound on an H100: at the flagship's first layer (8192 x 784 -> 128) the
// work is 1.64 GFLOP over 30.3 MB, so it is bound by FP32 operations
// (about 24.5 us at 67 TFLOP/s on CUDA cores), not by memory. The design
// keeps every FMA in FP32 (no TF32 tensor cores: they keep about three
// digits and miss the tolerance at K = 784): one CTA of 256 threads per
// 64 x 64 output tile, K streamed through shared memory in 16-deep
// slices with coalesced loads, a 4 x 4 register tile per thread (16
// FMAs per 8 shared loads), bias and activation applied in registers
// before the single store. Ragged M, N and K edges are masked. Softmax
// needs the whole row (the TPU kernel forces bn = N); here a second
// pass, one warp per row, normalises the finished rows in place.
#include "common.cuh"

namespace {

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 16;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
dense_kernel(const float* __restrict__ x, const float* __restrict__ w,
             const float* __restrict__ b, float* __restrict__ out,
             int M, int K, int N, int act) {
  __shared__ float xs[kBK][kBM + 4];  // x tile, transposed: xs[k][m]
  __shared__ float ws[kBK][kBN];
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    for (int e = tid; e < kBM * kBK; e += kThreads) {
      const int r = e / kBK, c = e % kBK;
      const int gm = m0 + r, gk = k0 + c;
      xs[c][r] = (gm < M && gk < K) ? x[(size_t)gm * K + gk] : 0.0f;
    }
    for (int e = tid; e < kBK * kBN; e += kThreads) {
      const int r = e / kBN, c = e % kBN;
      const int gk = k0 + r, gn = n0 + c;
      ws[r][c] = (gk < K && gn < N) ? w[(size_t)gk * N + gn] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = ws[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty + 16 * i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn >= N) continue;
      const float z = acc[i][j] + b[gn];
      out[(size_t)gm * N + gn] = (act == tdn::SOFTMAX) ? z : tdn::act_elem(z, act);
    }
  }
}

// Second pass for softmax: one warp per finished row of out.
__global__ void __launch_bounds__(kThreads)
softmax_rows_kernel(float* __restrict__ out, int M, int N) {
  const int row = blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  if (row >= M) return;
  tdn::softmax_row_warp(out + (size_t)row * N, N, threadIdx.x % 32);
}

}  // namespace

// x (M, K), w (K, N), b (N,), out (M, N): contiguous f32 on the device.
// Returns a cudaError_t code (0 = launched).
extern "C" int tdn_fused_dense(const float* x, const float* w, const float* b,
                               float* out, int M, int K, int N, int act,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((M + kBM - 1) / kBM, (N + kBN - 1) / kBN);
  dense_kernel<<<grid, kThreads, 0, s>>>(x, w, b, out, M, K, N, act);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || act != tdn::SOFTMAX) return static_cast<int>(err);
  const int rows_per_block = kThreads / 32;
  softmax_rows_kernel<<<(M + rows_per_block - 1) / rows_per_block, kThreads, 0, s>>>(out, M, N);
  return static_cast<int>(cudaGetLastError());
}

// fused_dense: one layer, out = act(x @ W + b), f32 in, f32 out.
//
// Replaces the Pallas kernel tpu_dist_nn/kernels/fused_dense.py::_dense_kernel
// (pallas_call at fused_dense.py:100), which tiles the output over an
// (M/bm, N/bn) grid with K resident in VMEM and applies bias and
// activation before the tile leaves VMEM.
//
// Bound on an H100: at the flagship's first layer (8192 x 784 -> 128) the
// work is 1.64 GFLOP over 30.3 MB, so it is bound by FP32 operations
// (about 24.5 us at 67 TFLOP/s on CUDA cores), not by memory. Every FMA
// stays FP32 on CUDA cores (TF32 keeps about three digits and misses the
// 1e-5 tolerance at K = 784). One CTA of 256 threads owns a tm x 16TN
// output tile (f32_tile.cuh: R x TN registers a thread in each of two K
// groups, K streamed through a 3-slot cp.async ring); the wrapper picks
// tm and TN from M, N and the SM count, so the flagship's layer runs as
// 128 CTAs of 64 x 128 (8 x 8 registers a thread), one wave. Bias and activation are applied
// in registers before the single store. Softmax needs the whole row (the
// TPU kernel forces bn >= N): when N fits one tile it is normalised in
// registers; a wider row is stored pre-activation and a second pass, one
// warp per row, normalises it in place.
#include "f32_tile.cuh"

namespace {

using namespace tdn;

template <int R, int TN>
__global__ void __launch_bounds__(kThreads)
dense_kernel(const float* __restrict__ x, const float* __restrict__ w,
             const float* __restrict__ b, float* __restrict__ out, int M, int K, int N,
             int act, bool x_vec, bool w_vec, bool out_vec) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  constexpr int TM = 8 * R;
  const Ring ring = make_ring(smem, TM);
  const int row0 = blockIdx.x * TM;
  const int c0 = blockIdx.y * 16 * TN;
  const int rows = min(TM, M - row0);

  float acc[R][TN];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;
  const PassA pa{x + (size_t)row0 * K, K, rows, x_vec, 1.0f};
  const PassW pw{w, N, c0, w_vec};
  gemm_pass<R, TN, A_GLOBAL_F32>(acc, ring, pa, pw, 0, K, Fold{nullptr, 0, 0, 0});
  if (!owns_result()) return;
  bias_act<R, TN>(acc, b, c0, N, act, /*row_softmax=*/gridDim.y == 1);
  store_global<R, TN>(acc, out + (size_t)row0 * N, N, rows, c0, N, out_vec);
}

// Second pass for a softmax row wider than one tile: one warp per row.
__global__ void __launch_bounds__(kThreads)
softmax_rows_kernel(float* __restrict__ out, int M, int N) {
  const int row = blockIdx.x * kWarpsPerCta + threadIdx.x / 32;
  if (row >= M) return;
  softmax_row_warp(out + (size_t)row * N, N, threadIdx.x % 32);
}

template <int R, int TN>
int launch(const float* x, const float* w, const float* b, float* out, int M, int K, int N,
           int act, cudaStream_t s) {
  constexpr int TM = 8 * R;
  const size_t smem = ring_floats(TM) * sizeof(float);
  auto kernel = dense_kernel<R, TN>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const bool x_vec = K % 4 == 0 && aligned(x);
  const bool w_vec = N % 4 == 0 && aligned(w);
  const bool out_vec = N % 4 == 0 && aligned(out);
  const dim3 grid((M + TM - 1) / TM, (N + 16 * TN - 1) / (16 * TN));
  kernel<<<grid, kThreads, smem, s>>>(x, w, b, out, M, K, N, act, x_vec, w_vec, out_vec);
  err = cudaGetLastError();
  if (err != cudaSuccess || act != SOFTMAX || grid.y == 1) return static_cast<int>(err);
  softmax_rows_kernel<<<(M + kWarpsPerCta - 1) / kWarpsPerCta, kThreads, 0, s>>>(out, M, N);
  return static_cast<int>(cudaGetLastError());
}

template <int R>
int launch_tn(int tn, const float* x, const float* w, const float* b, float* out, int M, int K,
              int N, int act, cudaStream_t s) {
  switch (tn) {
    case 8: return launch<R, 8>(x, w, b, out, M, K, N, act, s);
    case 4: return launch<R, 4>(x, w, b, out, M, K, N, act, s);
    case 2: return launch<R, 2>(x, w, b, out, M, K, N, act, s);
    case 1: return launch<R, 1>(x, w, b, out, M, K, N, act, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// x (M, K), w (K, N), b (N,), out (M, N): contiguous f32 on the device.
// tm (64, 32, 16 or 8) rows and 16 * tn (tn 8, 4, 2 or 1) columns per CTA,
// as fused_dense.py's dense_plan picks them. Returns a cudaError_t code
// (0 = launched).
extern "C" int tdn_fused_dense(const float* x, const float* w, const float* b, float* out,
                               int M, int K, int N, int act, int tm, int tn, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tm) {
    case 64: return launch_tn<8>(tn, x, w, b, out, M, K, N, act, s);
    case 32: return launch_tn<4>(tn, x, w, b, out, M, K, N, act, s);
    case 16: return launch_tn<2>(tn, x, w, b, out, M, K, N, act, s);
    case 8: return launch_tn<1>(tn, x, w, b, out, M, K, N, act, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

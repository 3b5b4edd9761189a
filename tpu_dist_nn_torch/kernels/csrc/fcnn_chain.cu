// fcnn_chain: the whole FCNN forward in one kernel, f32.
//
// Replaces the Pallas kernel tpu_dist_nn/kernels/fused_dense.py::_chain_kernel
// (pallas_call at fused_dense.py:198), which keeps every layer's weights
// resident in VMEM, walks the batch in tiles and never writes an
// inter-layer activation to HBM.
//
// Bound on an H100: at 784-128-64-10 and batch 8192 the chain does 1.79
// GFLOP over 26.5 MB (x read once, out written once), so it is bound by
// FP32 operations (about 27 us at 67 TFLOP/s on CUDA cores). The f32
// weights (437,544 bytes at that shape) do not fit a block's 227 KB of
// shared memory, so they cannot stay resident as they do in VMEM.
// Instead one CTA owns a tile of rows for the whole chain: its
// activations ping-pong between two shared-memory buffers (A holds the
// widths of even layer boundaries, B the odd ones), so intermediates
// never reach HBM, and each layer's weights stream from global memory
// and L2 in 32 x 128 slices that all warps share. The tile height comes
// from the widest boundaries and the shared-memory limit (the Python
// wrapper picks it). Every FMA is FP32 on CUDA cores, not TF32.
// Threads: warp w owns rows [w*RM, w*RM+RM) of the tile; lane l owns
// columns l, l+32, l+64, l+96 of each 128-column pass.
#include "common.cuh"

namespace {

constexpr int kMaxLayers = 32;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCW = 128;  // output columns per pass (32 lanes x 4)
constexpr int kBK = 32;   // K rows of W per shared slice

struct ChainArgs {
  const float* w[kMaxLayers];
  const float* b[kMaxLayers];
  int dim[kMaxLayers + 1];
  int act[kMaxLayers];
  int layers;
};

template <int RM>
__global__ void __launch_bounds__(kThreads)
chain_kernel(const void* __restrict__ x, int x_is_u8, float in_scale,
             float* __restrict__ out, int M, int tm, int ld_a, int ld_b,
             ChainArgs args) {
  extern __shared__ float smem[];
  float* buf_a = smem;
  float* buf_b = buf_a + tm * ld_a;
  float* wch = buf_b + tm * ld_b;  // kBK x kCW slice of W
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int row0 = blockIdx.x * tm;
  const int rows = min(tm, M - row0);

  // Stage the input tile; integer pixels are scaled on the device.
  const int d0 = args.dim[0];
  for (int e = tid; e < rows * d0; e += kThreads) {
    const int r = e / d0, c = e - r * d0;
    const size_t gi = (size_t)row0 * d0 + e;
    const float v = x_is_u8 ? static_cast<float>(static_cast<const uint8_t*>(x)[gi])
                            : static_cast<const float*>(x)[gi];
    buf_a[r * ld_a + c] = v * in_scale;
  }
  __syncthreads();

  // Rows past the tile's end (ragged tail, or tm < kWarps * RM) read the
  // tile's last row: computed, never stored, always inside the buffer.
  int rr[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) rr[i] = min(warp * RM + i, rows - 1);

  float* h_in = buf_a;
  int ld_in = ld_a;
  float* h_out = buf_b;
  int ld_out = ld_b;
  for (int l = 0; l < args.layers; ++l) {
    const int din = args.dim[l], dout = args.dim[l + 1], act = args.act[l];
    const float* __restrict__ W = args.w[l];
    const float* __restrict__ bias = args.b[l];
    for (int c0 = 0; c0 < dout; c0 += kCW) {
      float acc[RM][4];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
      for (int k0 = 0; k0 < din; k0 += kBK) {
        const int kn = min(kBK, din - k0);
        for (int e = tid; e < kBK * kCW; e += kThreads) {
          const int r = e / kCW, c = e % kCW;
          wch[e] = (r < kn && c0 + c < dout) ? W[(size_t)(k0 + r) * dout + c0 + c] : 0.0f;
        }
        __syncthreads();
        for (int kk = 0; kk < kn; ++kk) {
          float wv[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) wv[j] = wch[kk * kCW + lane + 32 * j];
#pragma unroll
          for (int i = 0; i < RM; ++i) {
            const float h = h_in[rr[i] * ld_in + k0 + kk];
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(h, wv[j], acc[i][j]);
          }
        }
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const int r = warp * RM + i;
        if (r >= rows) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = c0 + lane + 32 * j;
          if (c >= dout) continue;
          const float z = acc[i][j] + bias[c];
          h_out[r * ld_out + c] = (act == tdn::SOFTMAX) ? z : tdn::act_elem(z, act);
        }
      }
    }
    __syncthreads();
    if (act == tdn::SOFTMAX) {
      for (int r = warp; r < rows; r += kWarps) tdn::softmax_row_warp(h_out + r * ld_out, dout, lane);
      __syncthreads();
    }
    float* t = h_in;
    h_in = h_out;
    h_out = t;
    const int tl = ld_in;
    ld_in = ld_out;
    ld_out = tl;
  }

  const int dl = args.dim[args.layers];
  for (int e = tid; e < rows * dl; e += kThreads) {
    const int r = e / dl, c = e - r * dl;
    out[(size_t)row0 * dl + e] = h_in[r * ld_in + c];
  }
}

template <int RM>
int launch(const void* x, int x_is_u8, float in_scale, float* out, int M, int tm,
           int ld_a, int ld_b, const ChainArgs& args, cudaStream_t s) {
  const size_t smem = ((size_t)tm * (ld_a + ld_b) + kBK * kCW) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(chain_kernel<RM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  chain_kernel<RM><<<(M + tm - 1) / tm, kThreads, smem, s>>>(x, x_is_u8, in_scale, out, M,
                                                              tm, ld_a, ld_b, args);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (M, dims[0]) f32 or uint8 (x_is_u8), scaled by in_scale on load;
// per layer l: w[l] (dims[l], dims[l+1]) and b[l] (dims[l+1],) f32;
// out (M, dims[layers]) f32. tm rows per CTA (1..64); ld_a / ld_b are
// the widest even / odd layer boundaries. Returns a cudaError_t code.
extern "C" int tdn_fcnn_chain(const void* x, int x_is_u8, float in_scale, float* out,
                              int M, const void* const* w, const void* const* b,
                              const int* dims, const int* acts, int layers, int tm,
                              int ld_a, int ld_b, void* stream) {
  if (layers < 1 || layers > kMaxLayers || tm < 1 || tm > 8 * kWarps)
    return static_cast<int>(cudaErrorInvalidValue);
  ChainArgs args;
  for (int l = 0; l < layers; ++l) {
    args.w[l] = static_cast<const float*>(w[l]);
    args.b[l] = static_cast<const float*>(b[l]);
    args.act[l] = acts[l];
  }
  for (int l = 0; l <= layers; ++l) args.dim[l] = dims[l];
  args.layers = layers;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tm > 4 * kWarps) return launch<8>(x, x_is_u8, in_scale, out, M, tm, ld_a, ld_b, args, s);
  if (tm > 2 * kWarps) return launch<4>(x, x_is_u8, in_scale, out, M, tm, ld_a, ld_b, args, s);
  if (tm > kWarps) return launch<2>(x, x_is_u8, in_scale, out, M, tm, ld_a, ld_b, args, s);
  return launch<1>(x, x_is_u8, in_scale, out, M, tm, ld_a, ld_b, args, s);
}

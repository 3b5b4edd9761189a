// int8_chain: the whole int8-quantized FCNN forward in one kernel.
//
// Replaces the Pallas kernel tpu_dist_nn/kernels/quantized.py::_chain_kernel
// (pallas_call at quantized.py:171). Per layer, on f32 activations h:
//   s_r  = max(max_k |h[r,k]|, 1e-8) / 127            (per row, IEEE division)
//   q    = clip(rint(h / s_r), -127, 127)              (round half to even)
//   z    = q @ Wq                                      (int8 x int8 -> int32, exact)
//   y    = float(z) * (s_r * scale_c) + b_c            (three separately rounded ops)
//   h'   = act(y)
// which is forward_quantized in kernels/quantized.py, operation for
// operation, so relu and linear interiors match it bit for bit.
//
// Bound on an H100: at 784-128-64-10 and batch 8192 the chain reads
// 25.7 MB of f32 x and does 1.79 G int8 operations, so it is bound by
// memory (about 7.9 us at 3.35 TB/s). The design follows the f32 chain
// (fcnn_chain.cu): one CTA owns a tile of rows for the whole chain, its
// f32 activations ping-pong between two shared-memory buffers and its
// int8 codes sit in a third, so nothing between layers reaches HBM.
// Each layer quantises its rows in shared memory (one warp per row),
// then streams Wq from global memory and L2 in slices of 16 k-quads x
// 128 columns, packing four k-consecutive int8 weights into one int32
// so that __dp4a does four exact multiply-adds per instruction on CUDA
// cores. The rescale uses __fmul_rn / __fadd_rn so no FMA contraction
// changes its rounding.
#include "common.cuh"

namespace {

constexpr int kMaxLayers = 32;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCW = 128;  // output columns per pass (32 lanes x 4)
constexpr int kKQ = 16;   // k-quads (4 int8 each) per shared slice of Wq

struct Int8ChainArgs {
  const int8_t* wq[kMaxLayers];
  const float* scale[kMaxLayers];
  const float* b[kMaxLayers];
  int dim[kMaxLayers + 1];
  int act[kMaxLayers];
  int layers;
};

template <int RM>
__global__ void __launch_bounds__(kThreads)
int8_chain_kernel(const float* __restrict__ x, float* __restrict__ out, int M, int tm,
                  int ld_a, int ld_b, int ld_q, Int8ChainArgs args) {
  extern __shared__ float smem[];
  float* buf_a = smem;
  float* buf_b = buf_a + tm * ld_a;
  int* wch = reinterpret_cast<int*>(buf_b + tm * ld_b);  // kKQ x kCW packed k-quads
  float* row_scale = reinterpret_cast<float*>(wch + kKQ * kCW);
  int8_t* q = reinterpret_cast<int8_t*>(row_scale + tm);  // tm x ld_q codes, ld_q % 4 == 0
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int row0 = blockIdx.x * tm;
  const int rows = min(tm, M - row0);

  const int d0 = args.dim[0];
  for (int e = tid; e < rows * d0; e += kThreads) {
    const int r = e / d0, c = e - r * d0;
    buf_a[r * ld_a + c] = x[(size_t)row0 * d0 + e];
  }
  __syncthreads();

  // Rows past the tile's end read the tile's last row: computed, never stored.
  int rr[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) rr[i] = min(warp * RM + i, rows - 1);

  float* h_in = buf_a;
  int ld_in = ld_a;
  float* h_out = buf_b;
  int ld_out = ld_b;
  for (int l = 0; l < args.layers; ++l) {
    const int din = args.dim[l], dout = args.dim[l + 1], act = args.act[l];
    const int8_t* __restrict__ W = args.wq[l];
    const float* __restrict__ wscale = args.scale[l];
    const float* __restrict__ bias = args.b[l];
    const int nq = (din + 3) / 4;

    // Per-row dynamic symmetric quantisation, one warp per row. Codes
    // past din (up to the next multiple of 4) are zero.
    for (int r = warp; r < rows; r += kWarps) {
      const float* h = h_in + r * ld_in;
      float amax = 0.0f;
      for (int c = lane; c < din; c += 32) amax = fmaxf(amax, fabsf(h[c]));
      amax = fmaxf(tdn::warp_max(amax), 1e-8f);
      const float s = amax / 127.0f;
      int8_t* qr = q + r * ld_q;
      for (int c = lane; c < nq * 4; c += 32) {
        float v = 0.0f;
        if (c < din) v = fminf(fmaxf(rintf(h[c] / s), -127.0f), 127.0f);
        qr[c] = static_cast<int8_t>(v);
      }
      if (lane == 0) row_scale[r] = s;
    }
    __syncthreads();

    for (int c0 = 0; c0 < dout; c0 += kCW) {
      int acc[RM][4];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0;
      for (int q0 = 0; q0 < nq; q0 += kKQ) {
        const int qn = min(kKQ, nq - q0);
        for (int e = tid; e < kKQ * kCW; e += kThreads) {
          const int kq = e / kCW, c = e % kCW, gc = c0 + c;
          int packed = 0;
          if (kq < qn && gc < dout) {
            const int k = (q0 + kq) * 4;
#pragma unroll
            for (int t = 0; t < 4; ++t) {
              const int8_t v = (k + t < din) ? W[(size_t)(k + t) * dout + gc] : static_cast<int8_t>(0);
              packed |= static_cast<int>(static_cast<uint8_t>(v)) << (8 * t);
            }
          }
          wch[e] = packed;
        }
        __syncthreads();
        for (int kq = 0; kq < qn; ++kq) {
          int wv[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) wv[j] = wch[kq * kCW + lane + 32 * j];
#pragma unroll
          for (int i = 0; i < RM; ++i) {
            const int xa = *reinterpret_cast<const int*>(q + rr[i] * ld_q + (q0 + kq) * 4);
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(xa, wv[j], acc[i][j]);
          }
        }
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const int r = warp * RM + i;
        if (r >= rows) continue;
        const float sr = row_scale[r];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = c0 + lane + 32 * j;
          if (c >= dout) continue;
          const float y = __fadd_rn(
              __fmul_rn(__int2float_rn(acc[i][j]), __fmul_rn(sr, wscale[c])), bias[c]);
          h_out[r * ld_out + c] = (act == tdn::SOFTMAX) ? y : tdn::act_elem(y, act);
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
int launch(const float* x, float* out, int M, int tm, int ld_a, int ld_b, int ld_q,
           const Int8ChainArgs& args, cudaStream_t s) {
  const size_t smem = ((size_t)tm * (ld_a + ld_b) + kKQ * kCW + tm) * sizeof(float) +
                      (size_t)tm * ld_q;
  cudaError_t err = cudaFuncSetAttribute(int8_chain_kernel<RM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int8_chain_kernel<RM><<<(M + tm - 1) / tm, kThreads, smem, s>>>(x, out, M, tm, ld_a, ld_b,
                                                                   ld_q, args);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (M, dims[0]) f32; per layer l: wq[l] (dims[l], dims[l+1]) int8,
// scale[l] and b[l] (dims[l+1],) f32; out (M, dims[layers]) f32. tm rows
// per CTA (1..64); ld_a / ld_b are the widest even / odd layer
// boundaries, ld_q the widest layer input rounded up to a multiple of 4.
// Returns a cudaError_t code.
extern "C" int tdn_int8_chain(const float* x, float* out, int M, const void* const* wq,
                              const void* const* scale, const void* const* b,
                              const int* dims, const int* acts, int layers, int tm,
                              int ld_a, int ld_b, int ld_q, void* stream) {
  if (layers < 1 || layers > kMaxLayers || tm < 1 || tm > 8 * kWarps || ld_q % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Int8ChainArgs args;
  for (int l = 0; l < layers; ++l) {
    args.wq[l] = static_cast<const int8_t*>(wq[l]);
    args.scale[l] = static_cast<const float*>(scale[l]);
    args.b[l] = static_cast<const float*>(b[l]);
    args.act[l] = acts[l];
  }
  for (int l = 0; l <= layers; ++l) args.dim[l] = dims[l];
  args.layers = layers;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tm > 4 * kWarps) return launch<8>(x, out, M, tm, ld_a, ld_b, ld_q, args, s);
  if (tm > 2 * kWarps) return launch<4>(x, out, M, tm, ld_a, ld_b, ld_q, args, s);
  if (tm > kWarps) return launch<2>(x, out, M, tm, ld_a, ld_b, ld_q, args, s);
  return launch<1>(x, out, M, tm, ld_a, ld_b, ld_q, args, s);
}

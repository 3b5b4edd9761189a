// fcnn_chain: the whole FCNN forward in one kernel, f32.
//
// Replaces the Pallas kernel tpu_dist_nn/kernels/fused_dense.py::_chain_kernel
// (pallas_call at fused_dense.py:198), which keeps every layer's weights
// resident in VMEM, walks the batch in tiles and never writes an
// inter-layer activation to HBM.
//
// Bound on an H100: at 784-128-64-10 and batch 8192 the chain does 1.79
// GFLOP over 26.5 MB (x read once, out written once), so it is bound by
// FP32 operations (about 27 us at 67 TFLOP/s on CUDA cores); so is the
// conv network's 2048-64-10 tail at batch 1024 (0.27 GFLOP, 4.0 us). The
// f32 weights do not fit a block's 227 KB of shared memory, so they
// cannot stay resident as they do in VMEM: they stream from L2.
//
// Design (f32_tile.cuh holds the tile, the ring and the epilogue): a CTA
// owns tm rows for the whole chain. Layer 0 streams x (f32, or uint8
// scaled on read) through the cp.async ring, exactly like fused_dense;
// only the interior activations stay in shared memory, ping-ponging
// between two buffers (h0 holds dims[1], dims[3], ...; h1 dims[2], ...),
// so they never reach HBM and the input width is not limited. Each
// layer's columns go in passes of 16, 32, 64 or 128 (the smallest that
// covers what is left; 64 at most after the first layer), so a 64- or
// 10-wide layer spends no 128-column pass. Every FMA is FP32 on CUDA
// cores, not TF32.
//
// Split-K for short batches: layer 0's K is cut into 1, 2 or 8 ranges
// fixed by K (k_ranges). The wrapper's plan gives each row tile either
// one CTA, which walks the ranges and adds each range's sums into h0 in
// range order, or a thread-block cluster of one CTA a range, when the
// tiles alone do not fill the SMs. Rank r computes range r's sums into
// its h0; after a cluster barrier every rank takes a share of the tile's
// values, reads each value's sums from all ranks through distributed
// shared memory, adds them in rank order (no atomics), applies bias and
// activation and writes the value into the leader's (rank 0's) h0. After
// a second barrier the other ranks exit and the leader runs layers
// 1..L-1 alone. Either way a row's bits depend on K alone: two calls,
// and a row in any batch, agree.
#include <cooperative_groups.h>

#include "f32_tile.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace tdn;

constexpr int kMaxLayers = 32;

struct ChainArgs {
  const float* w[kMaxLayers];
  const float* b[kMaxLayers];
  int dim[kMaxLayers + 1];
  int act[kMaxLayers];
  int layers;
};

// Where a layer's output goes.
struct Dest {
  bool shared;   // resident rows in shared memory, else the global output
  float* h;      // the resident rows
  int ld;        // h's row stride
  float* out;    // global output rows of this tile
  int rows;      // valid rows
  bool out_vec;  // 16-byte global stores allowed
  bool raw;      // store the bare sums (split-K partials): no bias, no activation
};

// One pass of one layer: columns [c0, c0 + 16TN) of act(A @ W + b).
template <int R, int TN, int AS>
__device__ __forceinline__ void layer_pass(const Ring& ring, const PassA& pa, const float* w,
                                           const float* b, int dout, int act, int c0, int kb,
                                           int ke, bool w_vec, const Dest& d, const Fold& fold) {
  float acc[R][TN];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;
  const PassW pw{w, dout, c0, w_vec};
  gemm_pass<R, TN, AS>(acc, ring, pa, pw, kb, ke, fold);
  if (!owns_result()) return;
  if (!d.raw) bias_act<R, TN>(acc, b, c0, dout, act, /*row_softmax=*/c0 == 0 && dout <= 16 * TN);
  if (d.shared)
    store_shared<R, TN>(acc, d.h, d.ld, c0, dout);
  else
    store_global<R, TN>(acc, d.out, dout, d.rows, c0, dout, d.out_vec);
}

// Passes of the first layer are up to 128 columns wide, of the later
// layers up to 64 (their A is resident: an 8 x 8 tile there only adds
// registers and code to the kernel, for layers that are small).
template <int AS>
__host__ __device__ constexpr int max_pass_tn() {
  return AS == A_SHARED ? 4 : 8;
}

// Every pass of one layer, each at the width of what is left.
template <int R, int AS>
__device__ __forceinline__ void layer(const Ring& ring, const PassA& pa, const float* w,
                                      const float* b, int dout, int act, int kb, int ke,
                                      const Dest& d, const Fold& fold) {
  constexpr int kMaxTN = max_pass_tn<AS>();
  const bool w_vec = dout % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  for (int c0 = 0; c0 < dout; c0 += 16 * pass_tn(dout - c0, kMaxTN)) {
    switch (pass_tn(dout - c0, kMaxTN)) {
      case 8:
        if constexpr (kMaxTN == 8)
          layer_pass<R, 8, AS>(ring, pa, w, b, dout, act, c0, kb, ke, w_vec, d, fold);
        break;
      case 4:
        layer_pass<R, 4, AS>(ring, pa, w, b, dout, act, c0, kb, ke, w_vec, d, fold);
        break;
      case 2:
        layer_pass<R, 2, AS>(ring, pa, w, b, dout, act, c0, kb, ke, w_vec, d, fold);
        break;
      default:
        layer_pass<R, 1, AS>(ring, pa, w, b, dout, act, c0, kb, ke, w_vec, d, fold);
        break;
    }
  }
}

// Layer 0's K ranges (f32_tile.cuh's Fold): 8 from 32 slices, 2 from
// 16, else 1 (a shorter K is not worth splitting, and adding ranges
// costs a lone CTA a pass through shared memory each); a cluster splits
// K into exactly these.
__host__ __device__ constexpr int k_ranges(int slices) {
  return slices >= 32 ? 8 : slices >= 16 ? 2 : 1;
}

// Finish rows resident in shared memory: a softmax wider than one pass
// is normalised row by row, and the last layer's rows are copied out.
template <int R>
__device__ __forceinline__ void finish_rows(float* h, int ld, int dout, int act, bool multi_pass,
                                            float* out, int rows) {
  constexpr int TM = 8 * R;
  const int tid = threadIdx.x;
  if (act == SOFTMAX && multi_pass) {
    __syncthreads();
    for (int r = tid >> 5; r < TM; r += kWarpsPerCta) softmax_row_warp(h + r * ld, dout, tid & 31);
  }
  if (out != nullptr) {
    __syncthreads();
    for (int e = tid; e < rows * dout; e += kThreads) {
      const int r = e / dout, c = e - r * dout;
      out[e] = h[r * ld + c];
    }
  }
}

template <int R, int AS0>
__global__ void __launch_bounds__(kThreads)
chain_kernel(const void* __restrict__ x, float in_scale, float* __restrict__ out, int M,
             int split, int ld0, int ld1, ChainArgs args) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  constexpr int TM = 8 * R;
  const Ring ring = make_ring(smem, TM);
  // The resident buffers (selected by parity, never through an indexed
  // array, so every access stays a shared-memory access).
  float* const h0 = smem + ring_floats(TM);
  float* const h1 = h0 + TM * ld0;
  const int tid = threadIdx.x;
  const int rank = split > 1 ? static_cast<int>(cg::this_cluster().block_rank()) : 0;
  const int row0 = (blockIdx.x / split) * TM;
  const int rows = min(TM, M - row0);
  const int L = args.layers;
  const int dl = args.dim[L];
  float* const out_tile = out + (size_t)row0 * dl;
  const bool out_vec = dl % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;

  // Layer 0: this rank's K slices, x through the ring.
  const int K = args.dim[0], d1 = args.dim[1], act0 = args.act[0];
  const int ranges = k_ranges((K + kBK - 1) / kBK);
  const int per = ((K + kBK - 1) / kBK + ranges - 1) / ranges;  // slices a range
  const int kb = split > 1 ? min(K, rank * per * kBK) : 0;
  const int ke = split > 1 ? min(K, (rank + 1) * per * kBK) : K;
  const Fold fold0{split == 1 && ranges > 1 ? h0 : nullptr, ld0, d1, per};
  const bool single = L == 1 && split == 1;
  const bool wide_softmax0 = act0 == SOFTMAX && d1 > 16 * max_pass_tn<AS0>();
  const Dest d0{!single || wide_softmax0, h0, ld0, out_tile, rows, out_vec, split > 1};
  constexpr size_t elem = AS0 == A_GLOBAL_U8 ? 1 : 4;
  const PassA pa0{static_cast<const char*>(x) + (size_t)row0 * K * elem, K, rows,
                  reinterpret_cast<uintptr_t>(x) % 16 == 0 && (K * elem) % 16 == 0, in_scale};
  layer<R, AS0>(ring, pa0, args.w[0], args.b[0], d1, act0, kb, ke, d0, fold0);

  if (split > 1) {
    // Every rank takes an eighth (1/split) of the tile's values: it adds
    // the ranks' partials in rank order, applies bias and activation and
    // writes the value into the leader's h0. Each value has one writer,
    // which alone reads that value's partials, so no value is read after
    // it is overwritten.
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    const float* part[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) part[q] = cluster.map_shared_rank(h0, q < split ? q : 0);
    float* const lead = cluster.map_shared_rank(h0, 0);
    const int d1pad = (d1 + 3) & ~3;
    for (int e = rank * kThreads + tid; e < TM * (d1pad / 4); e += split * kThreads) {
      const int r = e / (d1pad / 4), c = 4 * (e % (d1pad / 4));
      float4 p[8];
#pragma unroll
      for (int q = 0; q < 8; ++q)
        if (q < split) p[q] = *reinterpret_cast<const float4*>(part[q] + r * ld0 + c);
      float4 s = p[0];
#pragma unroll
      for (int q = 1; q < 8; ++q) {
        if (q < split) {
          s.x += p[q].x;
          s.y += p[q].y;
          s.z += p[q].z;
          s.w += p[q].w;
        }
      }
      float v[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float z = v[j] + (c + j < d1 ? args.b[0][c + j] : 0.0f);
        v[j] = c + j >= d1 ? 0.0f : act0 == SOFTMAX ? z : act_elem(z, act0);
      }
      *reinterpret_cast<float4*>(lead + r * ld0 + c) = make_float4(v[0], v[1], v[2], v[3]);
    }
    cluster.sync();
    if (rank != 0) return;
    finish_rows<R>(h0, ld0, d1, act0, /*multi_pass=*/true, L == 1 ? out_tile : nullptr, rows);
    if (L == 1) return;
  } else if (d0.shared) {
    finish_rows<R>(h0, ld0, d1, act0, wide_softmax0, L == 1 ? out_tile : nullptr, rows);
  }

  // Layers 1 .. L-1: A resident in shared memory, W through the ring.
  for (int l = 1; l < L; ++l) {
    __syncthreads();
    const int dout = args.dim[l + 1], act = args.act[l];
    const bool last = l == L - 1;
    const bool wide_softmax = act == SOFTMAX && dout > 16 * max_pass_tn<A_SHARED>();
    const bool odd = l % 2 == 1;
    const Dest d{!last || wide_softmax, odd ? h1 : h0, odd ? ld1 : ld0, out_tile, rows, out_vec,
                 false};
    const PassA pa{odd ? h0 : h1, odd ? ld0 : ld1, TM, false, 1.0f};
    layer<R, A_SHARED>(ring, pa, args.w[l], args.b[l], dout, act, 0, args.dim[l], d,
                       Fold{nullptr, 0, 0, 0});
    if (d.shared)
      finish_rows<R>(d.h, d.ld, dout, act, wide_softmax, last ? out_tile : nullptr, rows);
  }
}

template <int R, int AS0>
int launch(const void* x, float in_scale, float* out, int M, int split, int ld0, int ld1,
           const ChainArgs& args, size_t smem, cudaStream_t s) {
  constexpr int TM = 8 * R;
  auto kernel = chain_kernel<R, AS0>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(((M + TM - 1) / TM) * split, 1, 1);
  if (split == 1) {
    kernel<<<grid, kThreads, smem, s>>>(x, in_scale, out, M, split, ld0, ld1, args);
    return static_cast<int>(cudaGetLastError());
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, x, in_scale, out, M, split, ld0, ld1, args);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <int R>
int launch_x(int x_kind, const void* x, float in_scale, float* out, int M, int split, int ld0,
             int ld1, const ChainArgs& args, size_t smem, cudaStream_t s) {
  switch (x_kind) {
    case A_GLOBAL_F32:
      return launch<R, A_GLOBAL_F32>(x, in_scale, out, M, split, ld0, ld1, args, smem, s);
    case A_GLOBAL_F32_SCALED:
      return launch<R, A_GLOBAL_F32_SCALED>(x, in_scale, out, M, split, ld0, ld1, args, smem, s);
    default:
      return launch<R, A_GLOBAL_U8>(x, in_scale, out, M, split, ld0, ld1, args, smem, s);
  }
}

}  // namespace

// How many clusters of `split` CTAs of tm rows, each with smem bytes of
// dynamic shared memory, the card runs at once (into *clusters).
// Returns a cudaError_t code.
extern "C" int tdn_fcnn_chain_max_clusters(int tm, int split, int smem, int* clusters) {
  auto kernel = tm == 72 ? chain_kernel<9, A_GLOBAL_F32>
                         : tm == 64 ? chain_kernel<8, A_GLOBAL_F32> : chain_kernel<1, A_GLOBAL_F32>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(split, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg));
}

// x (M, dims[0]) f32 or uint8 (x_is_u8), scaled by in_scale on load;
// per layer l: w[l] (dims[l], dims[l+1]) and b[l] (dims[l+1],) f32;
// out (M, dims[layers]) f32. The plan (fused_dense.py's chain_plan): tm
// rows per CTA (72, 64 or 8), split CTAs per row tile (1, or k_ranges of
// dims[0]: one cluster), ld0 / ld1 the resident buffers' row widths
// (multiples of 4, not of 32; h0 must hold dims[1] when K has more than
// one range). Returns a cudaError_t code.
extern "C" int tdn_fcnn_chain(const void* x, int x_is_u8, float in_scale, float* out, int M,
                              const void* const* w, const void* const* b, const int* dims,
                              const int* acts, int layers, int tm, int split, int ld0, int ld1,
                              void* stream) {
  const int ranges = k_ranges((dims[0] + kBK - 1) / kBK);
  if (layers < 1 || layers > kMaxLayers || (split != 1 && split != ranges) || ld0 % 4 != 0
      || ld1 % 4 != 0 || (ranges > 1 && ld0 < dims[1]))
    return static_cast<int>(cudaErrorInvalidValue);
  ChainArgs args;
  for (int l = 0; l < layers; ++l) {
    args.w[l] = static_cast<const float*>(w[l]);
    args.b[l] = static_cast<const float*>(b[l]);
    args.act[l] = acts[l];
  }
  for (int l = 0; l <= layers; ++l) args.dim[l] = dims[l];
  args.layers = layers;
  const int x_kind = x_is_u8 ? A_GLOBAL_U8 : in_scale != 1.0f ? A_GLOBAL_F32_SCALED : A_GLOBAL_F32;
  const size_t smem = (size_t)(ring_floats(tm) + tm * (ld0 + ld1)) * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tm) {
    case 72: return launch_x<9>(x_kind, x, in_scale, out, M, split, ld0, ld1, args, smem, s);
    case 64: return launch_x<8>(x_kind, x, in_scale, out, M, split, ld0, ld1, args, smem, s);
    case 8: return launch_x<1>(x_kind, x, in_scale, out, M, split, ld0, ld1, args, smem, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

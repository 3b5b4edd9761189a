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
// operation, so relu and linear interiors match it bit for bit: integer
// sums are exact in any order.
//
// Bound on an H100: at 784-128-64-10 and batch 8192 the chain reads
// 25.7 MB of f32 x and does 1.79 G int8 operations, so it is bound by
// memory (about 7.7 us at 3.35 TB/s).
//
// Design. A CTA of 8 warps walks row tiles of TM rows (16, 32 or 64; a
// persistent grid of as many CTAs as the SMs hold, so while one CTA
// multiplies another streams its input). Layer 0 quantises its input
// straight from device memory, one warp a row: a row of up to 1024
// floats is read once into registers (the warp max, then the codes);
// a wider row is read twice (the max, then the codes, which hit L2) and
// its codes are made chunk by chunk, so no input width is refused.
// Between layers only the tile's f32 activations, its int8 codes and
// its row scales stay in shared memory, and nothing reaches HBM; a later
// layer quantises all of a warp's rows at once, and a zero (a relu's)
// is coded without dividing (the IEEE division's slow path). The
// products run on the int8 tensor cores (mma.sync m16n8k32 s8 x s8 ->
// s32): the warps split the tile into 16-row x (128 / WN)-column
// blocks; A fragments are 32-bit loads from the resident codes (row
// stride 16 mod 128 bytes: no bank conflict); B comes packed once, when
// the parameters are quantised, in the fragments' own order
// (quantized.py::pack_wq: per 32-deep k step and 8 columns, 8 bytes a
// lane), and streams from L2 in 64-deep slices of up to 128 columns
// through a 4-slot cp.async ring of 16-byte copies. The rescale uses
// __fmul_rn / __fadd_rn so no FMA contraction changes its rounding; the
// epilogue branches once on the activation. A softmax is taken over the
// finished rows (the last layer's in device memory).
#include "common.cuh"

namespace {

constexpr int kMaxLayers = 32;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPassTiles = 16;                  // 8-column tiles a column pass (128 columns)
constexpr int kStepBytes = 256;                 // one packed (k32 step, 8 columns) fragment
constexpr int kSlotBytes = 2 * kPassTiles * kStepBytes;  // a 64-deep slice of a pass
constexpr int kStages = 4;
constexpr int kRegCols = 1024;                  // widest input row quantised from registers

struct Int8ChainArgs {
  const unsigned char* wq[kMaxLayers];  // packed (quantized.py::pack_wq)
  const float* scale[kMaxLayers];
  const float* b[kMaxLayers];
  int dim[kMaxLayers + 1];
  int act[kMaxLayers];
  int layers;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void mma_s8(int (&c)[4], int a0, int a1, int a2, int a3, int b0,
                                       int b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float row_scale(float amax) {
  return tdn::max_nan(amax, 1e-8f) / 127.0f;
}

// clip(rint(v / s), -127, 127) with the IEEE division. A zero dividend
// (a relu's zeros) is answered without dividing: it would send the
// division to its slow path, and its quotient is 0 either way. A row
// holding a NaN has a NaN scale (row_scale): its codes are 0 and its
// outputs NaN through the rescale, as the plain version's are.
__device__ __forceinline__ int8_t quantize(float v, float s) {
  const float q = (v == 0.0f ? s : v) / s;
  return static_cast<int8_t>(v == 0.0f || q != q ? 0.0f
                                                 : fminf(fmaxf(rintf(q), -127.0f), 127.0f));
}

// Layer 0 of a row of up to kRegCols floats: one read into registers
// (through the read-only path), the warp max, the codes.
__device__ __forceinline__ void quantize_row_regs(const float* __restrict__ xr, int din,
                                                  int8_t* q, float* s_out, int lane) {
  float v[kRegCols / 32];
  float amax = 0.0f;
#pragma unroll
  for (int j = 0; j < kRegCols / 32; ++j) {
    const int c = lane + 32 * j;
    v[j] = c < din ? __ldg(xr + c) : 0.0f;
    amax = tdn::max_nan(amax, fabsf(v[j]));
  }
  const float s = row_scale(tdn::warp_max(amax));
#pragma unroll
  for (int j = 0; j < kRegCols / 32; ++j) {
    const int c = lane + 32 * j;
    if (c < din) q[c] = quantize(v[j], s);
  }
  if (lane == 0) *s_out = s;
}

// A later layer's rows (this warp's RPW: r, r + kWarps, ...) from the
// resident activations, all at once: the maxima, then the codes.
template <int RPW>
__device__ __forceinline__ void quantize_rows_shared(const float* h, int ldh, int din, int r,
                                                     int rows, int8_t* codes, int ldq,
                                                     float* rscale, int lane) {
  float amax[RPW];
#pragma unroll
  for (int i = 0; i < RPW; ++i) amax[i] = 0.0f;
  for (int c = lane; c < din; c += 32)
#pragma unroll
    for (int i = 0; i < RPW; ++i)
      if (r + i * kWarps < rows)
        amax[i] = tdn::max_nan(amax[i], fabsf(h[(r + i * kWarps) * ldh + c]));
  float s[RPW];
#pragma unroll
  for (int i = 0; i < RPW; ++i) s[i] = row_scale(tdn::warp_max(amax[i]));
  for (int c = lane; c < din; c += 32)
#pragma unroll
    for (int i = 0; i < RPW; ++i)
      if (r + i * kWarps < rows)
        codes[(r + i * kWarps) * ldq + c] = quantize(h[(r + i * kWarps) * ldh + c], s[i]);
  if (lane == 0)
#pragma unroll
    for (int i = 0; i < RPW; ++i)
      if (r + i * kWarps < rows) rscale[r + i * kWarps] = s[i];
}

// C (dout columns of rows x ld) += one column pass over k in [kb, ke)
// (kb a multiple of 64): A from the resident codes (column k - cbase),
// B through the ring. acc is this warp's 16 rows x NT 8-column tiles.
// Copy slice s (64-deep, from k = kb) of a pass's packed columns into its
// ring slot, and commit it as one group (empty past the range's nsl).
__device__ __forceinline__ void issue_slice(unsigned char* ring, const unsigned char* __restrict__ w,
                                            int n8, int j0, int nt, int kb, int nsl, int s) {
  if (s < nsl) {
    unsigned char* dst = ring + (s % kStages) * kSlotBytes;
    const int step = (kb + 64 * s) / 32;
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      const unsigned char* src = w + ((size_t)(step + ks) * n8 + j0) * kStepBytes;
      for (int e = threadIdx.x; e < nt * (kStepBytes / 16); e += kThreads)
        cp_async16(dst + ks * kPassTiles * kStepBytes + 16 * e, src + 16 * e);
    }
  }
  cp_async_commit();
}

template <int NT, int WN>
__device__ __forceinline__ void mma_range(int (&acc)[NT][4], unsigned char* ring,
                                          const int8_t* codes, int ldq, int cbase,
                                          const unsigned char* __restrict__ w, int n8, int j0,
                                          int nt, int kb, int ke, int m0, int wn) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int nsl = (ke - kb + 63) / 64;
  auto issue = [&](int s) { issue_slice(ring, w, n8, j0, nt, kb, nsl, s); };
  __syncthreads();  // every warp is done with the ring's last contents
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) issue(s);
  const int8_t* arow = codes + (m0 + g) * ldq + 4 * t - cbase;
  for (int s = 0; s < nsl; ++s) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // slice s landed for every thread; slot s-1 is free
    issue(s + kStages - 1);
    const unsigned char* slot = ring + (s % kStages) * kSlotBytes;
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      const int8_t* ap = arow + kb + 64 * s + 32 * ks;
      const int a0 = *reinterpret_cast<const int*>(ap);
      const int a1 = *reinterpret_cast<const int*>(ap + 8 * ldq);
      const int a2 = *reinterpret_cast<const int*>(ap + 16);
      const int a3 = *reinterpret_cast<const int*>(ap + 8 * ldq + 16);
      const unsigned char* bp = slot + ks * kPassTiles * kStepBytes + 8 * lane;
#pragma unroll
      for (int i = 0; i < NT; ++i) {
        const int jl = wn * NT + i;
        if (jl < nt) {
          const int2 b = *reinterpret_cast<const int2*>(bp + jl * kStepBytes);
          mma_s8(acc[i], a0, a1, a2, a3, b.x, b.y);
        }
      }
    }
  }
  cp_async_wait<0>();
}

// The rescaled, biased, activated values of this warp's tiles (f),
// stored to the resident activations or, for the last layer, the output.
template <int NT, typename F>
__device__ __forceinline__ void store_pass(const int (&acc)[NT][4], F f, float* dst, int ld,
                                           const float* rscale, const float* __restrict__ wscale,
                                           const float* __restrict__ bias, int c_base, int dout,
                                           int rows, int m0, int wn) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < NT; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = m0 + g + 8 * (e >> 1);
      const int c = c_base + 8 * (wn * NT + i) + 2 * t + (e & 1);
      if (r < rows && c < dout) {
        const float y = __fadd_rn(
            __fmul_rn(__int2float_rn(acc[i][e]), __fmul_rn(rscale[r], wscale[c])), bias[c]);
        dst[(size_t)r * ld + c] = f(y);
      }
    }
  }
}

template <int TM>
__global__ void __launch_bounds__(kThreads)
int8_chain_kernel(const float* __restrict__ x, float* __restrict__ out, int M, int ldh, int ldq,
                  int kc, Int8ChainArgs args) {
  constexpr int WM = TM / 16;         // warps along the rows
  constexpr int WN = kWarps / WM;     // warps along a pass's columns
  constexpr int NT = kPassTiles / WN; // 8-column tiles a warp takes of a pass
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring = smem;
  int8_t* codes = reinterpret_cast<int8_t*>(smem + kStages * kSlotBytes);
  float* h = reinterpret_cast<float*>(codes + TM * ldq);
  float* rscale = h + TM * ldh;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m0 = 16 * (warp % WM), wn = warp / WM;
  const int d0 = args.dim[0];

  for (int tile = blockIdx.x; tile * TM < M; tile += gridDim.x) {
    const int row0 = tile * TM;
    const int rows = min(TM, M - row0);
    const float* xt = x + (size_t)row0 * d0;
    for (int l = 0; l < args.layers; ++l) {
      const int din = args.dim[l], dout = args.dim[l + 1], act = args.act[l];
      const bool last = l + 1 == args.layers;
      const bool chunked = l == 0 && din > kc;
      __syncthreads();  // the last layer's (or tile's) reads of codes and h are done
      const unsigned char* w = args.wq[l];
      const int n8 = (dout + 7) / 8;
      // Row scales, and the codes unless the input is quantised chunk by chunk.
      if (l > 0) {
        quantize_rows_shared<TM / kWarps>(h, ldh, din, warp, rows, codes, ldq, rscale, lane);
      } else if (din <= kRegCols) {
        for (int r = warp; r < rows; r += kWarps)
          quantize_row_regs(xt + (size_t)r * din, din, codes + r * ldq, rscale + r, lane);
      } else {
        for (int r = warp; r < rows; r += kWarps) {
          const float* xr = xt + (size_t)r * din;
          float amax = 0.0f;
#pragma unroll 4
          for (int c = lane; c < din; c += 32) amax = tdn::max_nan(amax, fabsf(xr[c]));
          const float s = row_scale(tdn::warp_max(amax));
          if (!chunked)
            for (int c = lane; c < din; c += 32) codes[r * ldq + c] = quantize(xr[c], s);
          if (lane == 0) rscale[r] = s;
        }
      }
      __syncthreads();

      float* dst = last ? out + (size_t)row0 * dout : h;
      const int ld = last ? dout : ldh;
      for (int j0 = 0; j0 < n8; j0 += kPassTiles) {
        const int nt = min(kPassTiles, n8 - j0);
        int acc[NT][4];
#pragma unroll
        for (int i = 0; i < NT; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][e] = 0;
        const int span = chunked ? kc : din;
        for (int kb = 0; kb < din; kb += span) {
          const int ke = min(din, kb + span);
          if (chunked) {
            __syncthreads();  // every warp is done with the last chunk's codes
            for (int r = warp; r < rows; r += kWarps) {
              const float* xr = xt + (size_t)r * din;
              const float s = rscale[r];
              for (int c = kb + lane; c < ke; c += 32) codes[r * ldq + c - kb] = quantize(xr[c], s);
            }
          }
          mma_range<NT, WN>(acc, ring, codes, ldq, chunked ? kb : 0, w, n8, j0, nt, kb, ke, m0,
                            wn);
        }
        const float* wscale = args.scale[l];
        const float* bias = args.b[l];
        const int cb = 8 * j0;
        switch (act) {
          case tdn::RELU:
            store_pass(acc, [](float y) { return tdn::relu_nan(y); }, dst, ld, rscale, wscale,
                       bias, cb, dout, rows, m0, wn);
            break;
          case tdn::SIGMOID:
            store_pass(acc, [](float y) { return tdn::act_elem(y, tdn::SIGMOID); }, dst, ld,
                       rscale, wscale, bias, cb, dout, rows, m0, wn);
            break;
          case tdn::TANH:
            store_pass(acc, [](float y) { return tanhf(y); }, dst, ld, rscale, wscale, bias, cb,
                       dout, rows, m0, wn);
            break;
          case tdn::GELU:
            store_pass(acc, [](float y) { return tdn::act_elem(y, tdn::GELU); }, dst, ld,
                       rscale, wscale, bias, cb, dout, rows, m0, wn);
            break;
          default:  // linear; softmax stores the pre-activation
            store_pass(acc, [](float y) { return y; }, dst, ld, rscale, wscale, bias, cb, dout,
                       rows, m0, wn);
            break;
        }
      }
      if (act == tdn::SOFTMAX) {
        __syncthreads();  // the rows are finished (in shared or device memory)
        for (int r = warp; r < rows; r += kWarps)
          tdn::softmax_row_warp(dst + (size_t)r * ld, dout, lane);
      }
    }
  }
}

template <int TM>
int launch(const float* x, float* out, int M, int ldh, int ldq, int kc, int smem,
           const Int8ChainArgs& args, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(int8_chain_kernel<TM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0, dev = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, int8_chain_kernel<TM>, kThreads,
                                                      smem);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int tiles = (M + TM - 1) / TM;
  const int grid = tiles < per_sm * sms ? tiles : per_sm * sms;
  int8_chain_kernel<TM><<<grid, kThreads, smem, s>>>(x, out, M, ldh, ldq, kc, args);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (M, dims[0]) f32; per layer l: wq[l] the packed codes of its
// (dims[l], dims[l+1]) int8 weights (quantized.py::pack_wq), scale[l]
// and b[l] (dims[l+1],) f32; out (M, dims[layers]) f32. tm rows a tile
// (16, 32 or 64); ldh the resident activations' row stride in floats,
// ldq the codes' row stride in bytes (16 mod 128), kc the widest input
// whose codes stay resident (a multiple of 64), smem the bytes of the
// layout (kernels/fused_dense.py::int8_plan). Returns a cudaError_t code.
extern "C" int tdn_int8_chain(const float* x, float* out, int M, const void* const* wq,
                              const void* const* scale, const void* const* b,
                              const int* dims, const int* acts, int layers, int tm, int ldh,
                              int ldq, int kc, int smem, void* stream) {
  const int need = kStages * kSlotBytes + tm * ldq + 4 * tm * (ldh + 1);
  if (layers < 1 || layers > kMaxLayers || ldq % 128 != 16 || kc % 64 != 0 || kc > ldq ||
      ldh % 4 != 0 || smem < need || smem > 232448)
    return static_cast<int>(cudaErrorInvalidValue);
  Int8ChainArgs args;
  for (int l = 0; l < layers; ++l) {
    args.wq[l] = static_cast<const unsigned char*>(wq[l]);
    args.scale[l] = static_cast<const float*>(scale[l]);
    args.b[l] = static_cast<const float*>(b[l]);
    args.act[l] = acts[l];
    if ((reinterpret_cast<uintptr_t>(wq[l]) & 15) != 0 || (l > 0 && (dims[l] > ldh || dims[l] > kc)))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int l = 0; l <= layers; ++l) args.dim[l] = dims[l];
  args.layers = layers;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tm) {
    case 64: return launch<64>(x, out, M, ldh, ldq, kc, smem, args, s);
    case 32: return launch<32>(x, out, M, ldh, ldq, kc, smem, args, s);
    case 16: return launch<16>(x, out, M, ldh, ldq, kc, smem, args, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

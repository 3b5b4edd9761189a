// flash_attention: softmax attention forward and its two backward
// kernels, f32 or bf16 in, f32 accumulation.
//
// Replaces the Pallas kernels of tpu_dist_nn/kernels/flash_attention.py:
//   tdn_flash_fwd     <- _fwd_kernel     (pallas_call at :100)
//   tdn_flash_bwd_dq  <- _bwd_dq_kernel  (pallas_call at :201)
//   tdn_flash_bwd_dkv <- _bwd_dkv_kernel (pallas_call at :220)
// Each TPU kernel owns one (batch*head, q-block) or (batch*head,
// k-block) tile, keeps the whole K/V (or Q/dO) of its head in VMEM and
// runs the blocks of the other side as a sequential fori_loop: the
// (T, T) score matrix never reaches HBM.
//
// Bound on an H100: at the LM's shape (B 16, H 12, T 1024, Dh 64,
// causal, bf16) the forward moves 101.5 MB and needs 25.8 GFLOP over
// the P = T(T+1)/2 unmasked pairs of each head, so it is bound by bytes
// (30 us at 3.35 TB/s) on bf16 tensor cores; the backward kernels are
// bound by operations (38.7 and 51.6 GFLOP: 39 and 52 us at 989
// TFLOP/s). These kernels compute with FP32 FFMA on CUDA cores (67
// TFLOP/s), so they sit well above that bound; wgmma, TMA and a
// pipelined ring of tiles are later work.
//
// Design (the same for the three kernels): one CTA of 256 threads per
// 64-row block of its own side, a loop over the 64-row blocks of the
// other side. Each block is staged in shared memory as f32, rows at a
// pitch of Dh + 4 floats (rounded up to 64 or 128), so float4 reads of
// 8 consecutive rows fall in 8 distinct 16-byte bank groups. A thread
// owns 4 rows (ty + 16 i) and, of a 64 x 64 score tile, 4 columns
// (tx + 16 j); a row's 16 owners are 16 lanes of one warp, so row max
// and row sum are 4 shuffles. Probabilities (or dS) go through shared
// memory into the second product, where a thread owns 4 rows and the
// columns tx*4 + 64 jj of the 64- or 128-wide output. Nothing is
// padded in device memory: q, k and v are read with their strides (the
// port hands in the three views of the fused qkv projection), rows past
// T read as zeros and their scores are masked, and the causal mask is
// applied element by element on the diagonal block. Causal loops stop
// at the diagonal (forward, dq) or start at it (dk/dv), as the TPU
// kernels' block skipping does. Masked probabilities are exactly 0;
// the running max starts at the finite -1e30 of the TPU kernel, so a
// fully masked tile gives alpha = exp(m - m_new) and never NaN, and
// l == 0 becomes 1 before lse = m + log(l). The forward scales q by
// 1/sqrt(Dh) once, on load; the backward applies the scale to the
// scores and to dq and dk, as the TPU kernels do.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int kB = 64;          // rows of a block, both sides
constexpr int kThreads = 256;   // 16 x 16
constexpr int kPitchP = kB + 4; // the 64 x 64 probability / dS tile
constexpr float kNegInf = -1e30f;

struct FlashArgs {
  int B, H, T, Dh, seq_len, causal;
  int q_sb, q_st, q_sh;  // element strides of q (batch, token, head); Dh is contiguous
  int k_sb, k_st, k_sh;
  int v_sb, v_st, v_sh;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to(bfloat16)
}

__device__ __forceinline__ float sum16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float max16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Stage rows [0, rows) of a (rows, Dh) slab with row stride st into dst
// (kB rows at pitch D + 4), times mul; rows past `rows` and columns
// past Dh become 0.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* __restrict__ dst, const T* __restrict__ src,
                                          int st, int rows, int Dh, float mul) {
  for (int e = threadIdx.x; e < kB * D; e += kThreads) {
    const int r = e / D, d = e % D;
    float x = 0.0f;
    if (r < rows && d < Dh) x = to_f(src[(size_t)r * st + d]) * mul;
    dst[r * (D + 4) + d] = x;
  }
}

// s[i][j] = sum_d A[ty + 16 i][d] * Bt[tx + 16 j][d] over d < dlim (a
// multiple of 4; the staged columns past Dh are 0).
template <int D>
__device__ __forceinline__ void tile_dot(float (&s)[4][4], const float* __restrict__ A,
                                         const float* __restrict__ Bt, int dlim) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 4
  for (int d = 0; d < dlim; d += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const float4*>(A + (ty + 16 * i) * (D + 4) + d);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      b[j] = *reinterpret_cast<const float4*>(Bt + (tx + 16 * j) * (D + 4) + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(a[i].x, b[j].x, s[i][j]);
        s[i][j] = fmaf(a[i].y, b[j].y, s[i][j]);
        s[i][j] = fmaf(a[i].z, b[j].z, s[i][j]);
        s[i][j] = fmaf(a[i].w, b[j].w, s[i][j]);
      }
  }
}

// acc[i][4 jj + e] += sum_c P[ty + 16 i][c] * V[c][tx * 4 + 64 jj + e]:
// a 64 x 64 tile (pitch kPitchP) times a staged block (pitch D + 4).
template <int D>
__device__ __forceinline__ void tile_pv(float (&acc)[4][D / 16], const float* __restrict__ P,
                                        const float* __restrict__ V) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll 2
  for (int c = 0; c < kB; c += 4) {
    float4 p[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      p[i] = *reinterpret_cast<const float4*>(P + (ty + 16 * i) * kPitchP + c);
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
#pragma unroll
      for (int jj = 0; jj < D / 64; ++jj) {
        const float4 v =
            *reinterpret_cast<const float4*>(V + (c + cc) * (D + 4) + tx * 4 + 64 * jj);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float pv = cc == 0 ? p[i].x : cc == 1 ? p[i].y : cc == 2 ? p[i].z : p[i].w;
          acc[i][4 * jj + 0] = fmaf(pv, v.x, acc[i][4 * jj + 0]);
          acc[i][4 * jj + 1] = fmaf(pv, v.y, acc[i][4 * jj + 1]);
          acc[i][4 * jj + 2] = fmaf(pv, v.z, acc[i][4 * jj + 2]);
          acc[i][4 * jj + 3] = fmaf(pv, v.w, acc[i][4 * jj + 3]);
        }
      }
    }
  }
}

// Write rows of acc * mul (the thread's 4 rows x D/16 columns) into a
// contiguous (B, T, H, Dh) tensor, rows r0 + ty + 16 i < T.
template <typename T, int D>
__device__ __forceinline__ void store_rows(T* __restrict__ out, const float (&acc)[4][D / 16],
                                           const float (&mul)[4], const FlashArgs& a, int b,
                                           int h, int r0) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty + 16 * i;
    if (r >= a.T) continue;
    T* row = out + (((size_t)b * a.T + r) * a.H + h) * a.Dh;
#pragma unroll
    for (int jj = 0; jj < D / 64; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = tx * 4 + 64 * jj + e;
        if (d < a.Dh) row[d] = from_f<T>(acc[i][4 * jj + e] * mul[i]);
      }
  }
}

// 64-row blocks of one head.
__host__ __device__ __forceinline__ int n_blocks(int T) { return (T + kB - 1) / kB; }

// ----------------------------------------------------------------- forward
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ lse, FlashArgs a, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Ks = Qs + kB * (D + 4);
  float* Vs = Ks + kB * (D + 4);
  float* Ps = Vs + kB * (D + 4);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int nb = n_blocks(a.T);
  const int bh = blockIdx.x / nb;
  const int q0 = (nb - 1 - blockIdx.x % nb) * kB;  // the longest causal rows start first
  const int b = bh / a.H, h = bh % a.H;
  const int n_keys = min(a.T, a.seq_len);
  const int k_end = a.causal ? min(n_keys, q0 + kB) : n_keys;
  const int dlim = (a.Dh + 3) & ~3;

  load_tile<T, D>(Qs, q + (size_t)b * a.q_sb + (size_t)h * a.q_sh + (size_t)q0 * a.q_st,
                  a.q_st, min(kB, a.T - q0), a.Dh, scale);
  float m[4], l[4], acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < D / 16; ++c) acc[i][c] = 0.0f;
  }
  const T* kbase = k + (size_t)b * a.k_sb + (size_t)h * a.k_sh;
  const T* vbase = v + (size_t)b * a.v_sb + (size_t)h * a.v_sh;
  for (int k0 = 0; k0 < k_end; k0 += kB) {
    __syncthreads();  // the previous block's readers of Ks, Vs and Ps are done
    const int rows = min(kB, a.T - k0);
    load_tile<T, D>(Ks, kbase + (size_t)k0 * a.k_st, a.k_st, rows, a.Dh, 1.0f);
    load_tile<T, D>(Vs, vbase + (size_t)k0 * a.v_st, a.v_st, rows, a.Dh, 1.0f);
    __syncthreads();
    float s[4][4];
    tile_dot<D>(s, Qs, Ks, dlim);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty + 16 * i;
      bool ok[4];
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx + 16 * j;
        ok[j] = kj < n_keys && (!a.causal || kj <= qi);
        if (!ok[j]) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = max16(mx);
      const float alpha = expf(m[i] - mx);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(s[i][j] - mx) : 0.0f;
        Ps[(ty + 16 * i) * kPitchP + tx + 16 * j] = p;
        rs += p;
      }
      l[i] = l[i] * alpha + sum16(rs);
#pragma unroll
      for (int c = 0; c < D / 16; ++c) acc[i][c] *= alpha;
      m[i] = mx;
    }
    __syncthreads();
    tile_pv<D>(acc, Ps, Vs);
  }
  float inv[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float l_safe = l[i] == 0.0f ? 1.0f : l[i];
    inv[i] = 1.0f / l_safe;
    const int r = q0 + ty + 16 * i;
    if (tx == 0 && r < a.T) lse[(size_t)bh * a.T + r] = m[i] + logf(l_safe);
  }
  store_rows<T, D>(o, acc, inv, a, b, h, q0);
}

// -------------------------------------------------------------- dq
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq, FlashArgs a,
                    float scale) {
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Os = Qs + kB * (D + 4);  // dO
  float* Ks = Os + kB * (D + 4);
  float* Vs = Ks + kB * (D + 4);
  float* Ss = Vs + kB * (D + 4);  // dS
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int nb = n_blocks(a.T);
  const int bh = blockIdx.x / nb;
  const int q0 = (nb - 1 - blockIdx.x % nb) * kB;
  const int b = bh / a.H, h = bh % a.H;
  const int n_keys = min(a.T, a.seq_len);
  const int k_end = a.causal ? min(n_keys, q0 + kB) : n_keys;
  const int dlim = (a.Dh + 3) & ~3;
  const int rows_q = min(kB, a.T - q0);
  const int o_st = a.H * a.Dh;  // dO is contiguous (B, T, H, Dh)

  load_tile<T, D>(Qs, q + (size_t)b * a.q_sb + (size_t)h * a.q_sh + (size_t)q0 * a.q_st,
                  a.q_st, rows_q, a.Dh, 1.0f);
  load_tile<T, D>(Os, dout + (((size_t)b * a.T + q0) * a.H + h) * a.Dh, o_st, rows_q, a.Dh,
                  1.0f);
  float row_lse[4], row_delta[4], acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    row_lse[i] = r < a.T ? lse[(size_t)bh * a.T + r] : 0.0f;
    row_delta[i] = r < a.T ? delta[(size_t)bh * a.T + r] : 0.0f;
#pragma unroll
    for (int c = 0; c < D / 16; ++c) acc[i][c] = 0.0f;
  }
  const T* kbase = k + (size_t)b * a.k_sb + (size_t)h * a.k_sh;
  const T* vbase = v + (size_t)b * a.v_sb + (size_t)h * a.v_sh;
  for (int k0 = 0; k0 < k_end; k0 += kB) {
    __syncthreads();
    const int rows = min(kB, a.T - k0);
    load_tile<T, D>(Ks, kbase + (size_t)k0 * a.k_st, a.k_st, rows, a.Dh, 1.0f);
    load_tile<T, D>(Vs, vbase + (size_t)k0 * a.v_st, a.v_st, rows, a.Dh, 1.0f);
    __syncthreads();
    float s[4][4], dp[4][4];
    tile_dot<D>(s, Qs, Ks, dlim);
    tile_dot<D>(dp, Os, Vs, dlim);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx + 16 * j;
        const bool ok = kj < n_keys && (!a.causal || kj <= qi);
        const float p = ok ? expf(s[i][j] * scale - row_lse[i]) : 0.0f;
        Ss[(ty + 16 * i) * kPitchP + tx + 16 * j] = p * (dp[i][j] - row_delta[i]);
      }
    }
    __syncthreads();
    tile_pv<D>(acc, Ss, Ks);
  }
  const float mul[4] = {scale, scale, scale, scale};
  store_rows<T, D>(dq, acc, mul, a, b, h, q0);
}

// ------------------------------------------------------------- dk, dv
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                     FlashArgs a, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;
  float* Vs = Ks + kB * (D + 4);
  float* Qs = Vs + kB * (D + 4);
  float* Os = Qs + kB * (D + 4);  // dO
  float* Pt = Os + kB * (D + 4);  // P transposed: [key][query]
  float* St = Pt + kB * kPitchP;  // dS transposed
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int nb = n_blocks(a.T);
  const int bh = blockIdx.x / nb;
  const int k0 = (blockIdx.x % nb) * kB;  // the longest causal columns start first
  const int b = bh / a.H, h = bh % a.H;
  const int n_keys = min(a.T, a.seq_len);
  const int dlim = (a.Dh + 3) & ~3;
  const int rows_k = min(kB, a.T - k0);
  const int o_st = a.H * a.Dh;

  load_tile<T, D>(Ks, k + (size_t)b * a.k_sb + (size_t)h * a.k_sh + (size_t)k0 * a.k_st,
                  a.k_st, rows_k, a.Dh, 1.0f);
  load_tile<T, D>(Vs, v + (size_t)b * a.v_sb + (size_t)h * a.v_sh + (size_t)k0 * a.v_st,
                  a.v_st, rows_k, a.Dh, 1.0f);
  float dk_acc[4][D / 16], dv_acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < D / 16; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.0f;
  const T* qbase = q + (size_t)b * a.q_sb + (size_t)h * a.q_sh;
  // Keys at or past seq_len are masked for every query: their dk, dv stay 0.
  const int q_begin = k0 >= n_keys ? a.T : (a.causal ? k0 : 0);
  for (int q0 = q_begin; q0 < a.T; q0 += kB) {
    __syncthreads();
    const int rows = min(kB, a.T - q0);
    load_tile<T, D>(Qs, qbase + (size_t)q0 * a.q_st, a.q_st, rows, a.Dh, 1.0f);
    load_tile<T, D>(Os, dout + (((size_t)b * a.T + q0) * a.H + h) * a.Dh, o_st, rows, a.Dh,
                    1.0f);
    float col_lse[4], col_delta[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = q0 + tx + 16 * j;
      col_lse[j] = r < a.T ? lse[(size_t)bh * a.T + r] : 0.0f;
      col_delta[j] = r < a.T ? delta[(size_t)bh * a.T + r] : 0.0f;
    }
    __syncthreads();
    float st[4][4], dpt[4][4];
    tile_dot<D>(st, Ks, Qs, dlim);  // st[i][j] = k_(ty+16i) . q_(tx+16j)
    tile_dot<D>(dpt, Vs, Os, dlim);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kc = k0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qr = q0 + tx + 16 * j;
        const bool ok = kc < n_keys && qr < a.T && (!a.causal || kc <= qr);
        const float p = ok ? expf(st[i][j] * scale - col_lse[j]) : 0.0f;
        Pt[(ty + 16 * i) * kPitchP + tx + 16 * j] = p;
        St[(ty + 16 * i) * kPitchP + tx + 16 * j] = p * (dpt[i][j] - col_delta[j]);
      }
    }
    __syncthreads();
    tile_pv<D>(dv_acc, Pt, Os);  // dv += P^T dO
    tile_pv<D>(dk_acc, St, Qs);  // dk += dS^T Q
  }
  const float one[4] = {1.0f, 1.0f, 1.0f, 1.0f};
  const float mul[4] = {scale, scale, scale, scale};
  store_rows<T, D>(dv, dv_acc, one, a, b, h, k0);
  store_rows<T, D>(dk, dk_acc, mul, a, b, h, k0);
}

// Shared-memory floats of each kernel: staged blocks plus 64 x 64 tiles.
template <int D> constexpr int fwd_floats() { return 3 * kB * (D + 4) + kB * kPitchP; }
template <int D> constexpr int dq_floats() { return 4 * kB * (D + 4) + kB * kPitchP; }
template <int D> constexpr int dkv_floats() { return 4 * kB * (D + 4) + 2 * kB * kPitchP; }

template <typename K>
int prepare(K kernel, int floats) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, floats * (int)sizeof(float)));
}

template <typename T, int D>
int launch_fwd(const FlashArgs& a, const void* q, const void* k, const void* v, void* o,
               float* lse, float scale, cudaStream_t s) {
  const int floats = fwd_floats<D>();
  if (int err = prepare(flash_fwd_kernel<T, D>, floats)) return err;
  const unsigned grid = (unsigned)(a.B * a.H) * n_blocks(a.T);
  flash_fwd_kernel<T, D><<<grid, kThreads, floats * sizeof(float), s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, a, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_dq(const FlashArgs& a, const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, void* dq, float scale, cudaStream_t s) {
  const int floats = dq_floats<D>();
  if (int err = prepare(flash_bwd_dq_kernel<T, D>, floats)) return err;
  const unsigned grid = (unsigned)(a.B * a.H) * n_blocks(a.T);
  flash_bwd_dq_kernel<T, D><<<grid, kThreads, floats * sizeof(float), s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dq), a, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_dkv(const FlashArgs& a, const void* q, const void* k, const void* v,
               const void* dout, const float* lse, const float* delta, void* dk, void* dv,
               float scale, cudaStream_t s) {
  const int floats = dkv_floats<D>();
  if (int err = prepare(flash_bwd_dkv_kernel<T, D>, floats)) return err;
  const unsigned grid = (unsigned)(a.B * a.H) * n_blocks(a.T);
  flash_bwd_dkv_kernel<T, D><<<grid, kThreads, floats * sizeof(float), s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), a,
      scale);
  return static_cast<int>(cudaGetLastError());
}

// p: B, H, T, Dh, seq_len, causal, then the (batch, token, head) element
// strides of q, k and v. -1 when the shape is out of the kernels' range.
int args_from(const int* p, FlashArgs* a) {
  *a = FlashArgs{p[0], p[1], p[2], p[3], p[4],  p[5],  p[6],  p[7],
                 p[8], p[9], p[10], p[11], p[12], p[13], p[14]};
  if (a->B < 1 || a->H < 1 || a->T < 1 || a->Dh < 1 || a->Dh > 128 || a->seq_len < 1)
    return -1;
  return a->Dh <= 64 ? 64 : 128;
}

}  // namespace

// q, k, v: (B, T, H, Dh) views with the strides in p (Dh contiguous), of
// float32 (bf16 = 0) or bfloat16 (bf16 = 1). o: contiguous (B, T, H, Dh)
// of the same type; lse: contiguous (B, H, T) float32. Returns a
// cudaError_t code.
extern "C" int tdn_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                             const int* p, float scale, int bf16, void* stream) {
  FlashArgs a;
  const int d = args_from(p, &a);
  if (d < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (bf16) {
    return d == 64 ? launch_fwd<__nv_bfloat16, 64>(a, q, k, v, o, l, scale, s)
                   : launch_fwd<__nv_bfloat16, 128>(a, q, k, v, o, l, scale, s);
  }
  return d == 64 ? launch_fwd<float, 64>(a, q, k, v, o, l, scale, s)
                 : launch_fwd<float, 128>(a, q, k, v, o, l, scale, s);
}

// As tdn_flash_fwd, plus dout: contiguous (B, T, H, Dh) of q's type;
// lse, delta: contiguous (B, H, T) float32; dq: contiguous (B, T, H, Dh).
extern "C" int tdn_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                                const void* lse, const void* delta, void* dq, const int* p,
                                float scale, int bf16, void* stream) {
  FlashArgs a;
  const int d = args_from(p, &a);
  if (d < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  if (bf16) {
    return d == 64 ? launch_dq<__nv_bfloat16, 64>(a, q, k, v, dout, l, dl, dq, scale, s)
                   : launch_dq<__nv_bfloat16, 128>(a, q, k, v, dout, l, dl, dq, scale, s);
  }
  return d == 64 ? launch_dq<float, 64>(a, q, k, v, dout, l, dl, dq, scale, s)
                 : launch_dq<float, 128>(a, q, k, v, dout, l, dl, dq, scale, s);
}

// As tdn_flash_bwd_dq, with dk and dv: contiguous (B, T, H, Dh).
extern "C" int tdn_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse, const void* delta,
                                 void* dk, void* dv, const int* p, float scale, int bf16,
                                 void* stream) {
  FlashArgs a;
  const int d = args_from(p, &a);
  if (d < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  if (bf16) {
    return d == 64
               ? launch_dkv<__nv_bfloat16, 64>(a, q, k, v, dout, l, dl, dk, dv, scale, s)
               : launch_dkv<__nv_bfloat16, 128>(a, q, k, v, dout, l, dl, dk, dv, scale, s);
  }
  return d == 64 ? launch_dkv<float, 64>(a, q, k, v, dout, l, dl, dk, dv, scale, s)
                 : launch_dkv<float, 128>(a, q, k, v, dout, l, dl, dk, dv, scale, s);
}

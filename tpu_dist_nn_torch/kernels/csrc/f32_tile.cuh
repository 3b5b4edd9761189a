// The FP32 register tile shared by fused_dense.cu and fcnn_chain.cu: one
// CTA of 256 threads computes a (8R) x (16TN) tile of act(A @ W + b) on
// CUDA cores, every FMA in FP32 (no TF32).
//
// Threads: two K groups of 128 (warps 0-3 and 4-7) each take half of
// every K slice over the whole tile; at the end group 1 hands its sums
// to group 0 through shared memory, which adds them (a fixed order) and
// owns the epilogue. In a group, 8 row groups x 16 column groups; a warp
// holds two row groups (lanes 0-15 and 16-31). Row group g owns rows g,
// g+8, ..., g+8(R-1); column group c owns TN columns (TN = 8: 4c..4c+3
// and 64+4c..64+4c+3; else TN c .. TN c+TN-1), an R x TN register tile
// (8 x 8 at the flagship's 64 x 128). A sits in shared memory row-major,
// so a thread reads 4 consecutive k of one row with one 128-bit load,
// which the 16 lanes of a row group share (the warp's two rows are
// adjacent: no bank conflict); W sits row-major too, and a column group
// reads its columns of one k with 128-bit loads over 256 contiguous
// bytes. Per 4 k a thread issues R + 4 TN/4 loads for 4 R TN FMAs (16
// loads for 256 FMAs at 8 x 8), so the FMA units, not shared memory, set
// the pace.
//
// K streams in 64-deep slices through a ring of kStages slots filled by
// cp.async: 16-byte copies where rows are 16-byte aligned, 4-byte
// copies otherwise (uint8 input that is not 16-byte aligned is stored
// by plain loads). Copies past the matrix edges zero-fill, so ragged M,
// N and K need no masks in the FMA loop. Slices t+1 and t+2 are in
// flight while slice t's FMAs run; one __syncthreads per slice.
//
// Code size matters as much as the loop: a CTA runs each layer's code
// once, so every byte of it is fetched cold. The K loop is unrolled by
// two 4-k steps, not over the whole slice, and the epilogue branches
// once on the activation (see bias_act).
#pragma once

#include "common.cuh"

namespace tdn {

constexpr int kThreads = 256;
constexpr int kWarpsPerCta = kThreads / 32;
constexpr int kGroups = kThreads / 128;  // K groups: each 128 threads own the whole tile
constexpr int kBK = 64;               // K per slice
constexpr int kStages = 3;            // slots in the ring
constexpr int kMaxPassCols = 128;     // 16 column groups x TN (TN <= 8)
constexpr int kAStride = kBK + 4;     // floats per A row in a slot (f32)
constexpr int kAStrideU8 = kBK + 16;  // bytes per A row in a slot (uint8)

// Where a pass reads A from.
enum ASource : int {
  A_GLOBAL_F32 = 0,         // float rows in device memory, through the ring
  A_GLOBAL_F32_SCALED = 1,  // the same, multiplied by PassA::scale on read
  A_GLOBAL_U8 = 2,          // uint8 rows in device memory, through the ring, scaled on read
  A_SHARED = 3,             // float rows already resident in shared memory
};

// Shared-memory ring: kStages A slots of tm rows (kAStride floats, or
// kAStrideU8 bytes for uint8 input) and kStages W slots of
// kBK x kMaxPassCols floats.
struct Ring {
  float* a;
  float* w;
  int a_slot;  // floats per A slot
};

__host__ __device__ constexpr int ring_floats(int tm) {
  return kStages * (tm * kAStride + kBK * kMaxPassCols);
}

__device__ __forceinline__ Ring make_ring(float* smem, int tm) {
  return Ring{smem, smem + kStages * tm * kAStride, tm * kAStride};
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Max and sum over the 16 lanes of a row group (lanes 0-15 or 16-31).
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// One operand of a pass.
struct PassA {
  const void* src;  // global: row 0 of the tile; shared: the resident rows
  int ld;           // row stride in elements
  int rows;         // valid rows (global)
  bool vec;         // 16-byte copies allowed (global)
  float scale;      // multiplies every A element (A_GLOBAL_F32_SCALED, A_GLOBAL_U8)
};

struct PassW {
  const float* w;  // (din, ldw) row-major
  int ldw;         // = the layer's dout
  int c0;          // first column of the pass
  bool vec;        // 16-byte copies allowed
};

// Copy W[k0 .. k0+kBK) x [c0 .. c0+16TN) into a W slot (row stride
// 16TN), zero past ke and past ldw. Thread tid copies chunks tid,
// tid + kThreads, ...: a fixed count, unrolled.
template <int TN>
__device__ __forceinline__ void load_w_slice(float* dst, const PassW& pw, int k0, int ke, int tid) {
  constexpr int W = 16 * TN;
  if (pw.vec) {
    constexpr int kChunks = kBK * W / 4;
#pragma unroll
    for (int it = 0; it < (kChunks + kThreads - 1) / kThreads; ++it) {
      const int e = tid + it * kThreads;
      if (kChunks % kThreads == 0 || e < kChunks) {
        const int r = e / (W / 4), c = 4 * (e % (W / 4));
        const int gk = k0 + r, gc = pw.c0 + c;
        const bool ok = gk < ke && gc < pw.ldw;
        cp_async16(dst + r * W + c, ok ? pw.w + (size_t)gk * pw.ldw + gc : pw.w, ok);
      }
    }
  } else {
#pragma unroll 4
    for (int e = tid; e < kBK * W; e += kThreads) {
      const int r = e / W, c = e % W;
      const int gk = k0 + r, gc = pw.c0 + c;
      const bool ok = gk < ke && gc < pw.ldw;
      cp_async4(dst + e, ok ? pw.w + (size_t)gk * pw.ldw + gc : pw.w, ok);
    }
  }
}

// Copy A rows [0, TM) x [k0 .. k0+kBK) into an A slot, zero past ke
// and past the valid rows.
template <int AS, int TM>
__device__ __forceinline__ void load_a_slice(void* dst, const PassA& pa, int k0, int ke, int tid) {
  if constexpr (AS != A_GLOBAL_U8) {
    const float* x = static_cast<const float*>(pa.src);
    float* d = static_cast<float*>(dst);
    if (pa.vec) {
      constexpr int kChunks = TM * kBK / 4;
#pragma unroll
      for (int it = 0; it < (kChunks + kThreads - 1) / kThreads; ++it) {
        const int e = tid + it * kThreads;
        if (kChunks % kThreads == 0 || e < kChunks) {
          const int r = e / (kBK / 4), c = 4 * (e % (kBK / 4));
          const bool ok = r < pa.rows && k0 + c < ke;
          cp_async16(d + r * kAStride + c, ok ? x + (size_t)r * pa.ld + k0 + c : x, ok);
        }
      }
    } else {
#pragma unroll 4
      for (int e = tid; e < TM * kBK; e += kThreads) {
        const int r = e / kBK, c = e % kBK;
        const bool ok = r < pa.rows && k0 + c < ke;
        cp_async4(d + r * kAStride + c, ok ? x + (size_t)r * pa.ld + k0 + c : x, ok);
      }
    }
  } else {
    const uint8_t* x = static_cast<const uint8_t*>(pa.src);
    uint8_t* d = static_cast<uint8_t*>(dst);
    if (pa.vec) {
      constexpr int kChunks = TM * kBK / 16;
#pragma unroll
      for (int it = 0; it < (kChunks + kThreads - 1) / kThreads; ++it) {
        const int e = tid + it * kThreads;
        if (kChunks % kThreads == 0 || e < kChunks) {
          const int r = e / (kBK / 16), c = 16 * (e % (kBK / 16));
          const bool ok = r < pa.rows && k0 + c < ke;
          cp_async16(d + r * kAStrideU8 + c, ok ? x + (size_t)r * pa.ld + k0 + c : x, ok);
        }
      }
    } else {
#pragma unroll 4
      for (int e = tid; e < TM * kBK; e += kThreads) {
        const int r = e / kBK, c = e % kBK;
        d[r * kAStrideU8 + c] =
            (r < pa.rows && k0 + c < ke) ? x[(size_t)r * pa.ld + k0 + c] : uint8_t(0);
      }
    }
  }
}

// 4 consecutive k of one A row.
template <int AS>
__device__ __forceinline__ float4 read_a4(const char* row, int k, float scale) {
  if constexpr (AS == A_GLOBAL_U8) {
    const uint32_t q = *reinterpret_cast<const uint32_t*>(row + k);
    return make_float4(static_cast<float>(q & 0xffu) * scale,
                       static_cast<float>((q >> 8) & 0xffu) * scale,
                       static_cast<float>((q >> 16) & 0xffu) * scale,
                       static_cast<float>(q >> 24) * scale);
  } else {
    float4 v = *reinterpret_cast<const float4*>(row + 4 * k);
    if constexpr (AS == A_GLOBAL_F32_SCALED) {
      v.x *= scale;
      v.y *= scale;
      v.z *= scale;
      v.w *= scale;
    }
    return v;
  }
}

// Column j (< TN) of column group cg, relative to the pass.
template <int TN>
__device__ __forceinline__ int col_of(int cg, int j) {
  if constexpr (TN == 8)
    return j < 4 ? 4 * cg + j : 64 + 4 * cg + (j - 4);
  else
    return TN * cg + j;
}

// Column group cg's TN values of one W row (row stride 16TN).
template <int TN>
__device__ __forceinline__ void read_w(float (&v)[TN], const float* row, int cg) {
  if constexpr (TN == 8) {
    const float4 lo = *reinterpret_cast<const float4*>(row + 4 * cg);
    const float4 hi = *reinterpret_cast<const float4*>(row + 64 + 4 * cg);
    v[0] = lo.x;
    v[1] = lo.y;
    v[2] = lo.z;
    v[3] = lo.w;
    v[4] = hi.x;
    v[5] = hi.y;
    v[6] = hi.z;
    v[7] = hi.w;
  } else if constexpr (TN == 4) {
    const float4 t = *reinterpret_cast<const float4*>(row + 4 * cg);
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  } else if constexpr (TN == 2) {
    const float2 t = *reinterpret_cast<const float2*>(row + 2 * cg);
    v[0] = t.x;
    v[1] = t.y;
  } else {
    v[0] = row[cg];
  }
}

// acc += A[rows, k .. k+4) @ W[k .. k+4) for this thread's R x TN tile.
// a_row: the thread's first A row; a_step: bytes between its rows
// (8 rows apart); w_k: W slot row k.
template <int R, int TN, int AS>
__device__ __forceinline__ void fma_k4(float (&acc)[R][TN], const char* a_row, int a_step, int k,
                                       const float* w_k, int cg, float scale) {
  constexpr int W = 16 * TN;
  float a[R][4];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const float4 t = read_a4<AS>(a_row + i * a_step, k, scale);
    a[i][0] = t.x;
    a[i][1] = t.y;
    a[i][2] = t.z;
    a[i][3] = t.w;
  }
  float w[4][TN];
#pragma unroll
  for (int q = 0; q < 4; ++q) read_w<TN>(w[q], w_k + q * W, cg);
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i][q], w[q][j], acc[i][j]);
}

// K group 1 hands its sums to group 0 through `scratch` (128 x R x TN
// floats of shared memory no copy is landing in); group 0 adds them
// after its own, a fixed order, and group 1's sums become 0.
template <int R, int TN>
__device__ __forceinline__ void add_groups(float (&acc)[R][TN], float* scratch) {
  static_assert(kGroups == 2, "two K groups of 128 threads");
  const int tid = threadIdx.x;
  if (tid >= 128) {
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        scratch[(i * TN + j) * 128 + tid - 128] = acc[i][j];
        acc[i][j] = 0.0f;
      }
  }
  __syncthreads();
  if (tid < 128) {
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] += scratch[(i * TN + j) * 128 + tid];
  }
}

// Running sums over K ranges. A layer's K is cut into ranges fixed by K
// alone (k_ranges); a cluster gives each rank one range, and a lone CTA
// walks them all, adding each range's sums into these rows in range
// order, so a row's bits do not depend on the split the batch took.
struct Fold {
  float* h;    // rows of ld floats in shared memory; nullptr: no ranges
  int ld;
  int dout;    // the layer's width: columns past it (rounded up to 4) are not kept
  int slices;  // slices a range takes
};

// Add this pass's range sums (group 0's acc) into the fold rows, or
// start them with the first range; acc becomes 0.
template <int R, int TN>
__device__ __forceinline__ void fold_range(float (&acc)[R][TN], const Fold& f, int c0, bool first) {
  const int cg = threadIdx.x & 15;
  const int rg = threadIdx.x >> 4;
  const int dpad = (f.dout + 3) & ~3;
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = c0 + col_of<TN>(cg, j);
      float* p = f.h + (rg + 8 * i) * f.ld + c;
      if (c < dpad) *p = first ? acc[i][j] : *p + acc[i][j];
      acc[i][j] = 0.0f;
    }
}

// One pass: acc (zeroed by the caller) += A[:, kb..ke) @ W[kb..ke, c0 .. c0+16TN).
// A_SHARED reads pa.src as 8R rows of pa.ld floats (zero past the
// layer's input width, up to a multiple of 4); the global sources stream
// through the ring with W. With 256 threads, two K groups of 128 each
// take half of every slice's k (8 warps an SM, 8 x 8 registers a
// thread) and group 0 ends with the sum. With a Fold, the sum is taken
// range by range (see Fold). Every thread of the CTA must call it; it
// leaves the ring free (all copies landed, all reads done).
template <int R, int TN, int AS>
__device__ __forceinline__ void gemm_pass(float (&acc)[R][TN], const Ring& ring, const PassA& pa,
                                          const PassW& pw, int kb, int ke, const Fold& fold) {
  constexpr int TM = 8 * R;
  constexpr int W = 16 * TN;
  constexpr int kFull = kBK / 4 / kGroups;  // 4-k steps a K group takes of a whole slice
  const int tid = threadIdx.x;
  const int kg = tid >> 7;
  const int cg = tid & 15;
  const int rg = (tid & 127) >> 4;
  const int nk = (ke - kb + kBK - 1) / kBK;

  auto issue = [&](int t) {
    if (t < nk) {
      const int slot = t % kStages;
      const int k0 = kb + t * kBK;
      load_w_slice<TN>(ring.w + slot * (kBK * kMaxPassCols), pw, k0, ke, tid);
      if constexpr (AS != A_SHARED)
        load_a_slice<AS, TM>(ring.a + slot * ring.a_slot, pa, k0, ke, tid);
    }
    cp_async_commit();
  };

#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) issue(t);
  for (int t = 0; t < nk; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // slot t landed for every thread; slot t-1 is free
    issue(t + kStages - 1);
    const int slot = t % kStages;
    const int k0 = kb + t * kBK;
    const int kn4 = (min(kBK, ke - k0) + 3) / 4;
    float* w_slot = ring.w + slot * (kBK * kMaxPassCols);
    const char* a_row;
    int a_step, a_k;
    if constexpr (AS == A_SHARED) {
      a_row = reinterpret_cast<const char*>(static_cast<const float*>(pa.src) + rg * pa.ld);
      a_step = 4 * 8 * pa.ld;
      a_k = k0;
    } else if constexpr (AS == A_GLOBAL_U8) {
      a_row = reinterpret_cast<const char*>(ring.a + slot * ring.a_slot) + rg * kAStrideU8;
      a_step = 8 * kAStrideU8;
      a_k = 0;
    } else {
      a_row = reinterpret_cast<const char*>(ring.a + slot * ring.a_slot + rg * kAStride);
      a_step = 4 * 8 * kAStride;
      a_k = 0;
    }
    if constexpr (AS == A_SHARED) {
      // A later layer runs a few slices: one compact loop for all.
      const int part = (kn4 + kGroups - 1) / kGroups;
#pragma unroll 1
      for (int k4 = kg * part; k4 < min(kn4, kg * part + part); ++k4)
        fma_k4<R, TN, AS>(acc, a_row, a_step, a_k + 4 * k4, w_slot + 4 * k4 * W, cg, pa.scale);
    } else if (kn4 == kBK / 4) {
#pragma unroll 2
      for (int k4 = kg * kFull; k4 < kg * kFull + kFull; ++k4)
        fma_k4<R, TN, AS>(acc, a_row, a_step, a_k + 4 * k4, w_slot + 4 * k4 * W, cg, pa.scale);
    } else {
      const int part = (kn4 + kGroups - 1) / kGroups;
      for (int k4 = kg * part; k4 < min(kn4, kg * part + part); ++k4)
        fma_k4<R, TN, AS>(acc, a_row, a_step, a_k + 4 * k4, w_slot + 4 * k4 * W, cg, pa.scale);
    }
    if (fold.h != nullptr && ((t + 1) % fold.slices == 0 || t + 1 == nk)) {
      // Slot t's W is read by every thread once all pass this barrier,
      // and no copy lands there before the next iteration's.
      __syncthreads();
      add_groups(acc, w_slot);
      if (kg == 0) fold_range(acc, fold, pw.c0, t + 1 == fold.slices);
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  if (fold.h != nullptr) {
    // The folded sums become this pass's result.
    if (kg == 0) {
      const int dpad = (fold.dout + 3) & ~3;
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const int c = pw.c0 + col_of<TN>(cg, j);
          acc[i][j] = c < dpad ? fold.h[(rg + 8 * i) * fold.ld + c] : 0.0f;
        }
    }
  } else {
    add_groups(acc, ring.w);
  }
  __syncthreads();
}

// Whether this thread holds a pass's result (K group 0).
__device__ __forceinline__ bool owns_result() { return threadIdx.x < 128; }

// Apply f to every value of the tile.
template <int R, int TN, typename F>
__device__ __forceinline__ void each(float (&v)[R][TN], F f) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) v[i][j] = f(v[i][j]);
}

// Bias and activation in registers: acc -> the layer's values for this
// thread's columns c0 + col_of(cg, j), 0 past dout. softmax: with
// row_softmax, the whole row is in this row group's registers (dout <=
// 16TN, one pass) and is normalised here; otherwise the pre-activation
// is left for a row pass over the finished rows. One branch picks the
// activation and its straight-line code, so only the code that runs is
// fetched (a tile of every activation behind per-value branches is tens
// of KB of code).
template <int R, int TN>
__device__ __forceinline__ void bias_act(float (&acc)[R][TN], const float* __restrict__ bias,
                                         int c0, int dout, int act, bool row_softmax) {
  const int cg = threadIdx.x & 15;
  float bv[TN];
  bool ok[TN];
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int c = c0 + col_of<TN>(cg, j);
    ok[j] = c < dout;
    bv[j] = ok[j] ? bias[c] : 0.0f;
  }
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] += bv[j];
  switch (act) {
    case RELU:
      each(acc, [](float z) { return relu_nan(z); });
      break;
    case SIGMOID:
      each(acc, [](float z) { return act_elem(z, SIGMOID); });
      break;
    case TANH:
      each(acc, [](float z) { return act_elem(z, TANH); });
      break;
    case GELU:
      each(acc, [](float z) { return act_elem(z, GELU); });
      break;
    case SOFTMAX:
      if (!row_softmax) break;
#pragma unroll
      for (int i = 0; i < R; ++i) {
        float m = -INFINITY;
#pragma unroll
        for (int j = 0; j < TN; ++j)
          if (ok[j]) m = fmaxf(m, acc[i][j]);
        m = group_max(m);
        float s = 0.0f;
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const float e = ok[j] ? expf(acc[i][j] - m) : 0.0f;
          acc[i][j] = e;
          s += e;
        }
        s = group_sum(s);
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = acc[i][j] / s;
      }
      break;
    default:
      break;
  }
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j)
      if (!ok[j]) acc[i][j] = 0.0f;
}

// Store this thread's tile to rows rg + 8i of a global (rows, ld)
// matrix, columns < dout only; vec: 16-byte stores allowed (ld % 4 == 0
// and an aligned base).
template <int R, int TN>
__device__ __forceinline__ void store_global(const float (&v)[R][TN], float* __restrict__ out,
                                             int ld, int rows, int c0, int dout, bool vec) {
  const int cg = threadIdx.x & 15;
  const int rg = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = rg + 8 * i;
    if (r >= rows) continue;
    float* o = out + (size_t)r * ld + c0;
#pragma unroll
    for (int j0 = 0; j0 < TN; j0 += 4) {
      const int c = col_of<TN>(cg, j0);
      if constexpr (TN >= 4) {
        if (vec && c0 + c + 3 < dout) {
          *reinterpret_cast<float4*>(o + c) =
              make_float4(v[i][j0], v[i][j0 + 1], v[i][j0 + 2], v[i][j0 + 3]);
          continue;
        }
      }
#pragma unroll
      for (int j = j0; j < (TN < j0 + 4 ? TN : j0 + 4); ++j)
        if (c0 + col_of<TN>(cg, j) < dout) o[col_of<TN>(cg, j)] = v[i][j];
    }
  }
}

// Store this thread's tile to 8R resident rows of ld floats in shared
// memory, columns up to dout rounded up to 4 (zeros past dout), so the
// next layer can read them 4 k at a time.
template <int R, int TN>
__device__ __forceinline__ void store_shared(const float (&v)[R][TN], float* h, int ld, int c0,
                                             int dout) {
  const int cg = threadIdx.x & 15;
  const int rg = threadIdx.x >> 4;
  const int dpad = (dout + 3) & ~3;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    float* o = h + (rg + 8 * i) * ld + c0;
    if constexpr (TN >= 4) {
#pragma unroll
      for (int j0 = 0; j0 < TN; j0 += 4) {
        const int c = col_of<TN>(cg, j0);
        if (c0 + c < dpad)
          *reinterpret_cast<float4*>(o + c) =
              make_float4(v[i][j0], v[i][j0 + 1], v[i][j0 + 2], v[i][j0 + 3]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int c = col_of<TN>(cg, j);
        if (c0 + c < dpad) o[c] = v[i][j];
      }
    }
  }
}

// Columns a column group takes in the pass that starts with `remaining`
// columns left: the pass is 16 x TN wide, TN the smallest of 1, 2, 4, 8
// that covers them, at most max_tn.
__host__ __device__ __forceinline__ int pass_tn(int remaining, int max_tn) {
  const int tn = remaining > 64 ? 8 : remaining > 32 ? 4 : remaining > 16 ? 2 : 1;
  return tn < max_tn ? tn : max_tn;
}

}  // namespace tdn

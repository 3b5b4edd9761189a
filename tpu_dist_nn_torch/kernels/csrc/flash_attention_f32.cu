// flash_attention_f32: float32 softmax attention forward and its fused
// backward on TF32 tensor cores with 3xTF32 products, f32 accumulation.
//
// Replaces, for float32 inputs, the Pallas kernels of
// tpu_dist_nn/kernels/flash_attention.py:
//   tdn_flash_fwd_f32 <- _fwd_kernel (:52, pallas_call at :100)
//   tdn_flash_bwd_f32 <- _bwd_dq_kernel (:126, pallas_call at :201) and
//                        _bwd_dkv_kernel (:157, pallas_call at :220), in one kernel
// (bf16 inputs take the wgmma kernels of flash_attention_sm90.cu).
//
// Bound on an H100 SXM at the LM's shape (B 16, H 12, T 1024, Dh 64,
// causal, float32): over the P = T(T+1)/2 causal pairs of each head the
// forward needs 4 P Dh FLOP (25.8 GFLOP) and moves 202 MB, the backward
// 10 P Dh (64.5 GFLOP: S, dP, dV, dK, dQ) and 353 MB, so both are bound by
// operations. A float32-accurate product on this card is either FP32 FFMA
// (67 TFLOP/s: 0.385 and 0.963 ms) or 3xTF32 on the tensor cores (three
// TF32 products at 495 TFLOP/s: 0.156 and 0.391 ms).
//
// 3xTF32: each operand x is split into hi = tf32_rna(x) and lo =
// tf32_rna(x - hi), with cvt.rna.tf32.f32's rounding (to nearest, ties
// away) spelled as an integer add and mask (bit for bit the same, and
// measured faster: tools/torch_flash_f32_variants.py); a product a b is
// taken as a_lo b_hi + a_hi b_lo + a_hi b_hi (mma.sync m16n8k8 .tf32, f32
// accumulators, the small terms first). The dropped a_lo b_lo and lo's
// own rounding are about 2^-22 of |a b| each, the level of float32
// rounding, so the kernels keep the float32 tolerances of their plain
// versions.
//
// What the design does about the bound: every product runs on the
// tensor cores; K/V (forward) and Q/dO/lse/delta (backward) tiles arrive
// through a 2-stage cp.async ring (16-byte copies where every row is
// 16-byte aligned, else 4-byte ones; rows past T and columns past Dh
// zero-filled), the next tile's copy in flight while the current one
// computes; shared rows are padded to Dh + 4 floats, so every fragment
// load is free of bank conflicts. The reduction index of the second
// product is permuted (fragment column c <-> key 2c, c + 4 <-> key 2c + 1
// within each 8), which makes the C fragment of S the A fragment of P as
// it stands: P never leaves registers and needs no shuffle. The split is
// the kernels' main cost beside the MMAs, so each operand is split as few
// times as registers and shared memory allow (below).
//
// Forward: one CTA of 4 warps per (batch*head, fwd_rows query rows);
// each warp owns 32 rows (16 at Dh > 64), two m-tiles that share every K
// and V fragment it splits; 32-key K/V tiles keep three CTAs on an SM at
// Dh 64. The grid runs the longest causal rows first. Per K/V tile: S =
// (Q scale log2 e) K^T, the online softmax on the accumulator fragments
// in the log2 domain (a row lives in the 4 lanes of a quad: two shuffles
// for its max; the sum stays per thread until the end), masks applied
// element by element only on tiles that hold the diagonal or seq_len,
// then O += P V. Epilogue: O / l, lse = (m + log2 l) ln 2.
//
// Backward: one CTA of 4 warps per (batch*head, 64 keys), each warp 16
// keys with dK and dV in registers; K and V, read for every query tile,
// are split once into high and low planes in shared memory. The CTA
// loops over query tiles of bwd_rows rows from the diagonal (causal):
//   S^T = K Q^T and dP^T = V dO^T,
//   P^T = exp2(S^T scale log2 e - lse log2 e), masked to 0,
//   dS^T = P^T (dP^T - delta),
//   dV += P^T dO and dK += dS^T Q (P^T, dS^T: A fragments in registers),
//   dS goes to shared memory, then dQ += dS K by query rows, added into
//   the float32 dq output (zeroed by the wrapper) with float2 atomicAdd
//   (a red.global.add: its result is unused).
// dq therefore sums in an order that changes from run to run.
//
// Contracts kept from the TPU kernels: lse (B, H, T) float32 in natural
// log, keys at or past seq_len masked, causal, the finite -1e30 start of
// the running max with masked probabilities exactly 0, l == 0 -> 1; the
// scale applied to q in the forward and to the scores, dq and dk in the
// backward. q, k and v are read with their strides (the three views of
// the fused qkv projection; the last dimension contiguous); any Dh <= 128,
// zero-padded to a multiple of 8 in shared memory inside a kernel built
// for 32, 64 or 128.
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBlock = 64;          // the backward's keys of a CTA
constexpr int kDsPitch = kBlock + 8;  // the backward's dS tile, [query][key]
constexpr int kChains = 2;          // the backward's accumulator sets for S^T, dP^T and dQ
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Args {
  int B, H, T, Dh, seq_len, causal;
  int q_sb, q_st, q_sh;  // element strides of q (batch, token, head); Dh is contiguous
  int k_sb, k_st, k_sh;
  int v_sb, v_st, v_sh;
  int vec;               // 1: every row of q, k, v (and dO) starts 16-byte aligned
};

// Tiles of a kernel built for head width D (the tiles the Python side
// passes, F32_TILES, must match): the forward's query rows of a CTA (16
// or 32 a warp) and keys of a K/V tile; the backward's keys of a CTA
// (kBlock) and query rows of a Q/dO tile.
__host__ __device__ constexpr int fwd_rows(int D) { return D == 128 ? 64 : 128; }
__host__ __device__ constexpr int fwd_keys(int) { return 32; }
__host__ __device__ constexpr int bwd_rows(int D) { return D == 32 ? 64 : D == 64 ? 32 : 16; }

// ------------------------------------------------------------ cp.async
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

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Copy rows [0, valid_rows) of a (rows, Dh) slab with row stride st
// (elements) into R rows of dst at pitch D + 4; columns [Dh, dpad) and
// rows past valid_rows become 0. Columns from dpad on are never read.
template <int R, int D>
__device__ __forceinline__ void stage_rows(float* dst, const float* src, long long st,
                                           int valid_rows, int Dh, int dpad, bool vec) {
  constexpr int P = D + 4;
  if (vec) {
    constexpr int C = D / 4;  // 16-byte chunks a row
    for (int e = threadIdx.x; e < R * C; e += kThreads) {
      const int r = e / C, c = (e % C) * 4;
      if (c >= dpad) continue;
      const bool ok = r < valid_rows && c < Dh;
      cp_async16(dst + r * P + c, ok ? src + r * st + c : src, ok);
    }
  } else {
    for (int e = threadIdx.x; e < R * D; e += kThreads) {
      const int r = e / D, c = e % D;
      if (c >= dpad) continue;
      const bool ok = r < valid_rows && c < Dh;
      cp_async4(dst + r * P + c, ok ? src + r * st + c : src, ok);
    }
  }
}

// ------------------------------------------------------------- 3xTF32
// cvt.rna.tf32.f32's rounding (to nearest, ties away from zero, the low
// 13 bits cleared), spelled as an integer add and mask: bit for bit the
// same result in two full-rate integer instructions.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// An A fragment of m16n8k8 (rows g, g + 8; columns c, c + 4 in the PTX
// layout), split into TF32 high and low parts.
struct FragA {
  uint32_t hi[4], lo[4];
};
struct FragB {
  uint32_t hi[2], lo[2];
};

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

__device__ __forceinline__ FragA frag_a(float a0, float a1, float a2, float a3) {
  FragA f;
  split(a0, f.hi[0], f.lo[0]);
  split(a1, f.hi[1], f.lo[1]);
  split(a2, f.hi[2], f.lo[2]);
  split(a3, f.hi[3], f.lo[3]);
  return f;
}

__device__ __forceinline__ FragB frag_b(float b0, float b1) {
  FragB f;
  split(b0, f.hi[0], f.lo[0]);
  split(b1, f.hi[1], f.lo[1]);
  return f;
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b in 3xTF32: the two small terms, then hi hi.
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a, const FragB& b) {
  mma(d, a.lo, b.hi);
  mma(d, a.hi, b.lo);
  mma(d, a.hi, b.hi);
}

// A fragment of rows r, r + 8 and reduction columns c .. c + 7 of a
// row-major tile at pitch P (identity order: t and t + 4).
template <int P>
__device__ __forceinline__ FragA load_a(const float* tile, int r, int c, float mul) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const float* p = tile + (r + g) * P + c + t;
  return frag_a(p[0] * mul, p[8 * P] * mul, p[4] * mul, p[8 * P + 4] * mul);
}

// B fragment (k = reduction column c .. c + 7, n = row n0 .. n0 + 7) of
// a row-major tile whose rows are the product's columns (S = X Y^T).
template <int P>
__device__ __forceinline__ FragB load_b_rows(const float* tile, int n0, int c) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const float* p = tile + (n0 + g) * P + c + t;
  return frag_b(p[0], p[4]);
}

// B fragment (k = rows k0 .. k0 + 7 in the permuted order: t <-> 2t,
// t + 4 <-> 2t + 1; n = columns n0 .. n0 + 7) of a row-major tile (O = P V).
template <int P>
__device__ __forceinline__ FragB load_b_perm(const float* tile, int k0, int n0) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const float* p = tile + (k0 + 2 * t) * P + n0 + g;
  return frag_b(p[0], p[P]);
}

// The same two loads from tiles already split into TF32 high and low
// planes (the backward's K and V).
template <int P>
__device__ __forceinline__ FragA load_a_split(const float* hi, const float* lo, int r, int c) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const int o = (r + g) * P + c + t;
  FragA f;
  const int off[4] = {o, o + 8 * P, o + 4, o + 8 * P + 4};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f.hi[i] = __float_as_uint(hi[off[i]]);
    f.lo[i] = __float_as_uint(lo[off[i]]);
  }
  return f;
}

template <int P>
__device__ __forceinline__ FragB load_b_perm_split(const float* hi, const float* lo, int k0,
                                                   int n0) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const int o = (k0 + 2 * t) * P + n0 + g;
  FragB f;
  f.hi[0] = __float_as_uint(hi[o]);
  f.hi[1] = __float_as_uint(hi[o + P]);
  f.lo[0] = __float_as_uint(lo[o]);
  f.lo[1] = __float_as_uint(lo[o + P]);
  return f;
}

// Split columns [0, dpad) of R staged rows (pitch D + 4) in place: the
// high parts stay in hi, the low parts go to lo.
template <int R, int D>
__device__ __forceinline__ void split_rows(float* hi, float* lo, int dpad) {
  constexpr int P = D + 4;
  for (int e = threadIdx.x; e < R * D; e += kThreads) {
    const int r = e / D, c = e % D;
    if (c >= dpad) continue;
    uint32_t h, l;
    split(hi[r * P + c], h, l);
    hi[r * P + c] = __uint_as_float(h);
    lo[r * P + c] = __uint_as_float(l);
  }
}

// The C fragment of a 16 x 8 tile (c0, c1: row g, columns 2t, 2t + 1;
// c2, c3: row g + 8) as the A fragment of the next product over those 8
// columns in the permuted order: a0 = (g, 2t), a1 = (g + 8, 2t), a2 = (g,
// 2t + 1), a3 = (g + 8, 2t + 1). No data moves between lanes.
__device__ __forceinline__ FragA c_as_a(const float (&c)[4]) { return frag_a(c[0], c[2], c[1], c[3]); }

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__host__ __device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

// ----------------------------------------------------------------- forward
template <int D>
__host__ __device__ constexpr int fwd_floats() {
  return (fwd_rows(D) + 4 * fwd_keys(D)) * (D + 4);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
                     Args a, float scale) {
  constexpr int P = D + 4, KB = fwd_keys(D), QB = fwd_rows(D);
  constexpr int MT = QB / (16 * kWarps);  // 16-row m-tiles of a warp
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;             // QB x P
  float* ring = Qs + QB * P;    // stage s: K (KB x P) then V (KB x P)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int BH = a.B * a.H;
  const int q0 = (cdiv(a.T, QB) - 1 - static_cast<int>(blockIdx.x) / BH) * QB;
  const int bh = static_cast<int>(blockIdx.x) % BH, b = bh / a.H, h = bh % a.H;
  const int n_keys = min(a.T, a.seq_len);
  const int k_end = a.causal ? min(n_keys, q0 + QB) : n_keys;
  const int n_tiles = cdiv(k_end, KB);
  const int dpad = (a.Dh + 7) & ~7, nks = dpad / 8;
  const float c = scale * kLog2e;
  const float* kbase = k + (size_t)b * a.k_sb + (size_t)h * a.k_sh;
  const float* vbase = v + (size_t)b * a.v_sb + (size_t)h * a.v_sh;

  stage_rows<QB, D>(Qs, q + (size_t)b * a.q_sb + (size_t)h * a.q_sh + (size_t)q0 * a.q_st,
                    a.q_st, min(QB, a.T - q0), a.Dh, dpad, a.vec);
  stage_rows<KB, D>(ring, kbase, a.k_st, min(KB, a.T), a.Dh, dpad, a.vec);
  stage_rows<KB, D>(ring + KB * P, vbase, a.v_st, min(KB, a.T), a.Dh, dpad, a.vec);
  cp_async_commit();

  const int qr = 16 * MT * warp;  // the warp's first row in the block; m-tile mt at qr + 16 mt
  float acc[MT][D / 8][4];
  float m[MT][2], l[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int n = 0; n < D / 8; ++n) acc[mt][n][0] = acc[mt][n][1] = acc[mt][n][2] = acc[mt][n][3] = 0.0f;
    m[mt][0] = m[mt][1] = kNegInf;
    l[mt][0] = l[mt][1] = 0.0f;
  }

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait_all();
    __syncthreads();  // tile it landed; every warp is done with the stage tile it + 1 overwrites
    if (it + 1 < n_tiles) {
      const int kn = (it + 1) * KB;
      float* st = ring + ((it + 1) & 1) * 2 * KB * P;
      stage_rows<KB, D>(st, kbase + (size_t)kn * a.k_st, a.k_st, min(KB, a.T - kn), a.Dh, dpad,
                        a.vec);
      stage_rows<KB, D>(st + KB * P, vbase + (size_t)kn * a.v_st, a.v_st, min(KB, a.T - kn),
                        a.Dh, dpad, a.vec);
    }
    cp_async_commit();
    const float* Ks = ring + (it & 1) * 2 * KB * P;
    const float* Vs = Ks + KB * P;
    const int k0 = it * KB;

    // S = (Q c) K^T: each K fragment, split once, feeds the warp's MT m-tiles.
    float s[MT][KB / 8][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int n = 0; n < KB / 8; ++n) s[mt][n][0] = s[mt][n][1] = s[mt][n][2] = s[mt][n][3] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < D / 8; ++ks) {
      if (ks < nks) {
        FragA fq[MT];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) fq[mt] = load_a<P>(Qs, qr + 16 * mt, 8 * ks, c);
#pragma unroll
        for (int n = 0; n < KB / 8; ++n) {
          const FragB fk = load_b_rows<P>(Ks, 8 * n, 8 * ks);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) mma3(s[mt][n], fq[mt], fk);
        }
      }
    }

    // Online softmax over this tile, rows qr + 16 mt + g (i = 0) and + 8 (i = 1).
    const bool edge = (a.causal && k0 + KB - 1 > q0) || k0 + KB > n_keys;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      if (edge) {
#pragma unroll
        for (int n = 0; n < KB / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = k0 + 8 * n + 2 * t + (e & 1);
            const int row = q0 + qr + 16 * mt + g + 8 * (e >> 1);
            if (!(key < n_keys && (!a.causal || key <= row))) s[mt][n][e] = kNegInf;
          }
      }
      float mx[2] = {m[mt][0], m[mt][1]};
#pragma unroll
      for (int n = 0; n < KB / 8; ++n) {
        mx[0] = fmaxf(mx[0], fmaxf(s[mt][n][0], s[mt][n][1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[mt][n][2], s[mt][n][3]));
      }
      float alpha[2], rs[2] = {0.0f, 0.0f};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = quad_max(mx[i]);
        alpha[i] = exp2f(m[mt][i] - mx[i]);
        m[mt][i] = mx[i];
      }
#pragma unroll
      for (int n = 0; n < KB / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p =
              (edge && s[mt][n][e] == kNegInf) ? 0.0f : exp2f(s[mt][n][e] - mx[e >> 1]);
          s[mt][n][e] = p;
          rs[e >> 1] += p;
        }
#pragma unroll
      for (int i = 0; i < 2; ++i) l[mt][i] = l[mt][i] * alpha[i] + rs[i];
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        acc[mt][n][0] *= alpha[0];
        acc[mt][n][1] *= alpha[0];
        acc[mt][n][2] *= alpha[1];
        acc[mt][n][3] *= alpha[1];
      }
    }

    // O += P V: P's C fragments are its A fragments over keys 8j .. 8j + 7;
    // each V fragment, split once, feeds the warp's MT m-tiles.
#pragma unroll
    for (int j = 0; j < KB / 8; ++j) {
      FragA fp[MT];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) fp[mt] = c_as_a(s[mt][j]);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        if (n < nks) {
          const FragB fv = load_b_perm<P>(Vs, 8 * j, 8 * n);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) mma3(acc[mt][n], fp[mt], fv);
        }
      }
    }
  }
  cp_async_wait_all();

#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float l_row = quad_sum(l[mt][i]);
      const float l_safe = l_row == 0.0f ? 1.0f : l_row;
      const int r = q0 + qr + 16 * mt + g + 8 * i;
      if (r >= a.T) continue;
      float* row = o + (((size_t)b * a.T + r) * a.H + h) * a.Dh;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const int d = 8 * n + 2 * t;
        if (d < a.Dh) row[d] = acc[mt][n][2 * i] / l_safe;
        if (d + 1 < a.Dh) row[d + 1] = acc[mt][n][2 * i + 1] / l_safe;
      }
      if (t == 0)
        lse[(size_t)bh * a.T + r] =
            m[mt][i] == kNegInf ? kNegInf : (m[mt][i] + log2f(l_safe)) * kLn2;
    }
}

// ---------------------------------------------------------------- backward
// One ring stage: Q and dO (BQ x P each), lse * log2 e and delta (BQ each).
template <int D>
__host__ __device__ constexpr int bwd_stage_floats() { return 2 * bwd_rows(D) * (D + 4) + 2 * bwd_rows(D); }
// K and V with their low planes, the ring, dS.
template <int D>
__host__ __device__ constexpr int bwd_floats() {
  return 4 * kBlock * (D + 4) + 2 * bwd_stage_floats<D>() + bwd_rows(D) * kDsPitch;
}

template <int D>
__device__ __forceinline__ void stage_q_tile(float* st, const float* qbase, const float* obase,
                                             const float* lse_row, const float* delta_row,
                                             const Args& a, int q0, int dpad) {
  constexpr int P = D + 4, BQ = bwd_rows(D);
  const int rows = min(BQ, a.T - q0);
  stage_rows<BQ, D>(st, qbase + (size_t)q0 * a.q_st, a.q_st, rows, a.Dh, dpad, a.vec);
  stage_rows<BQ, D>(st + BQ * P, obase + (size_t)q0 * a.H * a.Dh, (long long)a.H * a.Dh, rows,
                    a.Dh, dpad, a.vec);
  float* rs = st + 2 * BQ * P;
  for (int e = threadIdx.x; e < 2 * BQ; e += kThreads) {
    const int r = e % BQ;
    const float* src = e < BQ ? lse_row : delta_row;
    cp_async4(rs + e, src + q0 + (r < rows ? r : 0), r < rows);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     float* __restrict__ dq, float* __restrict__ dk, float* __restrict__ dv,
                     Args a, float scale) {
  constexpr int P = D + 4, BQ = bwd_rows(D);
  constexpr int kMT = BQ / 16;         // dQ: 16-row m-tiles of a query tile
  constexpr int kNT = D / 8 / (kWarps / kMT);  // dQ: n-tiles of a warp
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;                   // kBlock x P: K, then its TF32 high parts
  float* Kl = Ks + kBlock * P;        // kBlock x P: K's low parts
  float* Vs = Kl + kBlock * P;        // V, then its high parts
  float* Vl = Vs + kBlock * P;        // V's low parts
  float* ring = Vl + kBlock * P;      // 2 stages
  float* dSs = ring + 2 * bwd_stage_floats<D>();  // BQ x kDsPitch, [query][key]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int BH = a.B * a.H;
  const int k0 = static_cast<int>(blockIdx.x) / BH * kBlock;  // the longest causal columns first
  const int bh = static_cast<int>(blockIdx.x) % BH, b = bh / a.H, h = bh % a.H;
  const int n_keys = min(a.T, a.seq_len);
  // Keys at or past seq_len are masked for every query: their dk, dv stay 0.
  const int q_begin = k0 >= n_keys ? a.T : (a.causal ? k0 : 0);
  const int n_qt = cdiv(a.T - q_begin, BQ);
  const int dpad = (a.Dh + 7) & ~7, nks = dpad / 8;
  const float c = scale * kLog2e;
  const float* qbase = q + (size_t)b * a.q_sb + (size_t)h * a.q_sh;
  const float* obase = dout + (size_t)b * a.T * a.H * a.Dh + (size_t)h * a.Dh;
  const float* lse_row = lse + (size_t)bh * a.T;
  const float* delta_row = delta + (size_t)bh * a.T;

  const int rows_k = min(kBlock, a.T - k0);
  stage_rows<kBlock, D>(Ks, k + (size_t)b * a.k_sb + (size_t)h * a.k_sh + (size_t)k0 * a.k_st,
                        a.k_st, rows_k, a.Dh, dpad, a.vec);
  stage_rows<kBlock, D>(Vs, v + (size_t)b * a.v_sb + (size_t)h * a.v_sh + (size_t)k0 * a.v_st,
                        a.v_st, rows_k, a.Dh, dpad, a.vec);
  if (n_qt > 0) stage_q_tile<D>(ring, qbase, obase, lse_row, delta_row, a, q_begin, dpad);
  cp_async_commit();
  // K and V serve every query tile: split them once (the loop's first
  // barrier publishes the planes).
  cp_async_wait_all();
  __syncthreads();
  split_rows<kBlock, D>(Ks, Kl, dpad);
  split_rows<kBlock, D>(Vs, Vl, dpad);

  const int kr = 16 * warp;  // the warp's first key in the block
  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.0f;

  for (int it = 0; it < n_qt; ++it) {
    cp_async_wait_all();
    __syncthreads();  // tile it landed; every warp is done with the stage tile it + 1 overwrites
    const int q0 = q_begin + it * BQ;
    if (it + 1 < n_qt)
      stage_q_tile<D>(ring + ((it + 1) & 1) * bwd_stage_floats<D>(), qbase, obase, lse_row,
                      delta_row, a, q0 + BQ, dpad);
    cp_async_commit();
    const float* Qs = ring + (it & 1) * bwd_stage_floats<D>();
    const float* Os = Qs + BQ * P;
    const float* Ls = Os + BQ * P;
    const float* Dl = Ls + BQ;

    // S^T = K Q^T and dP^T = V dO^T: 16 keys of this warp x BQ queries.
    // Short tiles give few independent accumulators: the k-steps alternate
    // between kChains sets, added at the end.
    float sc[kChains][BQ / 8][4], dp[kChains][BQ / 8][4];
#pragma unroll
    for (int ch = 0; ch < kChains; ++ch)
#pragma unroll
      for (int n = 0; n < BQ / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[ch][n][e] = dp[ch][n][e] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < D / 8; ++ks) {
      if (ks < nks) {
        const FragA fk = load_a_split<P>(Ks, Kl, kr, 8 * ks);
        const FragA fv = load_a_split<P>(Vs, Vl, kr, 8 * ks);
#pragma unroll
        for (int n = 0; n < BQ / 8; ++n) {
          mma3(sc[ks % kChains][n], fk, load_b_rows<P>(Qs, 8 * n, 8 * ks));
          mma3(dp[ks % kChains][n], fv, load_b_rows<P>(Os, 8 * n, 8 * ks));
        }
      }
    }
#pragma unroll
    for (int ch = 1; ch < kChains; ++ch)
#pragma unroll
      for (int n = 0; n < BQ / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sc[0][n][e] += sc[ch][n][e];
          dp[0][n][e] += dp[ch][n][e];
        }

    // P^T and dS^T in place of S^T and dP^T.
    const bool edge = (a.causal && k0 + kBlock - 1 > q0) || k0 + kBlock > n_keys || q0 + BQ > a.T;
#pragma unroll
    for (int n = 0; n < BQ / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = 8 * n + 2 * t + (e & 1);
        float p = exp2f(fmaf(sc[0][n][e], c, -Ls[qc] * kLog2e));
        if (edge) {
          const int key = k0 + kr + g + 8 * (e >> 1), qi = q0 + qc;
          if (!(key < n_keys && qi < a.T && (!a.causal || key <= qi))) p = 0.0f;
        }
        sc[0][n][e] = p;
        dp[0][n][e] = p * (dp[0][n][e] - Dl[qc]);
      }

    // dV += P^T dO, dK += dS^T Q: over the BQ queries in the permuted order.
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
      const FragA fp = c_as_a(sc[0][j]);
      const FragA fs = c_as_a(dp[0][j]);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        if (n < nks) {
          mma3(dv_acc[n], fp, load_b_perm<P>(Os, 8 * j, 8 * n));
          mma3(dk_acc[n], fs, load_b_perm<P>(Qs, 8 * j, 8 * n));
        }
      }
    }

    // dS to shared memory as [query][key], for dQ by query rows.
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dSs[(8 * j + 2 * t + (e & 1)) * kDsPitch + kr + g + 8 * (e >> 1)] = dp[0][j][e];
    __syncthreads();

    // dQ += dS K over the block's 64 keys (permuted order), then into dq.
    const int mt = warp % kMT, n_base = (warp / kMT) * kNT;
    float qacc[kChains][kNT][4];
#pragma unroll
    for (int ch = 0; ch < kChains; ++ch)
#pragma unroll
      for (int n = 0; n < kNT; ++n)
        qacc[ch][n][0] = qacc[ch][n][1] = qacc[ch][n][2] = qacc[ch][n][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < kBlock / 8; ++kk) {
      const float* sa = dSs + (16 * mt + g) * kDsPitch + 8 * kk + 2 * t;
      const float2 x0 = *reinterpret_cast<const float2*>(sa);
      const float2 x1 = *reinterpret_cast<const float2*>(sa + 8 * kDsPitch);
      const FragA fs = frag_a(x0.x, x1.x, x0.y, x1.y);
#pragma unroll
      for (int n = 0; n < kNT; ++n)
        if (n_base + n < nks)
          mma3(qacc[kk % kChains][n], fs,
               load_b_perm_split<P>(Ks, Kl, 8 * kk, 8 * (n_base + n)));
    }
#pragma unroll
    for (int ch = 1; ch < kChains; ++ch)
#pragma unroll
      for (int n = 0; n < kNT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) qacc[0][n][e] += qacc[ch][n][e];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = q0 + 16 * mt + g + 8 * i;
      if (r >= a.T) continue;
      float* row = dq + (((size_t)b * a.T + r) * a.H + h) * a.Dh;
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        const int d = 8 * (n_base + n) + 2 * t;
        const float x = qacc[0][n][2 * i] * scale, y = qacc[0][n][2 * i + 1] * scale;
        if (d + 1 < a.Dh && (a.Dh & 1) == 0) {
          atomicAdd(reinterpret_cast<float2*>(row + d), make_float2(x, y));
        } else {
          if (d < a.Dh) atomicAdd(row + d, x);
          if (d + 1 < a.Dh) atomicAdd(row + d + 1, y);
        }
      }
    }
  }
  cp_async_wait_all();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = k0 + kr + g + 8 * i;
    if (key >= a.T) continue;
    const size_t off = (((size_t)b * a.T + key) * a.H + h) * a.Dh;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = 8 * n + 2 * t + e;
        if (d < a.Dh) {
          dk[off + d] = dk_acc[n][2 * i + e] * scale;
          dv[off + d] = dv_acc[n][2 * i + e];
        }
      }
  }
}

// ------------------------------------------------------------------ host
template <typename K>
int prepare(K kernel, int floats) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, floats * (int)sizeof(float)));
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }
bool stride_ok(int stride, int n) { return n == 1 || stride % 4 == 0; }

// p: B, H, T, Dh, seq_len, causal, the (batch, token, head) element
// strides of q, k and v, then the width the kernel is built for and its
// two tiles (forward: query rows of a CTA, keys of a K/V tile; backward:
// keys of a CTA, query rows of a Q/dO tile). Returns the width, or -1
// when the shape or the tiles are not the kernels'.
int args_from(const int* p, bool backward, Args* a) {
  *a = Args{p[0], p[1], p[2], p[3],  p[4],  p[5],  p[6],  p[7],
            p[8], p[9], p[10], p[11], p[12], p[13], p[14], 0};
  if (a->B < 1 || a->H < 1 || a->T < 1 || a->Dh < 1 || a->Dh > 128 || a->seq_len < 1 ||
      a->seq_len > a->T)
    return -1;
  const int width = a->Dh <= 32 ? 32 : a->Dh <= 64 ? 64 : 128;
  const int tile0 = backward ? kBlock : fwd_rows(width);
  const int tile1 = backward ? bwd_rows(width) : fwd_keys(width);
  if (p[15] != width || p[16] != tile0 || p[17] != tile1) return -1;
  a->vec = a->Dh % 4 == 0 && stride_ok(a->q_sb, a->B) && stride_ok(a->q_st, a->T) &&
           stride_ok(a->q_sh, a->H) && stride_ok(a->k_sb, a->B) && stride_ok(a->k_st, a->T) &&
           stride_ok(a->k_sh, a->H) && stride_ok(a->v_sb, a->B) && stride_ok(a->v_st, a->T) &&
           stride_ok(a->v_sh, a->H);
  return width;
}

template <int D>
int launch_fwd(const Args& a, const float* q, const float* k, const float* v, float* o,
               float* lse, float scale, cudaStream_t s) {
  const int floats = fwd_floats<D>();
  if (int err = prepare(flash_fwd_f32_kernel<D>, floats)) return err;
  const unsigned grid = (unsigned)(a.B * a.H) * cdiv(a.T, fwd_rows(D));
  flash_fwd_f32_kernel<D><<<grid, kThreads, floats * sizeof(float), s>>>(q, k, v, o, lse, a,
                                                                         scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_bwd(const Args& a, const float* q, const float* k, const float* v, const float* dout,
               const float* lse, const float* delta, float* dq, float* dk, float* dv, float scale,
               cudaStream_t s) {
  const int floats = bwd_floats<D>();
  if (int err = prepare(flash_bwd_f32_kernel<D>, floats)) return err;
  const unsigned grid = (unsigned)(a.B * a.H) * cdiv(a.T, kBlock);
  flash_bwd_f32_kernel<D><<<grid, kThreads, floats * sizeof(float), s>>>(
      q, k, v, dout, lse, delta, dq, dk, dv, a, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v: float32 (B, T, H, Dh) views with the strides in p (Dh
// contiguous); o: contiguous float32 (B, T, H, Dh); lse: contiguous (B,
// H, T) float32. Returns a cudaError_t code.
extern "C" int tdn_flash_fwd_f32(const void* q, const void* k, const void* v, void* o, void* lse,
                                 const int* p, float scale, void* stream) {
  Args a;
  const int d = args_from(p, false, &a);
  if (d < 0) return static_cast<int>(cudaErrorInvalidValue);
  a.vec = a.vec && aligned16(q) && aligned16(k) && aligned16(v);
  const float *fq = static_cast<const float*>(q), *fk = static_cast<const float*>(k),
              *fv = static_cast<const float*>(v);
  float *fo = static_cast<float*>(o), *fl = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 32) return launch_fwd<32>(a, fq, fk, fv, fo, fl, scale, s);
  if (d == 64) return launch_fwd<64>(a, fq, fk, fv, fo, fl, scale, s);
  return launch_fwd<128>(a, fq, fk, fv, fo, fl, scale, s);
}

// As tdn_flash_fwd_f32, plus dout: contiguous float32 (B, T, H, Dh);
// lse, delta: contiguous (B, H, T) float32; dq: contiguous float32 (B,
// T, H, Dh), zeroed by the caller (the kernel adds into it); dk, dv:
// contiguous float32 (B, T, H, Dh).
extern "C" int tdn_flash_bwd_f32(const void* q, const void* k, const void* v, const void* dout,
                                 const void* lse, const void* delta, void* dq, void* dk, void* dv,
                                 const int* p, float scale, void* stream) {
  Args a;
  const int d = args_from(p, true, &a);
  if (d < 0) return static_cast<int>(cudaErrorInvalidValue);
  a.vec = a.vec && aligned16(q) && aligned16(k) && aligned16(v) && aligned16(dout);
  const float *fq = static_cast<const float*>(q), *fk = static_cast<const float*>(k),
              *fv = static_cast<const float*>(v), *fo = static_cast<const float*>(dout),
              *fl = static_cast<const float*>(lse), *fd = static_cast<const float*>(delta);
  float *gq = static_cast<float*>(dq), *gk = static_cast<float*>(dk), *gv = static_cast<float*>(dv);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 32) return launch_bwd<32>(a, fq, fk, fv, fo, fl, fd, gq, gk, gv, scale, s);
  if (d == 64) return launch_bwd<64>(a, fq, fk, fv, fo, fl, fd, gq, gk, gv, scale, s);
  return launch_bwd<128>(a, fq, fk, fv, fo, fl, fd, gq, gk, gv, scale, s);
}

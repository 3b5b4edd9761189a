// flash_attention_sm90: bf16 softmax attention forward and its fused
// backward on Hopper tensor cores (wgmma fed by TMA), f32 accumulation.
//
// Replaces, for bf16 inputs, the Pallas kernels of
// tpu_dist_nn/kernels/flash_attention.py:
//   tdn_flash_fwd_sm90 <- _fwd_kernel (:52, pallas_call at :100)
//   tdn_flash_bwd_sm90 <- _bwd_dq_kernel (:126, pallas_call at :201) and
//                         _bwd_dkv_kernel (:157, pallas_call at :220), in one kernel
// float32 inputs take the 3xTF32 kernels of flash_attention_f32.cu.
//
// Bound on an H100 SXM at the LM's shape (B 16, H 12, T 1024, Dh 64,
// causal, bf16): the forward moves 101.5 MB and needs 25.8 GFLOP over
// the T(T+1)/2 causal pairs of each head, so it is bound by bytes (0.0303
// ms at 3.35 TB/s). The backward needs 5 products of 2 FLOP per causal
// pair and head dim (S, dP, dV, dK, dQ: 64.5 GFLOP) and moves 177.7 MB
// (q, k, v, dO, lse, delta in, dq, dk, dv out; 203 MB with the float32
// dq workspace in place of dq), so it is bound by operations (0.0652 ms
// at 989 TFLOP/s bf16).
// What the design does about it: every product runs on bf16 tensor cores
// (wgmma.mma_async, f32 accumulators in registers); tiles arrive by TMA
// into a two-stage ring of 128B- (Dh 64, 128) or 64B-swizzled (Dh 32)
// shared memory, so no thread spends instructions on loads; the (T, T)
// scores never leave registers, and one backward kernel shares S and dP
// between dV, dK and dQ (separate dq and dk/dv kernels recompute both: 7
// products a tile, here 5).
//
// Forward: one CTA per (batch*head, 128 query rows): a producer warp
// issues the TMA loads (Q once, then 128-key K and V tiles into the
// ring, mbarriers for full and empty), two consumer warpgroups own 64
// query rows each. Per key tile: S = Q K^T (m64n128k16, both operands
// K-major in shared memory), the online softmax in registers in the
// log2 domain (scale * log2(e) folded into the scores, exp2f, a row's
// values in the 4 lanes of a quad: 2 shuffles for its max; the sum
// stays per thread until the end), masking element by element only on
// the tiles that hold the diagonal or seq_len, the causal loop stopping
// at the diagonal. P is rounded to bf16 in registers and is wgmma's A
// operand straight from registers for O += P V (the accumulator layout
// of S is the A-register layout); V is MN-major, so B carries the
// transpose bit. Epilogue: O / l in q's type into (B, T, H, Dh), lse =
// (m + log2 l) ln 2.
//
// Backward: one CTA per (batch*head, 128 keys): K and V stay in shared
// memory; the producer streams 64-row Q and dO tiles from the causal
// start, and stages lse * log2(e) and delta beside them with plain loads
// (a (B, H, T) float32 row is 4T bytes apart, which TMA takes only when T
// is a multiple of 4); each consumer warpgroup owns 64 keys:
//   S^T = K Q^T and dP^T = V dO^T (m64n64k16, shared memory operands),
//   P^T = exp2(S^T c - lse) masked, dS^T = P^T (dP^T - delta),
//   dV += P^T dO and dK += dS^T Q (P^T, dS^T bf16 A operands from
//   registers, dO and Q MN-major),
//   dQ += dS K: dS^T goes to shared memory (bf16, 128B swizzle) and is
//   wgmma's A with the transpose bit.
// dq is summed in a fixed order, so a call's dq is the same bits on
// every run of the same inputs (the TPU's _bwd_dq_kernel sums the key
// blocks of a query block in a fixed loop order too). Warpgroup 1 puts
// its 64 x Dh dq partial of the tile into shared memory (two buffers, by
// the tile's parity, handed over with named barriers) and warpgroup 0
// adds it to its own; then warpgroup 0 adds the CTA's partial into a
// float32 (B, T, H, Dh) workspace (float2 red.global.add), which the
// wrapper zeroes first and casts after, in key-block order: a turn
// counter per (batch*head, query tile) lets key block j add only after
// block j - 1 has added. One thread waits for the turn while the tile's
// dQ product runs, and moves it on (a release store after a barrier over
// the adding warpgroup) during the next tile's products, so neither
// latency stalls the warpgroup. Key block j waits only on block j - 1,
// and a CTA takes its (key block, batch*head) from a ticket counter at
// its start (lower key blocks get lower tickets), so the block it waits
// on is running or done: the waits cannot deadlock whatever order the
// grid is dispatched in (tdn::take_ticket). Both counters live in an
// int32 workspace the wrapper zeroes with dq's (one allocation).
//
// Contracts kept from the TPU kernels: o in q's type, lse (B, H, T)
// float32 in natural log, keys at or past seq_len masked, causal, the
// finite -1e30 mask value with masked probabilities exactly 0, l == 0
// -> 1; the scale applied to the scores and to dq and dk. q, k and v are
// read with their strides (the three views of the fused qkv projection)
// through 4-D tensor maps over (Dh, H, T, B); rows past T come back as
// zeros from TMA's out-of-bounds fill and are masked. Head dims 32, 64
// and 128; strides and base addresses must be multiples of 16 bytes (the
// wrapper checks both and raises otherwise). cuTensorMapEncodeTiled is
// looked up through the CUDA runtime at first use, so the library links
// no -lcuda.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kBlock = 128;          // forward: query rows and keys of a tile; backward: keys of a CTA
constexpr int kWgRows = 64;          // rows of one consumer warpgroup; the backward's q tile
constexpr int kStages = 2;           // the ring of K/V (forward) or Q/dO (backward) tiles
constexpr int kConsumerWarps = 8;    // two warpgroups
constexpr int kThreads = 32 * kConsumerWarps + 32;  // + the producer warp
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Sm90Args {
  int B, H, T, seq_len, causal;
  float scale;
};

// ------------------------------------------------------------ PTX helpers
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
// A wait that has not completed after kWaitCycles (about 9 s) traps, so
// a pipeline fault ends the launch with an error instead of hanging the
// card.
constexpr long long kWaitCycles = 1LL << 34;

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  const long long t0 = clock64();
  uint32_t done = 0;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > kWaitCycles) __trap();
  }
}

// One box of a 4-D tensor map (coordinates innermost first) into shared
// memory; completion counts its bytes on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                         int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Pin accumulator registers in program order around the asynchronous
// wgmma (the compiler may not move their reads across this point).
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// Synchronise the 128 threads of one consumer warpgroup (ids 1 and 2; 0
// is __syncthreads).
__device__ __forceinline__ void wg_barrier(int wg) {
  asm volatile("bar.sync %0, 128;" ::"r"(wg + 1) : "memory");
}

// The backward's hand-over of warpgroup 1's dq partial to warpgroup 0:
// barrier ids 3-6 over both consumer warpgroups (256 threads); one side
// arrives, the other waits.
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;" ::"r"(id) : "memory");
}

__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;" ::"r"(id) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// ------------------------------------------------- shared-memory tiles
// A tile of `rows` x D bf16 as TMA writes it: D / kCols slabs, each
// `rows` rows of kRowBytes, 16-byte chunks XOR-swizzled by the row's
// place in an 8-row atom (128B swizzle for Dh 64 and 128, 64B for 32).
template <int D>
struct Tile {
  static constexpr int kCols = D < 64 ? D : 64;
  static constexpr int kRowBytes = 2 * kCols;
  static constexpr int kSlabs = D / kCols;
  static constexpr int kAtomBytes = 8 * kRowBytes;
  static constexpr uint64_t kLayout = kRowBytes == 128 ? 1 : 2;  // wgmma: 1 = 128B, 2 = 64B
  static constexpr int bytes(int rows) { return rows * D * 2; }
};

__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

// K-major operand (rows of the tile are M or N, D is the reduction):
// the 16 columns of k-step kk. `base` is the first row wanted, `slab` the
// tile's slab stride in bytes.
template <int D>
__device__ __forceinline__ uint64_t kmajor(uint32_t base, int kk, uint32_t slab) {
  using L = Tile<D>;
  const int col = 16 * kk;
  return make_desc(base + (col / L::kCols) * slab + (col % L::kCols) * 2, 16, L::kAtomBytes,
                   L::kLayout);
}

// MN-major operand (rows of the tile are the reduction, D is N): the 16
// rows of k-step kk; the slabs of D are `slab` bytes apart.
template <int D>
__device__ __forceinline__ uint64_t mnmajor(uint32_t base, int kk, uint32_t slab) {
  using L = Tile<D>;
  return make_desc(base + 16 * kk * L::kRowBytes, slab, L::kAtomBytes, L::kLayout);
}

// ------------------------------------------------------------- wgmma
// d (m64 x N, f32) += A (m64 x k16) B (k16 x N), bf16. ss: both operands
// from shared memory descriptors, TA / TB the transpose (MN-major) bits;
// rs: A from four registers in the accumulator's layout. acc = 0 zeroes d.
template <int N>
struct Mma;

template <>
struct Mma<32> {
  template <int TA, int TB>
  static __device__ __forceinline__ void ss(float (&d)[16], uint64_t da, uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p, 1, 1, %19, %20;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
  }
  template <int TB>
  static __device__ __forceinline__ void rs(float (&d)[16], const uint32_t* a, uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc), "n"(TB));
  }
};

template <>
struct Mma<64> {
  template <int TA, int TB>
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t da, uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
  }
  template <int TB>
  static __device__ __forceinline__ void rs(float (&d)[32], const uint32_t* a, uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc), "n"(TB));
  }
};

template <>
struct Mma<128> {
  template <int TA, int TB>
  static __device__ __forceinline__ void ss(float (&d)[64], uint64_t da, uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
  }
  template <int TB>
  static __device__ __forceinline__ void rs(float (&d)[64], const uint32_t* a, uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc), "n"(TB));
  }
};

// ------------------------------------------------------------- forward
template <int D>
struct FwdSmem {
  static constexpr int kTile = Tile<D>::bytes(kBlock);
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kTile;                 // kStages tiles
  static constexpr int kV = kK + kStages * kTile;       // kStages tiles
  static constexpr int kBars = kV + kStages * kTile;    // q_full, full[kStages], empty[kStages]
  static constexpr int kBytes = kBars + 8 * (1 + 2 * kStages) + 1024;  // + alignment slack
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v, __nv_bfloat16* __restrict__ o,
                      float* __restrict__ lse, const Sm90Args a) {
  using L = Tile<D>;
  using S = FwdSmem<D>;
  extern __shared__ uint8_t smem_raw[];
  // Swizzled tiles start on 1024-byte boundaries.
  uint8_t* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + S::kBars);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kStages;

  const int BH = a.B * a.H;
  const int n_qb = (a.T + kBlock - 1) / kBlock;
  const int bh = static_cast<int>(blockIdx.x) % BH;
  const int q0 = (n_qb - 1 - static_cast<int>(blockIdx.x) / BH) * kBlock;  // longest rows first
  const int b = bh / a.H, h = bh % a.H;
  const int n_keys = min(a.T, a.seq_len);
  const int k_end = a.causal ? min(n_keys, q0 + kBlock) : n_keys;
  const int n_kt = (k_end + kBlock - 1) / kBlock;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const uint32_t slab = kBlock * L::kRowBytes;
  if (warp == kConsumerWarps) {  // the producer: one thread issues every load
    if (lane == 0) {
      mbar_expect_tx(q_full, S::kTile);
      for (int sl = 0; sl < L::kSlabs; ++sl)
        tma_load(smem + S::kQ + sl * slab, &tm_q, q_full, sl * L::kCols, h, q0, b);
      for (int j = 0; j < n_kt; ++j) {
        const int s = j % kStages;
        mbar_wait(&empty[s], ((j / kStages) & 1) ^ 1);
        mbar_expect_tx(&full[s], 2 * S::kTile);
        for (int sl = 0; sl < L::kSlabs; ++sl) {
          tma_load(smem + S::kK + s * S::kTile + sl * slab, &tm_k, &full[s], sl * L::kCols, h,
                   j * kBlock, b);
          tma_load(smem + S::kV + s * S::kTile + sl * slab, &tm_v, &full[s], sl * L::kCols, h,
                   j * kBlock, b);
        }
      }
    }
    return;
  }

  // A consumer warpgroup: rows qw0 + [0, 64). This thread holds rows r0
  // and r0 + 8 of them, and in every 8 columns the two from cq.
  const int wg = warp / 4;
  const int r0 = 16 * (warp % 4) + lane / 4;
  const int cq = 2 * (lane % 4);
  const int qw0 = q0 + kWgRows * wg;
  const float c = a.scale * kLog2e;
  const uint32_t q_base = smem_u32(smem + S::kQ) + kWgRows * wg * L::kRowBytes;

  float oacc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) oacc[i] = 0.0f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};  // l: this thread's share of the row sum

  mbar_wait(q_full, 0);
  for (int j = 0; j < n_kt; ++j) {
    const int s = j % kStages;
    mbar_wait(&full[s], (j / kStages) & 1);
    const uint32_t k_base = smem_u32(smem + S::kK + s * S::kTile);
    const uint32_t v_base = smem_u32(smem + S::kV + s * S::kTile);

    float sc[kBlock / 2];  // S = Q K^T, 64 x 128
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      Mma<kBlock>::template ss<0, 0>(sc, kmajor<D>(q_base, kk, slab), kmajor<D>(k_base, kk, slab),
                                     kk > 0);
    wg_commit();
    wg_wait_all();
    fence_regs(sc);

    const int k0 = j * kBlock;
    const bool need_mask = k0 + kBlock > n_keys || (a.causal && k0 + kBlock - 1 > qw0);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < kBlock / 2; ++i) {
      float x = sc[i] * c;
      if (need_mask) {
        const int key = k0 + 8 * (i / 4) + cq + i % 2;
        const int qi = qw0 + r0 + 8 * ((i / 2) % 2);
        if (key >= n_keys || (a.causal && key > qi)) x = kNegInf;
      }
      sc[i] = x;
      mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], x);
    }
    float alpha[2], lsum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      mx[rr] = quad_max(mx[rr]);
      alpha[rr] = exp2f(m[rr] - mx[rr]);
      m[rr] = mx[rr];
    }
#pragma unroll
    for (int i = 0; i < kBlock / 2; ++i) {
      // A masked score is exactly kNegInf; its probability is exactly 0,
      // also while every key of the row so far is masked (mx == kNegInf).
      const float p = sc[i] == kNegInf ? 0.0f : exp2f(sc[i] - mx[(i / 2) % 2]);
      lsum[(i / 2) % 2] += p;
      sc[i] = p;
    }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) l[rr] = l[rr] * alpha[rr] + lsum[rr];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) oacc[i] *= alpha[(i / 2) % 2];
    uint32_t pa[kBlock / 4];  // P in bf16: wgmma's A fragments, 4 registers a k-step
#pragma unroll
    for (int i = 0; i < kBlock / 4; ++i) pa[i] = pack_bf16(sc[2 * i], sc[2 * i + 1]);

    fence_regs(oacc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kBlock / 16; ++kk)
      Mma<D>::template rs<1>(oacc, pa + 4 * kk, mnmajor<D>(v_base, kk, slab), 1);
    wg_commit();
    wg_wait_all();
    fence_regs(oacc);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);  // this warp has read K and V of stage s
  }

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const float lt = quad_sum(l[rr]);
    const float l_safe = lt == 0.0f ? 1.0f : lt;
    const float inv = 1.0f / l_safe;
    const int qi = qw0 + r0 + 8 * rr;
    if (qi < a.T) {
      __nv_bfloat16* row = o + ((static_cast<size_t>(b) * a.T + qi) * a.H + h) * D;
#pragma unroll
      for (int jj = 0; jj < D / 8; ++jj)
        *reinterpret_cast<uint32_t*>(row + 8 * jj + cq) =
            pack_bf16(oacc[4 * jj + 2 * rr] * inv, oacc[4 * jj + 2 * rr + 1] * inv);
      if (lane % 4 == 0)
        lse[static_cast<size_t>(bh) * a.T + qi] =
            m[rr] == kNegInf ? kNegInf : (m[rr] + log2f(l_safe)) * kLn2;
    }
  }
}

// ------------------------------------------------------------ backward
template <int D>
struct BwdSmem {
  static constexpr int kKV = Tile<D>::bytes(kBlock);    // K or V: the CTA's 128 keys
  static constexpr int kQT = Tile<D>::bytes(kWgRows);   // a Q or dO tile: 64 rows
  static constexpr int kDsT = kWgRows * kWgRows * 2;    // one warpgroup's dS^T, bf16
  static constexpr int kK = 0;
  static constexpr int kV = kK + kKV;
  static constexpr int kQ = kV + kKV;                   // kStages tiles
  static constexpr int kDO = kQ + kStages * kQT;        // kStages tiles
  static constexpr int kDs = kDO + kStages * kQT;       // 2 warpgroups
  static constexpr int kDqX = kDs + 2 * kDsT;          // warpgroup 1's dq partials: 2 buffers
  static constexpr int kDqXT = kWgRows * D * 4;         // one: 128 threads x D/2 floats
  static constexpr int kRows = kDqX + 2 * kDqXT;        // [kStages][lse * log2(e), delta][64] f32
  static constexpr int kBars = kRows + kStages * 2 * kWgRows * 4;  // kv_full, full[], empty[]
  static constexpr int kBytes = kBars + 8 * (1 + 2 * kStages) + 1024;
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      const __grid_constant__ CUtensorMap tm_do, const float* __restrict__ lse,
                      const float* __restrict__ delta, float* __restrict__ dq_accum,
                      __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                      int* __restrict__ order, const Sm90Args a) {
  using L = Tile<D>;
  using S = BwdSmem<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  float* rows = reinterpret_cast<float*>(smem + S::kRows);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + S::kBars);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kStages;

  __shared__ int ticket;
  if (threadIdx.x == 0) ticket = tdn::take_ticket(order);
  __syncthreads();
  const int BH = a.B * a.H;
  const int bh = ticket % BH;
  const int kb = ticket / BH;  // the key block: the longest causal columns first
  const int k0 = kb * kBlock;
  const int b = bh / a.H, h = bh % a.H;
  const int n_keys = min(a.T, a.seq_len);
  const int n_qt = (a.T + kWgRows - 1) / kWgRows;
  // Keys at or past seq_len are masked for every query: their dk, dv stay 0.
  const int i_begin = k0 >= n_keys ? n_qt : (a.causal ? k0 / kWgRows : 0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  int* turns = order + 1 + static_cast<size_t>(bh) * n_qt;  // one a query tile

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 32);  // the producer's 32 lanes: one expects the bytes, all stage rows
      mbar_init(&empty[s], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const uint32_t kv_slab = kBlock * L::kRowBytes, q_slab = kWgRows * L::kRowBytes;
  if (warp == kConsumerWarps) {  // the producer warp
    if (lane == 0) {
      mbar_expect_tx(kv_full, 2 * S::kKV);
      for (int sl = 0; sl < L::kSlabs; ++sl) {
        tma_load(smem + S::kK + sl * kv_slab, &tm_k, kv_full, sl * L::kCols, h, k0, b);
        tma_load(smem + S::kV + sl * kv_slab, &tm_v, kv_full, sl * L::kCols, h, k0, b);
      }
    }
    for (int i = i_begin, it = 0; i < n_qt; ++i, ++it) {
      const int s = it % kStages;
      mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
      float* st = rows + s * 2 * kWgRows;
      for (int r = lane; r < kWgRows; r += 32) {
        const int qi = i * kWgRows + r;
        const bool in = qi < a.T;
        st[r] = in ? lse[static_cast<size_t>(bh) * a.T + qi] * kLog2e : 0.0f;
        st[kWgRows + r] = in ? delta[static_cast<size_t>(bh) * a.T + qi] : 0.0f;
      }
      if (lane == 0) {
        mbar_expect_tx(&full[s], 2 * S::kQT);
        for (int sl = 0; sl < L::kSlabs; ++sl) {
          tma_load(smem + S::kQ + s * S::kQT + sl * q_slab, &tm_q, &full[s], sl * L::kCols, h,
                   i * kWgRows, b);
          tma_load(smem + S::kDO + s * S::kQT + sl * q_slab, &tm_do, &full[s], sl * L::kCols,
                   h, i * kWgRows, b);
        }
      } else {
        mbar_arrive(&full[s]);
      }
    }
    return;
  }

  // A consumer warpgroup: keys key_lo + [0, 64). This thread holds keys
  // r0 and r0 + 8 of S^T's rows, and in every 8 query columns the two
  // from cq.
  const int wg = warp / 4;
  const int r0 = 16 * (warp % 4) + lane / 4;
  const int cq = 2 * (lane % 4);
  const int key_lo = k0 + kWgRows * wg;
  const float c = a.scale * kLog2e;
  const uint32_t k_base = smem_u32(smem + S::kK) + kWgRows * wg * L::kRowBytes;
  const uint32_t v_base = smem_u32(smem + S::kV) + kWgRows * wg * L::kRowBytes;
  uint8_t* ds_tile = smem + S::kDs + wg * S::kDsT;  // dS^T: 64 keys x 64 queries, 128B swizzle
  const uint32_t ds_base = smem_u32(ds_tile);

  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.0f;

  const int tid = threadIdx.x % 128;  // the thread's place in its warpgroup
  int pending = -1;  // warpgroup 0: the query tile whose turn it has yet to move on
  mbar_wait(kv_full, 0);
  for (int i = i_begin, it = 0; i < n_qt; ++i, ++it) {
    const int s = it % kStages;
    mbar_wait(&full[s], (it / kStages) & 1);
    const int q0 = i * kWgRows;
    // Every pair of a warpgroup's tile masked: no product, no dq contribution.
    const bool skip = key_lo >= n_keys || (a.causal && q0 + kWgRows - 1 < key_lo);
    const int lo1 = k0 + kWgRows;  // warpgroup 1's first key
    const bool skip1 = lo1 >= n_keys || (a.causal && q0 + kWgRows - 1 < lo1);
    float dq[D / 2];  // this warpgroup's share of dQ for the tile: 64 queries x D
    if (!skip) {
      const uint32_t q_base = smem_u32(smem + S::kQ + s * S::kQT);
      const uint32_t do_base = smem_u32(smem + S::kDO + s * S::kQT);
      const float* st = rows + s * 2 * kWgRows;

      float sT[kWgRows / 2], dpT[kWgRows / 2];  // S^T = K Q^T and dP^T = V dO^T, 64 x 64
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        Mma<kWgRows>::template ss<0, 0>(sT, kmajor<D>(k_base, kk, kv_slab),
                                        kmajor<D>(q_base, kk, q_slab), kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        Mma<kWgRows>::template ss<0, 0>(dpT, kmajor<D>(v_base, kk, kv_slab),
                                        kmajor<D>(do_base, kk, q_slab), kk > 0);
      wg_commit();
      wg_wait_all();
      fence_regs(sT);
      fence_regs(dpT);

      const bool need_mask = key_lo + kWgRows > n_keys || q0 + kWgRows > a.T ||
                             (a.causal && key_lo + kWgRows - 1 > q0);
#pragma unroll
      for (int jj = 0; jj < kWgRows / 8; ++jj) {
        const float2 l2 = *reinterpret_cast<const float2*>(st + 8 * jj + cq);
        const float2 dl = *reinterpret_cast<const float2*>(st + kWgRows + 8 * jj + cq);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int idx = 4 * jj + e;
          float p = exp2f(sT[idx] * c - (e % 2 ? l2.y : l2.x));
          if (need_mask) {
            const int key = key_lo + r0 + 8 * (e / 2);
            const int qi = q0 + 8 * jj + cq + e % 2;
            if (key >= n_keys || qi >= a.T || (a.causal && key > qi)) p = 0.0f;
          }
          sT[idx] = p;
          dpT[idx] = p * (dpT[idx] - (e % 2 ? dl.y : dl.x));  // dS^T
        }
      }
      uint32_t pa[kWgRows / 4], da[kWgRows / 4];  // P^T and dS^T in bf16, A fragments
#pragma unroll
      for (int x = 0; x < kWgRows / 4; ++x) {
        pa[x] = pack_bf16(sT[2 * x], sT[2 * x + 1]);
        da[x] = pack_bf16(dpT[2 * x], dpT[2 * x + 1]);
      }

      fence_regs(dv_acc);
      fence_regs(dk_acc);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < kWgRows / 16; ++kk)
        Mma<D>::template rs<1>(dv_acc, pa + 4 * kk, mnmajor<D>(do_base, kk, q_slab), 1);
#pragma unroll
      for (int kk = 0; kk < kWgRows / 16; ++kk)
        Mma<D>::template rs<1>(dk_acc, da + 4 * kk, mnmajor<D>(q_base, kk, q_slab), 1);
      wg_commit();

      // dS^T to shared memory, 128B-swizzled as TMA would have written it,
      // for dQ = dS K with dS^T as an MN-major A operand.
      wg_barrier(wg);  // every warp's previous dQ product has read the tile
      // ... and has added it: the previous tile's turn moves on.
      if (wg == 0 && tid == 0 && pending >= 0) tdn::store_release(turns + pending, kb + 1);
      pending = -1;
#pragma unroll
      for (int kk = 0; kk < kWgRows / 16; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int chunk = 2 * kk + e / 2;
          const int row = r0 + 8 * (e % 2);
          *reinterpret_cast<uint32_t*>(ds_tile + row * 128 + ((chunk ^ (row % 8)) * 16) +
                                       cq * 2) = da[4 * kk + e];
        }
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      wg_barrier(wg);

      wg_fence();
#pragma unroll
      for (int kk = 0; kk < kWgRows / 16; ++kk)
        Mma<D>::template ss<1, 1>(dq, make_desc(ds_base + 16 * kk * 128, kWgRows * 128, 1024, 1),
                                  mnmajor<D>(k_base, kk, kv_slab), kk > 0);
      wg_commit();
      if (wg == 0 && tid == 0) tdn::wait_turn(turns + i, kb);  // beside the dQ product
      __syncwarp();
      wg_wait_all();
      fence_regs(dv_acc);
      fence_regs(dk_acc);
      fence_regs(dq);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);  // Q and dO of stage s are read
    } else {
#pragma unroll
      for (int x = 0; x < D / 2; ++x) dq[x] = 0.0f;
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
      if (wg == 0) {
        wg_barrier(0);
        if (tid == 0) {
          if (pending >= 0) tdn::store_release(turns + pending, kb + 1);
          tdn::wait_turn(turns + i, kb);
        }
        pending = -1;
      }
    }

    // The tile's dq, in a fixed order: warpgroup 0's partial plus
    // warpgroup 1's (thread t of each holds the same elements), then into
    // the workspace after key block kb - 1 (see the header).
    float* xbuf = reinterpret_cast<float*>(smem + S::kDqX + (it & 1) * S::kDqXT);
    if (wg == 1) {
      if (it >= 2) named_sync(5 + (it & 1));  // warpgroup 0 has read this buffer
      if (!skip) {
#pragma unroll
        for (int x = 0; x < D / 2; ++x) xbuf[x * 128 + tid] = dq[x];
      }
      named_arrive(3 + (it & 1));
      continue;
    }
    named_sync(3 + (it & 1));
    if (!skip1) {
#pragma unroll
      for (int x = 0; x < D / 2; ++x) dq[x] += xbuf[x * 128 + tid];
    }
    if (i + 2 < n_qt) named_arrive(5 + (it & 1));
    // The hand-over's barrier also ordered these adds after thread 0's
    // wait for the turn.
    if (!(skip && skip1)) {
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int qi = q0 + r0 + 8 * rr;
        if (qi < a.T) {
          float* row = dq_accum + ((static_cast<size_t>(b) * a.T + qi) * a.H + h) * D;
#pragma unroll
          for (int jj = 0; jj < D / 8; ++jj)
            atomicAdd(reinterpret_cast<float2*>(row + 8 * jj + cq),
                      make_float2(dq[4 * jj + 2 * rr] * a.scale, dq[4 * jj + 2 * rr + 1] * a.scale));
        }
      }
    }
    pending = i;  // its turn moves on after a barrier in the next tile
  }
  if (wg == 0) {
    wg_barrier(0);
    if (tid == 0 && pending >= 0) tdn::store_release(turns + pending, kb + 1);
  }

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int key = key_lo + r0 + 8 * rr;
    if (key < a.T) {
      const size_t off = ((static_cast<size_t>(b) * a.T + key) * a.H + h) * D;
#pragma unroll
      for (int jj = 0; jj < D / 8; ++jj) {
        *reinterpret_cast<uint32_t*>(dk + off + 8 * jj + cq) =
            pack_bf16(dk_acc[4 * jj + 2 * rr] * a.scale, dk_acc[4 * jj + 2 * rr + 1] * a.scale);
        *reinterpret_cast<uint32_t*>(dv + off + 8 * jj + cq) =
            pack_bf16(dv_acc[4 * jj + 2 * rr], dv_acc[4 * jj + 2 * rr + 1]);
      }
    }
  }
}

// --------------------------------------------------------------- host
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &found);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 4-D map over a (B, T, H, D) bf16 view with element strides st =
// (batch, token, head), read in boxes of `rows` tokens x Tile<D>::kCols
// columns of one head; rows past T read as zeros.
template <int D>
int make_map(CUtensorMap* map, const void* base, const Sm90Args& a, const long long* st,
             int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(a.H),
                              static_cast<cuuint64_t>(a.T), static_cast<cuuint64_t>(a.B)};
  const cuuint64_t bytes[3] = {static_cast<cuuint64_t>(st[2]) * 2,
                               static_cast<cuuint64_t>(st[1]) * 2,
                               static_cast<cuuint64_t>(st[0]) * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(Tile<D>::kCols), 1,
                             static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, bytes, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE,
      Tile<D>::kRowBytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

template <int D>
int launch_fwd(const Sm90Args& a, const long long* st, const void* q, const void* k,
               const void* v, void* o, float* lse, cudaStream_t s) {
  CUtensorMap mq, mk, mv;
  if (int e = make_map<D>(&mq, q, a, st, kBlock)) return e;
  if (int e = make_map<D>(&mk, k, a, st + 3, kBlock)) return e;
  if (int e = make_map<D>(&mv, v, a, st + 6, kBlock)) return e;
  const int bytes = FwdSmem<D>::kBytes;
  if (cudaError_t e = cudaFuncSetAttribute(flash_fwd_sm90_kernel<D>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, bytes))
    return static_cast<int>(e);
  const unsigned grid = static_cast<unsigned>(a.B * a.H) * ((a.T + kBlock - 1) / kBlock);
  flash_fwd_sm90_kernel<D><<<grid, kThreads, bytes, s>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), lse, a);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_bwd(const Sm90Args& a, const long long* st, const void* q, const void* k,
               const void* v, const void* dout, const float* lse, const float* delta,
               float* dq_accum, void* dk, void* dv, int* order, cudaStream_t s) {
  CUtensorMap mq, mk, mv, mdo;
  if (int e = make_map<D>(&mq, q, a, st, kWgRows)) return e;
  if (int e = make_map<D>(&mk, k, a, st + 3, kBlock)) return e;
  if (int e = make_map<D>(&mv, v, a, st + 6, kBlock)) return e;
  if (int e = make_map<D>(&mdo, dout, a, st + 9, kWgRows)) return e;
  const int bytes = BwdSmem<D>::kBytes;
  if (cudaError_t e = cudaFuncSetAttribute(flash_bwd_sm90_kernel<D>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, bytes))
    return static_cast<int>(e);
  const unsigned grid = static_cast<unsigned>(a.B * a.H) * ((a.T + kBlock - 1) / kBlock);
  flash_bwd_sm90_kernel<D><<<grid, kThreads, bytes, s>>>(
      mq, mk, mv, mdo, lse, delta, dq_accum, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), order, a);
  return static_cast<int>(cudaGetLastError());
}

// p: B, H, T, Dh, seq_len, causal, the tile rows and warpgroup rows the
// wrapper assumes (kBlock, kWgRows), then the (batch, token, head)
// element strides of q, k, v and dO. Returns Dh, or -1 when the call is
// outside the kernels' range.
int args_from(const long long* p, float scale, Sm90Args* a) {
  if (p[6] != kBlock || p[7] != kWgRows) return -1;
  *a = Sm90Args{static_cast<int>(p[0]), static_cast<int>(p[1]), static_cast<int>(p[2]),
                static_cast<int>(p[4]), static_cast<int>(p[5]), scale};
  if (a->B < 1 || a->H < 1 || a->T < 1 || a->seq_len < 1 || a->seq_len > a->T) return -1;
  return static_cast<int>(p[3]);
}

}  // namespace

// q, k, v: bf16 (B, T, H, Dh) views with the strides in p (Dh contiguous;
// strides and addresses multiples of 16 bytes). o: contiguous (B, T, H,
// Dh) bf16; lse: contiguous (B, H, T) float32. Returns a cudaError_t code.
extern "C" int tdn_flash_fwd_sm90(const void* q, const void* k, const void* v, void* o,
                                  void* lse, const long long* p, float scale, void* stream) {
  Sm90Args a;
  const int d = args_from(p, scale, &a);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  const long long* st = p + 8;
  switch (d) {
    case 32: return launch_fwd<32>(a, st, q, k, v, o, l, s);
    case 64: return launch_fwd<64>(a, st, q, k, v, o, l, s);
    case 128: return launch_fwd<128>(a, st, q, k, v, o, l, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// As tdn_flash_fwd_sm90, plus dout: bf16 (B, T, H, Dh) (strides in p);
// lse, delta: contiguous (B, H, T) float32; dq_accum: zeroed contiguous
// (B, T, H, Dh) float32, to which dq is added; dk, dv: contiguous (B, T,
// H, Dh) bf16; order: zeroed int32, 1 + B * H * ceil(T / 64) of them (the
// ticket and the turn counters).
extern "C" int tdn_flash_bwd_sm90(const void* q, const void* k, const void* v, const void* dout,
                                  const void* lse, const void* delta, void* dq_accum, void* dk,
                                  void* dv, void* order, const long long* p, float scale,
                                  void* stream) {
  Sm90Args a;
  const int d = args_from(p, scale, &a);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  float* dqa = static_cast<float*>(dq_accum);
  int* ord = static_cast<int*>(order);
  const long long* st = p + 8;
  switch (d) {
    case 32: return launch_bwd<32>(a, st, q, k, v, dout, l, dl, dqa, dk, dv, ord, s);
    case 64: return launch_bwd<64>(a, st, q, k, v, dout, l, dl, dqa, dk, dv, ord, s);
    case 128: return launch_bwd<128>(a, st, q, k, v, dout, l, dl, dqa, dk, dv, ord, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

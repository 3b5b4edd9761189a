// conv2d: maxpool?(act(conv2d(x, w) + b)) in one kernel, f32.
//
// Replaces the Pallas kernel tpu_dist_nn/kernels/conv2d.py::_conv_kernel
// (pallas_call at conv2d.py:257). That kernel computes a stride-1 VALID
// conv as kh*kw tap GEMMs over a VMEM-resident batch tile (SAME by a
// padded copy made in XLA), applies bias and activation and an optional
// max-pool, and writes only the pooled tile: the pre-pool activation
// never reaches HBM. Strided convs and stages whose lane-padded tile
// overflows VMEM (the 32x32x3 input stage) fall back to XLA there.
//
// Bound on an H100: at the CIFAR conv+MLP shapes and batch 1024 both
// stages are bound by FP32 operations (0.869 and 2.219 GFLOP, counting
// only the taps that land inside the image, against 29.4 and 25.2 MB
// of input read and pooled output written; 13.0 and 33.1 us at
// 67 TFLOP/s on CUDA cores). Without the fusion the pre-pool
// activations would add 67 and 34 MB of writes and reads.
//
// Design: an implicit GEMM on CUDA cores, every FMA in FP32 (no TF32).
// M is the conv pixels of a CTA's tile, N its output channels, K =
// kh * kw * Cin. A CTA owns a 2-D tile of conv rows x columns that
// covers whole pool windows (several whole images when one image is
// smaller than the tile) and 16 * CG output channels. K streams in
// slices of CK input channels: a slice of the im2col operand is staged
// as its compact form, the tile's input rows with their halo and CK
// channels (the "patch"), gathered by cp.async with SAME padding and
// image edges zero-filled on load, so no padded or im2col copy exists
// in device memory; the slice's weights (kh * kw * CK x 16CG) land
// beside it. With more than one slice the two form a 2-slot ring: the
// next slice's copies are in flight while this one's FMAs run; the
// gather takes a pixel a thread and divides by multiplying with
// reciprocals (small_div). Each thread keeps a 4-pixel x 16-channel
// register tile: per input channel of a tap it reads its 4 pixels'
// values (a warp's lanes read 32 pixels in 32 banks, pixel_slot) and 16
// weights with four 128-bit loads every lane of the warp shares (one
// channel group a warp), then does 64 FMAs. Those 20 floats per 64 FMAs
// are more than shared memory delivers per FMA issued (32 floats a clock
// against 128 FMAs an SM), so shared-memory bandwidth, not the FMA
// units, sets the loop's pace; a larger tile needs more registers than
// two CTAs an SM leave (PERF.md, tools/torch_conv_variants.py).
// The epilogue adds the bias into a conv tile in shared memory (the
// ring's space) and, in one branch on the activation, applies it while
// max-pooling each window (VALID, floor, -inf start) and writes the
// pooled values, channels fastest, a warp a pooled pixel. Softmax runs
// over each pixel's channels first (the CTA then holds every channel).
// The main path's 2x2 stride-2 pool of relu skips the conv tile: a
// window's two rows are in one thread's registers and its two columns
// in neighbour lanes, and max, bias and relu commute exactly for finite
// values; a NaN in a window comes out NaN in either order (the max and
// the relu keep NaN, common.cuh) (pool_regs_store). With overlapping windows (window > stride) the
// conv pixels two tiles share are computed by both. Tile, slice and
// shared-memory layout are chosen by the Python wrapper
// (kernels/conv2d.py::conv_plan), which passes the offsets; this file
// refuses a size over 227 KB.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPix = 4;     // conv pixels a thread computes
constexpr int kChan = 16;   // output channels a thread computes
constexpr int kSmemLimit = 232448;

struct ConvArgs {
  int B, H, W, cin;          // input, NHWC
  int kh, kw, cout;          // weights, HWIO
  int sh, sw, pad_t, pad_l;  // conv stride and leading padding
  int pwh, pww, psh, psw;    // pool window and stride (1 x 1 without a pool)
  int ph, pw;                // pooled output rows and columns
  int act;                   // activation id (common.cuh)
  int cg;                    // channel groups of kChan a CTA computes (1, 2, 4, 8)
  int imgs, tpr, tpc;        // a tile: images, pooled rows, pooled columns
  int cr, ccw;               // conv rows and columns of a tile
  int ck;                    // input channels per K slice
  int cs, prs, pimg;         // patch strides in floats: pixel (ck | 1), row, image
  int prow, pcol;            // patch rows and columns of one image
  int patch_floats;          // floats of a slot's patch (a multiple of 4)
  int stage_floats;          // floats of a slot: patch, then weights
  int ldt;                   // conv-tile pixel stride in floats (odd)
  int tiles_y, tiles_x, ctiles;  // row tiles, column tiles, channel tiles
  int pool_regs;             // 1: a 2x2/2 pool of relu or linear values in registers
  int smem_bytes;
};
constexpr int kArgs = 38;

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Where tile t starts: its first image, pooled row and column, and
// channel; the input row and column its patch starts at (padding makes
// them negative at the top and left edges).
struct TileOrigin {
  int b0, py0, px0, c0, iy0, ix0;
};

__device__ __forceinline__ TileOrigin tile_origin(const ConvArgs& a, int t) {
  TileOrigin o;
  const int ct = t % a.ctiles;
  t /= a.ctiles;
  const int tx = t % a.tiles_x;
  t /= a.tiles_x;
  const int ty = t % a.tiles_y;
  o.b0 = t / a.tiles_y * a.imgs;
  o.c0 = ct * kChan * a.cg;
  o.py0 = ty * a.tpr;
  o.px0 = tx * a.tpc;
  o.iy0 = o.py0 * a.psh * a.sh - a.pad_t;
  o.ix0 = o.px0 * a.psw * a.sw - a.pad_l;
  return o;
}

// Which of the tile's pixels (image, row, column order) a thread's p-th
// pixel is. A warp takes 32 * kPix of them; at each p its 32 lanes read
// 32 pixels whose patch offsets fall in 32 banks (the planner's patch
// strides). With a register pool on a 16-column tile a thread holds both
// rows of its windows: lanes l and l + 16 take rows 2 apart, each p and
// p + 1 the two rows of one window; otherwise the lanes take 32
// consecutive pixels and p the next 32.
__device__ __forceinline__ int pixel_slot(const ConvArgs& a, int pwi, int lane, int p) {
  if (a.pool_regs && a.ccw == 16)
    return pwi * 32 * kPix + (2 * (2 * (p >> 1) + (lane >> 4)) + (p & 1)) * 16 + (lane & 15);
  return pwi * 32 * kPix + lane + 32 * p;
}

// n / d for 0 <= n < 2^22 by one multiply by inv = 1 / d: (n + 0.5) / d
// lies at least 0.5 / d from an integer, and the two roundings move the
// product by under (n + 0.5) / d * 2^-23 < 0.5 / d. Integer division by
// a runtime value costs some twenty instructions; a CTA's gather does
// thousands.
__device__ __forceinline__ int small_div(int n, float inv) {
  return __float2int_rz((static_cast<float>(n) + 0.5f) * inv);
}

// Stage K slice `s` (input channels s*ck ..) of a tile into a slot: the
// patch of every image of the tile, a thread a pixel of it, zero outside
// the image and past cin; and the weights (kh*kw*ck rows of 16cg
// channels), zero past cin and cout.
__device__ __forceinline__ void load_slice(float* slot, const float* __restrict__ x,
                                           const float* __restrict__ w, const ConvArgs& a,
                                           const TileOrigin& o, int s) {
  const int b0 = o.b0, iy0 = o.iy0, ix0 = o.ix0, c0 = o.c0;
  const int k0 = s * a.ck;
  const int kn = min(a.ck, a.cin - k0);  // input channels this slice holds; zero past them
  const float inv_pcol = 1.0f / a.pcol, inv_prow = 1.0f / a.prow;
  for (int pix = threadIdx.x; pix < a.imgs * a.prow * a.pcol; pix += kThreads) {
    const int row = small_div(pix, inv_pcol);
    const int c = pix - row * a.pcol;
    const int img = small_div(row, inv_prow);
    const int r = row - img * a.prow;
    const int b = b0 + img, iy = iy0 + r, ix = ix0 + c;
    const bool in = b < a.B && iy >= 0 && iy < a.H && ix >= 0 && ix < a.W;
    const float* src = in ? x + (((size_t)b * a.H + iy) * a.W + ix) * a.cin + k0 : x;
    float* dst = slot + img * a.pimg + r * a.prs + c * a.cs;
    for (int ci = 0; ci < a.ck; ++ci) {
      const bool ok = in && ci < kn;
      cp_async4(dst + ci, ok ? src + ci : x, ok);
    }
  }
  const int nct = kChan * a.cg;
  float* ws = slot + a.patch_floats;
  const int rows = a.kh * a.kw * a.ck;
  const float inv_ck = 1.0f / a.ck;
  if (a.cout % 4 == 0 && (reinterpret_cast<uintptr_t>(w) & 15) == 0) {
    const int q = nct / 4;  // 16-byte chunks a row: a power of 2
    const int qs = __ffs(q) - 1;
    for (int e = threadIdx.x; e < rows * q; e += kThreads) {
      const int row = e >> qs, n = 4 * (e & (q - 1));
      const int tap = small_div(row, inv_ck), ci = row - tap * a.ck;
      const bool ok = ci < kn && c0 + n < a.cout;
      cp_async16(ws + row * nct + n,
                 ok ? w + ((size_t)tap * a.cin + k0 + ci) * a.cout + c0 + n : w, ok);
    }
  } else {
    const int ns = __ffs(nct) - 1;  // nct is a power of 2
    for (int e = threadIdx.x; e < rows * nct; e += kThreads) {
      const int row = e >> ns, n = e & (nct - 1);
      const int tap = small_div(row, inv_ck), ci = row - tap * a.ck;
      const bool ok = ci < kn && c0 + n < a.cout;
      cp_async4(ws + e, ok ? w + ((size_t)tap * a.cin + k0 + ci) * a.cout + c0 + n : w, ok);
    }
  }
}

// The pooled values of the tile from the conv tile, with the activation
// applied to each conv value (f). VALID windows, floor, -inf start.
template <typename F>
__device__ __forceinline__ void pool_store(const float* tile, float* __restrict__ out,
                                           const ConvArgs& a, int b0, int py0, int px0, int c0,
                                           int nct, F f) {
  const int nc = min(nct, a.cout - c0);
  const int npr = min(a.tpr, a.ph - py0), npc = min(a.tpc, a.pw - px0);
  const int per_img = npr * npc;
  const int lane = threadIdx.x & 31;
  for (int t = threadIdx.x >> 5; t < a.imgs * per_img; t += kWarps) {  // a warp a pooled pixel
    const int img = t / per_img;
    const int rem = t - img * per_img;
    const int pr = rem / npc, pc = rem - pr * npc;
    if (b0 + img >= a.B) break;
    const float* base = tile + ((img * a.cr + pr * a.psh) * a.ccw + pc * a.psw) * a.ldt;
    float* o = out + (((size_t)(b0 + img) * a.ph + py0 + pr) * a.pw + px0 + pc) * a.cout + c0;
    for (int n = lane; n < nc; n += 32) {
      float m = -INFINITY;
      for (int i = 0; i < a.pwh; ++i)
        for (int j = 0; j < a.pww; ++j) m = tdn::max_nan(m, f(base[(i * a.ccw + j) * a.ldt + n]));
      o[n] = m;
    }
  }
}

// The 2x2 stride-2 pool of relu or linear values, in registers: a
// thread holds both rows of its windows (its pixels p and p + 1, see
// pixel_slot), lanes l and l ^ 1 the two columns. The window max of the
// sums is taken first: adding the bias and relu are monotonic, so they
// commute with max exactly for finite values; a NaN in the window gives
// NaN either way, since max_nan and relu_nan keep it. The lane holding the window's top-left pixel
// stores its 16 channels.
__device__ __forceinline__ void pool_regs_store(float (&acc)[kPix][kChan], const float (&bv)[kChan],
                                                float* __restrict__ out, const ConvArgs& a, int b0,
                                                int py0, int px0, int c, int pwi, int lane) {
  const int per_img = a.cr * a.ccw;
  const int npr = min(a.tpr, a.ph - py0), npc = min(a.tpc, a.pw - px0);
  const bool vec = a.cout % 4 == 0 && c + kChan <= a.cout;
#pragma unroll
  for (int p = 0; p < kPix; p += 2) {
    float y[kChan];
#pragma unroll
    for (int jj = 0; jj < kChan; ++jj) {
      const float v = tdn::max_nan(acc[p][jj], acc[p + 1][jj]);
      y[jj] = tdn::max_nan(v, __shfl_xor_sync(0xffffffffu, v, 1)) + bv[jj];
      if (a.act == tdn::RELU) y[jj] = tdn::relu_nan(y[jj]);
    }
    const int m = pixel_slot(a, pwi, lane, p);
    const int img = m / per_img;
    const int rem = m - img * per_img;
    const int cy = rem / a.ccw, cx = rem - cy * a.ccw;
    if ((cx & 1) || img >= a.imgs || b0 + img >= a.B || cy / 2 >= npr || cx / 2 >= npc) continue;
    float* o = out + (((size_t)(b0 + img) * a.ph + py0 + cy / 2) * a.pw + px0 + cx / 2) * a.cout + c;
    if (vec) {
#pragma unroll
      for (int q = 0; q < kChan / 4; ++q)
        reinterpret_cast<float4*>(o)[q] = make_float4(y[4 * q], y[4 * q + 1], y[4 * q + 2], y[4 * q + 3]);
    } else {
#pragma unroll
      for (int jj = 0; jj < kChan; ++jj)
        if (c + jj < a.cout) o[jj] = y[jj];
    }
  }
}

// The tile's epilogue: bias, activation and pool, into the output.
__device__ __forceinline__ void epilogue(float (&acc)[kPix][kChan], float* smem,
                                         const float* __restrict__ bias, float* __restrict__ out,
                                         const ConvArgs& a, const TileOrigin& o, int cgi, int pwi,
                                         int lane) {
  const int tid = threadIdx.x;
  const int nct = kChan * a.cg;
  const int per_img = a.cr * a.ccw;
  const int b0 = o.b0, py0 = o.py0, px0 = o.px0, c0 = o.c0;
  float bv[kChan];
#pragma unroll
  for (int jj = 0; jj < kChan; ++jj) {
    const int c = c0 + cgi * kChan + jj;
    bv[jj] = c < a.cout ? bias[c] : 0.0f;
  }
  if (a.pool_regs) {
    pool_regs_store(acc, bv, out, a, b0, py0, px0, c0 + cgi * kChan, pwi, lane);
    return;
  }

  // z + bias into the conv tile: pixel m, channel n at m * ldt + n.
  float* tile = smem;
#pragma unroll
  for (int p = 0; p < kPix; ++p) {
    float* t = tile + pixel_slot(a, pwi, lane, p) * a.ldt + cgi * kChan;
#pragma unroll
    for (int jj = 0; jj < kChan; ++jj) t[jj] = acc[p][jj] + bv[jj];
  }
  __syncthreads();

  switch (a.act) {
    case tdn::RELU:
      pool_store(tile, out, a, b0, py0, px0, c0, nct, [](float z) { return tdn::relu_nan(z); });
      break;
    case tdn::SIGMOID:
      pool_store(tile, out, a, b0, py0, px0, c0, nct,
                 [](float z) { return tdn::act_elem(z, tdn::SIGMOID); });
      break;
    case tdn::TANH:
      pool_store(tile, out, a, b0, py0, px0, c0, nct, [](float z) { return tanhf(z); });
      break;
    case tdn::GELU:
      pool_store(tile, out, a, b0, py0, px0, c0, nct,
                 [](float z) { return tdn::act_elem(z, tdn::GELU); });
      break;
    case tdn::SOFTMAX:
      // Over each conv pixel's channels (the CTA holds all of them).
      for (int m = tid; m < a.imgs * per_img; m += kThreads) {
        float* row = tile + m * a.ldt;
        float mx = -INFINITY;
        for (int c = 0; c < a.cout; ++c) mx = fmaxf(mx, row[c]);
        float sum = 0.0f;
        for (int c = 0; c < a.cout; ++c) {
          const float e = expf(row[c] - mx);
          row[c] = e;
          sum += e;
        }
        for (int c = 0; c < a.cout; ++c) row[c] = row[c] / sum;
      }
      __syncthreads();
      pool_store(tile, out, a, b0, py0, px0, c0, nct, [](float z) { return z; });
      break;
    default:
      pool_store(tile, out, a, b0, py0, px0, c0, nct, [](float z) { return z; });
      break;
  }
}

__global__ void __launch_bounds__(kThreads, 2)
conv_kernel(const float* __restrict__ x, const float* __restrict__ w,
            const float* __restrict__ bias, float* __restrict__ out, ConvArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int cgi = warp % a.cg;  // this warp's channel group
  const int pwi = warp / a.cg;  // its block of 32 * kPix pixels
  const int nct = kChan * a.cg;

  // This thread's pixels (pixel_slot). Pixels past the tile compute from
  // pixel 0 and are never stored.
  const int per_img = a.cr * a.ccw;
  int poff[kPix];
#pragma unroll
  for (int p = 0; p < kPix; ++p) {
    int m = pixel_slot(a, pwi, lane, p);
    if (m >= a.imgs * per_img) m = 0;
    const int img = m / per_img;
    const int rem = m - img * per_img;
    const int cy = rem / a.ccw, cx = rem - cy * a.ccw;
    poff[p] = img * a.pimg + cy * a.sh * a.prs + cx * a.sw * a.cs;
  }

  // One tile a CTA; its K slices stream through a 2-slot ring, slice
  // s + 1 landing while slice s multiplies.
  const TileOrigin o = tile_origin(a, blockIdx.x);
  const int slices = (a.cin + a.ck - 1) / a.ck;
  float acc[kPix][kChan];
#pragma unroll
  for (int p = 0; p < kPix; ++p)
#pragma unroll
    for (int j = 0; j < kChan; ++j) acc[p][j] = 0.0f;
  load_slice(smem, x, w, a, o, 0);
  cp_async_commit();
  for (int s = 0; s < slices; ++s) {
    if (s + 1 < slices)  // the other slot was last read in slice s - 1, before its barrier
      load_slice(smem + ((s + 1) & 1) * a.stage_floats, x, w, a, o, s + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // slice s landed for every thread
    const float* patch = smem + (s & 1) * a.stage_floats;
    const float* ws = patch + a.patch_floats + cgi * kChan;
    for (int i = 0; i < a.kh; ++i) {
      for (int j = 0; j < a.kw; ++j) {
        const float* ap[kPix];
#pragma unroll
        for (int p = 0; p < kPix; ++p) ap[p] = patch + poff[p] + i * a.prs + j * a.cs;
        const float* wp = ws + (i * a.kw + j) * a.ck * nct;
#pragma unroll 4
        for (int ci = 0; ci < a.ck; ++ci) {
          float av[kPix];
#pragma unroll
          for (int p = 0; p < kPix; ++p) av[p] = ap[p][ci];
          float wv[kChan];
#pragma unroll
          for (int q = 0; q < kChan / 4; ++q) {
            const float4 t = reinterpret_cast<const float4*>(wp + ci * nct)[q];
            wv[4 * q] = t.x;
            wv[4 * q + 1] = t.y;
            wv[4 * q + 2] = t.z;
            wv[4 * q + 3] = t.w;
          }
#pragma unroll
          for (int p = 0; p < kPix; ++p)
#pragma unroll
            for (int jj = 0; jj < kChan; ++jj) acc[p][jj] = fmaf(av[p], wv[jj], acc[p][jj]);
        }
      }
    }
    __syncthreads();  // slice s is read: its slot may refill, the conv tile may overwrite it
  }
  epilogue(acc, smem, bias, out, a, o, cgi, pwi, lane);
}

}  // namespace

// x (B, H, W, cin) f32, w (kh, kw, cin, cout) f32, b (cout,) f32,
// out (B, ph, pw, cout) f32, all contiguous. p holds the kArgs ints of
// ConvArgs in its order (kernels/conv2d.py::conv_plan). Returns a
// cudaError_t code.
extern "C" int tdn_conv2d(const void* x, const void* w, const void* b, void* out,
                          const int* p, void* stream) {
  ConvArgs a;
  static_assert(sizeof(ConvArgs) == kArgs * sizeof(int), "ConvArgs holds kArgs ints");
  int* f = reinterpret_cast<int*>(&a);
  for (int i = 0; i < kArgs; ++i) f[i] = p[i];
  const int mt = kWarps / a.cg * 32 * kPix;  // pixels a CTA computes
  const bool cg_ok = a.cg == 1 || a.cg == 2 || a.cg == 4 || a.cg == 8;
  if (a.B < 1 || a.ph < 1 || a.pw < 1 || !cg_ok || a.imgs * a.cr * a.ccw > mt || a.ck < 1 ||
      a.cs < a.ck || a.prs < a.pcol * a.cs || a.pimg < a.prow * a.prs ||
      a.patch_floats < a.imgs * a.pimg || a.patch_floats % 4 != 0 ||
      a.stage_floats < a.patch_floats + a.kh * a.kw * a.ck * kChan * a.cg ||
      a.ldt < kChan * a.cg || (!a.pool_regs && a.smem_bytes < 4 * mt * a.ldt) ||
      a.smem_bytes < 4 * a.stage_floats * (a.cin > a.ck ? 2 : 1) ||
      a.smem_bytes > kSmemLimit ||
      (a.act == tdn::SOFTMAX && (a.ctiles != 1 || a.cout > kChan * a.cg)) ||
      (a.pool_regs && !((a.act == tdn::RELU || a.act == tdn::LINEAR) && a.pwh == 2 &&
                        a.pww == 2 && a.psh == 2 && a.psw == 2 && (a.ccw == 32 || a.ccw == 16) &&
                        (a.cr * a.ccw) % (32 * kPix) == 0)) ||
      a.imgs * a.prow * a.pcol >= (1 << 22))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(conv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         a.smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks =
      (long long)((a.B + a.imgs - 1) / a.imgs) * a.tiles_y * a.tiles_x * a.ctiles;
  conv_kernel<<<static_cast<unsigned>(blocks), kThreads, a.smem_bytes,
                static_cast<cudaStream_t>(stream)>>>(static_cast<const float*>(x),
                                                     static_cast<const float*>(w),
                                                     static_cast<const float*>(b),
                                                     static_cast<float*>(out), a);
  return static_cast<int>(cudaGetLastError());
}

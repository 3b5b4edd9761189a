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
// Design: a direct convolution, one CTA per (image, band of pooled
// output rows). The CTA stages the input rows its band needs, halo
// included, in shared memory; rows and columns outside the image (SAME
// padding, lax's split: total // 2 before) are zero-filled on load, so
// no padded copy exists in device memory, and any stride is index
// arithmetic. The weights of a chunk of output channels are staged
// beside them (the whole 18.4 KB of the second stage in one chunk). A
// thread computes CPT output channels of one conv pixel in registers
// with FFMA (no TF32), and writes the activated value (softmax: the
// pre-activation) into a conv tile in shared memory that holds every
// channel of the band's conv pixels. The epilogue then runs softmax
// over each pixel's channels and the max-pool (VALID, floor, -inf
// start) from that tile and writes the pooled rows, which are one
// contiguous run of the NHWC output. Overlapping windows (window >
// stride) make the band compute the conv rows its windows need, so rows
// at band edges are computed twice. Pixel strides in shared memory are
// odd (C | 1) so that a warp's 32 pixels fall in 32 banks. The band
// height, the weight chunk and the shared-memory layout are chosen by
// the Python wrapper (kernels/conv2d.py::conv_plan), which passes the
// offsets of the input rows and the conv tile and the total size; this
// file refuses a size over 227 KB.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kSmemLimit = 232448;

struct ConvArgs {
  int B, H, W, cin;          // input, NHWC
  int kh, kw, cout;          // weights, HWIO
  int sh, sw, pad_t, pad_l;  // conv stride and leading padding
  int pwh, pww, psh, psw;    // pool window and stride (1 x 1 without a pool)
  int ph, pw;                // pooled output rows and columns
  int act;                   // activation id (common.cuh)
  int band;                  // pooled rows per CTA
  int cc;                    // output channels per weight chunk (a multiple of CPT)
  int in_off, tile_off;      // float offsets of the input rows and the conv tile
  int smem_bytes;            // the whole layout: weight chunk, input rows, conv tile
};

template <int CPT>
__device__ __forceinline__ void fma_channels(float (&acc)[CPT], float v, const float* w) {
  if constexpr (CPT % 4 == 0) {
#pragma unroll
    for (int q = 0; q < CPT / 4; ++q) {
      const float4 w4 = reinterpret_cast<const float4*>(w)[q];
      acc[4 * q + 0] = fmaf(v, w4.x, acc[4 * q + 0]);
      acc[4 * q + 1] = fmaf(v, w4.y, acc[4 * q + 1]);
      acc[4 * q + 2] = fmaf(v, w4.z, acc[4 * q + 2]);
      acc[4 * q + 3] = fmaf(v, w4.w, acc[4 * q + 3]);
    }
  } else {
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[c] = fmaf(v, w[c], acc[c]);
  }
}

template <int CPT>
__global__ void __launch_bounds__(kThreads)
conv_kernel(const float* __restrict__ x, const float* __restrict__ w,
            const float* __restrict__ bias, float* __restrict__ out, ConvArgs a) {
  extern __shared__ __align__(16) float smem[];
  float* w_s = smem;  // (kh*kw*cin, cc), 16-byte aligned for float4 reads
  float* in_s = smem + a.in_off;
  float* tile = smem + a.tile_off;
  const int cs = a.cin | 1;   // input pixel stride in shared memory
  const int ts = a.cout | 1;  // conv-tile pixel stride
  const int cw = (a.pw - 1) * a.psw + a.pww;  // conv columns the pool reads
  const int iw = (cw - 1) * a.sw + a.kw;      // input columns they read

  const int n_bands = (a.ph + a.band - 1) / a.band;
  const int b = blockIdx.x / n_bands;
  const int p0 = (blockIdx.x - b * n_bands) * a.band;  // first pooled row
  const int np = min(a.band, a.ph - p0);
  const int cr = (np - 1) * a.psh + a.pwh;  // conv rows of this band
  const int ir = (cr - 1) * a.sh + a.kh;    // input rows they read
  const int in_row0 = p0 * a.psh * a.sh - a.pad_t;
  const int tid = threadIdx.x;

  // Stage the band's input rows; padding is zero-filled here.
  const float* xb = x + (size_t)b * a.H * a.W * a.cin;
  const int row_elems = iw * a.cin;
  for (int e = tid; e < ir * row_elems; e += kThreads) {
    const int r = e / row_elems;
    const int rem = e - r * row_elems;
    const int c = rem / a.cin;
    const int ci = rem - c * a.cin;
    const int gr = in_row0 + r, gc = c - a.pad_l;
    float v = 0.0f;
    if (gr >= 0 && gr < a.H && gc >= 0 && gc < a.W) v = xb[((size_t)gr * a.W + gc) * a.cin + ci];
    in_s[(r * iw + c) * cs + ci] = v;
  }

  const int taps_k = a.kh * a.kw * a.cin;
  const int groups = a.cc / CPT;
  const int npix = cr * cw;
  for (int c0 = 0; c0 < a.cout; c0 += a.cc) {
    __syncthreads();  // the input is staged; the last chunk's weights are read
    for (int e = tid; e < taps_k * a.cc; e += kThreads) {
      const int k = e / a.cc, c = e - k * a.cc;
      w_s[e] = (c0 + c < a.cout) ? w[(size_t)k * a.cout + c0 + c] : 0.0f;
    }
    __syncthreads();
    // Consecutive threads take consecutive pixels of one channel group:
    // weight reads are broadcasts, input reads hit distinct banks.
    for (int item = tid; item < npix * groups; item += kThreads) {
      const int g = item / npix;
      const int pix = item - g * npix;
      const int pr = pix / cw, pc = pix - pr * cw;
      float acc[CPT];
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[c] = 0.0f;
      const float* in0 = in_s + (pr * a.sh * iw + pc * a.sw) * cs;
      const float* w0 = w_s + g * CPT;
      for (int i = 0; i < a.kh; ++i) {
        for (int j = 0; j < a.kw; ++j) {
          const float* ip = in0 + (i * iw + j) * cs;
          const float* wp = w0 + (i * a.kw + j) * a.cin * a.cc;
          for (int ci = 0; ci < a.cin; ++ci) fma_channels<CPT>(acc, ip[ci], wp + ci * a.cc);
        }
      }
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int oc = c0 + g * CPT + c;
        if (oc < a.cout) {
          const float z = acc[c] + bias[oc];
          tile[pix * ts + oc] = (a.act == tdn::SOFTMAX) ? z : tdn::act_elem(z, a.act);
        }
      }
    }
  }
  __syncthreads();

  if (a.act == tdn::SOFTMAX) {  // over each pixel's channels
    for (int pix = tid; pix < npix; pix += kThreads) {
      float* row = tile + pix * ts;
      float m = -INFINITY;
      for (int c = 0; c < a.cout; ++c) m = fmaxf(m, row[c]);
      float s = 0.0f;
      for (int c = 0; c < a.cout; ++c) {
        const float e = expf(row[c] - m);
        row[c] = e;
        s += e;
      }
      for (int c = 0; c < a.cout; ++c) row[c] = row[c] / s;
    }
    __syncthreads();
  }

  // Max-pool the activated tile and write the band's pooled rows: one
  // contiguous run of the output, channels fastest.
  float* ob = out + ((size_t)b * a.ph + p0) * a.pw * a.cout;
  const int n_out = np * a.pw * a.cout;
  for (int e = tid; e < n_out; e += kThreads) {
    const int oc = e % a.cout;
    const int t = e / a.cout;
    const int q = t % a.pw, p = t / a.pw;
    const float* base = tile + (p * a.psh * cw + q * a.psw) * ts + oc;
    float m = -INFINITY;
    for (int i = 0; i < a.pwh; ++i)
      for (int j = 0; j < a.pww; ++j) m = fmaxf(m, base[(i * cw + j) * ts]);
    ob[e] = m;
  }
}

template <int CPT>
int launch(const float* x, const float* w, const float* b, float* out, const ConvArgs& a,
           size_t smem, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(conv_kernel<CPT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (long long)a.B * ((a.ph + a.band - 1) / a.band);
  conv_kernel<CPT><<<static_cast<unsigned>(blocks), kThreads, smem, s>>>(x, w, b, out, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (B, H, W, cin) f32, w (kh, kw, cin, cout) f32, b (cout,) f32,
// out (B, ph, pw, cout) f32, all contiguous. p holds the 23 ints of
// ConvArgs in its order; cpt (1, 2, 4 or 8) is the channels a thread
// computes. Returns a cudaError_t code.
extern "C" int tdn_conv2d(const void* x, const void* w, const void* b, void* out,
                          const int* p, int cpt, void* stream) {
  ConvArgs a{p[0],  p[1],  p[2],  p[3],  p[4],  p[5],  p[6],  p[7],  p[8],  p[9],
             p[10], p[11], p[12], p[13], p[14], p[15], p[16], p[17], p[18], p[19],
             p[20], p[21], p[22]};
  if (a.B < 1 || a.ph < 1 || a.pw < 1 || a.band < 1 || a.cc < cpt || a.cc % cpt != 0 ||
      a.in_off < a.kh * a.kw * a.cin * a.cc || a.tile_off <= a.in_off ||
      a.smem_bytes <= 4 * a.tile_off || a.smem_bytes > kSmemLimit)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(a.smem_bytes);
  const float* xf = static_cast<const float*>(x);
  const float* wt = static_cast<const float*>(w);
  const float* bf = static_cast<const float*>(b);
  float* of = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (cpt) {
    case 8: return launch<8>(xf, wt, bf, of, a, smem, s);
    case 4: return launch<4>(xf, wt, bf, of, a, smem, s);
    case 2: return launch<2>(xf, wt, bf, of, a, smem, s);
    case 1: return launch<1>(xf, wt, bf, of, a, smem, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

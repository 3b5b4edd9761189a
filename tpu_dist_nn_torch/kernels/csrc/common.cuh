// Shared device helpers for the port's kernels (dense chains and conv).
//
// Numerics: these sources are built without --use_fast_math. Activations
// use expf / tanhf (not __expf), divisions are IEEE, and the int8 chain
// spells out its rounding with __fmul_rn / __fadd_rn / rintf, so each
// kernel computes what its plain PyTorch version computes.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace tdn {

// Activation ids: the order of tpu_dist_nn_torch/core/activations.py.
enum Act : int { LINEAR = 0, RELU = 1, SIGMOID = 2, SOFTMAX = 3, TANH = 4, GELU = 5 };

// NaN-keeping max and relu. fmaxf(NaN, y) returns y, where jnp.maximum,
// torch.maximum and torch.relu return the NaN: a NaN input must come out
// non-finite, or the serving path's numeric guard cannot see it. PTX's
// max.NaN.f32 (sm_80 and up) returns NaN when either input is NaN and is
// otherwise max.f32, fmaxf's own instruction: the same bits for every
// other input (signed zeros included) at the same cost.
__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

__device__ __forceinline__ float relu_nan(float z) { return max_nan(z, 0.0f); }

// Element-wise activations. Softmax is a row operation: callers store
// the pre-activation and run softmax_row_warp over the finished row.
__device__ __forceinline__ float act_elem(float z, int act) {
  switch (act) {
    case RELU:
      return relu_nan(z);
    case SIGMOID:
      return 1.0f / (1.0f + expf(-z));
    case TANH:
      return tanhf(z);
    case GELU: {
      // tanh form, as jax.nn.gelu's default and F.gelu(approximate="tanh").
      const float k_beta = 0.7978845608028654f;  // sqrt(2 / pi)
      const float inner = k_beta * (z + 0.044715f * z * z * z);
      return 0.5f * z * (1.0f + tanhf(inner));
    }
    default:
      return z;
  }
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = max_nan(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Numerically stable softmax of one row of n floats, in place, by one
// full warp: exp(z - max) / sum.
__device__ __forceinline__ void softmax_row_warp(float* row, int n, int lane) {
  float m = -INFINITY;
  for (int c = lane; c < n; c += 32) m = fmaxf(m, row[c]);
  m = warp_max(m);
  float s = 0.0f;
  for (int c = lane; c < n; c += 32) {
    const float e = expf(row[c] - m);
    row[c] = e;
    s += e;
  }
  s = warp_sum(s);
  for (int c = lane; c < n; c += 32) row[c] = row[c] / s;
}

// Ordered sums across CTAs (the flash backwards' dq). A CTA takes a
// ticket from a zeroed counter at its start and maps the ticket, not
// blockIdx, to its work: a CTA holding ticket t is running, so every
// ticket below t belongs to a CTA that is running or has finished. A CTA
// that waits only on lower tickets therefore always makes progress,
// whatever order the hardware dispatches the grid in. A turn counter per
// summed tile then lets its adders in one at a time, in a fixed order.
__device__ __forceinline__ int take_ticket(int* counter) { return atomicAdd(counter, 1); }

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_release(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// Spin until *turn == want. A turn that has not come after about 9 s
// traps, so a fault ends the launch with an error instead of hanging
// the card.
__device__ __forceinline__ void wait_turn(const int* turn, int want) {
  const long long t0 = clock64();
  while (load_acquire(turn) != want) {
    if (clock64() - t0 > (1LL << 34)) __trap();
    __nanosleep(64);
  }
}

}  // namespace tdn

// Each kernel library exports this so the Python wrapper can name a
// failed launch's error code.
extern "C" const char* tdn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

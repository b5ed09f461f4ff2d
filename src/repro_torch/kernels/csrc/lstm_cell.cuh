// Shared LSTM cell body of the Hopper kernels (lstm_stack.cu, lstm_scan.cu).
//
// Every helper is a single IEEE fp32 operation, or a fixed sequence of
// them, in the order of the plain PyTorch versions (kernels/*/ref.py,
// core/quant.py): __fmul_rn and __fadd_rn never contract into FMAs, and
// the transcendentals are the expf/tanhf PyTorch's CUDA kernels call.  A
// kernel built from these helpers therefore equals its plain version bit
// for bit on the card.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum DType { kF32 = 0, kBF16 = 1, kI8 = 2 };
enum Act { kExact = 0, kHard = 1, kPaperHwKernel = 2 };

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float clip(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(int8_t v) { return static_cast<float>(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Round an fp32 value to the compute dtype and back (exact for fp32).
template <typename CT> __device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<CT>(v));
}

// Piecewise-linear tanh: sum of clipped ramps times sign(x).  The constants
// are double literals cast to float, the rounding PyTorch applies to the
// Python floats of core/quant.py.
__device__ float tanh_pwl(float x) {
  const float knots[6] = {0.0f, 0.5f, 1.0f, 1.5f, 2.0f, 2.5f};
  const float slopes[6] = {(float)0.92423, (float)0.58891, (float)0.28699,
                           (float)0.11786, (float)0.04513, (float)0.01702};
  const float ax = fabsf(x);
  float y = 0.0f;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    y = add(y, mul(slopes[i], clip(__fsub_rn(ax, knots[i]), 0.0f, 0.5f)));
  }
  const float sgn = x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
  return mul(sgn, y);
}

__device__ __forceinline__ float sigma(float x, int act) {
  if (act == kExact) return __fdiv_rn(1.0f, add(1.0f, expf(-x)));
  if (act == kHard) return clip(add(mul(x, 0.25f), 0.5f), 0.0f, 1.0f);
  return add(mul(0.5f, tanh_pwl(mul(0.5f, x))), 0.5f);
}

__device__ __forceinline__ float tanh_act(float x, int act) {
  return act == kExact ? tanhf(x) : tanh_pwl(x);
}

// Fake-quant onto the <bits, bits/2> fixed-point grid: round half to even
// (rintf, not roundf), saturate.
__device__ __forceinline__ float act_quant(float x, int bits) {
  const float scale = float(1 << (bits / 2));
  const float lo = -float(1 << (bits - 1)) / scale;
  const float hi = float((1 << (bits - 1)) - 1) / scale;
  return clip(__fdiv_rn(rintf(mul(x, scale)), scale), lo, hi);
}

// The activation of one gate pre-activation, by gate (0 i, 1 f, 2 g, 3 o):
// sigma for i, f and o, tanh for g.
__device__ __forceinline__ float gate_act(float x, int gate, int act) {
  return gate == 2 ? tanh_act(x, act) : sigma(x, act);
}

// The fp32 cell of one element from its activated gates, *cp updated in
// place.  Returns the new h, fake-quantized when act_bits != 0 and rounded
// to the compute dtype.
template <typename CT>
__device__ __forceinline__ float cell_update(float ig, float fg, float gg, float og, float* cp,
                                             int act, int act_bits) {
  const float c = add(mul(fg, *cp), mul(ig, gg));
  float h = mul(og, tanh_act(c, act));
  if (act_bits) h = act_quant(h, act_bits);
  *cp = c;
  return round_to<CT>(h);
}

// The cell tail of one element: gate pre-activations g[0..4W) of one row
// ([i|f|g|o]), element k, fp32 cell *cp updated in place.  The same
// operations as gate_act on each gate, then cell_update.
template <typename CT>
__device__ __forceinline__ float cell_tail(const float* g, int W, int k, float* cp,
                                           int act, int act_bits) {
  const float ig = sigma(g[k], act);
  const float fg = sigma(g[W + k], act);
  const float gg = tanh_act(g[2 * W + k], act);
  const float og = sigma(g[3 * W + k], act);
  return cell_update<CT>(ig, fg, gg, og, cp, act, act_bits);
}

__device__ void copy_to_smem(void* dst, const void* src, size_t bytes) {
  if (bytes % 16 == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const uint4* s = static_cast<const uint4*>(src);
    uint4* d = static_cast<uint4*>(dst);
    for (size_t i = threadIdx.x; i < bytes / 16; i += blockDim.x) d[i] = s[i];
  } else {  // every array the kernels load is a whole number of 4-byte words
    const uint32_t* s = static_cast<const uint32_t*>(src);
    uint32_t* d = static_cast<uint32_t*>(dst);
    for (size_t i = threadIdx.x; i < bytes / 4; i += blockDim.x) d[i] = s[i];
  }
}

}  // namespace

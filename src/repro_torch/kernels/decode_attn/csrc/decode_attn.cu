// Single-query GQA decode attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/decode_attn/decode_attn.py
// `decode_attn` (body `_decode_attn_kernel`): one new token per batch row
// attends to the valid prefix of a (B, S, Hkv, D) KV cache,
//     out[b, h] = softmax_s(scale * q[b, h] . k[b, s, h / G]) @ v[b, :, h / G]
// over s < lengths[b], with G = Hq / Hkv query heads sharing each cache
// head.  q is scaled before the dot (as the TPU kernel does); the scores,
// the running max m, the denominator l and the numerator acc are fp32, and
// the output is rounded once to q's dtype.  The plain version
// (decode_attn.decode_attn_plain) performs the same steps in PyTorch.
//
// What bounds it on this card.  A decode step reads every valid cache row
// once and does 4 fp32 operations per cached element (2 for q.k, 2 for
// p.v): about G/2 operations per byte of a bf16 cache, far below the
// card's ~20 fp32 operations per byte.  So it is bound by bytes: at the
// smollm-360m serving shape (B=8, 5 KV heads, D=64, 576 rows, bf16) one
// call must move 5.9 MB, 1.8 us at 3.35 TB/s.
//
// What the design does about it.
//   * One CTA per (batch row, KV head): the cache head is read once for
//     all G query heads that share it (the GQA saving the TPU kernel gets
//     from its per-head loop), and no K/V is repeated.
//   * The loop runs over s < lengths[b] only, in blocks of kBlockS rows
//     staged through shared memory as fp32; the ragged last block is
//     masked here, so the wrapper never pads the cache (the reference
//     wrapper's jnp.pad copied the whole cache per call).  Blocks past the
//     length are never read.
//   * The online softmax follows the TPU kernel: per block, m_new =
//     max(m, max_s score), p = exp(score - m_new), corr = exp(m - m_new),
//     l = corr * l + sum(p), acc = corr * acc + p @ V; m starts at -1e30.
//   * Shared rows of K are padded to D + 1 floats, so the 32 lanes that
//     score 32 rows read 32 different banks.
// Split-S (flash-decoding) across CTAs, vector loads, TMA and keeping K in
// bf16 in shared memory are left for later work: at B=8 the grid has 40
// CTAs for 132 SMs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

namespace {

enum DType { kF32 = 0, kBF16 = 1 };

constexpr int kThreads = 128;
constexpr int kBlockS = 32;            // cache rows per staged block (one per lane)
constexpr int kAccPerThread = 8;       // G * D <= kThreads * kAccPerThread
constexpr float kNegInf = -1e30f;      // the TPU kernel's mask value

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Floats of dynamic shared memory one CTA needs.
__host__ __device__ inline size_t smem_floats(int G, int D) {
  return size_t(G) * D                  // q, scaled
         + size_t(kBlockS) * (D + 1)    // K block, rows padded
         + size_t(kBlockS) * D          // V block
         + size_t(G) * kBlockS          // scores, then p
         + 3 * size_t(G);               // m, l, corr
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const int* __restrict__ lengths,
                   T* __restrict__ out, int S, int Hkv, int G, int D, float scale) {
  extern __shared__ float smem[];
  float* q_s = smem;
  float* k_s = q_s + G * D;
  float* v_s = k_s + kBlockS * (D + 1);
  float* p_s = v_s + kBlockS * D;
  float* m_s = p_s + G * kBlockS;
  float* l_s = m_s + G;
  float* c_s = l_s + G;

  const int b = blockIdx.x / Hkv, h = blockIdx.x % Hkv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int GD = G * D;
  const int len = min(max(lengths[b], 0), S);

  // this CTA's G query heads are contiguous: q[b, h*G : (h+1)*G, :]
  const size_t q_off = (size_t(b) * Hkv + h) * GD;
  for (int i = tid; i < GD; i += kThreads) q_s[i] = to_f(q[q_off + i]) * scale;
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.0f;
  }
  float acc[kAccPerThread];
#pragma unroll
  for (int j = 0; j < kAccPerThread; ++j) acc[j] = 0.0f;
  __syncthreads();

  const size_t row_stride = size_t(Hkv) * D;
  const size_t kv_off = (size_t(b) * S * Hkv + h) * D;
  for (int s0 = 0; s0 < len; s0 += kBlockS) {
    const int rows = min(kBlockS, len - s0);
    for (int i = tid; i < rows * D; i += kThreads) {
      const int r = i / D, d = i - r * D;
      const size_t off = kv_off + size_t(s0 + r) * row_stride + d;
      k_s[r * (D + 1) + d] = to_f(k[off]);
      v_s[r * D + d] = to_f(v[off]);
    }
    __syncthreads();
    // scores: lane r of a warp scores row r against one query head
    for (int i = tid; i < G * kBlockS; i += kThreads) {
      const int g = i / kBlockS, r = i - g * kBlockS;
      float sc = kNegInf;
      if (r < rows) {
        sc = 0.0f;
        const float* qg = q_s + g * D;
        const float* kr = k_s + r * (D + 1);
        for (int d = 0; d < D; ++d) sc = fmaf(qg[d], kr[d], sc);
      }
      p_s[i] = sc;
    }
    __syncthreads();
    // online softmax: one warp per query head, one lane per row
    for (int g = warp; g < G; g += kThreads / 32) {
      const float sc = p_s[g * kBlockS + lane];
      float mx = sc;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      const float p = lane < rows ? expf(sc - m_new) : 0.0f;
      float sum = p;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      p_s[g * kBlockS + lane] = p;
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        c_s[g] = corr;
        l_s[g] = corr * l_s[g] + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();
    // acc = corr * acc + p @ V, one (head, d) element per slot
#pragma unroll
    for (int j = 0; j < kAccPerThread; ++j) {
      const int e = tid + j * kThreads;
      if (e < GD) {
        const int g = e / D, d = e - g * D;
        const float* pg = p_s + g * kBlockS;
        float pv = 0.0f;
        for (int r = 0; r < rows; ++r) pv = fmaf(pg[r], v_s[r * D + d], pv);
        acc[j] = c_s[g] * acc[j] + pv;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < kAccPerThread; ++j) {
    const int e = tid + j * kThreads;
    if (e < GD) out[q_off + e] = from_f<T>(acc[j] / fmaxf(l_s[e / D], 1e-30f));
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const int* lengths,
                   void* out, int B, int S, int Hkv, int G, int D, cudaStream_t stream) {
  const size_t smem = smem_floats(G, D) * sizeof(float);
  auto kernel = decode_attn_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  // the TPU kernel's scale: the Python float 1 / sqrt(D), rounded to fp32
  const float scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(D)));
  kernel<<<B * Hkv, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      lengths, static_cast<T*>(out), S, Hkv, G, D, scale);
  return cudaGetLastError();
}

}  // namespace

// Returns cudaGetLastError() of the launch (0 on success).  q (B, Hkv*G, D),
// k and v (B, S, Hkv, D) and out (B, Hkv*G, D) are contiguous, of one dtype;
// lengths (B,) int32.  Requires G * D <= 1024.
extern "C" int decode_attn(const void* q, const void* k, const void* v,
                           const void* lengths, void* out, int B, int S, int Hkv,
                           int G, int D, int dtype, void* stream) {
  if (G * D > kThreads * kAccPerThread) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(lengths);
  if (dtype == kF32) return launch<float>(q, k, v, len, out, B, S, Hkv, G, D, s);
  if (dtype == kBF16) return launch<__nv_bfloat16>(q, k, v, len, out, B, S, Hkv, G, D, s);
  return cudaErrorInvalidValue;
}

// Dynamic shared memory one CTA needs.
extern "C" long long decode_attn_smem_bytes(int G, int D) {
  return static_cast<long long>(smem_floats(G, D) * sizeof(float));
}

// Query heads times head width one CTA can hold (G * D at most).
extern "C" int decode_attn_max_gd() { return kThreads * kAccPerThread; }

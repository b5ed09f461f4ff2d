// Row-wise product (M, K) @ (K, N) (+ b) for Hopper (sm_90a), with each
// output element one K-long chain in a fixed order.
//
// Replaces the two products of the GW score tail that the reference leaves
// to XLA around its Pallas kernels: layer 0's input projection of the
// wavefront kernel (repro/kernels/lstm_stack/ops.py:198, `x @ W_x[0]`) and
// the dense head (repro/core/autoencoder.py:222, `h @ W + b`).  The port
// also sums each window's squared error through it (a product with a
// column of ones).  cuBLAS, and PyTorch's reductions, pick their reduction
// order by shape, so a row's bits there depend on how many rows share the
// call; here they never do, which is what a batched window decode needs to
// score each stream as it scores it alone.
//
//   out[m, n] = ((0 + x[m, 0] w[0, n]) + x[m, 1] w[1, n]) + ... (+ b[n])
//
// Each step is one IEEE fp32 multiply and one IEEE fp32 add (__fmul_rn and
// __fadd_rn never contract into an FMA), the order of the plain version
// (lstm_stack/ref.py `seq_dot`, then `+ b`).  x is fp32 or bf16 (widened
// exactly); w and b are fp32; out is fp32.
//
// What bounds it on this card.  At the score tail's shapes (M = B * 100
// rows, K <= 32, N <= 128; the error sums K = 100, N = 1) a call moves at
// most a few hundred KB and does under 30 MFLOP: microseconds either way,
// so one launch's latency sets it.  The design is the plainest that keeps
// the order: one thread per output element, consecutive threads on
// consecutive n (w's rows read coalesced, x's row by broadcast), the chain
// in registers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum DType { kF32 = 0, kBF16 = 1 };

constexpr int kThreads = 256;

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }

template <typename X>
__global__ void __launch_bounds__(kThreads) rowwise_kernel(const X* __restrict__ x,
                                                           const float* __restrict__ w,
                                                           const float* __restrict__ b,
                                                           float* __restrict__ out, int M,
                                                           int K, int N) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= static_cast<long long>(M) * N) return;
  const int m = static_cast<int>(i / N), n = static_cast<int>(i - static_cast<long long>(m) * N);
  const X* xr = x + static_cast<size_t>(m) * K;
  float acc = 0.0f;
  for (int k = 0; k < K; ++k) {
    acc = __fadd_rn(acc, __fmul_rn(ld(xr + k), w[static_cast<size_t>(k) * N + n]));
  }
  if (b != nullptr) acc = __fadd_rn(acc, b[n]);
  out[i] = acc;
}

template <typename X>
cudaError_t launch(const void* x, const float* w, const float* b, float* out, int M, int K,
                   int N, cudaStream_t stream) {
  const long long total = static_cast<long long>(M) * N;
  const unsigned blocks = static_cast<unsigned>((total + kThreads - 1) / kThreads);
  rowwise_kernel<X><<<blocks, kThreads, 0, stream>>>(static_cast<const X*>(x), w, b, out, M,
                                                     K, N);
  return cudaGetLastError();
}

}  // namespace

// Returns cudaGetLastError() of the launch (0 on success).  x (M, K) at
// `dtype`, w (K, N) fp32, b (N,) fp32 or null, out (M, N) fp32, all
// contiguous; M, K, N >= 1 and M * N below 2^31 * 256.
extern "C" int rowwise_matmul(const void* x, const void* w, const void* b, void* out, int M,
                              int K, int N, int dtype, void* stream) {
  if (M < 1 || K < 1 || N < 1) return cudaErrorInvalidValue;
  if (static_cast<long long>(M) * N > (static_cast<long long>(1) << 31) * kThreads) {
    return cudaErrorInvalidValue;
  }
  const float* wf = static_cast<const float*>(w);
  const float* bf = static_cast<const float*>(b);
  float* of = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return launch<float>(x, wf, bf, of, M, K, N, s);
  if (dtype == kBF16) return launch<__nv_bfloat16>(x, wf, bf, of, M, K, N, s);
  return cudaErrorInvalidValue;
}

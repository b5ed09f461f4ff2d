// Chunked Mamba-2 SSD scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/ssd_scan/ssd_scan.py
// `ssd_scan` (body `_ssd_kernel`).  Per batch row b and head h, with the
// head's scalar decay a[h] < 0 and alpha_t = dt_t * a[h]:
//     S_t = exp(alpha_t) S_{t-1} + dt_t (x_t outer B_t),   y_t = S_t . C_t
// computed chunk by chunk (L steps each), with cum the inclusive prefix sum
// of alpha inside the chunk:
//     intra:  y  = [tril(exp(cum_t - cum_s)) * (C B^T) * dt_s] @ X
//     inter:  y += (C * exp(cum)) @ S_prev^T
//     carry:  S  = exp(cum_L) S_prev + (X * dt * exp(cum_L - cum))^T @ B
// x, B and C arrive in the model dtype and are widened to fp32; dt and a
// are fp32; S is fp32 throughout; y is rounded once to x's dtype.  The
// plain version (ssd_scan.ssd_chunked) is this algorithm in PyTorch.
//
// Layout.  The kernel reads the model's tensors as they are: x (B, T, H,
// P), dt (B, T, H), B and C (B, T, G, N), s0 and s_f (B, H, P, N), y (B, T,
// H, P).  Head h reads B/C group h / (H / G): the reference wrapper's
// jnp.repeat of B and C to H heads is never materialised.  T need not be a
// multiple of L: the last chunk runs its Lr < L real steps, which is what
// the reference's zero-dt padding computes (a padded step has alpha = 0, so
// cum stays at its last real value, and x = B = C = 0, so it adds nothing).
//
// What bounds it on this card.  At mamba2-130m's prefill shape (B=8, T=512,
// H=24, P=64, N=128, L=64) a call must move 34 MB (x and y in bf16, B, C,
// dt and the fp32 final state; 10 us at 3.35 TB/s) and does 4.5 GFLOP of
// fp32 chunk products (67 us at 67 TFLOP/s on the CUDA cores): bound by
// operations.
//
// What the design does about it.
//   * One CTA per (batch row, head) walks the chunks in order, the TPU's
//     sequential grid axis as a loop.  S (P x N fp32, 32 KB at P=64, N=128)
//     stays in shared memory across chunks, as the reference keeps it in
//     VMEM, and never touches device memory until the final state.
//   * Per chunk, x, B, C (fp32), the L x L matrix M = tril(decay) * CB^T *
//     dt and S all sit in shared memory: at L=64 that is 133 KB of the
//     227 KB a CTA may use.  Rows are padded by one float, so the lanes of a
//     warp walk 32 different banks in each of the four products.
//   * cum is an inclusive prefix sum in a fixed sequential order (one
//     thread, L adds).
//   * Every product runs on the fp32 CUDA cores with fmaf, one output
//     element per thread slot.  The tensor cores (wgmma on bf16 or tf32
//     tiles), register tiling and more CTAs per head are left for later
//     work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "smem_attr.cuh"

namespace {

enum DType { kF32 = 0, kBF16 = 1 };

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

struct SsdArgs {
  const void* x;     // (B, T, H, P) model dtype
  const float* dt;   // (B, T, H)
  const float* a;    // (H,) negative decay rates
  const void* bm;    // (B, T, G, N) model dtype
  const void* cm;    // (B, T, G, N) model dtype
  const float* s0;   // (B, H, P, N), or null for a zero state
  void* y;           // (B, T, H, P) model dtype
  float* s_f;        // (B, H, P, N)
  int B, T, H, G, P, N, L;
};

// Offsets (in floats) of the shared-memory carve-up.
struct SsdLayout {
  size_t x, b, c, m, s, cum, dt, ecum, wdec, total;
};

__host__ __device__ inline SsdLayout ssd_layout(int L, int P, int N) {
  SsdLayout o;
  o.x = 0;                                   // L x (P + 1): x, then x * dt * exp(cum_L - cum)
  o.b = o.x + size_t(L) * (P + 1);           // L x (N + 1)
  o.c = o.b + size_t(L) * (N + 1);           // L x (N + 1)
  o.m = o.c + size_t(L) * (N + 1);           // L x (L + 1)
  o.s = o.m + size_t(L) * (L + 1);           // P x (N + 1): the carried state
  o.cum = o.s + size_t(P) * (N + 1);         // L
  o.dt = o.cum + L;                          // L
  o.ecum = o.dt + L;                         // L: exp(cum)
  o.wdec = o.ecum + L;                       // L: exp(cum_L - cum)
  o.total = o.wdec + L;
  return o;
}

template <typename E>  // element type of x, B, C and y
__global__ void __launch_bounds__(kThreads) ssd_scan_kernel(SsdArgs a) {
  extern __shared__ float smem[];
  const int P = a.P, N = a.N, L = a.L, T = a.T, H = a.H, G = a.G;
  const SsdLayout o = ssd_layout(L, P, N);
  float* x_s = smem + o.x;
  float* b_s = smem + o.b;
  float* c_s = smem + o.c;
  float* m_s = smem + o.m;
  float* st = smem + o.s;
  float* cum = smem + o.cum;
  float* dts = smem + o.dt;
  float* ecum = smem + o.ecum;
  float* wdec = smem + o.wdec;

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int g = h / (H / G);
  const int tid = threadIdx.x;
  const float a_h = a.a[h];
  const E* x = static_cast<const E*>(a.x);
  const E* bm = static_cast<const E*>(a.bm);
  const E* cm = static_cast<const E*>(a.cm);
  E* y = static_cast<E*>(a.y);
  const size_t state_off = size_t(blockIdx.x) * P * N;  // (b * H + h) * P * N

  for (int i = tid; i < P * N; i += kThreads) {
    const int p = i / N, n = i - p * N;
    st[p * (N + 1) + n] = a.s0 ? a.s0[state_off + i] : 0.0f;
  }

  for (int t0 = 0; t0 < T; t0 += L) {
    const int Lc = min(L, T - t0);
    // ---- stage the chunk: x, B, C widened to fp32, and dt -----------------
    for (int i = tid; i < Lc * P; i += kThreads) {
      const int t = i / P, p = i - t * P;
      x_s[t * (P + 1) + p] = to_f(x[((size_t(b) * T + t0 + t) * H + h) * P + p]);
    }
    for (int i = tid; i < Lc * N; i += kThreads) {
      const int t = i / N, n = i - t * N;
      const size_t off = ((size_t(b) * T + t0 + t) * G + g) * N + n;
      b_s[t * (N + 1) + n] = to_f(bm[off]);
      c_s[t * (N + 1) + n] = to_f(cm[off]);
    }
    for (int t = tid; t < Lc; t += kThreads) dts[t] = a.dt[(size_t(b) * T + t0 + t) * H + h];
    __syncthreads();
    if (tid == 0) {  // inclusive prefix sum of alpha = dt * a, in order
      float run = 0.0f;
      for (int t = 0; t < Lc; ++t) {
        run = __fadd_rn(run, __fmul_rn(dts[t], a_h));  // no FMA contraction
        cum[t] = run;
      }
    }
    __syncthreads();
    const float total = cum[Lc - 1];
    for (int t = tid; t < Lc; t += kThreads) {
      ecum[t] = expf(cum[t]);
      wdec[t] = expf(total - cum[t]);
    }
    // ---- M[t, s] = (C_t . B_s) * exp(cum_t - cum_s) * dt_s for s <= t -----
    for (int i = tid; i < Lc * Lc; i += kThreads) {
      const int t = i / Lc, s = i - t * Lc;
      float mv = 0.0f;
      if (s <= t) {
        const float* ct = c_s + t * (N + 1);
        const float* bs = b_s + s * (N + 1);
        float dot = 0.0f;
        for (int n = 0; n < N; ++n) dot = fmaf(ct[n], bs[n], dot);
        mv = dot * expf(cum[t] - cum[s]) * dts[s];
      }
      m_s[t * (L + 1) + s] = mv;
    }
    __syncthreads();
    // ---- C * exp(cum), in place (M no longer reads C) ---------------------
    for (int i = tid; i < Lc * N; i += kThreads) {
      const int t = i / N, n = i - t * N;
      c_s[t * (N + 1) + n] *= ecum[t];
    }
    __syncthreads();
    // ---- y = M @ X + (C * exp(cum)) @ S_prev^T ----------------------------
    for (int i = tid; i < Lc * P; i += kThreads) {
      const int t = i / P, p = i - t * P;
      const float* mt = m_s + t * (L + 1);
      float intra = 0.0f;
      for (int s = 0; s <= t; ++s) intra = fmaf(mt[s], x_s[s * (P + 1) + p], intra);
      const float* ce = c_s + t * (N + 1);
      const float* sp = st + p * (N + 1);
      float inter = 0.0f;
      for (int n = 0; n < N; ++n) inter = fmaf(ce[n], sp[n], inter);
      y[((size_t(b) * T + t0 + t) * H + h) * P + p] = from_f<E>(intra + inter);
    }
    __syncthreads();
    // ---- xw = x * dt * exp(cum_L - cum), in place -------------------------
    for (int i = tid; i < Lc * P; i += kThreads) {
      const int t = i / P, p = i - t * P;
      x_s[t * (P + 1) + p] = x_s[t * (P + 1) + p] * dts[t] * wdec[t];
    }
    __syncthreads();
    // ---- S = exp(cum_L) S_prev + xw^T @ B ----------------------------------
    const float etot = expf(total);
    for (int i = tid; i < P * N; i += kThreads) {
      const int p = i / N, n = i - p * N;
      float acc = 0.0f;
      for (int s = 0; s < Lc; ++s) acc = fmaf(x_s[s * (P + 1) + p], b_s[s * (N + 1) + n], acc);
      st[p * (N + 1) + n] = etot * st[p * (N + 1) + n] + acc;
    }
    __syncthreads();
  }

  for (int i = tid; i < P * N; i += kThreads) {
    const int p = i / N, n = i - p * N;
    a.s_f[state_off + i] = st[p * (N + 1) + n];
  }
}

template <typename T>
struct Instance {};  // one shared-memory table each

template <typename T>
cudaError_t launch(const SsdArgs& a, cudaStream_t stream) {
  const size_t smem = ssd_layout(a.L, a.P, a.N).total * sizeof(float);
  auto kernel = ssd_scan_kernel<T>;
  cudaError_t err = set_smem_once<Instance<T>>(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<a.B * a.H, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Returns cudaGetLastError() of the launch (0 on success).  Every tensor is
// contiguous in the layout above; x, B, C and y share `dtype`; s0 may be
// null.  Requires H % G == 0, T >= 1 and 1 <= L.
extern "C" int ssd_scan(const void* x, const void* dt, const void* a, const void* bm,
                        const void* cm, const void* s0, void* y, void* s_f, int B,
                        int T, int H, int G, int P, int N, int L, int dtype,
                        void* stream) {
  if (G < 1 || H % G != 0 || T < 1 || L < 1) return cudaErrorInvalidValue;
  SsdArgs args;
  args.x = x;
  args.dt = static_cast<const float*>(dt);
  args.a = static_cast<const float*>(a);
  args.bm = bm;
  args.cm = cm;
  args.s0 = static_cast<const float*>(s0);
  args.y = y;
  args.s_f = static_cast<float*>(s_f);
  args.B = B;
  args.T = T;
  args.H = H;
  args.G = G;
  args.P = P;
  args.N = N;
  args.L = L;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return launch<float>(args, s);
  if (dtype == kBF16) return launch<__nv_bfloat16>(args, s);
  return cudaErrorInvalidValue;
}

// Dynamic shared memory one CTA needs at chunk L.
extern "C" long long ssd_scan_smem_bytes(int L, int P, int N) {
  return static_cast<long long>(ssd_layout(L, P, N).total * sizeof(float));
}

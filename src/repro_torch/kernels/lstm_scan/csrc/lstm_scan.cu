// Per-layer LSTM recurrence kernel for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/lstm_scan/lstm_scan.py
// `lstm_scan` (body `_lstm_scan_kernel`): one layer's recurrent sub-layer
// over a precomputed input stream.  The input product and the bias arrive
// in xw (T, B, 4H) fp32, time-major; per timestep
//     gates = xw[t] + h_{t-1} @ W_h        (fp32 accumulation)
//     i, f, o = sigma(.), g = tanh(.), c = f*c + i*g (fp32),
//     h = o * tanh(c), rounded to the compute dtype,
// and hs[t] = h; the finals are written after the last step.  No int8, no
// scales, no activation fake-quant: the kernel_safe activation sets only.
//
// A second entry, lstm_scan_layer, takes the layer's raw input x (B, T,
// IN) at the compute dtype with W_x and b instead of xw, and forms
//     xw[t] = round_to_compute(x[t] @ W_x) + b
// in the kernel, per row and in a fixed order over k: the reference's
// `(x @ W_x).astype(f32) + b` of its kernel backend.  A cuBLAS product
// picks its reduction by shape, so a row's xw would depend on how many
// rows share the call; in-kernel it does not, and the `kernel` backend's
// push_many stays bit-equal to sequential pushes.
//
// What bounds it on this card.  At the GW nominal shapes (H <= 32, T=100,
// B <= 64) a call moves well under a MB and does a few MFLOP, so the bytes
// and FLOP bounds are microseconds.  What bounds it is the chain of T
// dependent cells: each needs the previous cell's h.  Per cell a thread
// runs one H-long chain of dependent fp32 adds from shared memory, two
// block barriers and the transcendental tail; at T=1 and B=1, launch
// latency.
//
// What the design does about it.
//   * One CTA per block of `rows` batch rows (default 1) runs the whole
//     time loop: the TPU's sequential grid axis becomes a loop inside the
//     CTA, and independent rows are independent chains on different SMs.
//   * W_h sits in dynamic shared memory at its storage dtype (16 KiB at
//     H=32 in fp32), loaded once per CTA; h (rounded to the compute dtype)
//     and the fp32 cell c stay in shared memory.  Nothing recurrent touches
//     device memory.
//   * blockDim = 4H: one thread per gate column computes that column's
//     h @ W_h in a fixed sequential order over k; after a barrier H threads
//     run the tail of ../../csrc/lstm_cell.cuh, the cell body of the fused
//     stack kernels.  This is their layer-0 cell with the bias already in
//     the stream and no scales.
//   * Every operation is a single IEEE fp32 operation in the order of the
//     plain version (ref.lstm_scan_ref), so the two agree bit for bit and a
//     row's result does not depend on the batch size or the row grouping.
// wgmma, persistent CTAs and CUDA graphs are left for later work.

#include "lstm_cell.cuh"
#include "smem_attr.cuh"

namespace {

struct ScanArgs {
  const float* xw;  // (T, B, 4H) fp32, bias included; unused by lstm_scan_layer
  const void* x;    // lstm_scan_layer: (B, T, IN) compute dtype
  const void* w_x;  // lstm_scan_layer: (IN, 4H) storage dtype
  const float* b;   // lstm_scan_layer: (4H)
  const void* w_h;  // (H, 4H) storage dtype
  const void* h0;   // (B, H) compute dtype
  const float* c0;  // (B, H)
  void* hs;         // (T, B, H) compute dtype
  void* h_f;        // (B, H) compute dtype
  float* c_f;       // (B, H)
  int T, B, H, IN, rows, act;
};

// Byte offsets of the dynamic shared-memory carve-up (IN = 0: no W_x, b).
struct ScanLayout {
  size_t wh, wx, b, h, c, gates, total;
};

__host__ __device__ inline ScanLayout scan_layout(int H, int IN, int rows, int w_bytes) {
  ScanLayout s;
  s.wh = 0;
  s.wx = align16(size_t(H) * 4 * H * w_bytes);
  s.b = s.wx + align16(size_t(IN) * 4 * H * w_bytes);
  s.h = s.b + (IN ? align16(size_t(4) * H * sizeof(float)) : 0);
  s.c = s.h + align16(size_t(rows) * H * sizeof(float));
  s.gates = s.c + align16(size_t(rows) * H * sizeof(float));
  s.total = s.gates + align16(size_t(rows) * 4 * H * sizeof(float));
  return s;
}

// CT: compute dtype of h (and of x); WT: storage dtype of W_h (and W_x).
// kRaw: false = xw streamed in; true = the input product in-kernel.
template <typename CT, typename WT, bool kRaw>
__global__ void __launch_bounds__(1024) lstm_scan_kernel(const ScanArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int H = a.H, H4 = 4 * a.H, R = a.rows, T = a.T, B = a.B, IN = a.IN;
  const ScanLayout lay = scan_layout(H, kRaw ? IN : 0, R, sizeof(WT));
  WT* wh_s = reinterpret_cast<WT*>(smem + lay.wh);
  WT* wx_s = reinterpret_cast<WT*>(smem + lay.wx);
  float* b_s = reinterpret_cast<float*>(smem + lay.b);
  float* h_s = reinterpret_cast<float*>(smem + lay.h);      // [R][H]
  float* c_s = reinterpret_cast<float*>(smem + lay.c);      // [R][H]
  float* g_s = reinterpret_cast<float*>(smem + lay.gates);  // [R][4H]

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * R;
  const int nrows = min(R, B - row0);

  copy_to_smem(wh_s, a.w_h, size_t(H) * H4 * sizeof(WT));
  if (kRaw) {
    copy_to_smem(wx_s, a.w_x, size_t(IN) * H4 * sizeof(WT));
    copy_to_smem(b_s, a.b, size_t(H4) * sizeof(float));
  }
  const CT* h0 = static_cast<const CT*>(a.h0);
  for (int i = tid; i < nrows * H; i += blockDim.x) {
    const size_t g = size_t(row0) * H + i;
    h_s[i] = to_f(h0[g]);
    c_s[i] = a.c0[g];
  }
  __syncthreads();

  const int j = tid;  // the gate column this thread owns in phase 1
  const WT* wh_col = wh_s + j;
  const WT* wx_col = wx_s + j;
  CT* hs = static_cast<CT*>(a.hs);
  for (int t = 0; t < T; ++t) {
    // phase 1: gate pre-activations, one column per thread
    for (int r = 0; r < nrows; ++r) {
      float xw;
      if (kRaw) {  // round_to_compute(x[t] @ W_x) + b, sequential over k
        const CT* x_row = static_cast<const CT*>(a.x) + (size_t(row0 + r) * T + t) * IN;
        float gx = 0.0f;
        for (int k = 0; k < IN; ++k) gx = add(gx, mul(to_f(x_row[k]), to_f(wx_col[k * H4])));
        xw = add(round_to<CT>(gx), b_s[j]);
      } else {
        xw = a.xw[(size_t(t) * B + row0 + r) * H4 + j];
      }
      const float* h_own = h_s + r * H;
      float hh = 0.0f;
      for (int k = 0; k < H; ++k) hh = add(hh, mul(h_own[k], to_f(wh_col[k * H4])));
      g_s[r * H4 + j] = add(xw, hh);
    }
    __syncthreads();
    // phase 2: activations and the fp32 cell, one element per thread
    for (int i = tid; i < nrows * H; i += blockDim.x) {
      const int r = i / H, k = i % H;
      const float h = cell_tail<CT>(g_s + r * H4, H, k, c_s + i, a.act, 0);
      h_s[i] = h;
      hs[(size_t(t) * B + row0 + r) * H + k] = from_f<CT>(h);
    }
    __syncthreads();
  }

  CT* h_f = static_cast<CT*>(a.h_f);
  for (int i = tid; i < nrows * H; i += blockDim.x) {
    const size_t g = size_t(row0) * H + i;
    h_f[g] = from_f<CT>(h_s[i]);
    a.c_f[g] = c_s[i];
  }
}

template <typename CT, typename WT, bool kRaw>
struct Instance {};  // one shared-memory table each

template <typename CT, typename WT, bool kRaw>
cudaError_t launch(const ScanArgs& a, cudaStream_t stream) {
  const size_t smem = scan_layout(a.H, kRaw ? a.IN : 0, a.rows, sizeof(WT)).total;
  auto kernel = lstm_scan_kernel<CT, WT, kRaw>;
  cudaError_t err = set_smem_once<Instance<CT, WT, kRaw>>(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.B + a.rows - 1) / a.rows);
  kernel<<<grid, 4 * a.H, smem, stream>>>(a);
  return cudaGetLastError();
}

template <bool kRaw>
int dispatch(const ScanArgs& a, int compute_dtype, int weight_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (compute_dtype == kF32) {
    if (weight_dtype == kF32) return launch<float, float, kRaw>(a, s);
    if (weight_dtype == kBF16) return launch<float, __nv_bfloat16, kRaw>(a, s);
  } else if (compute_dtype == kBF16) {
    if (weight_dtype == kF32) return launch<__nv_bfloat16, float, kRaw>(a, s);
    if (weight_dtype == kBF16) return launch<__nv_bfloat16, __nv_bfloat16, kRaw>(a, s);
  }
  return cudaErrorInvalidValue;
}

ScanArgs make_args(const void* xw, const void* x, const void* w_x, const void* b,
                   const void* w_h, const void* h0, const void* c0, void* hs,
                   void* h_f, void* c_f, int T, int B, int H, int IN, int rows, int act) {
  ScanArgs a;
  a.xw = static_cast<const float*>(xw);
  a.x = x;
  a.w_x = w_x;
  a.b = static_cast<const float*>(b);
  a.w_h = w_h;
  a.h0 = h0;
  a.c0 = static_cast<const float*>(c0);
  a.hs = hs;
  a.h_f = h_f;
  a.c_f = static_cast<float*>(c_f);
  a.T = T;
  a.B = B;
  a.H = H;
  a.IN = IN;
  a.rows = rows;
  a.act = act;
  return a;
}

}  // namespace

// Each entry returns cudaGetLastError() of its launch (0 on success).
extern "C" int lstm_scan(const void* xw, const void* w_h, const void* h0,
                         const void* c0, void* hs, void* h_f, void* c_f, int T,
                         int B, int H, int rows, int compute_dtype,
                         int weight_dtype, int act, void* stream) {
  const ScanArgs a = make_args(xw, nullptr, nullptr, nullptr, w_h, h0, c0, hs, h_f,
                               c_f, T, B, H, 0, rows, act);
  return dispatch<false>(a, compute_dtype, weight_dtype, stream);
}

extern "C" int lstm_scan_layer(const void* x, const void* w_x, const void* b,
                               const void* w_h, const void* h0, const void* c0,
                               void* hs, void* h_f, void* c_f, int T, int B, int H,
                               int IN, int rows, int compute_dtype, int weight_dtype,
                               int act, void* stream) {
  const ScanArgs a = make_args(nullptr, x, w_x, b, w_h, h0, c0, hs, h_f, c_f, T, B, H,
                               IN, rows, act);
  return dispatch<true>(a, compute_dtype, weight_dtype, stream);
}

// Dynamic shared memory one CTA needs (IN = 0 for lstm_scan).
extern "C" long long lstm_scan_smem_bytes(int H, int IN, int rows, int weight_dtype) {
  const int w_bytes = weight_dtype == kF32 ? 4 : 2;
  return static_cast<long long>(scan_layout(H, IN, rows, w_bytes).total);
}

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
// dependent cells: each needs the previous cell's h, and the bit contract
// (below) makes each gate column an H-long chain of dependent fp32 adds.
// At T=1 and B=1 (a sample pushed into a stream), launch latency and the
// kernel's own set-up.
//
// What the design does about it.
//   * One CTA per block of `rows` batch rows (default 1) runs the whole
//     time loop: the TPU's sequential grid axis becomes a loop inside the
//     CTA, and independent rows are independent chains on different SMs.
//   * Two paths.  In the lstm_scan_layer entry (the one the kernel backend
//     runs) at the hidden widths a config runs (H = 32 and H = 8,
//     gw_nominal's four layers) with IN <= 32, H is a compile-time
//     constant, the warp-cell kernel below:
//       - each thread loads its gate column of W_h and of W_x from device
//         memory straight into fp32 registers (coalesced across a warp; no
//         shared-memory copy, no barrier before the first step);
//       - a warp holds all four gates of 8 elements (lane = 8 * gate +
//         element % 8, K1's map): each lane applies its gate's activation
//         right after its dot product, shuffles bring f, g and o to the
//         lane of gate i, which runs the cell (lstm_cell.cuh's
//         cell_update);
//       - the x . w_x chain has a compile-time length (1, 8 or 32, W_x and
//         the x row zero past IN), so neither chain tests a run-time bound:
//         with a test on every term, the dot product of a step took 410-460
//         cycles at any length (clock stamps on the H100);
//       - h is double-buffered in shared memory, so a step has one
//         barrier; at H = 8, 4H = 32 threads are one warp and a step needs
//         only __syncwarp;
//       - the x rows are staged in
//         chunks of kChunk = 8 steps, loaded into registers a chunk ahead,
//         so a step never waits on device memory (loaded one step ahead,
//         every step waited on a DRAM miss).
//     One lane per element with all four gates in its registers measured
//     slower (1,635-2,377 cycles a step against 1,160-1,380): its four
//     activations do not overlap (each division and tanhf has a branch)
//     and its dot products took 751-1,460 cycles.  Every other shape
//     (gw_small's H = 9, the tests' 16 and 64, IN past 32, and the
//     lstm_scan entry, which no serving path runs) runs the
//     run-time-width kernel: W_h (and W_x) in dynamic shared memory,
//     blockDim = 4H, one gate column per thread, the gates handed over in
//     shared memory and the tail of ../../csrc/lstm_cell.cuh run by H
//     threads, two barriers per step.
//   * Every operation is a single IEEE fp32 operation (__fmul_rn and
//     __fadd_rn never contract into FMAs) in the order of the plain
//     version (ref.lstm_scan_ref, seq_dot's order over k), on both paths,
//     so kernel and plain version agree bit for bit and a row's result
//     does not depend on the batch size, the row grouping or the path.
//     That forbids partial sums: the H-long add chain bounds a step.
// wgmma, persistent CTAs and CUDA graphs are left for later work.

#include "lstm_cell.cuh"
#include "probe.cuh"
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

// ---- the warp-cell path: H at compile time, weights in registers -------

constexpr int kMaxRegIn = 32;  // W_x columns live in registers up to this input width
constexpr int kChunk = 8;      // input steps staged per batch of loads
constexpr int kPrefetch = 8;   // input elements of the next batch a thread holds in registers

// Whether (H, IN) runs the warp-cell kernel (IN = 0: lstm_scan, which
// always runs the run-time-width kernel).
__host__ __device__ inline bool warp_cell(int H, int IN) {
  return (H == 8 || H == 32) && IN >= 1 && IN <= kMaxRegIn;
}

// The compile-time length of the x . w_x chain for an input width: 1, 8 or
// 32 (gw_nominal's layers take IN = 1, 32, 8, 8).  Past IN the x row and
// W_x hold zeros: each adds +0 * +0 = +0 to a sum that is never -0, which
// leaves its bits as they are.
__host__ __device__ inline int in_bucket(int IN) { return IN <= 1 ? 1 : IN <= 8 ? 8 : 32; }

// Floats of one staged x row: its bucket, padded to whole float4s.
__host__ __device__ inline int warp_in_stride(int IN) { return (in_bucket(IN) + 3) & ~3; }

// Byte offsets of the warp-cell kernel's shared memory: h [2][R][H] (two
// buffers), c [R][H], the x rows of kChunk steps [2][kChunk][R][in_stride]
// (two buffers).
struct WarpLayout {
  size_t h, c, in, total;
};

__host__ __device__ inline WarpLayout warp_layout(int H, int IN, int rows) {
  WarpLayout s;
  s.h = 0;
  s.c = align16(size_t(2) * rows * H * sizeof(float));
  s.in = s.c + align16(size_t(rows) * H * sizeof(float));
  s.total = s.in + align16(size_t(2) * kChunk * rows * warp_in_stride(IN) * sizeof(float));
  return s;
}

template <int kN>
__device__ __forceinline__ void load_row(const float* v, float (&r)[kN]) {
  if constexpr (kN < 4) {
#pragma unroll
    for (int k = 0; k < kN; ++k) r[k] = v[k];
  } else {
#pragma unroll
    for (int k = 0; k < kN; k += 4) {
      const float4 q = *reinterpret_cast<const float4*>(v + k);
      r[k] = q.x;
      r[k + 1] = q.y;
      r[k + 2] = q.z;
      r[k + 3] = q.w;
    }
  }
}

// CT, WT as in lstm_scan_kernel (the lstm_scan_layer entry: x in, the
// input product in-kernel); kH: the hidden width (8 or 32); kIN: the x
// chain's length (in_bucket(IN)).
template <typename CT, typename WT, int kH, int kIN>
__global__ void __launch_bounds__(4 * kH) lstm_scan_warp_kernel(const ScanArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int H4 = 4 * kH;
  constexpr int kLen = kIN > kH ? kIN : kH;        // interleaved dot length
  const int R = a.rows, T = a.T, B = a.B, IN = a.IN;
  const int in_ld = warp_in_stride(IN);
  const WarpLayout lay = warp_layout(kH, IN, R);
  float* h_s = reinterpret_cast<float*>(smem + lay.h);    // [2][R][H]
  float* c_s = reinterpret_cast<float*>(smem + lay.c);    // [R][H]
  float* in_s = reinterpret_cast<float*>(smem + lay.in);  // [2][kChunk][R][in_ld]

  const int tid = threadIdx.x, lane = tid & 31;
  const int kq = (tid >> 5) * 8 + (lane & 7);  // the element of this lane's gate
  const int gate = lane >> 3;
  const int j = gate * kH + kq;                 // the gate column it owns
  const int row0 = blockIdx.x * R;
  const int nrows = min(R, B - row0);
  // clock stamps (-DKERNEL_PROBE builds only): thread 0 of CTA 0, the
  // kernel's start and end, and each of the first 200 steps' phases
  [[maybe_unused]] const bool stamps = blockIdx.x == 0 && tid == 0;
#define STEP_STAMP(k) PROBE(stamps && t < 200, t * 8 + (k))
  PROBE(stamps, 60002);
  PROBE_NS(stamps, 60003);

  float whr[kH], wxr[kIN];
  const WT* gh = static_cast<const WT*>(a.w_h) + j;
#pragma unroll
  for (int k = 0; k < kH; ++k) whr[k] = to_f(gh[size_t(k) * H4]);
  const WT* gx = static_cast<const WT*>(a.w_x) + j;
#pragma unroll
  for (int k = 0; k < kIN; ++k) wxr[k] = k < IN ? to_f(gx[size_t(k) * H4]) : 0.0f;
  const float bias = a.b[j];

  const size_t hbuf = size_t(R) * kH;              // floats of one h buffer
  const size_t ibuf = size_t(kChunk) * R * in_ld;   // floats of one input buffer
  const int per_step = nrows * IN;                  // input elements of one step
  const int per_chunk = kChunk * per_step;
  const CT* h0 = static_cast<const CT*>(a.h0);
  for (int i = tid; i < nrows * kH; i += H4) {
    const size_t g = size_t(row0) * kH + i;
    h_s[i] = to_f(h0[g]);
    c_s[i] = a.c0[g];
  }
  // the x rows' padding past IN reads +0 (staging never writes it)
  for (int i = tid; i < 2 * kChunk * R * (in_ld - IN); i += H4) {
    const int row = i / (in_ld - IN);
    in_s[row * in_ld + IN + i % (in_ld - IN)] = 0.0f;
  }
  // element i of input chunk c (steps c * kChunk ...): its step, its value,
  // and where it is staged
  auto step_of = [&](int c, int i) { return c * kChunk + i / per_step; };
  auto load_in = [&](int c, int i) -> float {
    const int u = i / per_step, rem = i - u * per_step;
    const int r = rem / IN, e = rem - r * IN, t = c * kChunk + u;
    return to_f(static_cast<const CT*>(a.x)[(size_t(row0 + r) * T + t) * IN + e]);
  };
  auto slot = [&](int i) {
    const int u = i / per_step, rem = i - u * per_step;
    return (u * R + rem / IN) * in_ld + rem % IN;
  };
  for (int i = tid; i < per_chunk; i += H4) {
    if (step_of(0, i) < T) in_s[slot(i)] = load_in(0, i);
  }
  if constexpr (kH == 8) __syncwarp(); else __syncthreads();

  // the next chunk's input is loaded into registers at the first step of a
  // chunk and stored to the other buffer at its last: kChunk steps to land
  float pf[kPrefetch];
  CT* hs = static_cast<CT*>(a.hs);
  for (int t = 0; t < T; ++t) {
    const int ck = t / kChunk, u = t - ck * kChunk;
    const bool more = (ck + 1) * kChunk < T;
    STEP_STAMP(0);
    const float* h_rd = h_s + (t & 1) * hbuf;
    float* h_wr = h_s + ((t + 1) & 1) * hbuf;
    const float* in_rd = in_s + (ck & 1) * ibuf + size_t(u) * R * in_ld;
    if (u == 0 && more) {
#pragma unroll
      for (int n = 0; n < kPrefetch; ++n) {
        const int i = tid + n * H4;
        pf[n] = i < per_chunk && step_of(ck + 1, i) < T ? load_in(ck + 1, i) : 0.0f;
      }
    }

    for (int r = 0; r < nrows; ++r) {
      float hv[kH];
      load_row<kH>(h_rd + r * kH, hv);
      // round(x . w_x) + b, then + h . w_h: two chains in seq_dot's order,
      // interleaved so that one hides the other's latency
      float xv[kIN];
      load_row<kIN>(in_rd + r * in_ld, xv);
      float ax = 0.0f, ah = 0.0f;
#pragma unroll
      for (int k = 0; k < kLen; ++k) {
        if (k < kIN) ax = add(ax, mul(xv[k < kIN ? k : 0], wxr[k < kIN ? k : 0]));
        if (k < kH) ah = add(ah, mul(hv[k < kH ? k : 0], whr[k < kH ? k : 0]));
      }
      const float pre = add(add(round_to<CT>(ax), bias), ah);
      STEP_STAMP(1);
      const float act = gate_act(pre, gate, a.act);
      STEP_STAMP(2);
      const float fg = __shfl_sync(0xffffffffu, act, (lane & 7) + 8);
      const float gg = __shfl_sync(0xffffffffu, act, (lane & 7) + 16);
      const float og = __shfl_sync(0xffffffffu, act, (lane & 7) + 24);
      STEP_STAMP(3);
      if (gate == 0) {
        float c = c_s[r * kH + kq];
        const float h = cell_update<CT>(act, fg, gg, og, &c, a.act, 0);
        c_s[r * kH + kq] = c;
        h_wr[r * kH + kq] = h;
        hs[(size_t(t) * B + row0 + r) * kH + kq] = from_f<CT>(h);
        STEP_STAMP(4);
      }
    }
    if (u == kChunk - 1 && more) {  // chunk ck - 1's buffer: last read in step t - kChunk
      float* in_wr = in_s + ((ck + 1) & 1) * ibuf;
#pragma unroll
      for (int n = 0; n < kPrefetch; ++n) {
        const int i = tid + n * H4;
        if (i < per_chunk && step_of(ck + 1, i) < T) in_wr[slot(i)] = pf[n];
      }
      for (int i = tid + kPrefetch * H4; i < per_chunk; i += H4) {
        if (step_of(ck + 1, i) < T) in_wr[slot(i)] = load_in(ck + 1, i);
      }
    }
    if constexpr (kH == 8) __syncwarp(); else __syncthreads();
    STEP_STAMP(5);
  }
#undef STEP_STAMP
  PROBE(stamps, 60000);
  PROBE_NS(stamps, 60001);

  // the last step wrote h to buffer T & 1
  CT* h_f = static_cast<CT*>(a.h_f);
  for (int i = tid; i < nrows * kH; i += H4) {
    const size_t g = size_t(row0) * kH + i;
    h_f[g] = from_f<CT>(h_s[(T & 1) * hbuf + i]);
    a.c_f[g] = c_s[i];
  }
}

// ---- launch ---------------------------------------------------------------

template <typename CT, typename WT, bool kRaw, int kH, int kIN>
struct Instance {};  // one shared-memory table each (kH = 0: the run-time width)

// Dynamic shared memory of the kernel that (H, IN) runs.
inline size_t smem_bytes(int H, int IN, int rows, int w_bytes) {
  return warp_cell(H, IN) ? warp_layout(H, IN, rows).total
                          : scan_layout(H, IN, rows, w_bytes).total;
}

// kH > 0: the warp-cell kernel, which only lstm_scan_layer (kRaw) runs.
template <typename CT, typename WT, bool kRaw, int kH, int kIN>
cudaError_t launch(const ScanArgs& a, cudaStream_t stream) {
  const int IN = kRaw ? a.IN : 0;
  const size_t smem = smem_bytes(a.H, IN, a.rows, sizeof(WT));
  const dim3 grid((a.B + a.rows - 1) / a.rows);
  if constexpr (kH > 0) {
    static_assert(kRaw, "the warp-cell kernel takes x, not xw");
    auto kernel = lstm_scan_warp_kernel<CT, WT, kH, kIN>;
    cudaError_t err = set_smem_once<Instance<CT, WT, kRaw, kH, kIN>>(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, 4 * kH, smem, stream>>>(a);
  } else {
    auto kernel = lstm_scan_kernel<CT, WT, kRaw>;
    cudaError_t err = set_smem_once<Instance<CT, WT, kRaw, 0, 0>>(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, 4 * a.H, smem, stream>>>(a);
  }
  return cudaGetLastError();
}

template <typename CT, typename WT, int kH>
cudaError_t by_input(const ScanArgs& a, cudaStream_t s) {
  const int b = in_bucket(a.IN);
  if (b == 1) return launch<CT, WT, true, kH, 1>(a, s);
  if (b == 8) return launch<CT, WT, true, kH, 8>(a, s);
  return launch<CT, WT, true, kH, 32>(a, s);
}

template <typename CT, typename WT, bool kRaw>
cudaError_t by_width(const ScanArgs& a, cudaStream_t s) {
  if constexpr (kRaw) {
    if (warp_cell(a.H, a.IN)) {
      return a.H == 8 ? by_input<CT, WT, 8>(a, s) : by_input<CT, WT, 32>(a, s);
    }
  }
  return launch<CT, WT, kRaw, 0, 0>(a, s);
}

template <bool kRaw>
int dispatch(const ScanArgs& a, int compute_dtype, int weight_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.H < 1 || 4 * a.H > 1024 || a.rows < 1 || (kRaw && a.IN < 1)) {
    return cudaErrorInvalidValue;
  }
  if (compute_dtype == kF32) {
    if (weight_dtype == kF32) return by_width<float, float, kRaw>(a, s);
    if (weight_dtype == kBF16) return by_width<float, __nv_bfloat16, kRaw>(a, s);
  } else if (compute_dtype == kBF16) {
    if (weight_dtype == kF32) return by_width<__nv_bfloat16, float, kRaw>(a, s);
    if (weight_dtype == kBF16) return by_width<__nv_bfloat16, __nv_bfloat16, kRaw>(a, s);
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
  return static_cast<long long>(smem_bytes(H, IN, rows, weight_dtype == kF32 ? 4 : 2));
}

// 1 where (H, IN) runs the warp-cell kernel (H at compile time, weights in
// registers), 0 where it runs the run-time-width kernel (IN = 0 for
// lstm_scan).
extern "C" int lstm_scan_warp_cell(int H, int IN) { return warp_cell(H, IN); }

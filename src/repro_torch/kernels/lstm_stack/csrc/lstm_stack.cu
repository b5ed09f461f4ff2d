// Fused L-layer LSTM stack kernels for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of the reference package:
//   * lstm_stack_wavefront  <- repro/kernels/lstm_stack/lstm_stack.py
//     `lstm_stack` (body `_lstm_stack_kernel`): the window-scale kernel.
//     Layer 0's gate stream xw0 = x @ W_x[0] (+ scales, + bias) arrives
//     precomputed, time-major (T, B, 4W), with a time stride of B * 4W, or
//     of 0 where one (B, 4W) block repeats over the window (the decoder's
//     RepeatVector input: every step reads the same rows).
//   * lstm_stack_step       <- repro/kernels/lstm_stack/step.py
//     `lstm_stack_step` (body `_lstm_stack_step_kernel`): the chunk-scale
//     kernel.  It takes the raw chunk (B, T, W) and computes layer 0's
//     projection in-kernel, rounded to the compute dtype as the reference's
//     hoisted `(x @ W_x[0]).astype(f32)` is.
// Both are one template (kStep) over one shared cell body
// (../../csrc/lstm_cell.cuh, shared with the per-layer lstm_scan kernel)
// and differ only in where layer 0's gate input comes from.
//
// What bounds them on this card.  At the GW nominal shapes (L=2, W=32,
// T=100, B <= 64) a call moves a few MB and does ~0.2 GFLOP: the bytes and
// FLOP bounds are a few microseconds.  The kernels are bound instead by
// the dependency chain of the recurrence: every step needs the previous
// step's h, and each gate column is a W-long chain of dependent fp32 adds
// (the order the bit-for-bit contract fixes), then a barrier, the
// transcendental, the cell and a barrier.  At B=1 and T=1, launch latency.
//
// What the design does about it.
//   * A wavefront across layers, as the TPU kernel runs it: at step s,
//     layer l computes timestep t = s - l, and every layer with t in
//     [0, T) runs in the same phase.  Each layer's h is double-buffered in
//     shared memory: step s reads buffer s & 1 (h of every layer after step
//     s - 1) and writes buffer (s + 1) & 1, which is the TPU kernel's
//     reverse-order layer loop as a ping-pong.  T + L - 1 steps, where a
//     time loop with the layers inside took T * L (of two barriers each).
//     blockDim is L * 4W (256 at L=2, W=32); where that exceeds 1024,
//     groups of layers take turns inside a step, on the same buffers, so
//     the bits do not change.
//   * Two paths.  At W = 32 while L * 4W <= 256 (gw_nominal's encoder and
//     decoder packs: L = 2, W = 32) W is a compile-time constant, the k
//     loops unroll, and each thread keeps the W_x and W_h columns of its
//     gate column in registers as fp32 (2W values), loaded once, and loads
//     the h rows it needs into registers before each dot product.  Every
//     other shape (gw_small's W = 9 at a small batch, more layers) runs at
//     run-time width with the packed weights in shared memory: the same
//     operations in the same order.  h is read by broadcast from shared
//     memory.  (A third, the row-thread path, is below.)
//   * The thread that owns a gate column applies that gate's activation
//     right after its dot product (sigma for i, f, o; tanh for g).  On the
//     register path a warp holds all four gates of 8 elements (lane =
//     8 * gate + element % 8): shuffles bring f, g and o to the lane of
//     gate i, which does only c = f*c + i*g, tanh(c), the fake-quant and
//     the rounding, so a step has one barrier (h visible to every layer).
//     The run-time-width path hands the gates over in shared memory: two
//     barriers per step.
//   * Layer 0's input of step s + 1 (a row of xw0, or of the raw chunk) is
//     copied at the start of step s into a double-buffered shared row,
//     by cp.async for fp32 rows (through registers for bf16 chunks), and
//     waited for before the step's last barrier: off the critical path.
//   * One CTA per block of `rows` batch rows (default 1); the weights, b,
//     the scales and every layer's h and c stay on chip for the whole call.
//     An explicit `rows` > 1 runs the CTA's rows one after another inside
//     a step: each row's chain, shuffles and cell finish before the next
//     row's start, so the step takes `rows` times as long.
//   * Row blocking (wavefront kernel, register path; kRows = kBlockedRows = 8).
//     At a large
//     batch the one-row CTAs are bound by occupancy times latency: with 64
//     weights and two whole h rows per thread in registers (137 registers by
//     ptxas) an SM holds one of them (8 warps), and each step waits on its own
//     W-long add chain, transcendentals, shuffles and barrier while most issue
//     slots stay empty.  The blocked instantiation runs kRows rows per CTA
//     with every thread carrying all of them through each step: the thread's
//     W_x and W_h columns in registers serve every row, the k loop is
//     outermost with the rows inside it (kRows independent x and h chains,
//     each row's h and x read four floats at a time by broadcast), so the
//     chains' latencies overlap.  Each chain keeps its own order, so every
//     row's bits are those of the one-row launch.  The pre-activations meet in
//     shared memory, where the lanes of gate g take the four gates of rows g,
//     g + 4, ... and run their activations and cells (no shuffles, and no lane
//     runs sigma while its neighbour runs tanh); one barrier a step serves all
//     rows.  Layer 0's stream rows of the next step, contiguous in (T, B, 4W),
//     arrive as one copy of kRows * 4W floats by 16-byte cp.async.cg.
//     __launch_bounds__ asks for two 256-thread CTAs (16 warps) per SM (128
//     registers, no spills; an SM holds three of the 160-thread CTAs below).
//     The last CTA's rows past B are computed on zeros
//     and never stored.  The wrapper launches it above one wave of one-row
//     CTAs (`kernel_path` in lstm_stack.py); the step kernel, whose
//     batches are small, has no blocked instantiation.
//   * The layers' own widths (row-blocked path).  A pack pads every layer to
//     W = 32, so gw_nominal's 32-8-8-32 stack does 12,288 multiply-adds a
//     row-step where its widths need 5,376.  Given each layer's real input
//     and hidden width (Args::warps, x_len, h_len; the wrapper passes a
//     pack's), the kTrim instantiation runs only the warps that hold real
//     elements (ceil(h_l / 8) for layer l: 160 threads at both nominal
//     segments, three CTAs an SM where 256 took two), and each chain ends
//     at its layer's width rounded up to 4 (the x chain of layer l >= 1 at
//     in_l, the h chain at h_l): the k loops stay unrolled to 32, each group
//     of 4 terms behind a warp-uniform test, so the weights stay in
//     registers.  The dropped terms are a trailing run of products of the
//     pack's zero rows with finite h, each +0 or -0, and a chain from +0 is
//     never -0 (in round to nearest a sum is -0 only if both addends are),
//     so adding them changed nothing: every real output keeps its bits,
//     whatever the state holds at its padded positions.  Where it holds +0
//     there (a zero state, or one packed from the real widths) the padded
//     elements stay +0 under every activation set (sigma(0) * tanh(0) from
//     c = +0): the skipped warps' h and c keep the state in shared memory,
//     and the last layer's warps write +0 into hs for its padded elements,
//     so whole tensors equal the padded launch's.  (A state with other
//     values there keeps them in h_f and c_f, at positions every caller
//     slices away.)
//   * Every operation is a single IEEE fp32 operation (__fmul_rn and
//     __fadd_rn never contract into FMAs) in the order of the plain
//     PyTorch versions (ref.py, step.py), so kernel and plain version agree
//     bit for bit; a row's result does not depend on the batch size, on how
//     rows are grouped into CTAs, or on which path a width takes.
//   * cudaFuncSetAttribute runs once per instantiation and size
//     (smem_attr.cuh), not on every launch.
//   * fuse_gates (step kernel only, the reference's single [x ; h] @
//     [W_x ; W_h] product): each gate's sum is one 2W-long chain over x
//     then h, then + b; layer 0's sum is not rounded to the compute dtype.
//     Refused with int8 scales.  Off by default: one 2W chain is longer
//     than two W chains run side by side, and only separate chains keep a
//     T=1 step bit-equal to the wavefront kernel.
//   * The row-thread path (wavefront kernel, `lstm_stack_kernel_row_thread`,
//     gw_small's W = 9 at a large batch).  One row a CTA at that width is 4W
//     = 36 threads (two warps, the second with 4 live lanes), an SM holds at
//     most 32 CTAs, and each step reads every weight through a run-time W
//     loop, divides by run-time values and crosses two barriers: 30.0 ms a
//     launch at 294,912 rows, 18.8x its byte bound.  Here one thread owns
//     one batch row and runs, for each t and inside it each layer l, the
//     layer's gate sums element by element (the four gates' chains over k
//     side by side, each in dot_flat's order), the tail and cell_update, so
//     a row's bits are the one-row launch's.  No thread reads another's h,
//     so the time loop has no barrier.  W and the activation set are
//     compile-time constants: the row's h, c, the layer below's h and the
//     gates stay in registers (each layer's h and c between steps in shared
//     memory, [l][k][thread], conflict-free), and every sigma and tanh is
//     straight-line code that the scheduler interleaves across elements (a
//     run-time set branches around each one: 3.58 against 2.77 ms).  The
//     weights, widened to fp32 once per CTA, sit in shared memory
//     element-major, so the four gates of (k, e) are one broadcast float4.
//     Each warp stages its 32 rows of step t + 1 of layer 0's stream (one
//     contiguous run) by 16-byte cp.async while step t computes, rows padded
//     to an odd number of 16-byte groups so that each lane's float4 reads of
//     its own row hit distinct banks (a stream of time stride 0 is staged
//     once), and writes hs through a [32][W] tile, 32 consecutive elements a
//     store.  What bounds it now is latency: a lone warp takes ~3.5 us a
//     step, and an SM holds 16 warps (128 registers, 26 KB of shared memory
//     a 64-row CTA); at 294,912 rows it takes 2.8 ms against 1.6 ms of bytes.
//     The wrapper takes the path by shape and batch (`row_thread` in
//     lstm_stack.py); `blockDim` is its rows a CTA.
// wgmma and TMA are left out: the products are (rows x W) . (W x 4W) per
// step, a few hundred multiply-adds per thread on the critical path.

#include "lstm_cell.cuh"
#include "smem_attr.cuh"

namespace {

constexpr int kMaxThreads = 1024;  // per CTA, weights in shared memory
constexpr int kRegThreads = 256;   // per CTA, weights and h in registers (<= 255 each)
constexpr int kPrefetch = 2;       // bf16 layer-0 inputs of the next step a thread loads ahead

constexpr int kRegW = 32;          // the width whose weights live in registers
// the wavefront kernel's paths (Args::path): one row a CTA (or an explicit
// block of rows one after another), the row-blocked instantiation, one row a
// thread
enum Path { kOneRow = 0, kBlocked = 1, kRowThread = 2 };
constexpr int kRowThreadMax = 128;  // rows (threads) of one row-thread CTA, at most
// rows every thread of the row-blocked wavefront kernel carries through a
// step (BLOCKED_ROWS in lstm_stack.py)
constexpr int kBlockedRows = 8;
// layers of the register path at most (L * 4W <= kRegThreads at W = kRegW):
// the length of Args' per-layer geometry
constexpr int kRegLayers = kRegThreads / (4 * kRegW);

struct Args {
  const void* x;        // wavefront: xw0 (T, B, 4W) fp32; step: xs (B, T, W) compute dtype
  const void* w_x;      // (L, W, 4W) storage dtype
  const void* w_h;      // (L, W, 4W) storage dtype
  const float* b;       // (L, 4W)
  const float* scales;  // (L, 2, 4) per-gate [s_x, s_h]; nullptr = all ones
  const void* h0;       // (L, B, W) compute dtype
  const float* c0;      // (L, B, W)
  void* hs;             // wavefront: (T, B, W); step: (B, T, W); compute dtype
  void* h_f;            // (L, B, W) compute dtype
  float* c_f;           // (L, B, W)
  int T, B, L, W, rows, act, act_bits;
  int fuse;             // step only: each gate's sum one 2W-long chain over [x; h]
  int path;             // wavefront only: kOneRow, kBlocked (kRows = rows) or kRowThread
  long long x_tstride;  // wavefront only: floats between timesteps of xw0, B * 4W or 0
  // row-blocked path at the layers' own widths (trim): layer l's warps
  // (those of its real elements) and the lengths of its x and h chains
  // (multiples of 4); W / 8 and W at the padded geometry
  bool trim;
  int warps[kRegLayers], x_len[kRegLayers], h_len[kRegLayers];
};

// Whether a thread's columns of W_x and W_h live in registers (the width the
// GW configs pack to, all layers at once) or in shared memory.
__host__ __device__ inline bool in_regs(int L, int W) {
  return W == kRegW && L * 4 * W <= kRegThreads;
}

// Layers whose threads run at once: all L, or as many as a CTA holds (the
// others take turns inside each step).
__host__ __device__ inline int layers_at_once(int L, int W) {
  const int cap = (in_regs(L, W) ? kRegThreads : kMaxThreads) / (4 * W);
  return L < cap ? L : cap;
}

// Byte offsets of the dynamic shared-memory carve-up.
struct Layout {
  size_t wx, wh, b, scales, h, c, gates, in, total;
};

__host__ __device__ inline Layout smem_layout(int L, int W, int rows, int w_bytes, bool step) {
  Layout s;
  const size_t W4 = 4 * size_t(W);
  const size_t w = in_regs(L, W) ? 0 : align16(size_t(L) * W * W4 * w_bytes);
  s.wx = 0;
  s.wh = w;
  s.b = 2 * w;
  s.scales = s.b + align16(size_t(L) * W4 * sizeof(float));
  s.h = s.scales + align16(size_t(L) * 8 * sizeof(float));
  s.c = s.h + align16(2 * size_t(L) * rows * W * sizeof(float));     // two buffers
  s.gates = s.c + align16(size_t(L) * rows * W * sizeof(float));
  s.in = s.gates + align16(size_t(L) * rows * W4 * sizeof(float));
  s.total = s.in + align16(2 * size_t(rows) * (step ? W : W4) * sizeof(float));  // two buffers
  return s;
}

// sum_k h[k] * w[k], sequential over k, one rounded multiply and one
// rounded add per term (the plain versions' seq_dot).  h is a shared row
// of fp32, read by broadcast.  dot2_regs runs two such sums (x . w_x and
// h . w_h) interleaved: two independent chains, each in its own order, so
// that one hides the other's latency.  The register forms load every
// element of the shared row(s) first, 16 bytes at a time, so that the
// loads overlap one another and the add chain never waits on one.
template <int kW>
__device__ __forceinline__ void load_row(const float* h, float (&v)[kW]) {
#pragma unroll
  for (int k = 0; k < kW; k += 4) {
    const float4 q = *reinterpret_cast<const float4*>(h + k);
    v[k] = q.x;
    v[k + 1] = q.y;
    v[k + 2] = q.z;
    v[k + 3] = q.w;
  }
}

template <int kW>
__device__ __forceinline__ float dot_regs(const float* h, const float (&w)[kW]) {
  float hv[kW];
  load_row<kW>(h, hv);
  float acc = 0.0f;
#pragma unroll
  for (int k = 0; k < kW; ++k) acc = add(acc, mul(hv[k], w[k]));
  return acc;
}

template <int kW>
__device__ __forceinline__ void dot2_regs(const float* x, const float (&wx)[kW], const float* h,
                                          const float (&wh)[kW], float& gx, float& hh) {
  float xv[kW], hv[kW];
  load_row<kW>(x, xv);
  load_row<kW>(h, hv);
  float ax = 0.0f, ah = 0.0f;
#pragma unroll
  for (int k = 0; k < kW; ++k) {
    ax = add(ax, mul(xv[k], wx[k]));
    ah = add(ah, mul(hv[k], wh[k]));
  }
  gx = ax;
  hh = ah;
}

// fuse_gates: one chain over [x; h] . [w_x; w_h], the x terms first.
template <int kW>
__device__ __forceinline__ float dotcat_regs(const float* x, const float (&wx)[kW],
                                             const float* h, const float (&wh)[kW]) {
  float xv[kW], hv[kW];
  load_row<kW>(x, xv);
  load_row<kW>(h, hv);
  float acc = 0.0f;
#pragma unroll
  for (int k = 0; k < kW; ++k) acc = add(acc, mul(xv[k], wx[k]));
#pragma unroll
  for (int k = 0; k < kW; ++k) acc = add(acc, mul(hv[k], wh[k]));
  return acc;
}

// The sums of kRows rows with one thread's column over k < n (n a
// multiple of 4, at most kW; the row-blocked path's layer width), k
// outermost, the rows inside, each row's chain in dot_regs's order (from
// 0, one rounded multiply and one rounded add per term, k ascending), so
// each row's bits are dot_regs's wherever the terms from n on are +0.  Row
// r starts at v + r * kW; each row is read four floats at a time by
// broadcast.  dot2_rows runs x . w_x over k < nx and h . w_h over k < nh
// the same way, 2 * kRows independent chains.  The k loop stays unrolled
// (w's indices are compile-time, so w stays in registers), and with kTrim
// each group of four terms runs behind a test of n, uniform across the
// warp.  Those tests cost a launch at the padded geometry 4% (13.56 against
// 13.03 ms at B = 73,728 on the H100), so it runs the instantiation
// without them (kTrim false, n = kW); a second copy of the loop inside one
// instantiation spilled registers and slowed the trimmed launches by 3-5%.
template <int kW, int kRows>
__device__ __forceinline__ void rows_terms(const float* v, const float (&w)[kW], int k,
                                           float (&acc)[kRows]) {
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const float4 q = *reinterpret_cast<const float4*>(v + r * kW + k);
    acc[r] = add(acc[r], mul(q.x, w[k]));
    acc[r] = add(acc[r], mul(q.y, w[k + 1]));
    acc[r] = add(acc[r], mul(q.z, w[k + 2]));
    acc[r] = add(acc[r], mul(q.w, w[k + 3]));
  }
}

template <int kW, int kRows, bool kTrim>
__device__ __forceinline__ void dot_rows(const float* v, const float (&w)[kW], int n,
                                         float (&acc)[kRows]) {
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0.0f;
#pragma unroll
  for (int k = 0; k < kW; k += 4) {
    if (!kTrim || k < n) rows_terms<kW, kRows>(v, w, k, acc);
  }
}

template <int kW, int kRows, bool kTrim>
__device__ __forceinline__ void dot2_rows(const float* x, const float (&wx)[kW], int nx,
                                          const float* h, const float (&wh)[kW], int nh,
                                          float (&gx)[kRows], float (&hh)[kRows]) {
#pragma unroll
  for (int r = 0; r < kRows; ++r) gx[r] = hh[r] = 0.0f;
#pragma unroll
  for (int k = 0; k < kW; k += 4) {
    if (!kTrim || k < nx) rows_terms<kW, kRows>(x, wx, k, gx);
    if (!kTrim || k < nh) rows_terms<kW, kRows>(h, wh, k, hh);
  }
}

// continues the chain `acc` (0 starts one)
template <typename WT>
__device__ __forceinline__ float dot_flat(const float* h, const WT* col, int W, int W4,
                                          float acc = 0.0f) {
  for (int k = 0; k < W; ++k) acc = add(acc, mul(h[k], to_f(col[size_t(k) * W4])));
  return acc;
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Column j of layer l's W_h dotted with the shared row h (hh), and, where
// x is given, column j of W_x with x (gx).
template <typename WT, int kW, int kR>
__device__ __forceinline__ void col_dots(const float* x, const float (&wxr)[kR], const WT* wx_s,
                                         const float* h, const float (&whr)[kR], const WT* wh_s,
                                         int l, int j, int W, float& gx, float& hh) {
  if constexpr (kW > 0) {
    if (x != nullptr) {
      dot2_regs<kW>(x, wxr, h, whr, gx, hh);
    } else {
      hh = dot_regs<kW>(h, whr);
    }
  } else {
    const size_t col = size_t(l) * W * 4 * W + j;
    hh = dot_flat(h, wh_s + col, W, 4 * W);
    if (x != nullptr) gx = dot_flat(x, wx_s + col, W, 4 * W);
  }
}

// CT: compute dtype of h and of the step kernel's input (float or bf16).
// WT: weight storage dtype (float, bf16 or int8 codes).
// kStep: false = wavefront kernel (xw0 input), true = step kernel (raw chunk).
// kW: kRegW (weights in registers, W at compile time) or 0 (weights in
// shared memory, W at run time).
// kRows: 1 (a.rows rows per CTA, one after another), or kBlockedRows, the
// rows every thread carries through each step (wavefront kernel, register
// path).
// kTrim (row-blocked only): the layers' real widths in Args (warps, x_len,
// h_len) set the warps and the chains; false runs the padded geometry.
template <typename CT, typename WT, bool kStep, int kW, int kRows, bool kTrim = false>
__global__ void __launch_bounds__(kW > 0 ? kRegThreads : kMaxThreads, kRows > 1 ? 2 : 1)
lstm_stack_kernel(const Args a) {
  static_assert(kRows == 1 || (kW > 0 && !kStep), "row blocking: wavefront, register path");
  static_assert(!kTrim || kRows > 1, "the layers' own widths: row-blocked path only");
  extern __shared__ __align__(16) unsigned char smem[];
  const int L = a.L, W = kW > 0 ? kW : a.W, W4 = 4 * W, T = a.T, B = a.B;
  const int R = kRows > 1 ? kRows : a.rows;
  const int IN = kStep ? W : W4;  // layer 0's input per row and step
  // fp32 input rows are copied by cp.async, 4 bytes per element
  constexpr bool kAsyncIn = !kStep || sizeof(CT) == 4;
  const Layout lay = smem_layout(L, W, R, sizeof(WT), kStep);
  WT* wx_s = reinterpret_cast<WT*>(smem + lay.wx);
  WT* wh_s = reinterpret_cast<WT*>(smem + lay.wh);
  float* b_s = reinterpret_cast<float*>(smem + lay.b);
  float* sc_s = reinterpret_cast<float*>(smem + lay.scales);
  float* h_s = reinterpret_cast<float*>(smem + lay.h);      // [2][L][R][W]
  float* c_s = reinterpret_cast<float*>(smem + lay.c);      // [L][R][W]
  float* g_s = reinterpret_cast<float*>(smem + lay.gates);  // [L][R][4W], activated
  float* in_s = reinterpret_cast<float*>(smem + lay.in);    // [2][R][IN]

  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int row0 = blockIdx.x * R;
  const int nrows = min(R, B - row0);
  const int nl = nthreads / W4;  // layers whose threads run at once
  // this thread's (first) layer, and its warp within the layer: 4W / 32
  // warps a layer, but at the layers' own widths a.warps[l] (those of the
  // layer's real elements, uniform across each warp)
  int lt = tid / W4, wl = (tid - lt * W4) >> 5;
  if constexpr (kTrim) {
    lt = 0;
    wl = tid >> 5;
    while (wl >= a.warps[lt]) wl -= a.warps[lt++];
  }
  // the gate column j this thread owns.  On the register path a warp
  // holds all four gates of 8 elements: lane = 8 * gate + element % 8, so
  // the gates of one element meet by shuffles; at run-time widths column j
  // is thread j of the layer and the gates meet in shared memory
  constexpr bool kWarpCell = kW > 0;
  const int lane = tid & 31;
  const int kq = kWarpCell ? wl * 8 + (lane & 7) : 0;  // element
  const int gate = kWarpCell ? lane >> 3 : (tid - lt * W4) / W;
  const int j = kWarpCell ? gate * W + kq : tid - lt * W4;

  // weights: registers (the one layer of this thread), or shared memory
  constexpr int kR = kW > 0 ? kW : 1;
  float wxr[kR], whr[kR];
  if constexpr (kW > 0) {
    const WT* gx = static_cast<const WT*>(a.w_x) + size_t(lt) * W * W4 + j;
    const WT* gh = static_cast<const WT*>(a.w_h) + size_t(lt) * W * W4 + j;
#pragma unroll
    for (int k = 0; k < kW; ++k) {
      wxr[k] = to_f(gx[size_t(k) * W4]);
      whr[k] = to_f(gh[size_t(k) * W4]);
    }
  } else {
    const size_t w_bytes = size_t(L) * W * W4 * sizeof(WT);
    copy_to_smem(wx_s, a.w_x, w_bytes);
    copy_to_smem(wh_s, a.w_h, w_bytes);
  }
  copy_to_smem(b_s, a.b, size_t(L) * W4 * sizeof(float));
  if (a.scales != nullptr) {
    copy_to_smem(sc_s, a.scales, size_t(L) * 8 * sizeof(float));
  } else {  // unquantized packs: x * 1.0f is exact, one code path for all
    for (int i = tid; i < L * 8; i += nthreads) sc_s[i] = 1.0f;
  }
  const size_t hbuf = size_t(L) * R * W;  // floats of one h buffer
  const CT* h0 = static_cast<const CT*>(a.h0);
  for (int i = tid; i < L * R * W; i += nthreads) {
    const int l = i / (R * W), r = (i / W) % R, k = i % W;
    const size_t g = (size_t(l) * B + row0 + r) * W + k;
    const size_t o = (size_t(l) * R + r) * W + k;
    // a layer reads h0 until its first step; rows past B hold zeros
    h_s[o] = h_s[hbuf + o] = r < nrows ? to_f(h0[g]) : 0.0f;
    c_s[o] = r < nrows ? a.c0[g] : 0.0f;
  }
  // layer 0's input of timestep t, element i of the CTA's rows: at
  // in_off(i) + t * in_step
  const size_t in_step = kStep ? size_t(W) : size_t(a.x_tstride);
  auto in_off = [&](int i) -> size_t {
    const int r = i / IN, e = i - r * IN;
    return kStep ? size_t(row0 + r) * T * W + e : size_t(row0 + r) * W4 + e;
  };
  auto load_at = [&](size_t off) -> float {
    if constexpr (kStep) {
      return to_f(static_cast<const CT*>(a.x)[off]);
    } else {
      return static_cast<const float*>(a.x)[off];
    }
  };
  auto load_in = [&](int t, int i) { return load_at(in_off(i) + t * in_step); };
  for (int i = tid; i < 2 * R * IN; i += nthreads) {
    in_s[i] = i < nrows * IN ? load_in(0, i) : 0.0f;
  }
  __syncthreads();
  // with weights in registers a thread has one layer: its scales and bias
  // stay in registers too
  const float s_x0 = sc_s[lt * 8 + gate], s_h0 = sc_s[lt * 8 + 4 + gate];
  const float bias0 = b_s[lt * W4 + j];

  CT* hs = static_cast<CT*>(a.hs);
  for (int s = 0; s < T + L - 1; ++s) {
    const float* h_rd = h_s + (s & 1) * hbuf;
    float* h_wr = h_s + ((s + 1) & 1) * hbuf;
    const float* in_rd = in_s + (s & 1) * R * IN;
    // layer 0's input of the next step, into the other buffer (its last
    // reads were in step s - 1, before the barrier that ended it): fp32
    // rows by cp.async now, waited for before this step's last barrier;
    // bf16 rows into registers now, stored after the cells
    const bool more = s + 1 < T;
    float* in_wr = in_s + ((s + 1) & 1) * R * IN;
    float pf[kPrefetch];
    if constexpr (kRows > 1) {  // the rows of one timestep are contiguous
      if (more) {
        const float* src =
            static_cast<const float*>(a.x) + (s + 1) * in_step + size_t(row0) * W4;
        for (int i = 4 * tid; i < nrows * W4; i += 4 * nthreads) cp_async16(in_wr + i, src + i);
      }
      cp_async_commit();
    } else if constexpr (kAsyncIn) {
      if (more) {
        for (int i = tid; i < nrows * IN; i += nthreads) {
          cp_async4(in_wr + i, static_cast<const float*>(a.x) + in_off(i) + (s + 1) * in_step);
        }
      }
      cp_async_commit();
    } else {
#pragma unroll
      for (int n = 0; n < kPrefetch; ++n) {
        const int i = tid + n * nthreads;
        pf[n] = more && i < nrows * IN ? load_in(s + 1, i) : 0.0f;
      }
    }

    // layer l on timestep s - l: gate column j's pre-activation of row r
    auto gate_pre = [&](int l, int r) -> float {
      const float* h_own = h_rd + (size_t(l) * R + r) * W;
      const bool streamed = !kStep && l == 0;  // mvm_x applied outside, with scales and bias
      const float* x = streamed ? nullptr
                     : l == 0   ? in_rd + r * W
                                : h_rd + (size_t(l - 1) * R + r) * W;
      if (kStep && a.fuse) {  // no int8 scales (refused); no rounding of layer 0's sum
        float g;
        if constexpr (kW > 0) {
          g = dotcat_regs<kW>(x, wxr, h_own, whr);
        } else {
          const size_t col = size_t(l) * W * W4 + j;
          g = dot_flat(h_own, wh_s + col, W, W4, dot_flat(x, wx_s + col, W, W4));
        }
        return add(g, kW > 0 ? bias0 : b_s[l * W4 + j]);
      }
      float gx = 0.0f, hh;
      col_dots<WT, kW>(x, wxr, wx_s, h_own, whr, wh_s, l, j, W, gx, hh);
      const float s_h = kW > 0 ? s_h0 : sc_s[l * 8 + 4 + gate];
      if (streamed) return add(in_rd[r * W4 + j], mul(hh, s_h));
      if (kStep && l == 0) gx = round_to<CT>(gx);
      const float s_x = kW > 0 ? s_x0 : sc_s[l * 8 + gate];
      const float bias = kW > 0 ? bias0 : b_s[l * W4 + j];
      // per-gate tail order of both reference kernels: (gx*s_x + b) + hh*s_h
      return add(add(mul(gx, s_x), bias), mul(hh, s_h));
    };
    // the cell of element k of (l, r) from its activated gates and its
    // previous c (loaded early by the caller); c is updated in place
    auto cell = [&](int l, int r, int k, float ig, float fg, float gg, float og, float& c) {
      const size_t o = (size_t(l) * R + r) * W + k;
      const float h = cell_update<CT>(ig, fg, gg, og, &c, a.act, a.act_bits);
      c_s[o] = c;
      h_wr[o] = h;
      if (l == L - 1 && r < nrows) {
        const int t = s - l;
        const size_t out = kStep ? (size_t(row0 + r) * T + t) * W + k
                                 : (size_t(t) * B + row0 + r) * W + k;
        hs[out] = from_f<CT>(h);
      }
    };

    if constexpr (kRows > 1) {
      // every row's pre-activation first: 2 * kRows independent chains
      // (kRows on layer 0, whose x product is streamed in)
      const int t = s - lt;
      if (t >= 0 && t < T) {  // uniform across the warp
        const float* h_own = h_rd + size_t(lt) * kRows * kW;
        float pre[kRows], hh[kRows];
        if (lt == 0) {
          dot_rows<kW, kRows, kTrim>(h_own, whr, a.h_len[0], hh);
#pragma unroll
          for (int r = 0; r < kRows; ++r) pre[r] = add(in_rd[r * W4 + j], mul(hh[r], s_h0));
        } else {
          float gx[kRows];
          // the layer past layer 0 (L <= kRegLayers = 2 here): its chain
          // lengths read at fixed offsets, with no register held for them
          static_assert(kRegLayers == 2, "one layer past layer 0 on the register path");
          dot2_rows<kW, kRows, kTrim>(h_own - kRows * kW, wxr, a.x_len[1], h_own, whr,
                                      a.h_len[1], gx, hh);
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            pre[r] = add(add(mul(gx[r], s_x0), bias0), mul(hh[r], s_h0));
          }
        }
        // the warp's four gates of its 8 elements, every row, meet in
        // shared memory; then the lanes of gate g run the cells of rows g,
        // g + 4, ...: each lane applies the four activations of one row
        // and element, so no lane waits on another gate's activation
        float* g_own = g_s + size_t(lt) * kRows * W4;
#pragma unroll
        for (int r = 0; r < kRows; ++r) g_own[r * W4 + j] = pre[r];
        __syncwarp();
#pragma unroll
        for (int r = gate; r < kRows; r += 4) {
          const float* g = g_own + r * W4;
          float c = c_s[(size_t(lt) * kRows + r) * kW + kq];
          cell(lt, r, kq, sigma(g[kq], a.act), sigma(g[kW + kq], a.act),
               tanh_act(g[2 * kW + kq], a.act), sigma(g[3 * kW + kq], a.act), c);
        }
      }
    } else if constexpr (kWarpCell) {
      // one phase, all layers at once (one layer per thread): a warp's
      // lanes own the four gates of 8 elements; each applies its gate's
      // activation, shuffles bring f, g and o to the lane of gate i, which
      // runs the cell
      const int t = s - lt;
      if (t >= 0 && t < T) {  // uniform across the warp
        for (int r = 0; r < nrows; ++r) {
          float c = c_s[(size_t(lt) * R + r) * W + kq];  // used by the lanes of gate i
          const float act = gate_act(gate_pre(lt, r), gate, a.act);
          const float fg = __shfl_sync(0xffffffffu, act, (lane & 7) + 8);
          const float gg = __shfl_sync(0xffffffffu, act, (lane & 7) + 16);
          const float og = __shfl_sync(0xffffffffu, act, (lane & 7) + 24);
          if (gate == 0) cell(lt, r, kq, act, fg, gg, og, c);
        }
      }
    } else {
      // phase 1: one gate column per thread, its activation applied at once
      for (int l = lt; l < L; l += nl) {
        const int t = s - l;
        if (t < 0 || t >= T) continue;
        for (int r = 0; r < nrows; ++r) {
          g_s[(size_t(l) * R + r) * W4 + j] = gate_act(gate_pre(l, r), gate, a.act);
        }
      }
      __syncthreads();
      // phase 2: the fp32 cell, one element per thread
      for (int i = tid; i < L * nrows * W; i += nthreads) {
        const int l = i / (nrows * W), r = (i / W) % nrows, k = i % W;
        const int t = s - l;
        if (t < 0 || t >= T) continue;
        const float* g = g_s + (size_t(l) * R + r) * W4;
        float c = c_s[(size_t(l) * R + r) * W + k];
        cell(l, r, k, g[k], g[W + k], g[2 * W + k], g[3 * W + k], c);
      }
    }
    if constexpr (kAsyncIn) {
      cp_async_wait_all();
    } else if (more) {
#pragma unroll
      for (int n = 0; n < kPrefetch; ++n) {
        const int i = tid + n * nthreads;
        if (i < nrows * IN) in_wr[i] = pf[n];
      }
      for (int i = tid + kPrefetch * nthreads; i < nrows * IN; i += nthreads) {
        in_wr[i] = load_in(s + 1, i);
      }
    }
    __syncthreads();
  }

  // the last layer's elements past its warps' are padding, +0 at every
  // step: its warps write them into hs once the time loop is done
  if constexpr (kTrim) {
    const int e0 = 8 * a.warps[lt], step = 32 * a.warps[lt];
    if (lt == L - 1 && e0 < kW) {
      const int first = e0 + (kq >> 3) * 32 + lane;  // kq >> 3: the warp within the layer
      for (int t = 0; t < T; ++t) {
        CT* out = hs + (size_t(t) * B + row0) * kW;
        for (int e = first; e < kW; e += step) {
          for (int r = 0; r < nrows; ++r) out[size_t(r) * kW + e] = from_f<CT>(0.0f);
        }
      }
    }
  }

  // layer l's last write went to buffer (l + T) & 1
  CT* h_f = static_cast<CT*>(a.h_f);
  for (int i = tid; i < L * nrows * W; i += nthreads) {
    const int l = i / (nrows * W), r = (i / W) % nrows, k = i % W;
    const size_t g = (size_t(l) * B + row0 + r) * W + k;
    const size_t o = (size_t(l) * R + r) * W + k;
    h_f[g] = from_f<CT>(h_s[((l + T) & 1) * hbuf + o]);
    a.c_f[g] = c_s[o];
  }
}

template <typename CT, typename WT, bool kStep, int kW, int kRows, bool kTrim>
struct Instance {};  // one shared-memory table each

// Launches the instantiation, or, where ctas_per_sm is given, writes the
// CTAs of it one SM holds at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor)
// and launches nothing.
template <typename CT, typename WT, bool kStep, int kW, int kRows, bool kTrim = false>
cudaError_t launch(const Args& a, cudaStream_t stream, int* ctas_per_sm) {
  const size_t smem = smem_layout(a.L, a.W, a.rows, sizeof(WT), kStep).total;
  auto kernel = lstm_stack_kernel<CT, WT, kStep, kW, kRows, kTrim>;
  cudaError_t err = set_smem_once<Instance<CT, WT, kStep, kW, kRows, kTrim>>(kernel, smem);
  if (err != cudaSuccess) return err;
  int threads = layers_at_once(a.L, a.W) * 4 * a.W;
  if constexpr (kTrim) {  // the warps of the layers' real elements
    threads = 0;
    for (int l = 0; l < a.L; ++l) threads += 32 * a.warps[l];
  }
  if (ctas_per_sm != nullptr) {
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas_per_sm, kernel, threads, smem);
  }
  const dim3 grid((a.B + a.rows - 1) / a.rows);
  kernel<<<grid, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The row-thread path: one batch row a thread (see the note at the top).

// Floats between two rows of a warp's staged stream: 4W, or 4W + 4 where W
// is even, so that a row spans an odd number of 16-byte groups and the eight
// lanes of a quarter warp read their own rows' groups from distinct banks.
__host__ __device__ constexpr int row_pitch(int W) { return W % 2 ? 4 * W : 4 * W + 4; }

struct RowLayout {
  size_t w, b, scales, h, c, in, total;
};

__host__ __device__ inline RowLayout row_layout(int L, int W, int rows) {
  RowLayout s;
  const size_t W4 = 4 * size_t(W);
  const size_t state = align16(size_t(L) * W * rows * sizeof(float));
  s.w = 0;                                                   // [2][L][k][e] float4 (w_x, w_h)
  s.b = align16(2 * size_t(L) * W * W4 * sizeof(float));     // [L][e] float4
  s.scales = s.b + align16(size_t(L) * W4 * sizeof(float));  // [L][8]
  s.h = s.scales + align16(size_t(L) * 8 * sizeof(float));   // [L][k][rows]
  s.c = s.h + state;                                         // [L][k][rows]
  s.in = s.c + state;                                        // [2][rows][row_pitch]
  s.total = s.in + align16(2 * size_t(rows) * row_pitch(W) * sizeof(float));
  return s;
}

// The four gates' sums of element e, v . w[:, e], k ascending: four chains
// side by side, each in dot_flat's order (from 0, one rounded multiply and
// one rounded add per term).  w is one layer's [k][e] float4s (gates i, f,
// g, o), read by broadcast.
template <int kW>
__device__ __forceinline__ float4 gate_sums(const float (&v)[kW], const float4* w, int e) {
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
  for (int k = 0; k < kW; ++k) {
    const float4 q = w[k * kW + e];
    acc.x = add(acc.x, mul(v[k], q.x));
    acc.y = add(acc.y, mul(v[k], q.y));
    acc.z = add(acc.z, mul(v[k], q.z));
    acc.w = add(acc.w, mul(v[k], q.w));
  }
  return acc;
}

// kAct: the activation set (Act), a compile-time constant so that each
// sigma and tanh is straight-line code that the scheduler can interleave
// across elements (a run-time set branches around every one of them).
template <typename CT, typename WT, int kW, int kAct>
__global__ void __launch_bounds__(kRowThreadMax) lstm_stack_kernel_row_thread(const Args a) {
  constexpr int W4 = 4 * kW, kPitch = row_pitch(kW);
  extern __shared__ __align__(16) unsigned char smem[];
  const int L = a.L, T = a.T, B = a.B, R = blockDim.x, tid = threadIdx.x;
  const RowLayout lay = row_layout(L, kW, R);
  const float4* w_s = reinterpret_cast<const float4*>(smem + lay.w);
  const float4* b_s = reinterpret_cast<const float4*>(smem + lay.b);
  float* sc_s = reinterpret_cast<float*>(smem + lay.scales);
  float* h_s = reinterpret_cast<float*>(smem + lay.h);
  float* c_s = reinterpret_cast<float*>(smem + lay.c);
  float* in_s = reinterpret_cast<float*>(smem + lay.in);

  // the weights widened to fp32 (exact, as the plain version's
  // .to(compute).to(float32)), element-major: (l, k, gate g, element e) of
  // the (L, W, 4W) pack goes to float (l * W + k) * 4W + 4e + g
  float* wf = reinterpret_cast<float*>(smem + lay.w);
  float* bf = reinterpret_cast<float*>(smem + lay.b);
  const int nw = L * kW * W4;
  for (int i = tid; i < nw; i += R) {
    const int j = i % W4, g = j / kW;
    const int o = i - j + 4 * (j - g * kW) + g;
    wf[o] = to_f(static_cast<const WT*>(a.w_x)[i]);
    wf[nw + o] = to_f(static_cast<const WT*>(a.w_h)[i]);
  }
  for (int i = tid; i < L * W4; i += R) {
    const int j = i % W4, g = j / kW;
    bf[i - j + 4 * (j - g * kW) + g] = a.b[i];
  }
  for (int i = tid; i < L * 8; i += R) {  // unquantized packs: x * 1.0f is exact
    sc_s[i] = a.scales != nullptr ? a.scales[i] : 1.0f;
  }
  // each row's h and c between steps, [l][k][thread]; rows past B hold zeros
  const int row = blockIdx.x * R + tid;
  const bool live = row < B;
  const CT* h0 = static_cast<const CT*>(a.h0);
  for (int l = 0; l < L; ++l) {
    for (int k = 0; k < kW; ++k) {
      const size_t g = (size_t(l) * B + row) * kW + k;
      h_s[(l * kW + k) * R + tid] = live ? to_f(h0[g]) : 0.0f;
      c_s[(l * kW + k) * R + tid] = live ? a.c0[g] : 0.0f;
    }
  }
  __syncthreads();  // the last barrier: from here on a thread reads only its warp's rows

  // layer 0's stream: a warp's 32 rows of one step are one contiguous run of
  // 32 * 4W floats, staged by the warp into its rows of a double buffer
  const int lane = tid & 31, wrow = tid - lane;
  const int first = blockIdx.x * R + wrow, nrows = min(32, B - first);
  if (nrows <= 0) return;  // the whole warp is past the batch
  float* buf0 = in_s + size_t(wrow) * kPitch;
  float* buf1 = buf0 + size_t(R) * kPitch;
  const float* src0 = static_cast<const float*>(a.x) + size_t(first) * W4;
  const long long tstride = a.x_tstride;
  auto stage = [&](int t, float* buf) {
    const float* src = src0 + t * tstride;
    for (int q = lane; q < nrows * kW; q += 32) {  // 16-byte group q of the run
      const int r = q / kW;
      cp_async16(buf + r * kPitch + 4 * (q - r * kW), src + 4 * q);
    }
    cp_async_commit();
  };
  stage(0, buf0);  // a stream of time stride 0 is read from here at every step
  cp_async_wait_all();
  __syncwarp();

  CT* hs = static_cast<CT*>(a.hs);
  constexpr int act = kAct;
  const int act_bits = a.act_bits;
  float x[kW];  // the layer below's h at this step (rounded to CT), for layers > 0
  for (int t = 0; t < T; ++t) {
    // step t + 1's rows into the other buffer, whose last reads (step t - 1,
    // and its hs tile) came before the __syncwarp that ended step t - 1
    const bool more = tstride != 0 && t + 1 < T;
    if (more) stage(t + 1, (t & 1) ? buf0 : buf1);
    const float4* in = reinterpret_cast<const float4*>(((t & 1) && tstride != 0 ? buf1 : buf0) +
                                                       lane * kPitch);
    for (int l = 0; l < L; ++l) {
      float* h_l = h_s + l * kW * R + tid;
      float* c_l = c_s + l * kW * R + tid;
      float h[kW], c[kW], hn[kW];
#pragma unroll
      for (int k = 0; k < kW; ++k) {
        h[k] = h_l[k * R];
        c[k] = c_l[k * R];
      }
      const float4* wx = w_s + l * kW * kW;
      const float4* wh = w_s + (L + l) * kW * kW;
      const float s_x[4] = {sc_s[l * 8], sc_s[l * 8 + 1], sc_s[l * 8 + 2], sc_s[l * 8 + 3]};
      const float s_h[4] = {sc_s[l * 8 + 4], sc_s[l * 8 + 5], sc_s[l * 8 + 6], sc_s[l * 8 + 7]};
      if (l == 0) {
        float v[W4];  // this row's xw0 at step t, [i | f | g | o]
#pragma unroll
        for (int q = 0; q < kW; ++q) {
          const float4 p = in[q];
          v[4 * q] = p.x;
          v[4 * q + 1] = p.y;
          v[4 * q + 2] = p.z;
          v[4 * q + 3] = p.w;
        }
#pragma unroll
        for (int e = 0; e < kW; ++e) {
          const float4 hh = gate_sums<kW>(h, wh, e);
          // mvm_x applied outside, with scales and bias: xw0 + hh * s_h
          float ce = c[e];
          hn[e] = cell_update<CT>(sigma(add(v[e], mul(hh.x, s_h[0])), act),
                                  sigma(add(v[kW + e], mul(hh.y, s_h[1])), act),
                                  tanh_act(add(v[2 * kW + e], mul(hh.z, s_h[2])), act),
                                  sigma(add(v[3 * kW + e], mul(hh.w, s_h[3])), act), &ce, act,
                                  act_bits);
          c[e] = ce;
        }
      } else {
#pragma unroll
        for (int e = 0; e < kW; ++e) {
          const float4 gx = gate_sums<kW>(x, wx, e), hh = gate_sums<kW>(h, wh, e);
          const float4 b = b_s[l * kW + e];
          // per-gate tail order of both reference kernels: (gx*s_x + b) + hh*s_h
          float ce = c[e];
          hn[e] = cell_update<CT>(sigma(add(add(mul(gx.x, s_x[0]), b.x), mul(hh.x, s_h[0])), act),
                                  sigma(add(add(mul(gx.y, s_x[1]), b.y), mul(hh.y, s_h[1])), act),
                                  tanh_act(add(add(mul(gx.z, s_x[2]), b.z), mul(hh.z, s_h[2])),
                                           act),
                                  sigma(add(add(mul(gx.w, s_x[3]), b.w), mul(hh.w, s_h[3])), act),
                                  &ce, act, act_bits);
          c[e] = ce;
        }
      }
#pragma unroll
      for (int k = 0; k < kW; ++k) {
        h_l[k * R] = hn[k];
        c_l[k * R] = c[k];
        x[k] = hn[k];
      }
    }
    // the last layer's h of the warp's rows, one contiguous run of hs: each
    // lane puts its row into a [32][W] tile (this step's stream buffer, whose
    // reads are done, or buf1 where the stream is staged once), then the warp
    // stores the run 32 consecutive elements at a time
    float* tile = tstride == 0 || (t & 1) ? buf1 : buf0;
    __syncwarp();
#pragma unroll
    for (int k = 0; k < kW; ++k) tile[lane * kW + k] = x[k];
    __syncwarp();
    CT* out = hs + (size_t(t) * B + first) * kW;
    for (int f = lane; f < nrows * kW; f += 32) out[f] = from_f<CT>(tile[f]);
    if (more) {
      cp_async_wait_all();
      __syncwarp();
    }
  }
  if (!live) return;
  CT* h_f = static_cast<CT*>(a.h_f);
  for (int l = 0; l < L; ++l) {
    for (int k = 0; k < kW; ++k) {
      const size_t g = (size_t(l) * B + row) * kW + k;
      h_f[g] = from_f<CT>(h_s[(l * kW + k) * R + tid]);
      a.c_f[g] = c_s[(l * kW + k) * R + tid];
    }
  }
}

template <typename CT, typename WT, int kW, int kAct>
struct RowThreadInstance {};

template <typename CT, typename WT, int kW, int kAct>
cudaError_t launch_row_thread(const Args& a, cudaStream_t stream, int* ctas_per_sm) {
  const size_t smem = row_layout(a.L, kW, a.rows).total;
  auto kernel = lstm_stack_kernel_row_thread<CT, WT, kW, kAct>;
  cudaError_t err = set_smem_once<RowThreadInstance<CT, WT, kW, kAct>>(kernel, smem);
  if (err != cudaSuccess) return err;
  if (ctas_per_sm != nullptr) {
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas_per_sm, kernel, a.rows, smem);
  }
  kernel<<<(a.B + a.rows - 1) / a.rows, a.rows, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename CT, typename WT, int kW>
cudaError_t row_thread_by_act(const Args& a, cudaStream_t s, int* ctas_per_sm) {
  switch (a.act) {
    case kExact: return launch_row_thread<CT, WT, kW, kExact>(a, s, ctas_per_sm);
    case kHard: return launch_row_thread<CT, WT, kW, kHard>(a, s, ctas_per_sm);
    case kPaperHwKernel: return launch_row_thread<CT, WT, kW, kPaperHwKernel>(a, s, ctas_per_sm);
  }
  return cudaErrorInvalidValue;
}

template <typename CT, typename WT, bool kStep>
cudaError_t by_width(const Args& a, cudaStream_t s, int* ctas_per_sm) {
  const bool regs = in_regs(a.L, a.W);
  if (a.path == kBlocked) {
    if constexpr (!kStep) {
      if (regs && a.rows == kBlockedRows) {
        return a.trim ? launch<CT, WT, kStep, kRegW, kBlockedRows, true>(a, s, ctas_per_sm)
                      : launch<CT, WT, kStep, kRegW, kBlockedRows>(a, s, ctas_per_sm);
      }
    }
    return cudaErrorInvalidValue;
  }
  if (a.path == kRowThread) {
    if constexpr (!kStep) {
      if (a.rows % 32 == 0 && a.rows <= kRowThreadMax) {
        if (a.W == 9) return row_thread_by_act<CT, WT, 9>(a, s, ctas_per_sm);  // ROW_THREAD_WIDTHS
      }
    }
    return cudaErrorInvalidValue;
  }
  if (regs) return launch<CT, WT, kStep, kRegW, 1>(a, s, ctas_per_sm);
  return launch<CT, WT, kStep, 0, 1>(a, s, ctas_per_sm);
}

template <bool kStep>
int dispatch(const Args& a, int compute_dtype, int weight_dtype, void* stream,
             int* ctas_per_sm = nullptr) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.W < 1 || 4 * a.W > kMaxThreads || a.L < 1 || a.rows < 1) return cudaErrorInvalidValue;
  if (compute_dtype == kF32) {
    if (weight_dtype == kF32) return by_width<float, float, kStep>(a, s, ctas_per_sm);
    if (weight_dtype == kBF16) return by_width<float, __nv_bfloat16, kStep>(a, s, ctas_per_sm);
    if (weight_dtype == kI8) return by_width<float, int8_t, kStep>(a, s, ctas_per_sm);
  } else if (compute_dtype == kBF16) {
    // fp32 storage under bf16 compute is refused before the launch
    if (weight_dtype == kBF16) {
      return by_width<__nv_bfloat16, __nv_bfloat16, kStep>(a, s, ctas_per_sm);
    }
    if (weight_dtype == kI8) return by_width<__nv_bfloat16, int8_t, kStep>(a, s, ctas_per_sm);
  }
  return cudaErrorInvalidValue;
}

Args make_args(const void* x, const void* w_x, const void* w_h, const void* b,
               const void* scales, const void* h0, const void* c0, void* hs,
               void* h_f, void* c_f, int T, int B, int L, int W, int rows,
               int act, int act_bits, int fuse, int path, long long x_tstride) {
  Args a = {};
  a.x = x;
  a.w_x = w_x;
  a.w_h = w_h;
  a.b = static_cast<const float*>(b);
  a.scales = static_cast<const float*>(scales);
  a.h0 = h0;
  a.c0 = static_cast<const float*>(c0);
  a.hs = hs;
  a.h_f = h_f;
  a.c_f = static_cast<float*>(c_f);
  a.T = T;
  a.B = B;
  a.L = L;
  a.W = W;
  a.rows = rows;
  a.act = act;
  a.act_bits = act_bits;
  a.fuse = fuse;
  a.path = path;
  a.x_tstride = x_tstride;
  for (int l = 0; l < kRegLayers; ++l) {  // the padded geometry
    a.warps[l] = W / 8;
    a.x_len[l] = a.h_len[l] = W;
  }
  return a;
}

// Sets the row-blocked path's geometry from `widths`, layer l's real input
// width at widths[l] and hidden width at widths[L + l] (null: the padded
// geometry, kept).  False where widths is given off that path, or a width
// lies outside [1, W].
bool set_widths(Args& a, const int* widths) {
  if (widths == nullptr) return true;
  if (a.path != kBlocked || !in_regs(a.L, a.W)) return false;
  a.trim = true;
  for (int l = 0; l < a.L; ++l) {
    const int in = widths[l], h = widths[a.L + l];
    if (in < 1 || in > a.W || h < 1 || h > a.W) return false;
    a.warps[l] = (h + 7) / 8;
    a.x_len[l] = (in + 3) / 4 * 4;  // read from layer 1 on; layer 0's x is streamed
    a.h_len[l] = (h + 3) / 4 * 4;
  }
  return true;
}

}  // namespace

// Each entry returns cudaGetLastError() of its launch (0 on success).
// path (wavefront only): 0 one row a CTA, or `rows` rows one after another;
// 1 the row-blocked instantiation, every thread carrying `rows` rows (a
// compiled value, register path only) through each step; 2 the row-thread
// instantiation, one row a thread and `rows` (a multiple of 32, at most 128)
// rows a CTA, W = 9.  x_tstride: floats between timesteps of xw0,
// B * 4W for a dense stream or 0 for one (B, 4W) block repeated over the
// window; the (B, 4W) rows of a timestep are contiguous and 16-byte aligned.
// widths (row-blocked path only; null elsewhere, or for the padded work):
// 2L ints, the layers' real input widths then their hidden widths, of a
// pack whose weights are zero past them.
extern "C" int lstm_stack_wavefront(
    const void* xw0, const void* w_x, const void* w_h, const void* b,
    const void* scales, const void* h0, const void* c0, void* hs, void* h_f,
    void* c_f, int T, int B, int L, int W, int rows, int compute_dtype,
    int weight_dtype, int act, int act_bits, int path, long long x_tstride,
    const int* widths, void* stream) {
  if (x_tstride != 0 && x_tstride != 4LL * B * W) return cudaErrorInvalidValue;
  Args a = make_args(xw0, w_x, w_h, b, scales, h0, c0, hs, h_f, c_f, T, B,
                     L, W, rows, act, act_bits, 0, path, x_tstride);
  if (!set_widths(a, widths)) return cudaErrorInvalidValue;
  return dispatch<false>(a, compute_dtype, weight_dtype, stream);
}

// fuse_gates (step only, 0 or 1): each gate's sum one 2W-long chain over
// [x_or_h_prev ; h_l] . [w_x ; w_h], then + b; scales must be null.
extern "C" int lstm_stack_step(
    const void* xs, const void* w_x, const void* w_h, const void* b,
    const void* scales, const void* h0, const void* c0, void* hs, void* h_f,
    void* c_f, int T, int B, int L, int W, int rows, int compute_dtype,
    int weight_dtype, int act, int act_bits, int fuse_gates, void* stream) {
  if (fuse_gates && scales != nullptr) return cudaErrorInvalidValue;
  const Args a = make_args(xs, w_x, w_h, b, scales, h0, c0, hs, h_f, c_f, T, B,
                           L, W, rows, act, act_bits, fuse_gates, 0, 0);
  return dispatch<true>(a, compute_dtype, weight_dtype, stream);
}

// Dynamic shared memory one CTA of either kernel needs (step: 1 for
// lstm_stack_step, 0 for lstm_stack_wavefront).
extern "C" long long lstm_stack_smem_bytes(int L, int W, int rows, int weight_dtype, int step) {
  const int w_bytes = weight_dtype == kF32 ? 4 : (weight_dtype == kBF16 ? 2 : 1);
  return static_cast<long long>(
      smem_layout(L, W, rows, w_bytes, step != 0).total);
}

// Threads of one CTA, and whether the weights live in registers (1) or in
// shared memory at run-time width (0).
extern "C" int lstm_stack_threads(int L, int W) { return layers_at_once(L, W) * 4 * W; }
extern "C" int lstm_stack_weights_in_registers(int L, int W) { return in_regs(L, W); }

// Dynamic shared memory one row-thread CTA of `rows` rows needs (any
// storage dtype: the weights are widened to fp32).
extern "C" long long lstm_stack_row_thread_smem_bytes(int L, int W, int rows) {
  return static_cast<long long>(row_layout(L, W, rows).total);
}

// CTAs of the wavefront kernel's instantiation for (L, W, rows, path) and
// the dtypes that one SM holds at once (-1 where it has none; on the
// row-thread path, the exact activation set's instantiation), at the
// layers' real widths where `widths` is given (as lstm_stack_wavefront's).
extern "C" int lstm_stack_ctas_per_sm(int L, int W, int rows, int path, int compute_dtype,
                                      int weight_dtype, const int* widths) {
  Args a = make_args(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                     nullptr, nullptr, 1, rows, L, W, rows, 0, 0, 0, path, 0);
  if (!set_widths(a, widths)) return -1;
  int n = -1;
  return dispatch<false>(a, compute_dtype, weight_dtype, nullptr, &n) == cudaSuccess ? n : -1;
}

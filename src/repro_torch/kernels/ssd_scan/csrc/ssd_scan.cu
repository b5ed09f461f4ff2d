// Chunked Mamba-2 SSD scan for Hopper (sm_90a), on the CUDA cores.
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
// x, B and C arrive in the model dtype; dt and a are fp32; S is fp32
// throughout; y is rounded once to x's dtype.  The plain version
// (ssd_scan.ssd_chunked) is this algorithm in PyTorch.
//
// Layout.  The kernel reads the model's tensors as they are: x (B, T, H,
// P) and B, C (B, T, G, N) with any batch and token strides (the SSM block
// hands it views into one projection; heads and state columns contiguous),
// dt (B, T, H), s0 and s_f (B, H, P, N), y (B, T, H, P).  Head h reads B/C
// group h / (H / G): the reference wrapper's jnp.repeat of B and C to H
// heads is never materialised.  T need not be a multiple of L: the last
// chunk runs its Lr < L real steps, which is what the reference's zero-dt
// padding computes (a padded step has alpha = 0, so cum stays at its last
// real value, and x = B = C = 0, so it adds nothing).
//
// What bounds it on this card.  At mamba2-130m's prefill shape (B=8, T=512,
// H=24, P=64, N=128, L=64) a call must move 34 MB (x and y in bf16, B, C,
// dt and the fp32 final state): 10 us at 3.35 TB/s.  Its 4.5 GFLOP of fp32
// chunk products (with C B^T's lower triangle once per group) take 67 us
// at the 67 TFLOP/s of the CUDA cores: the operations bound it.
//
// Why the CUDA cores.  Every element of the four products is one fp32 FMA
// chain over its sum index in ascending order, and every elementwise step
// is the plain version's operation in its order: that is what cuBLAS
// computes for the plain version's einsums on this card (fp32, TF32 off),
// so kernel and plain version agree bit for bit (tools/ssd_drift.py: no
// bf16 y of mamba2-130m's prefill rounds apart).  PR 15's kernel ran the
// products on the tensor cores (mma.sync, fp32 operands split into three
// bf16 parts): 0.149 ms a launch, but an mma truncates its sum toward
// zero, 6.5e-5 of the bf16 y rounded apart from the plain version's, and
// mamba2-130m's teacher-forced logits drifted 3.9-4.1% of the largest
// |logit| from the plain path's over 24 layers (0 now).  C B^T alone on
// the CUDA cores halved the roundings apart (2.7e-5) and left 2.8-3.3%:
// only matching every product brought the drift down.
//
// What the design does about the operations.
//   * C B^T depends on the group, not the head: a first kernel
//     (ssd_cb_kernel, one CTA per (batch row, group, chunk)) computes its
//     lower triangle once into a scratch the wrapper allocates, where the
//     heads of a group (24 at mamba2-130m) and their state tiles would
//     otherwise each recompute it.
//   * The scan kernel: one CTA of 512 threads per (batch row, head, tile of
//     kPT = 16 state rows p), 768 CTAs at the serving shape.  Both outputs depend on the
//     CTA's own S tile only:
//         y[:, tile]  = M @ X[:, tile] + (C e) @ S[tile]^T
//         S[tile]     = exp(total) S[tile] + xw[:, tile]^T @ B
//     so CTAs never talk.
//   * Sixteen warps in two groups that run side by side, meeting at one CTA
//     barrier and two named barriers (cum ready; M ready) a chunk.  Both
//     groups turn the staged C B^T into M = (C B^T * exp(cum_t - cum_s)) *
//     dt_s in place, half the elements each.  The row group (warps 0-7)
//     then computes y: a thread owns 4 state rows of one chunk row, M @ X
//     and (C e) @ S_prev^T, two FMA chains each, added once.  The state
//     group (warps 8-15) stages the chunks, forms cum and runs the carry;
//     thread t of it owns S row t / 16, columns 8 (t % 16) .. + 7, in
//     registers across all chunks, with
//     an fp32 copy in shared memory (two, by chunk parity) for the row
//     group's (C e) @ S_prev^T.
//   * Each inner loop loads 4 or 8 consecutive elements of a row at once
//     and keeps 4 or 8 independent partial sums in registers.  Sixteen
//     warps, one CTA per SM (the two stage buffers take most of its
//     shared memory), hide the latency of the loads: with eight, the
//     chunk loop took 19,000 cycles (tools/kernel_probe.py).
//   * Staging is double-buffered with cp.async (16-byte copies of x, B, C
//     and C B^T, 4-byte copies of dt): the next chunk lands while this one
//     computes.  cum is a sequential sum in torch.cumsum's order (below);
//     exp(cum) and the carry weights dt * exp(total - cum) are computed
//     once per chunk.
//   * About 130 KB of shared memory per CTA in bf16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "probe.cuh"
#include "smem_attr.cuh"

namespace {

enum DType { kF32 = 0, kBF16 = 1 };

constexpr int kWarps = 8;                  // warps in each group
constexpr int kGroup = 32 * kWarps;        // threads in each group
constexpr int kThreads = 2 * kGroup;       // the row group, then the state group
constexpr int kL = 64;                     // chunk rows a CTA holds (the largest chunk)
constexpr int kPT = 16;                    // state rows p per CTA
constexpr int kMaxN = 128;                 // state columns at most
constexpr int kSN = kMaxN * kPT / kGroup;  // S columns a state thread owns (8)
constexpr int kSNT = kMaxN / kSN;          // state threads per S row (16)
constexpr int kYP = kPT * kL / kGroup;     // state rows of y a row thread owns (4)
constexpr int kCB = kL + 4;                // row stride of the staged C B^T, then M (floats)
constexpr int kXW = kPT + 1;               // row stride of xw (floats)
constexpr int kCbThreads = 256;            // threads of the C B^T kernel

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

struct SsdArgs {
  const void* x;     // (B, T, H, P) model dtype: (b, t, h, p) at b*x_sb + t*x_st + h*P + p
  const float* dt;   // (B, T, H)
  const float* a;    // (H,) negative decay rates
  const void* bm;    // (B, T, G, N) model dtype: (b, t, g, n) at b*bc_sb + t*bc_st + g*N + n
  const void* cm;    // (B, T, G, N), the strides of bm
  const float* s0;   // (B, H, P, N), or null for a zero state
  void* y;           // (B, T, H, P) model dtype
  float* s_f;        // (B, H, P, N)
  float* cb;         // (B, G, chunks, kL, kL): C B^T of each chunk, lower triangle, 0 above
  long long x_sb, x_st, bc_sb, bc_st;
  int B, T, H, G, P, N, L;
};

// Byte offsets of the shared-memory carve-up and the padded row lengths
// (in elements): two stage buffers of x [kL][xs], B and C [kL][ns] at the
// model dtype, dt [kL] and C B^T [kL][kCB] (then M, in place) fp32; cum,
// exp(cum) and the carry weights [kL]; S [2][kPT][sf] and xw [kL][kXW],
// fp32.
struct SsdLayout {
  size_t x, b, c, dt, cb, stage, cum, ecum, w, s, xw, total;
  int np, xs, ns, sf;
};

__host__ __device__ inline SsdLayout ssd_layout(int N, int esize) {
  SsdLayout o;
  const int pad = 16 / esize;  // rows stay 16-byte aligned and shift by 4 banks
  o.np = (N + 15) & ~15;       // N rounded up to 16 (zero columns)
  o.xs = kPT + pad;
  o.ns = o.np + pad;
  o.sf = o.np + 4;
  o.x = 0;
  o.b = align16(size_t(kL) * o.xs * esize);
  o.c = o.b + align16(size_t(kL) * o.ns * esize);
  o.dt = o.c + align16(size_t(kL) * o.ns * esize);
  o.cb = o.dt + align16(kL * sizeof(float));
  o.stage = o.cb + align16(size_t(kL) * kCB * sizeof(float));
  o.cum = 2 * o.stage;
  o.ecum = o.cum + kL * sizeof(float);
  o.w = o.ecum + kL * sizeof(float);
  o.s = align16(o.w + kL * sizeof(float));
  o.xw = align16(o.s + 2 * size_t(kPT) * o.sf * sizeof(float));
  o.total = align16(o.xw + size_t(kL) * kXW * sizeof(float));
  return o;
}

// Row length (elements) of the C B^T kernel's copies of B and C: rows
// shift by one bank (bf16 pairs) or two (fp32 pairs).
__host__ __device__ inline int cb_row(int N) { return ((N + 15) & ~15) + 2; }

// ---- helpers ---------------------------------------------------------------

__device__ __forceinline__ float ldf(const float* p) { return *p; }
__device__ __forceinline__ float ldf(const __nv_bfloat16* p) { return __bfloat162float(*p); }

// two consecutive elements, widened (8- or 4-byte aligned)
__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 ld2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ float2 unpack(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// 4 (8) consecutive elements from shared memory, 8 (16)-byte aligned in bf16.
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  const float2 a = unpack(q.x), b = unpack(q.y);
  v[0] = a.x;
  v[1] = a.y;
  v[2] = b.x;
  v[3] = b.y;
}
template <typename E>
__device__ __forceinline__ void load8(const E* p, float* v) {
  load4(p, *reinterpret_cast<float(*)[4]>(v));
  load4(p + 4, *reinterpret_cast<float(*)[4]>(v + 4));
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Named barrier `id` over `n` threads: sync waits, arrive only counts.
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
constexpr int kBarCum = 1;    // cum and exp(cum) ready (state -> rows)
constexpr int kBarState = 2;  // within the state group: the carry weights, then xw, ready
constexpr int kBarM = 3;      // M ready (both groups -> rows)

__device__ __forceinline__ void zero_bytes(unsigned char* p, size_t bytes) {  // 16-byte units
  for (size_t i = threadIdx.x; i < bytes / 16; i += kThreads) {
    reinterpret_cast<uint4*>(p)[i] = make_uint4(0, 0, 0, 0);
  }
}

// ---- the kernels -----------------------------------------------------------

// C B^T of one (batch row, group, chunk): element (t, s) = sum_n C[t, n]
// B[s, n], one FMA chain over n in order, for s <= t < the chunk's length;
// every other element of the kL x kL block 0.
template <typename E>
__global__ void __launch_bounds__(kCbThreads) ssd_cb_kernel(const SsdArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int N = a.N, L = a.L, T = a.T;
  const int n_chunks = (T + L - 1) / L;
  const int bg_ = blockIdx.x / n_chunks, c = blockIdx.x - bg_ * n_chunks;
  const int b = bg_ / a.G, g = bg_ - b * a.G;
  const int t0 = c * L, lc = min(L, T - t0), R = cb_row(N);
  E* cs = reinterpret_cast<E*>(smem);
  E* bs = cs + kL * R;
  for (int i = threadIdx.x; i < 2 * kL * R * int(sizeof(E)) / 4; i += kCbThreads) {
    reinterpret_cast<uint32_t*>(smem)[i] = 0u;  // R is even: whole words
  }
  __syncthreads();
  const E* cg = static_cast<const E*>(a.cm) + size_t(b) * a.bc_sb + size_t(g) * N;
  const E* bg = static_cast<const E*>(a.bm) + size_t(b) * a.bc_sb + size_t(g) * N;
  for (int i = threadIdx.x; i < lc * N; i += kCbThreads) {
    const int t = i / N, n = i - t * N;
    cs[t * R + n] = cg[size_t(t0 + t) * a.bc_st + n];
    bs[t * R + n] = bg[size_t(t0 + t) * a.bc_st + n];
  }
  __syncthreads();
  float* out = a.cb + size_t(blockIdx.x) * kL * kL;
  for (int e = threadIdx.x; e < kL * kL; e += kCbThreads) {
    const int t = e / kL, s = e - t * kL;
    float acc = 0.0f;
    if (s <= t && t < lc) {
      const E* cr = cs + t * R;
      const E* br = bs + s * R;
#pragma unroll 4
      for (int n = 0; n < N; n += 2) {
        const float2 cv = ld2(cr + n), bv = ld2(br + n);
        acc = __fmaf_rn(cv.y, bv.y, __fmaf_rn(cv.x, bv.x, acc));
      }
    }
    out[e] = acc;
  }
}

// E: element type of x, B, C and y (fp32 or bf16).
template <typename E>
__global__ void __launch_bounds__(kThreads, 1) ssd_scan_kernel(const SsdArgs a) {
  constexpr int kEpu = 16 / sizeof(E);  // elements per 16-byte copy
  extern __shared__ __align__(16) unsigned char smem[];
  const int P = a.P, N = a.N, T = a.T, H = a.H, L = a.L;
  const SsdLayout o = ssd_layout(N, sizeof(E));
  const int XS = o.xs, NS = o.ns, SF = o.sf;
  const int n_pt = (P + kPT - 1) / kPT;
  const int bh = blockIdx.x / n_pt, pt = blockIdx.x - bh * n_pt;
  const int b = bh / H, h = bh - b * H, grp = h / (H / a.G);
  const int p0 = pt * kPT, pw = min(kPT, P - p0);  // this CTA's state rows
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const bool rows_group = warp < kWarps;
  const int w = rows_group ? warp : warp - kWarps;  // the warp's index in its group
  const int st = tid - kGroup;                      // the thread's index in the state group
  const int n_chunks = (T + L - 1) / L;
  const float a_h = a.a[h];
  const E* xg = static_cast<const E*>(a.x) + size_t(b) * a.x_sb + size_t(h) * P + p0;
  const E* bg = static_cast<const E*>(a.bm) + size_t(b) * a.bc_sb + size_t(grp) * N;
  const E* cg = static_cast<const E*>(a.cm) + size_t(b) * a.bc_sb + size_t(grp) * N;
  const float* dtg = a.dt + size_t(b) * T * H + h;
  const float* cbg = a.cb + (size_t(b) * a.G + grp) * n_chunks * kL * kL;
  float* cum = reinterpret_cast<float*>(smem + o.cum);
  float* ecum = reinterpret_cast<float*>(smem + o.ecum);
  float* wts = reinterpret_cast<float*>(smem + o.w);
  float* xw_s = reinterpret_cast<float*>(smem + o.xw);  // [kL][kXW]
  auto x_s = [&](int buf) { return reinterpret_cast<E*>(smem + buf * o.stage + o.x); };
  auto b_s = [&](int buf) { return reinterpret_cast<E*>(smem + buf * o.stage + o.b); };
  auto c_s = [&](int buf) { return reinterpret_cast<E*>(smem + buf * o.stage + o.c); };
  auto dt_s = [&](int buf) { return reinterpret_cast<float*>(smem + buf * o.stage + o.dt); };
  auto cb_s = [&](int buf) { return reinterpret_cast<float*>(smem + buf * o.stage + o.cb); };
  // S after chunk c - 1 (S_prev of chunk c) in s_s(c & 1), [kPT][SF]
  auto s_s = [&](int parity) {
    return reinterpret_cast<float*>(smem + o.s) + parity * kPT * SF;
  };

  // every pad row and column reads as 0 (x past pw, B and C past N, rows
  // past L); staging writes only real elements
  zero_bytes(smem, o.total);
  __syncthreads();

  // chunk c into buffer buf, by the state group: cp.async of its real
  // rows; rows lc..L-1 (a ragged last chunk) cleared, as the reference's
  // zero-dt padding
  auto stage = [&](int c, int buf) {
    const int st = tid - 32 * kWarps, nst = 32 * kWarps;
    const int t0 = c * L, lc = min(L, T - t0);
    E* xs = x_s(buf);
    E* bs = b_s(buf);
    E* cs = c_s(buf);
    float* dts = dt_s(buf);
    // 16-byte units: a row of x has xu of them (1, 2 or 4), of B and C nu;
    // a thread copies unit st % units of rows st / units, st / units + nst /
    // units, ... where units divide nst = 128 (N = 8, 16, 32, 64 or 128 in
    // bf16); other widths of B and C (N = 24, say) take the general loop
    const int xu = pw / kEpu, nu = N / kEpu;
    for (int t = st / xu, u = st % xu; t < lc; t += nst / xu) {
      cp_async16(xs + t * XS + u * kEpu, xg + size_t(t0 + t) * a.x_st + u * kEpu);
    }
    if (nst % nu == 0) {
      const int u = st % nu, dt_rows = nst / nu;
      const size_t step = size_t(dt_rows) * a.bc_st;
      size_t off = size_t(t0 + st / nu) * a.bc_st + u * kEpu;
      for (int t = st / nu; t < lc; t += dt_rows, off += step) {
        cp_async16(bs + t * NS + u * kEpu, bg + off);
        cp_async16(cs + t * NS + u * kEpu, cg + off);
      }
    } else {
      for (int i = st; i < lc * nu; i += nst) {
        const int t = i / nu, u = i - t * nu;
        const size_t off = size_t(t0 + t) * a.bc_st + u * kEpu;
        cp_async16(bs + t * NS + u * kEpu, bg + off);
        cp_async16(cs + t * NS + u * kEpu, cg + off);
      }
    }
    for (int t = st; t < lc; t += nst) cp_async4(dts + t, dtg + size_t(t0 + t) * H);
    // C B^T of the chunk, all kL rows (0 past lc and above the diagonal)
    const float* cbc = cbg + size_t(c) * kL * kL;
    float* cbs = cb_s(buf);
    for (int i = st; i < kL * kL / 4; i += nst) {
      const int t = i / (kL / 4), u = i - t * (kL / 4);
      cp_async16(cbs + t * kCB + 4 * u, cbc + t * kL + 4 * u);
    }
    if (lc < L) {
      const size_t xr = size_t(XS) * sizeof(E), nr = size_t(NS) * sizeof(E);
      for (size_t i = st; i < (L - lc) * xr / 16; i += nst) {
        reinterpret_cast<uint4*>(reinterpret_cast<unsigned char*>(xs) + lc * xr)[i] = uint4{};
      }
      for (size_t i = st; i < (L - lc) * nr / 16; i += nst) {
        reinterpret_cast<uint4*>(reinterpret_cast<unsigned char*>(bs) + lc * nr)[i] = uint4{};
        reinterpret_cast<uint4*>(reinterpret_cast<unsigned char*>(cs) + lc * nr)[i] = uint4{};
      }
      for (int t = lc + st; t < L; t += nst) dts[t] = 0.0f;
    }
  };

  // the state group's S: row sp, columns n0 .. n0 + kSN - 1 (those below N),
  // in registers across all chunks
  const int sp = st / kSNT, n0 = kSN * (st % kSNT);
  const int sn = rows_group ? 0 : max(0, min(kSN, N - n0));
  float sr[kSN];
  auto store_state = [&](int parity) {
    float* ss = s_s(parity);
#pragma unroll
    for (int j = 0; j < kSN; ++j) {
      if (j < sn) ss[sp * SF + n0 + j] = sr[j];
    }
  };
  if (!rows_group) {
    const float* s0 = a.s0 ? a.s0 + ((size_t(b) * H + h) * P + p0 + sp) * N + n0 : nullptr;
#pragma unroll
    for (int j = 0; j < kSN; ++j) sr[j] = s0 != nullptr && j < sn && sp < pw ? s0[j] : 0.0f;
    store_state(0);
    stage(0, 0);
    cp_async_commit();
  }

  E* yg = static_cast<E*>(a.y) + size_t(b) * T * H * P + size_t(h) * P + p0;
  // clock stamps (-DKERNEL_PROBE builds only): lane 0 of every warp of
  // CTAs 0 and 400, the phases of each of the first 16 chunks
  [[maybe_unused]] const bool stamps = (blockIdx.x == 0 || blockIdx.x == 400) && lane == 0;
#define CHUNK_STAMP(k) \
  PROBE(stamps && c < 16, ((blockIdx.x ? 16 * kThreads / 32 : 0) + warp * 16 + c) * 8 + (k))
  for (int c = 0; c < n_chunks; ++c) {
    const int buf = c & 1, t0 = c * L, lc = min(L, T - t0);
    if (!rows_group) cp_async_wait_all();  // chunk c: the one group in flight
    __syncthreads();  // chunk c staged, S_prev stored, chunk c - 1 done
    CHUNK_STAMP(0);
    const E* xs = x_s(buf);
    const E* bs = b_s(buf);
    const E* cs = c_s(buf);
    const float* dts = dt_s(buf);

    // M = (C B^T * exp(cum_t - cum_s)) * dt_s on and below the diagonal,
    // in place (0 above it, as staged), by both groups: element e is
    // thread e % kThreads's
    float* ms = cb_s(buf);
    auto make_m = [&]() {
      for (int e = tid; e < kL * kL; e += kThreads) {
        const int t = e / kL, s = e - t * kL;
        if (s <= t && t < lc) {
          float* m = ms + t * kCB + s;
          *m = __fmul_rn(__fmul_rn(*m, expf(__fsub_rn(cum[t], cum[s]))), dts[s]);
        }
      }
    };

    if (rows_group) {
      bar_sync(kBarCum, kThreads);  // cum and exp(cum) of this chunk
      CHUNK_STAMP(1);
      make_m();
      bar_sync(kBarM, kThreads);    // every element of M
      CHUNK_STAMP(2);
      // y = M @ X + (C e) @ S_prev^T: state rows pb .. pb + 7 of chunk row
      // t, each product one FMA chain (over s, then over n), added once
      const int t = tid / (kPT / kYP), pb = kYP * (tid % (kPT / kYP));
      if (t < lc) {
        float yv[kYP], yi[kYP];
#pragma unroll
        for (int j = 0; j < kYP; ++j) yv[j] = yi[j] = 0.0f;
        const float* mr = ms + t * kCB;
#pragma unroll 8
        for (int s = 0; s < kL; ++s) {
          float xv[kYP];
          load4(xs + s * XS + pb, xv);
          const float m = mr[s];
#pragma unroll
          for (int j = 0; j < kYP; ++j) yv[j] = __fmaf_rn(m, xv[j], yv[j]);
        }
        const float e_t = ecum[t];
        const float* ss = s_s(buf);
#pragma unroll 2
        for (int n = 0; n < N; n += 4) {
          float cv[4], sv[kYP][4];
          load4(cs + t * NS + n, cv);
#pragma unroll
          for (int j = 0; j < kYP; ++j) load4(ss + (pb + j) * SF + n, sv[j]);
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const float ce = __fmul_rn(cv[k], e_t);
#pragma unroll
            for (int j = 0; j < kYP; ++j) yi[j] = __fmaf_rn(ce, sv[j][k], yi[j]);
          }
        }
#pragma unroll
        for (int j = 0; j < kYP; ++j) {
          if (pb + j < pw) {
            store1(yg + (size_t(t0 + t) * H) * P + pb + j, __fadd_rn(yv[j], yi[j]));
          }
        }
      }
      CHUNK_STAMP(3);
    } else {
      if (w == 0 && lane == 0) {
        // cum: the inclusive prefix sum of alpha = dt * a in torch.cumsum's
        // order (sequential), so that exp(cum_t - cum_s) equals the plain
        // version's bit for bit: |cum| reaches tens, and one ulp of it moves
        // the decay by about 4e-6, which a bf16 model carries on
        float run = 0.0f;
        for (int t0s = 0; t0s < kL; t0s += 16) {  // 16 steps at a time, in registers
          float v[16];
#pragma unroll
          for (int t = 0; t < 16; t += 4) {
            const float4 q = *reinterpret_cast<const float4*>(dts + t0s + t);
            v[t] = q.x;
            v[t + 1] = q.y;
            v[t + 2] = q.z;
            v[t + 3] = q.w;
          }
#pragma unroll
          for (int t = 0; t < 16; ++t) {  // padded steps add -0
            run = __fadd_rn(run, __fmul_rn(v[t], a_h));
            v[t] = run;
          }
#pragma unroll
          for (int t = 0; t < 16; t += 4) {
            *reinterpret_cast<float4*>(cum + t0s + t) =
                make_float4(v[t], v[t + 1], v[t + 2], v[t + 3]);
          }
        }
      }
      if (w == 0) {
        __syncwarp();
        const float total = cum[kL - 1];
#pragma unroll
        for (int t = lane; t < kL; t += 32) {
          ecum[t] = expf(cum[t]);
          wts[t] = dts[t] * expf(total - cum[t]);
        }
      }
      __threadfence_block();
      bar_arrive(kBarCum, kThreads);  // for the row group, which waits there
      bar_sync(kBarState, kGroup);    // warp kWarps's cum and weights, for this group
      make_m();
      __threadfence_block();
      bar_arrive(kBarM, kThreads);    // this group's elements of M
      CHUNK_STAMP(1);

      // the next chunk lands while this one computes (its buffer's last
      // reads were in chunk c - 1, before this chunk's barrier)
      if (c + 1 < n_chunks) {
        stage(c + 1, buf ^ 1);
        cp_async_commit();
      }
      CHUNK_STAMP(2);

      // the carry: S = exp(total) S + xw^T @ B, xw = x * (dt * exp(total -
      // cum)), over all kL rows (past lc, x and the weights are 0)
      for (int i = st; i < kL * kPT; i += kGroup) {
        const int s = i / kPT, p = i - s * kPT;
        xw_s[s * kXW + p] = __fmul_rn(ldf(xs + s * XS + p), wts[s]);
      }
      bar_sync(kBarState, kGroup);  // xw ready
      if (sn > 0) {
        float u[kSN];
#pragma unroll
        for (int j = 0; j < kSN; ++j) u[j] = 0.0f;
#pragma unroll 4
        for (int s = 0; s < kL; ++s) {
          const float xv = xw_s[s * kXW + sp];
          float bv[kSN];
          load8(bs + s * NS + n0, bv);
#pragma unroll
          for (int j = 0; j < kSN; ++j) u[j] = __fmaf_rn(xv, bv[j], u[j]);
        }
        const float etot = expf(cum[kL - 1]);
#pragma unroll
        for (int j = 0; j < kSN; ++j) sr[j] = __fadd_rn(__fmul_rn(etot, sr[j]), u[j]);
      }
      CHUNK_STAMP(3);
      store_state(buf ^ 1);
      CHUNK_STAMP(4);
    }
  }
#undef CHUNK_STAMP

  if (!rows_group && sp < pw) {
    float* sf = a.s_f + ((size_t(b) * H + h) * P + p0 + sp) * N + n0;
#pragma unroll
    for (int j = 0; j < kSN; ++j) {
      if (j < sn) sf[j] = sr[j];
    }
  }
}

// CTAs of a launch: one per (batch row, head, tile of kPT state rows).
inline int grid_ctas(int B, int H, int P) { return B * H * ((P + kPT - 1) / kPT); }

template <typename T, bool kCbKernel>
struct Instance {};  // one shared-memory table each

template <typename T>
cudaError_t launch(const SsdArgs& a, cudaStream_t stream) {
  const int n_chunks = (a.T + a.L - 1) / a.L;
  const size_t cb_smem = 2 * size_t(kL) * cb_row(a.N) * sizeof(T);
  auto cb_kernel = ssd_cb_kernel<T>;
  cudaError_t err = set_smem_once<Instance<T, true>>(cb_kernel, cb_smem);
  if (err != cudaSuccess) return err;
  cb_kernel<<<a.B * a.G * n_chunks, kCbThreads, cb_smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t smem = ssd_layout(a.N, sizeof(T)).total;
  auto kernel = ssd_scan_kernel<T>;
  err = set_smem_once<Instance<T, false>>(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid_ctas(a.B, a.H, a.P), kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Returns cudaGetLastError() of the two launches (0 on success).  x, B
// and C share `dtype` and are read at the batch and token strides given
// (in elements; heads and state columns contiguous, every row 16-byte
// aligned); dt, s0, y and s_f are contiguous; s0 may be null; cb is fp32
// scratch of ssd_scan_scratch_floats(B, G, T, L) floats, 16-byte aligned.
// Requires H % G == 0, T >= 1, 1 <= L <= 64, P % 8 == 0, N % 8 == 0 and
// N <= 128.
extern "C" int ssd_scan(const void* x, const void* dt, const void* a, const void* bm,
                        const void* cm, const void* s0, void* y, void* s_f, void* cb,
                        long long x_sb, long long x_st, long long bc_sb, long long bc_st,
                        int B, int T, int H, int G, int P, int N, int L, int dtype,
                        void* stream) {
  if (G < 1 || H % G != 0 || T < 1 || L < 1 || L > kL || P < 1 || P % 8 != 0 || N < 8 ||
      N % 8 != 0 || N > kMaxN) {
    return cudaErrorInvalidValue;
  }
  SsdArgs args;
  args.x = x;
  args.dt = static_cast<const float*>(dt);
  args.a = static_cast<const float*>(a);
  args.bm = bm;
  args.cm = cm;
  args.s0 = static_cast<const float*>(s0);
  args.y = y;
  args.s_f = static_cast<float*>(s_f);
  args.cb = static_cast<float*>(cb);
  args.x_sb = x_sb;
  args.x_st = x_st;
  args.bc_sb = bc_sb;
  args.bc_st = bc_st;
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

// Dynamic shared memory one CTA needs at N state columns.
extern "C" long long ssd_scan_smem_bytes(int N, int dtype) {
  return static_cast<long long>(ssd_layout(N, dtype == kF32 ? 4 : 2).total);
}

// CTAs of the scan kernel's launch (the grid the launch uses).
extern "C" long long ssd_scan_ctas(int B, int H, int P) { return grid_ctas(B, H, P); }

// fp32 elements of the C B^T scratch: a kL x kL block per (batch row,
// group, chunk).
extern "C" long long ssd_scan_scratch_floats(int B, int G, int T, int L) {
  return static_cast<long long>(B) * G * ((T + L - 1) / L) * kL * kL;
}

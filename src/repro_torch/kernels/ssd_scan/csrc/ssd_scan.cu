// Chunked Mamba-2 SSD scan for Hopper (sm_90a), on the tensor cores.
//
// Replaces the Pallas TPU kernel repro/kernels/ssd_scan/ssd_scan.py
// `ssd_scan` (body `_ssd_kernel`).  Per batch row b and head h, with the
// head's scalar decay a[h] < 0 and alpha_t = dt_t * a[h]:
//     S_t = exp(alpha_t) S_{t-1} + dt_t (x_t outer B_t),   y_t = S_t . C_t
// computed chunk by chunk (L steps each), with cum the inclusive prefix sum
// of alpha inside the chunk:
//     intra:  y  = [tril(exp(cum_t - cum_s)) * (C B^T) * dt_s] @ X
//     inter:  y += exp(cum) * (C @ S_prev^T)
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
// dt and the fp32 final state): 10 us at 3.35 TB/s.  Its 4.5 GFLOP of chunk
// products take 4.5 us on the bf16 tensor cores, so the bytes bound it.
//
// What the design does about it.
//   * Many CTAs per head: one CTA per (batch row, head, tile of kPT = 16
//     state rows p), 768 CTAs at the serving shape (192 before).  Both
//     outputs depend on the CTA's own S tile only:
//         y[:, tile]  = M @ X[:, tile] + exp(cum) * (C @ S[tile]^T)
//         S[tile]     = exp(total) S[tile] + xw[:, tile]^T @ B
//     so CTAs never talk.  M = tril(exp(cum_t - cum_s)) * (C B^T) * dt_s
//     is recomputed by each tile's CTA: 64 x 64 x 128 multiply-adds per
//     chunk on the tensor cores.
//   * The four products run on the tensor cores (mma.sync m16n8k16, bf16
//     in, fp32 accumulation).  bf16 operands (x, B, C of a bf16 model) are
//     exact and enter once.  An fp32 operand the kernel derives (M, S, xw)
//     is split exactly into three bf16 parts, hi + mid + lo = its 24 bits,
//     and a product is the sum of each part times the other operand's high
//     part: fp32 products, fp32 sums.  (A two-part split, 16 bits, with cum
//     summed in another order, drifted mamba2-130m's teacher-forced logits
//     5% from the plain path's over 24 layers.)  fp32 x, B and C (the fp32
//     instantiation) are split into hi + lo, and their low parts meet the
//     other operand's high part.
//   * An mma's fp32 sum is truncated toward zero, not rounded.  Chained
//     into one accumulator (the small parts' products into the hi sum, a
//     chunk's carry into S, k step after k step), that made 65-67% of the
//     bf16 y values that round apart from the plain version lie toward
//     zero, a lean every later layer carries on.  So the small parts'
//     products have accumulators of their own, the carry is summed apart
//     from S, and the high parts' products of C B^T (8 k16 steps at N =
//     128) and M @ X start from zero at every k16 step, added in IEEE fp32
//     (mma_add); the lean left, 53-56%, is the truncation inside one step's
//     sum (chip_smoke.py holds it under 55% over its cases).
//   * Eight warps in two groups that run side by side, meeting at one CTA
//     barrier and one named barrier (cum and C @ S_prev^T ready) a chunk.
//     The row group (warps 0-3) computes C B^T, M, M @ X and y.  The lower
//     triangle is cut into (row block, column pair) units, three at most
//     per warp: warp 0 takes block 0 and half of block 3, warp 1 block 1
//     and a third of block 2, warps 2 and 3 the rest of blocks 2 and 3,
//     adding the partial M @ X the others leave in shared memory.  M stays
//     in registers: the accumulator layout of two 8-column tiles is the
//     A-operand layout of a 16-deep step.  The state group (warps 4-7)
//     stages the chunks, forms cum, computes C @ S_prev^T for the row group
//     and runs the carry; warp 4 + v owns S columns n in 8-wide tiles v,
//     v + 4, ...: S stays in those fp32 accumulator registers across all
//     chunks and reaches device memory once, as the final state.  Its
//     three-part bf16 copy in shared memory feeds C @ S_prev^T; xw is split
//     once a chunk into shared memory for all four state warps.  Clock
//     stamps showed why (tools/kernel_probe.py): with four warps doing
//     everything in turn, a chunk took 17,000 cycles, 8,400 of them from
//     the end of C B^T to the end of the carry, set by the triangle's
//     longest rows.
//   * bf16 fragments come from shared memory by ldmatrix (.trans where the
//     operand is stored the other way round): one instruction for four
//     8x8 tiles.
//   * Staging is double-buffered with cp.async (16-byte copies of x, B and
//     C at their model dtype, 4-byte copies of dt): the next chunk lands
//     while this one computes.  cum is a sequential sum in torch.cumsum's
//     order (below); exp(cum) and the carry weights dt * exp(total - cum)
//     are computed once per chunk.
//   * Shared-memory rows are padded so the fragment loads of a warp hit 32
//     different banks.  About 105 KB per CTA in bf16 (2 CTAs, 16 warps per
//     SM); 128 registers a thread, the most 2 CTAs of 256 threads allow.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "probe.cuh"
#include "smem_attr.cuh"

namespace {

enum DType { kF32 = 0, kBF16 = 1 };

constexpr int kWarps = 4;                  // warps in each group
constexpr int kThreads = 64 * kWarps;      // the row group, then the state group
constexpr int kL = 16 * kWarps;            // chunk rows a CTA holds (the largest chunk)
constexpr int kPT = 16;                    // state rows p per CTA
constexpr int kMaxN = 128;                 // state columns at most
constexpr int kNTW = kMaxN / 8 / kWarps;   // S column tiles per state warp

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
  long long x_sb, x_st, bc_sb, bc_st;
  int B, T, H, G, P, N, L;
};

// Byte offsets of the shared-memory carve-up and the padded row lengths
// (in elements): two stage buffers of x [kL][xs], B and C [kL][ns] at the
// model dtype and dt [kL]; the split state, hi, mid and lo [kPT][ss]
// (bf16); the carry's xw = x * dt * exp(total - cum) split the same way
// [3][kL][kXW] (bf16); cum, exp(cum) and the carry weights [kL]; C @ S_prev^T
// [kL][kYS] fp32, from the state group to the row group; two partial
// M @ X blocks [2][16][kYS] fp32, between row warps.
constexpr int kYS = kPT + 4;  // row stride of C @ S_prev^T (floats)
constexpr int kXW = kPT + 8;  // row stride of the split xw (bf16)
struct SsdLayout {
  size_t x, b, c, dt, stage, split, part, xw, xw_part, cum, ecum, w, yi, yp, total;
  int np, xs, ns, ss;
};

__host__ __device__ inline SsdLayout ssd_layout(int N, int esize) {
  SsdLayout o;
  const int pad = 16 / esize;  // rows stay 16-byte aligned and shift by 4 banks
  o.np = (N + 15) & ~15;       // N rounded up to a whole k16 step (zero columns)
  o.xs = kPT + pad;
  o.ns = o.np + pad;
  o.ss = o.np + 8;
  o.x = 0;
  o.b = align16(size_t(kL) * o.xs * esize);
  o.c = o.b + align16(size_t(kL) * o.ns * esize);
  o.dt = o.c + align16(size_t(kL) * o.ns * esize);
  o.stage = o.dt + align16(kL * sizeof(float));
  o.part = align16(size_t(kPT) * o.ss * 2);  // bytes of one part
  o.split = 2 * o.stage;                       // [3 parts]
  o.xw_part = align16(size_t(kL) * kXW * 2);
  o.xw = o.split + 3 * o.part;                 // [3 parts]
  o.cum = o.xw + 3 * o.xw_part;
  o.ecum = o.cum + kL * sizeof(float);
  o.w = o.ecum + kL * sizeof(float);
  o.yi = o.w + kL * sizeof(float);
  o.yp = o.yi + size_t(kL) * kYS * sizeof(float);
  o.total = align16(o.yp + size_t(32) * kYS * sizeof(float));
  return o;
}

// ---- helpers ---------------------------------------------------------------

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}

// (x0, x1) -> bf16 pairs hi = bf16(x), lo = bf16(x - hi); the element with
// the lower index in the low half, as mma expects.
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = bf16x2_bits(h);
  lo = bf16x2_bits(__floats2bfloat162_rn(__fsub_rn(x0, hf.x), __fsub_rn(x1, hf.y)));
}

// (x0, x1) -> three bf16 pairs with hi + mid + lo == x exactly: each
// residual is exact in fp32, and the last has at most 8 significant bits.
__device__ __forceinline__ void split3(float x0, float x1, uint32_t& hi, uint32_t& mid,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const float r0 = __fsub_rn(x0, hf.x), r1 = __fsub_rn(x1, hf.y);
  const __nv_bfloat162 m = __floats2bfloat162_rn(r0, r1);
  const float2 mf = __bfloat1622float2(m);
  hi = bf16x2_bits(h);
  mid = bf16x2_bits(m);
  lo = bf16x2_bits(__floats2bfloat162_rn(__fsub_rn(r0, mf.x), __fsub_rn(r1, mf.y)));
}

__device__ __forceinline__ float ldf(const float* p) { return *p; }
__device__ __forceinline__ float ldf(const __nv_bfloat16* p) { return __bfloat162float(*p); }

// An operand pair of two adjacent elements p[0], p[1] (hi, and lo for fp32).
__device__ __forceinline__ void frag_adj(const __nv_bfloat16* p, uint32_t& hi, uint32_t& lo) {
  hi = *reinterpret_cast<const uint32_t*>(p);
  lo = 0;
}
__device__ __forceinline__ void frag_adj(const float* p, uint32_t& hi, uint32_t& lo) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  split2(v.x, v.y, hi, lo);
}

// An operand pair of two elements at p0 and p1 (rows apart).
__device__ __forceinline__ void frag_two(const __nv_bfloat16* p0, const __nv_bfloat16* p1,
                                         uint32_t& hi, uint32_t& lo) {
  hi = uint32_t(__bfloat16_as_ushort(*p0)) | (uint32_t(__bfloat16_as_ushort(*p1)) << 16);
  lo = 0;
}
__device__ __forceinline__ void frag_two(const float* p0, const float* p1, uint32_t& hi,
                                         uint32_t& lo) {
  split2(*p0, *p1, hi, lo);
}

__device__ __forceinline__ void store2(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}

// d += a (16x16, row) * b (16x8, col); bf16 in, fp32 accumulation.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm(  // a pure function of its operands: the compiler may schedule it
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a * b as a sum of its own: the mma starts from zero and its result
// is added to d in IEEE fp32.  An mma truncates its sum toward zero (terms
// aligned to the largest, the result not rounded), so a chain of mmas into
// one accumulator drops a part of an ulp of the running sum at every step,
// always toward zero; from zero it drops it of this step's products only,
// and the adds round to nearest.
__device__ __forceinline__ void mma_add(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                        uint32_t b1) {
  float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  mma(s, a, b0, b1);
#pragma unroll
  for (int e = 0; e < 4; ++e) d[e] = __fadd_rn(d[e], s[e]);
}

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
// ldmatrix: four 8x8 b16 tiles; lane l gives the address of row l % 8 of
// tile l / 8 and receives, of tile j in r[j], (row l / 4, cols 2(l % 4),
// 2(l % 4) + 1), or with .trans (rows 2(l % 4), 2(l % 4) + 1, col l / 4)
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s));
}
__device__ __forceinline__ void ldsm4_t(uint32_t (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s));
}

__device__ __forceinline__ float2 unpack(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// Named barrier `id` over `n` threads: sync waits, arrive only counts.
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
constexpr int kBarCum = 1;    // cum and exp(cum) of the chunk ready (state -> rows)
constexpr int kBarState = 2;  // warp 4's cum and weights ready (the state group)
constexpr int kBarPart = 3;   // partial M @ X of row blocks 2 and 3 ready (row warps)

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void zero_bytes(unsigned char* p, size_t bytes) {  // 16-byte units
  for (size_t i = threadIdx.x; i < bytes / 16; i += kThreads) {
    reinterpret_cast<uint4*>(p)[i] = make_uint4(0, 0, 0, 0);
  }
}

// ---- the kernel ------------------------------------------------------------

// E: element type of x, B, C and y (fp32 or bf16).  Fragment layouts of
// mma.m16n8k16 (g = lane / 4, q = lane % 4): A a0 (row g, k 2q..2q+1), a1
// (row g + 8), a2 (k + 8), a3 (row g + 8, k + 8); B b0 (k 2q..2q+1, col
// g), b1 (k + 8); C c0, c1 (row g, cols 2q, 2q + 1), c2, c3 (row g + 8).
template <typename E>
__global__ void __launch_bounds__(kThreads, 2) ssd_scan_kernel(const SsdArgs a) {
  constexpr bool kSplitIn = sizeof(E) == 4;  // fp32 x, B, C: split into hi + lo too
  constexpr int kEpu = 16 / sizeof(E);        // elements per 16-byte copy
  extern __shared__ __align__(16) unsigned char smem[];
  const int P = a.P, N = a.N, T = a.T, H = a.H, L = a.L;
  const SsdLayout o = ssd_layout(N, sizeof(E));
  const int XS = o.xs, NS = o.ns, SS = o.ss;
  const int n_pt = (P + kPT - 1) / kPT;
  const int bh = blockIdx.x / n_pt, pt = blockIdx.x - bh * n_pt;
  const int b = bh / H, h = bh - b * H, grp = h / (H / a.G);
  const int p0 = pt * kPT, pw = min(kPT, P - p0);  // this CTA's state rows
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const bool rows_group = warp < kWarps;
  const int w = rows_group ? warp : warp - kWarps;  // the warp's index in its group
  const int n_tiles = N / 8;
  const float a_h = a.a[h];
  const E* xg = static_cast<const E*>(a.x) + size_t(b) * a.x_sb + size_t(h) * P + p0;
  const E* bg = static_cast<const E*>(a.bm) + size_t(b) * a.bc_sb + size_t(grp) * N;
  const E* cg = static_cast<const E*>(a.cm) + size_t(b) * a.bc_sb + size_t(grp) * N;
  const float* dtg = a.dt + size_t(b) * T * H + h;
  float* cum = reinterpret_cast<float*>(smem + o.cum);
  float* ecum = reinterpret_cast<float*>(smem + o.ecum);
  float* wts = reinterpret_cast<float*>(smem + o.w);
  float* yi_s = reinterpret_cast<float*>(smem + o.yi);  // [kL][kYS]
  float* yp_s = reinterpret_cast<float*>(smem + o.yp);  // [2][16][kYS]
  auto x_s = [&](int buf) { return reinterpret_cast<E*>(smem + buf * o.stage + o.x); };
  auto b_s = [&](int buf) { return reinterpret_cast<E*>(smem + buf * o.stage + o.b); };
  auto c_s = [&](int buf) { return reinterpret_cast<E*>(smem + buf * o.stage + o.c); };
  auto dt_s = [&](int buf) { return reinterpret_cast<float*>(smem + buf * o.stage + o.dt); };
  // part 0 (hi), 1 (mid), 2 (lo) of the split state, [kPT][SS], and of
  // the split xw, [kL][kXW] (bf16); only the state group reads or writes them
  auto s_part = [&](int part) {
    return reinterpret_cast<__nv_bfloat16*>(smem + o.split + part * o.part);
  };
  auto xw_part = [&](int part) {
    return reinterpret_cast<__nv_bfloat16*>(smem + o.xw + part * o.xw_part);
  };

  // the A operand of C, chunk rows r0..r0 + 15, k step k: ldmatrix for bf16,
  // hi + lo pairs for fp32
  auto load_c_frag = [&](const E* cs, int r0, int k, uint32_t (&ah)[4], uint32_t (&al)[4]) {
    if constexpr (kSplitIn) {
      const E* cp = cs + (r0 + gq) * NS + k + 2 * tq;
      frag_adj(cp, ah[0], al[0]);
      frag_adj(cp + 8 * NS, ah[1], al[1]);
      frag_adj(cp + 8, ah[2], al[2]);
      frag_adj(cp + 8 * NS + 8, ah[3], al[3]);
    } else {
      ldsm4(ah, cs + (r0 + (lane & 15)) * NS + k + 8 * (lane >> 4));
      al[0] = al[1] = al[2] = al[3] = 0;
    }
  };

  // every pad row and column reads as 0 (x past pw, B and C past N, the
  // split state past N, rows past L); staging writes only real elements
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

  // the state group's S tile in accumulator layout: sr[i] is column tile
  // nt = w + 4i, elements (p = gq, gq + 8) x (n = 8nt + 2tq, + 1)
  float sr[kNTW][4];
  auto store_split_state = [&]() {
#pragma unroll
    for (int i = 0; i < kNTW; ++i) {
      const int nt = w + kWarps * i;
      if (nt < n_tiles) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int off = (gq + 8 * half) * SS + 8 * nt + 2 * tq;
          uint32_t hi, mid, lo;
          split3(sr[i][2 * half], sr[i][2 * half + 1], hi, mid, lo);
          *reinterpret_cast<uint32_t*>(s_part(0) + off) = hi;
          *reinterpret_cast<uint32_t*>(s_part(1) + off) = mid;
          *reinterpret_cast<uint32_t*>(s_part(2) + off) = lo;
        }
      }
    }
  };
  if (!rows_group) {
    const float* s0 = a.s0 ? a.s0 + ((size_t(b) * H + h) * P + p0) * N : nullptr;
#pragma unroll
    for (int i = 0; i < kNTW; ++i) {
      const int nt = w + kWarps * i;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = gq + 8 * (e >> 1), n = 8 * nt + 2 * tq + (e & 1);
        sr[i][e] = s0 != nullptr && nt < n_tiles && p < pw ? s0[size_t(p) * N + n] : 0.0f;
      }
    }
    store_split_state();
    stage(0, 0);
    cp_async_commit();
  }

  E* yg = static_cast<E*>(a.y) + size_t(b) * T * H * P + size_t(h) * P + p0;
  const int n_chunks = (T + L - 1) / L;
  // clock stamps (-DKERNEL_PROBE builds only): lane 0 of every warp of
  // CTAs 0 and 400, the phases of each of the first 16 chunks
  [[maybe_unused]] const bool stamps = (blockIdx.x == 0 || blockIdx.x == 400) && lane == 0;
#define CHUNK_STAMP(k) \
  PROBE(stamps && c < 16, ((blockIdx.x ? 128 : 0) + warp * 16 + c) * 8 + (k))
  for (int c = 0; c < n_chunks; ++c) {
    const int buf = c & 1, t0 = c * L, lc = min(L, T - t0);
    if (!rows_group) cp_async_wait_all();  // chunk c: the one group in flight
    __syncthreads();  // chunk c staged, S_prev split, chunk c - 1 done
    CHUNK_STAMP(0);
    const E* xs = x_s(buf);
    const E* bs = b_s(buf);
    const E* cs = c_s(buf);
    const float* dts = dt_s(buf);

    if (rows_group) {
      // The lower triangle in units of (row block rb, column pair kk <= rb):
      // block rb has rb + 1 of them, so each warp takes a share: warp 0
      // block 0 and pairs 0-1 of block 3, warp 1 block 1 and pair 0 of
      // block 2, warp 2 pairs 1-2 of block 2, warp 3 pairs 2-3 of block 3
      // (three units at most, four for one warp before).  Warps 0 and 1
      // hand their partial M @ X of blocks 3 and 2 over in shared memory.
      // Segment 0: (rb0, pairs lo0..hi0); warps 0 and 1 also segment 1:
      // their own block, pairs 0..w.
      const int rb0 = w == 0 ? 3 : w == 1 ? 2 : w;
      const int lo0 = w == 0 ? 0 : w == 1 ? 0 : w - 1;
      const int hi0 = w == 0 ? 1 : w == 1 ? 0 : w;
      const bool part0 = w < 2;      // segment 0 is a partial, finished by warp rb0
      const bool has1 = w < 2;       // segment 1: block w, pairs 0..w, finished here
      // C B^T of a segment: column tiles 2lo..2hi + 1 of row block rb, each
      // k16 step of n added by mma_add (cb[2j + q]: tile 2(lo + j) + q); no
      // cum
      auto cb_tiles = [&](float (&cb)[4][4], int rb, int lo, int hi) {
#pragma unroll
        for (int t = 0; t < 4; ++t) cb[t][0] = cb[t][1] = cb[t][2] = cb[t][3] = 0.0f;
        if (16 * rb >= lc) return;
        // two k16 steps an iteration, their fragments loaded first (np is a
        // multiple of 16; an odd last step runs alone); not unrolled further,
        // which held more registers and measured slower
#pragma unroll 1
        for (int k = 0; k < o.np; k += 32) {
          const bool two = k + 16 < o.np;
          uint32_t ah[2][4], al[2][4];
          load_c_frag(cs, 16 * rb, k, ah[0], al[0]);
          if (two) load_c_frag(cs, 16 * rb, k + 16, ah[1], al[1]);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int pr = lo + j;
            if (pr <= hi) {
              uint32_t bh[2][4], bl[2][4];
#pragma unroll
              for (int ks = 0; ks < 2; ++ks) {
                if (ks == 0 || two) {
                  const int kk = k + 16 * ks;
                  if constexpr (kSplitIn) {
#pragma unroll
                    for (int q = 0; q < 2; ++q) {
                      const E* bp = bs + (16 * pr + 8 * q + gq) * NS + kk + 2 * tq;
                      frag_adj(bp, bh[ks][2 * q], bl[ks][2 * q]);
                      frag_adj(bp + 8, bh[ks][2 * q + 1], bl[ks][2 * q + 1]);
                    }
                  } else {
                    ldsm4(bh[ks], bs + (16 * pr + (lane & 7) + 8 * (lane >> 4)) * NS + kk +
                                      8 * ((lane >> 3) & 1));
                  }
                }
              }
#pragma unroll
              for (int ks = 0; ks < 2; ++ks) {
                if (ks == 0 || two) {
#pragma unroll
                  for (int q = 0; q < 2; ++q) {
                    mma_add(cb[2 * j + q], ah[ks], bh[ks][2 * q], bh[ks][2 * q + 1]);
                    if constexpr (kSplitIn) {
                      mma(cb[2 * j + q], ah[ks], bl[ks][2 * q], bl[ks][2 * q + 1]);
                      mma(cb[2 * j + q], al[ks], bh[ks][2 * q], bh[ks][2 * q + 1]);
                    }
                  }
                }
              }
            }
          }
        }
      };
      // M = CB * exp(cum_t - cum_s) * dt_s on and below the diagonal, 0
      // above; then M @ X over the segment's pairs into yo.  The high
      // parts' products go to yo one k16 step at a time (mma_add), the mid
      // and low parts' into yl, added to yo once in IEEE fp32: added into
      // the hi sum, an mma would cut their low bits off, always toward zero
      auto m_times_x = [&](float (&cb)[4][4], int rb, int lo, int hi, float (&yo)[2][4]) {
        float yl[2][4];
#pragma unroll
        for (int e = 0; e < 4; ++e) yo[0][e] = yo[1][e] = yl[0][e] = yl[1][e] = 0.0f;
        if (16 * rb >= lc) return;
        const int ta = 16 * rb + gq, tb = ta + 8;
        const float cum_a = cum[ta], cum_b = cum[tb];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int kk = lo + j;
          if (kk > hi) break;
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const int s0 = 16 * kk + 8 * q + 2 * tq;  // columns s0 and s0 + 1
            const float2 cs2 = *reinterpret_cast<const float2*>(cum + s0);
            const float2 ds2 = *reinterpret_cast<const float2*>(dts + s0);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int t = e < 2 ? ta : tb, s = s0 + (e & 1);
              const float cum_s = e & 1 ? cs2.y : cs2.x, dt_s = e & 1 ? ds2.y : ds2.x;
              float& m = cb[2 * j + q][e];
              m = s <= t ? m * expf((e < 2 ? cum_a : cum_b) - cum_s) * dt_s : 0.0f;
            }
          }
          uint32_t mh[4], mm[4], ml[4];
          split3(cb[2 * j][0], cb[2 * j][1], mh[0], mm[0], ml[0]);
          split3(cb[2 * j][2], cb[2 * j][3], mh[1], mm[1], ml[1]);
          split3(cb[2 * j + 1][0], cb[2 * j + 1][1], mh[2], mm[2], ml[2]);
          split3(cb[2 * j + 1][2], cb[2 * j + 1][3], mh[3], mm[3], ml[3]);
          uint32_t xh[4], xl[4];  // b0, b1 of state-row tiles pn = 0, 1
          if constexpr (kSplitIn) {
#pragma unroll
            for (int pn = 0; pn < 2; ++pn) {
              const E* xp = xs + (16 * kk + 2 * tq) * XS + 8 * pn + gq;
              frag_two(xp, xp + XS, xh[2 * pn], xl[2 * pn]);
              frag_two(xp + 8 * XS, xp + 9 * XS, xh[2 * pn + 1], xl[2 * pn + 1]);
            }
          } else {
            ldsm4_t(xh, xs + (16 * kk + (lane & 7) + 8 * ((lane >> 3) & 1)) * XS +
                            8 * (lane >> 4));
          }
#pragma unroll
          for (int pn = 0; pn < 2; ++pn) {
            mma(yl[pn], ml, xh[2 * pn], xh[2 * pn + 1]);
            mma(yl[pn], mm, xh[2 * pn], xh[2 * pn + 1]);
            if constexpr (kSplitIn) mma(yl[pn], mh, xl[2 * pn], xl[2 * pn + 1]);
            mma_add(yo[pn], mh, xh[2 * pn], xh[2 * pn + 1]);
          }
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          yo[0][e] = __fadd_rn(yo[0][e], yl[0][e]);
          yo[1][e] = __fadd_rn(yo[1][e], yl[1][e]);
        }
      };
      // y = M @ X (+ a partner's partial) + exp(cum) * (C @ S_prev^T) of
      // block rb, real rows and columns only
      auto store_y = [&](float (&yo)[2][4], int rb, const float* partial) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int tl = gq + 8 * half, t = 16 * rb + tl;
          if (t < lc) {
            const float e_c = ecum[t];
#pragma unroll
            for (int pn = 0; pn < 2; ++pn) {
              const int p = 8 * pn + 2 * tq;
              if (p < pw) {
                float v0 = yo[pn][2 * half], v1 = yo[pn][2 * half + 1];
                if (partial != nullptr) {
                  const float2 pp = *reinterpret_cast<const float2*>(partial + tl * kYS + p);
                  v0 += pp.x;
                  v1 += pp.y;
                }
                const float2 yi = *reinterpret_cast<const float2*>(yi_s + t * kYS + p);
                store2(yg + (size_t(t0 + t) * H) * P + p, v0 + e_c * yi.x, v1 + e_c * yi.y);
              }
            }
          }
        }
      };

      float cb0[4][4], cb1[4][4], yo[2][4];
      cb_tiles(cb0, rb0, lo0, hi0);
      if (has1) cb_tiles(cb1, w, 0, w);
      CHUNK_STAMP(1);
      bar_sync(kBarCum, kThreads);  // cum, exp(cum) and C @ S_prev^T of this chunk
      CHUNK_STAMP(2);
      m_times_x(cb0, rb0, lo0, hi0, yo);
      float* slot = yp_s + (rb0 - 2) * 16 * kYS;  // blocks 2 and 3
      if (part0) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
#pragma unroll
          for (int pn = 0; pn < 2; ++pn) {
            *reinterpret_cast<float2*>(slot + (gq + 8 * half) * kYS + 8 * pn + 2 * tq) =
                make_float2(yo[pn][2 * half], yo[pn][2 * half + 1]);
          }
        }
        __threadfence_block();
        bar_arrive(kBarPart, 32 * kWarps);
        m_times_x(cb1, w, 0, w, yo);
        store_y(yo, w, nullptr);
      } else {
        bar_sync(kBarPart, 32 * kWarps);  // the partner's pairs of this block
        store_y(yo, rb0, slot);
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
      // C @ S_prev^T for chunk rows 16w..16w + 15 and the tile's 16 state
      // rows, one k16 step of n at a time; each part of the split state in
      // its own accumulator, summed at the end, the small parts first (the
      // hi part's chain by mma_add measured no change in the rounding lean)
      if (16 * w < lc) {
        float yp[3][2][4];
#pragma unroll
        for (int q = 0; q < 3; ++q) {
#pragma unroll
          for (int e = 0; e < 4; ++e) yp[q][0][e] = yp[q][1][e] = 0.0f;
        }
        const int soff = ((lane & 7) + 8 * (lane >> 4)) * SS + 8 * ((lane >> 3) & 1);
#pragma unroll 2
        for (int k = 0; k < o.np; k += 16) {
          uint32_t ah[4], al[4];
          load_c_frag(cs, 16 * w, k, ah, al);
#pragma unroll
          for (int q = 0; q < 3; ++q) {
            uint32_t sq[4];  // b0, b1 of state-row tiles pn = 0, 1: the split state's rows p
            ldsm4(sq, s_part(q) + soff + k);
#pragma unroll
            for (int pn = 0; pn < 2; ++pn) {
              mma(yp[q][pn], ah, sq[2 * pn], sq[2 * pn + 1]);
              if (kSplitIn && q == 0) mma(yp[1][pn], al, sq[2 * pn], sq[2 * pn + 1]);
            }
          }
        }
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int t = 16 * w + gq + 8 * half;
#pragma unroll
          for (int pn = 0; pn < 2; ++pn) {
            float2 v;
            v.x = yp[0][pn][2 * half] + (yp[1][pn][2 * half] + yp[2][pn][2 * half]);
            v.y = yp[0][pn][2 * half + 1] + (yp[1][pn][2 * half + 1] + yp[2][pn][2 * half + 1]);
            *reinterpret_cast<float2*>(yi_s + t * kYS + 8 * pn + 2 * tq) = v;
          }
        }
      }
      CHUNK_STAMP(1);
      __threadfence_block();
      bar_sync(kBarState, 32 * kWarps);  // warp 4's cum and weights, for the carry
      bar_arrive(kBarCum, kThreads);     // and for the row group, which waits there
      CHUNK_STAMP(2);

      // the next chunk lands while this one computes (its buffer's last
      // reads were in chunk c - 1, before this chunk's barrier)
      if (c + 1 < n_chunks) {
        stage(c + 1, buf ^ 1);
        cp_async_commit();
      }

      // the carry: S = exp(total) S + xw^T @ B, xw = x * dt * exp(total - cum),
      // split once into three bf16 parts by the whole state group (all kL
      // rows: past lc, x and the weights are 0)
      for (int i = tid - 32 * kWarps; i < kL * (kPT / 2); i += 32 * kWarps) {
        const int sr_ = i / (kPT / 2), pp = 2 * (i % (kPT / 2));  // row s, columns pp, pp + 1
        const float ws = wts[sr_];
        uint32_t hi, mid, lo;
        split3(ldf(xs + sr_ * XS + pp) * ws, ldf(xs + sr_ * XS + pp + 1) * ws, hi, mid, lo);
        *reinterpret_cast<uint32_t*>(xw_part(0) + sr_ * kXW + pp) = hi;
        *reinterpret_cast<uint32_t*>(xw_part(1) + sr_ * kXW + pp) = mid;
        *reinterpret_cast<uint32_t*>(xw_part(2) + sr_ * kXW + pp) = lo;
      }
      bar_sync(kBarState, 32 * kWarps);  // the split xw, for every state warp
      // xw^T @ B into accumulators u of its own, each part's products
      // (small parts first) chained over the chunk's k16 steps, then S =
      // exp(total) S + u in IEEE fp32, the plain version's order: chained
      // into S itself, every mma would cut the low bits of the small terms
      // off at S's exponent, always toward zero
      const float etot = expf(cum[kL - 1]);
      float u[kNTW][4];
#pragma unroll
      for (int i = 0; i < kNTW; ++i) u[i][0] = u[i][1] = u[i][2] = u[i][3] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < kWarps; ++kk) {
        if (16 * kk < lc) {
          // the A operand xw^T (rows p, k = s) of each part by ldmatrix.trans
          uint32_t xq[3][4];
          const int xoff = (16 * kk + (lane & 7) + 8 * (lane >> 4)) * kXW + 8 * ((lane >> 3) & 1);
#pragma unroll
          for (int q = 0; q < 3; ++q) ldsm4_t(xq[q], xw_part(q) + xoff);
          const int s = 16 * kk + 2 * tq;
#pragma unroll
          for (int i = 0; i < kNTW; i += 2) {  // column tiles w + 4i and w + 4(i + 1)
            const int nta = w + kWarps * i, ntb = nta + kWarps;
            if (nta < n_tiles) {
              uint32_t bh[4], bl[4];
              if constexpr (kSplitIn) {
#pragma unroll
                for (int q = 0; q < 2; ++q) {
                  const E* bp = bs + s * NS + 8 * (q ? ntb : nta) + gq;
                  frag_two(bp, bp + NS, bh[2 * q], bl[2 * q]);
                  frag_two(bp + 8 * NS, bp + 9 * NS, bh[2 * q + 1], bl[2 * q + 1]);
                }
              } else {
                const int nt = lane < 16 || ntb >= n_tiles ? nta : ntb;
                ldsm4_t(bh, bs + (16 * kk + (lane & 7) + 8 * ((lane >> 3) & 1)) * NS + 8 * nt);
              }
#pragma unroll
              for (int q = 0; q < 2; ++q) {
                if (q == 0 || ntb < n_tiles) {
                  float (&acc)[4] = u[i + q];
                  mma(acc, xq[2], bh[2 * q], bh[2 * q + 1]);
                  mma(acc, xq[1], bh[2 * q], bh[2 * q + 1]);
                  if constexpr (kSplitIn) mma(acc, xq[0], bl[2 * q], bl[2 * q + 1]);
                  mma(acc, xq[0], bh[2 * q], bh[2 * q + 1]);
                }
              }
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kNTW; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) sr[i][e] = __fadd_rn(__fmul_rn(sr[i][e], etot), u[i][e]);
      }
      // every state warp has read S_prev's split copy (C @ S_prev^T) before
      // the barrier above
      CHUNK_STAMP(3);
      store_split_state();
      CHUNK_STAMP(4);
    }
  }
#undef CHUNK_STAMP

  if (!rows_group) {
    float* sf = a.s_f + ((size_t(b) * H + h) * P + p0) * N;
#pragma unroll
    for (int i = 0; i < kNTW; ++i) {
      const int nt = w + kWarps * i;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int p = gq + 8 * half;
        if (nt < n_tiles && p < pw) {
          store2(sf + size_t(p) * N + 8 * nt + 2 * tq, sr[i][2 * half], sr[i][2 * half + 1]);
        }
      }
    }
  }
}

// CTAs of a launch: one per (batch row, head, tile of kPT state rows).
inline int grid_ctas(int B, int H, int P) { return B * H * ((P + kPT - 1) / kPT); }

template <typename T>
struct Instance {};  // one shared-memory table each

template <typename T>
cudaError_t launch(const SsdArgs& a, cudaStream_t stream) {
  const size_t smem = ssd_layout(a.N, sizeof(T)).total;
  auto kernel = ssd_scan_kernel<T>;
  cudaError_t err = set_smem_once<Instance<T>>(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid_ctas(a.B, a.H, a.P), kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Returns cudaGetLastError() of the launch (0 on success).  x, B and C
// share `dtype` and are read at the batch and token strides given (in
// elements; heads and state columns contiguous, every row 16-byte
// aligned); dt, s0, y and s_f are contiguous; s0 may be null.  Requires
// H % G == 0, T >= 1, 1 <= L <= 64, P % 8 == 0, N % 8 == 0 and N <= 128.
extern "C" int ssd_scan(const void* x, const void* dt, const void* a, const void* bm,
                        const void* cm, const void* s0, void* y, void* s_f,
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

// CTAs of one launch (the grid the launch uses).
extern "C" long long ssd_scan_ctas(int B, int H, int P) { return grid_ctas(B, H, P); }

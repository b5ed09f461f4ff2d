// Single-query GQA decode attention for Hopper (sm_90a), split over the cache.
//
// Replaces the Pallas TPU kernel repro/kernels/decode_attn/decode_attn.py
// `decode_attn` (body `_decode_attn_kernel`): one new token per batch row
// attends to the valid prefix of a (B, S, Hkv, D) KV cache,
//     out[b, h] = softmax_s(scale * q[b, h] . k[b, s, h / G]) @ v[b, :, h / G]
// over s < lengths[b], with G = Hq / Hkv query heads sharing each cache
// head.  q is scaled before the dot (as the TPU kernel does); the scores,
// the maxima m, the denominators l and the numerators acc are fp32, and the
// output is rounded once to q's dtype.  The plain version
// (decode_attn.decode_attn_plain) performs the same steps in PyTorch.
//
// What bounds it on this card.  A decode step reads every valid cache row
// once and does 4 fp32 operations per cached element (2 for q.k, 2 for
// p.v): about G/2 operations per byte of a bf16 cache, far below the
// card's ~20 fp32 operations per byte.  So it is bound by bytes: at the
// smollm-360m serving shape (B=8, 5 KV heads, D=64, 576 rows, bf16) one
// call must move 5.9 MB, 1.8 us at 3.35 TB/s.  So little work per call also
// makes it bound by latency: the time one CTA takes from its first load to
// its last store, and the launch.
//
// What the design does about it (flash-decoding).
//   * The grid is (B * Hkv) x ceil(S / kSplitRows): each CTA takes one
//     split of kSplitRows cache rows of one (row, KV head), so at the
//     serving shape 360 CTAs of 128 threads stream 16 KB each, where one
//     CTA per (row, head) gave 40.  kSplitRows is a constant, never derived
//     from B or the SM count, so a row's output does not depend on the
//     batch it is served in.  A split that starts at or past the row's
//     length reads nothing.
//   * A split's K and V are copied to shared memory at their storage dtype
//     with 16-byte cp.async copies, neighbouring threads on neighbouring
//     addresses, in two stages of kBlockS rows: the scores of the first
//     stage are computed while the second is in flight.  The ragged last
//     split is masked here; rows at or past the length are never read.
//   * Scores: a group of kLPR lanes takes one row, each lane a 16-byte
//     chunk of D, dotted against its chunk of q (scaled, fp32, in
//     registers, kQTile heads at a time) and summed across the group with
//     shuffles.  The softmax of the split (m = max, p = exp(s - m),
//     l = sum p) takes one warp per head; p @ V gives each thread pairs of
//     (head, d) accumulators.  Two barriers per stage.
//   * Each CTA writes its partial (m, l, acc) in fp32 to a scratch; the
//     last CTA of a (row, head) to finish, found with a per-(row, head)
//     counter after __threadfence, combines the valid splits in split order
//     0..n-1 (m* = max m_i, l = sum exp(m_i - m*) l_i, acc likewise,
//     out = acc / max(l, 1e-30)) and resets the counter to 0.  No float
//     atomics: the result is the same on every run.  One thread fences and
//     counts after a CTA barrier (a fence on every thread was the largest
//     single cost of the first version), and the combine loads all its
//     partials in one round trip to L2.  A thread block cluster that keeps
//     the partials in shared memory and combines them over DSMEM was no
//     faster on the H100, so the counter stays: the combine's cost is the
//     wait for the slowest split, not the round trip.
//   * cudaFuncSetAttribute runs once per instantiation and size
//     (smem_attr.cuh), not on every launch.
// TMA and wgmma are not used: a split is 16 KB and its products are
// (G x D) . (D x 64), too small for either to pay.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

#include "smem_attr.cuh"

namespace {

enum DType { kF32 = 0, kBF16 = 1 };

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kSplitRows = 64;  // cache rows per CTA (one split)
constexpr int kBlockS = 32;     // rows per cp.async stage
constexpr int kStages = kSplitRows / kBlockS;
constexpr int kQTile = 4;       // query heads whose q chunks a lane holds at once
constexpr int kMaxPairs = 4;    // (head, d) pairs per thread: G * D <= 2 * kThreads * kMaxPairs
constexpr int kCombineSplits = 16;  // splits whose partials the combine holds in registers
constexpr float kNegInf = -1e30f;  // the TPU kernel's mask value
static_assert(kSplitRows == 64 && kStages == 2, "the softmax gives each lane two rows");

// One 16-byte chunk of the cache: E elements of T, unpacked to fp32.
template <typename T> struct Chunk;
template <> struct Chunk<float> {
  static constexpr int E = 4;
  __device__ static void unpack(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
};
template <> struct Chunk<__nv_bfloat16> {
  static constexpr int E = 8;
  __device__ static void unpack(const uint4& u, float* f) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);            // bf16 -> fp32 is exact
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kPending> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

struct Args {
  const void* q;       // (B, Hkv * G, D)
  const void* k;       // (B, S, Hkv, D)
  const void* v;       // (B, S, Hkv, D)
  const int* lengths;  // (B,)
  void* out;           // (B, Hkv * G, D)
  float* part;         // (B * Hkv, n_split, G * D + 2 * G): acc, then m, then l
  unsigned* count;     // (B * Hkv,): 0 before and after every launch
  int S, Hkv, G, D, n_split;
  float scale;
};

// Bytes of dynamic shared memory one CTA needs.
__host__ __device__ inline size_t smem_bytes(int G, int D, int t_bytes) {
  return 2 * size_t(kSplitRows) * D * t_bytes                    // K and V of the split
         + (size_t(G) * kSplitRows + 2 * size_t(G) + 1) * 4;     // scores/p, m, l, flag
}

// kLPR lanes score one row (a power of two <= 32), each kCPL 16-byte chunks.
template <typename T, int kLPR, int kCPL>
__global__ void __launch_bounds__(kThreads) decode_attn_kernel(const Args a) {
  constexpr int E = Chunk<T>::E;
  extern __shared__ __align__(16) unsigned char smem[];
  const int G = a.G, D = a.D, GD = G * D, cpr = D / E;
  T* k_s = reinterpret_cast<T*>(smem);
  T* v_s = k_s + kSplitRows * D;
  float* s_s = reinterpret_cast<float*>(v_s + kSplitRows * D);  // [G][kSplitRows]
  float* m_s = s_s + G * kSplitRows;
  float* l_s = m_s + G;
  int* last_s = reinterpret_cast<int*>(l_s + G);

  const int bh = blockIdx.x, split = blockIdx.y;
  const int b = bh / a.Hkv, h = bh - b * a.Hkv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int len = min(max(a.lengths[b], 0), a.S);
  const int n_valid = (len + kSplitRows - 1) / kSplitRows;
  const int row0 = split * kSplitRows;
  const int rows = min(kSplitRows, len - row0);  // <= 0: an empty split
  // this CTA's G query heads are contiguous: q[b, h*G : (h+1)*G, :]
  const size_t q_off = size_t(bh) * GD;
  const T* q = static_cast<const T*>(a.q) + q_off;
  const size_t stride = size_t(GD) + 2 * G;  // floats of one partial
  float* part = a.part + size_t(bh) * a.n_split * stride;
  float* mine = part + split * stride;  // this split's partial

  if (rows > 0) {
    // stage the split's K and V rows, kBlockS rows per commit group
    const size_t row_stride = size_t(a.Hkv) * D;
    const size_t kv_off = (size_t(b) * a.S * a.Hkv + h) * D + size_t(row0) * row_stride;
    const T* kg = static_cast<const T*>(a.k) + kv_off;
    const T* vg = static_cast<const T*>(a.v) + kv_off;
#pragma unroll
    for (int st = 0; st < kStages; ++st) {
      const int r_lo = st * kBlockS;
      const int n = (min(r_lo + kBlockS, rows) - r_lo) * cpr;  // <= 0 past the length
      for (int i = tid; i < n; i += kThreads) {
        const int r = r_lo + i / cpr, c = i % cpr;
        const size_t g = size_t(r) * row_stride + size_t(c) * E;
        cp_async16(k_s + r * D + c * E, kg + g);
        cp_async16(v_s + r * D + c * E, vg + g);
      }
      cp_async_commit();  // every thread commits one group per stage
    }

    // scores: lane `lig` of a group of kLPR lanes holds chunks lig,
    // lig + kLPR, ... of q (kCPL of them) for kQTile heads
    constexpr int lpr = kLPR, rpw = 32 / kLPR;  // rows per warp per pass
    const int lig = lane & (lpr - 1), rw = lane / lpr;
    float qr[kQTile][kCPL * E];
    auto load_q = [&](int g0) {
#pragma unroll
      for (int gg = 0; gg < kQTile; ++gg) {
#pragma unroll
        for (int cc = 0; cc < kCPL; ++cc) {
          const int c = lig + cc * lpr;
          float* qc = qr[gg] + cc * E;
          if (g0 + gg < G && c < cpr) {
            Chunk<T>::unpack(*reinterpret_cast<const uint4*>(q + (g0 + gg) * D + c * E), qc);
#pragma unroll
            for (int e = 0; e < E; ++e) qc[e] *= a.scale;
          } else {
#pragma unroll
            for (int e = 0; e < E; ++e) qc[e] = 0.0f;
          }
        }
      }
    };
    load_q(0);
#pragma unroll
    for (int st = 0; st < kStages; ++st) {
      if (st == 0) {
        cp_async_wait<kStages - 1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();  // stage st is in shared memory for every thread
      const int r_lo = st * kBlockS, r_hi = min(r_lo + kBlockS, rows);
      for (int g0 = 0; g0 < G; g0 += kQTile) {
        // one tile of heads is loaded once, above; more are reloaded in turn
        if (G > kQTile && (g0 > 0 || st > 0)) load_q(g0);
        for (int base = r_lo; base < r_lo + kBlockS; base += kWarps * rpw) {
          const int r = base + warp * rpw + rw;
          const bool row_ok = r < r_hi;  // uniform across the lpr lanes of a row
          float kf[kCPL * E];
#pragma unroll
          for (int cc = 0; cc < kCPL; ++cc) {
            const int c = lig + cc * lpr;
            if (row_ok && c < cpr) {
              Chunk<T>::unpack(*reinterpret_cast<const uint4*>(k_s + r * D + c * E), kf + cc * E);
            } else {
#pragma unroll
              for (int e = 0; e < E; ++e) kf[cc * E + e] = 0.0f;
            }
          }
#pragma unroll
          for (int gg = 0; gg < kQTile; ++gg) {
            float sc = 0.0f;
#pragma unroll
            for (int i = 0; i < kCPL * E; ++i) sc = fmaf(qr[gg][i], kf[i], sc);
#pragma unroll
            for (int o = lpr >> 1; o > 0; o >>= 1) sc += __shfl_xor_sync(0xffffffffu, sc, o);
            if (row_ok && lig == 0 && g0 + gg < G) s_s[(g0 + gg) * kSplitRows + r] = sc;
          }
        }
      }
    }
    __syncthreads();  // every score of the split is in s_s

    // softmax of the split: one warp per head, lanes own rows lane, lane + 32
    for (int g = warp; g < G; g += kWarps) {
      float* sg = s_s + g * kSplitRows;
      const float s0 = lane < rows ? sg[lane] : kNegInf;
      const float s1 = lane + 32 < rows ? sg[lane + 32] : kNegInf;
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float p0 = lane < rows ? expf(s0 - mx) : 0.0f;
      const float p1 = lane + 32 < rows ? expf(s1 - mx) : 0.0f;
      float sum = p0 + p1;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      sg[lane] = p0;
      sg[lane + 32] = p1;
      if (lane == 0) {
        m_s[g] = mx;
        l_s[g] = sum;
      }
    }
    __syncthreads();  // p, m and l of every head

    // acc = p @ V of the split, two (head, d) elements per pair; write the
    // partial (acc unnormalised, m, l)
#pragma unroll
    for (int j = 0; j < kMaxPairs; ++j) {
      const int e = tid + j * kThreads;
      if (2 * e < GD) {
        const int g = 2 * e / D, d = 2 * e - g * D;
        const float* pg = s_s + g * kSplitRows;
        float a0 = 0.0f, a1 = 0.0f;
#pragma unroll 16
        for (int r = 0; r < rows; ++r) {
          const float2 vv = load_pair(v_s + r * D + d);
          a0 = fmaf(pg[r], vv.x, a0);
          a1 = fmaf(pg[r], vv.y, a1);
        }
        store_pair(mine + 2 * e, a0, a1);
      }
    }
    for (int g = tid; g < G; g += kThreads) {
      mine[GD + g] = m_s[g];
      mine[GD + G + g] = l_s[g];
    }
  }

  // the last CTA of this (row, head) to finish combines the partials.  The
  // barrier orders the CTA's partial writes before thread 0's fence and
  // count (the pattern of cooperative groups' grid sync); the last CTA's
  // fence after the count orders the other CTAs' partials before its reads
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    const bool last = atomicAdd(a.count + bh, 1u) == unsigned(a.n_split - 1);
    if (last) {
      __threadfence();
      a.count[bh] = 0;  // ready for the next launch
    }
    *last_s = last;
  }
  __syncthreads();
  if (!*last_s) return;

  // the combine, in split order 0..n-1: m* = max m_i, l = sum exp(m_i - m*)
  // l_i, acc alike, out = acc / max(l, 1e-30).  Each thread takes (head,
  // d) pairs; the m, l and acc of up to kCombineSplits splits are loaded
  // together, in one round trip to L2
  T* out = static_cast<T*>(a.out) + q_off;
#pragma unroll 1
  for (int j = 0; j < kMaxPairs; ++j) {
    const int e = tid + j * kThreads;
    if (2 * e >= GD) break;
    const int g = 2 * e / D;
    auto m_of = [&](int i) { return __ldcg(part + i * stride + GD + g); };
    auto l_of = [&](int i) { return __ldcg(part + i * stride + GD + G + g); };
    auto acc_of = [&](int i) {
      return __ldcg(reinterpret_cast<const float2*>(part + i * stride) + e);
    };
    float mx = kNegInf, l = 0.0f, a0 = 0.0f, a1 = 0.0f;
    if (n_valid <= kCombineSplits) {
      float mi[kCombineSplits], li[kCombineSplits];
      float2 ai[kCombineSplits];
#pragma unroll
      for (int i = 0; i < kCombineSplits; ++i) {
        if (i < n_valid) {
          mi[i] = m_of(i);
          li[i] = l_of(i);
          ai[i] = acc_of(i);
        }
      }
#pragma unroll
      for (int i = 0; i < kCombineSplits; ++i) {
        if (i < n_valid) mx = fmaxf(mx, mi[i]);
      }
#pragma unroll
      for (int i = 0; i < kCombineSplits; ++i) {
        if (i < n_valid) {
          const float w = expf(mi[i] - mx);
          l = fmaf(w, li[i], l);
          a0 = fmaf(w, ai[i].x, a0);
          a1 = fmaf(w, ai[i].y, a1);
        }
      }
    } else {  // long caches: the same arithmetic, loads as they come
      for (int i = 0; i < n_valid; ++i) mx = fmaxf(mx, m_of(i));
      for (int i = 0; i < n_valid; ++i) {
        const float w = expf(m_of(i) - mx);
        const float2 ai = acc_of(i);
        l = fmaf(w, l_of(i), l);
        a0 = fmaf(w, ai.x, a0);
        a1 = fmaf(w, ai.y, a1);
      }
    }
    const float den = fmaxf(l, 1e-30f);
    store_pair(out + 2 * e, a0 / den, a1 / den);
  }
}

template <typename T, int kLPR, int kCPL> struct Instance {};  // one shared-memory table each

template <typename T, int kLPR, int kCPL>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  const size_t smem = smem_bytes(a.G, a.D, sizeof(T));
  auto kernel = decode_attn_kernel<T, kLPR, kCPL>;
  cudaError_t err = set_smem_once<Instance<T, kLPR, kCPL>>(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(B * a.Hkv, a.n_split), kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// Lanes per row and chunks per lane from the 16-byte chunks of a row.  The
// configs' head widths, D = 64 and 128, give 8 (D=64 bf16), 16 (D=64 fp32,
// D=128 bf16) or 32 (D=128 fp32) chunks: one lane each.  Narrower heads
// leave lanes of a group idle (the c < cpr masks); wider ones up to the
// G * D limit take 4 chunks a lane.
template <typename T>
cudaError_t by_chunks(const Args& a, int B, int cpr, cudaStream_t stream) {
  if (cpr <= 8) return launch<T, 8, 1>(a, B, stream);
  if (cpr <= 16) return launch<T, 16, 1>(a, B, stream);
  if (cpr <= 32) return launch<T, 32, 1>(a, B, stream);
  if (cpr <= 128) return launch<T, 32, 4>(a, B, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// Returns cudaGetLastError() of the launch (0 on success).  q (B, Hkv*G, D),
// k and v (B, S, Hkv, D) and out (B, Hkv*G, D) are contiguous, 16-byte
// aligned and of one dtype; lengths (B,) int32; part holds
// decode_attn_part_floats() fp32; count holds B*Hkv uint32 that are 0 (the
// kernel leaves them 0).  Requires G * D <= decode_attn_max_gd() and D a
// multiple of 16 bytes' worth of elements (8 in bf16, 4 in fp32).
extern "C" int decode_attn(const void* q, const void* k, const void* v,
                           const void* lengths, void* out, void* part, void* count,
                           int B, int S, int Hkv, int G, int D, int dtype, void* stream) {
  const int e = dtype == kF32 ? Chunk<float>::E : Chunk<__nv_bfloat16>::E;
  if (dtype != kF32 && dtype != kBF16) return cudaErrorInvalidValue;
  if (G * D > 2 * kThreads * kMaxPairs || D % e != 0 || S < 1 || B < 1 ||
      (S + kSplitRows - 1) / kSplitRows > 65535) {
    return cudaErrorInvalidValue;
  }
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.lengths = static_cast<const int*>(lengths);
  a.out = out;
  a.part = static_cast<float*>(part);
  a.count = static_cast<unsigned*>(count);
  a.S = S;
  a.Hkv = Hkv;
  a.G = G;
  a.D = D;
  a.n_split = (S + kSplitRows - 1) / kSplitRows;
  // the TPU kernel's scale: the Python float 1 / sqrt(D), rounded to fp32
  a.scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(D)));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return by_chunks<float>(a, B, D / e, s);
  return by_chunks<__nv_bfloat16>(a, B, D / e, s);
}

// Dynamic shared memory one CTA needs.
extern "C" long long decode_attn_smem_bytes(int G, int D, int dtype) {
  return static_cast<long long>(smem_bytes(G, D, dtype == kF32 ? 4 : 2));
}

// fp32 values of the partials' scratch of one launch.
extern "C" long long decode_attn_part_floats(int B, int S, int Hkv, int G, int D) {
  const long long n_split = (S + kSplitRows - 1) / kSplitRows;
  return static_cast<long long>(B) * Hkv * n_split * (static_cast<long long>(G) * D + 2 * G);
}

// Query heads times head width one CTA can hold (G * D at most).
extern "C" int decode_attn_max_gd() { return 2 * kThreads * kMaxPairs; }

// Cache rows per split and per cp.async stage (decode_attn.SPLIT_ROWS, BLOCK_S).
extern "C" int decode_attn_split_rows() { return kSplitRows; }
extern "C" int decode_attn_block_rows() { return kBlockS; }

// One lockstep beam-search iteration for a batch of queries, on Hopper.
//
// Replaces three Pallas kernels: beam_step (the kernel the JAX package runs
// on every serving and build iteration over f32/bf16 rows) and
// beam_step_lvq (the same step over LVQ-8 code rows decoded in the kernel),
// both in scalablevectorsearch_tpu/ops/pallas/beam_step.py, and beam_update
// (scalablevectorsearch_tpu/ops/pallas/beam_update.py: the same merge and
// pop over candidates scored beforehand).  The Python wrappers and the
// plain PyTorch versions are in scalablevectorsearch_tpu_torch/ops/kernels/
// beam_step.py and beam_update.py.
//
// Per query row it scores K gathered candidate rows, masks ids repeated
// within the iteration and ids already in the beam, sorts the candidates,
// merges them into the sorted beam (truncated to C) and pops the first m
// unvisited slots inside the window, setting their visited bit
// (packed = id | visited << 30).  One kernel template serves the three
// entry points; only the row loader differs (DenseRows / LvqRows below, and
// KeyRows, which reads the keys as given and scores nothing).
//
// What bounds it: bytes and instructions, not tensor cores.  Each gathered
// row meets one query (a matrix-vector product: one multiply-add per
// element read, about one operation per byte), so the tensor cores have
// nothing to do.  Reading the (B, K, d) rows is the byte bound (64 KB per
// query per iteration at K = d = 128 in f32, half at bf16, a quarter as
// LVQ-8 codes); the dedup / sort / merge core and the LVQ decode are the
// instruction bound.  At the main path's shapes every query of a launch is
// resident at once (one wave), so a launch lasts about as long as one
// warp's whole chain of staging, loads and core.  The design:
// - One warp owns one query through all steps (stage, score, dedup,
//   membership, sort, merge and pop); a CTA holds several queries and its
//   warps never wait for each other (no __syncthreads after the shared
//   mean), so one warp's sorting overlaps another's loads.  Where B warps
//   would leave the SMs thin (the serving search's compacted tail, B 418),
//   the launcher gives each query 2-8 warps that split its scoring and meet
//   at a named barrier; the query's first warp then runs the core, and
//   small CTAs spread the queries over every SM.
// - Staging issues all of a thread's loads (candidate ids, beam, query,
//   LVQ scales and biases, or beam_update's keys) before its first store:
//   one round trip to memory.
// - The row stream is design (a) of the two the redesign weighed: many
//   resident warps, registers only.  Design (b), each warp's row block
//   streamed by cp.async.bulk through a two-slot shared-memory ring, ran
//   16-21% slower at the build shape (PERF.md): the ring's shared memory
//   and reads cost more than the loads they replace.  The stream reads
//   every byte of a live candidate's row once (rows of invalid ids are
//   not read), 16 bytes a load.  On the
//   fast path (a row of 8 * kCpl 16-byte chunks: d = 128 for f32, bf16
//   and LVQ-8 codes) 8 lanes share a row, each lane keeps its slice of the
//   query (and of the LVQ mean) in registers and has 8 (LVQ: 4) loads in
//   flight; other widths take the generic path (the whole warp on a row,
//   four rows in flight, query in shared memory), and so do rows that are
//   not 16-byte aligned (4- or 1-element loads).
// - LVQ-8 rows decode in registers as (mean + bias) + scale * code with
//   the plain version's rounding (no fused multiply-add in the decode); the
//   dead-lane term is subtracted after the sum.  The int8 -> f32 convert is
//   a byte permute into a float's mantissa and one exact subtraction, not
//   the quarter-rate I2F.
// - The core is O(K log^2 K) on one warp in place of O(K^2) rank loops:
//   a bitonic sort of (id, column) (in registers up to 128 elements, in
//   shared memory above) finds repeats as equal neighbours and gives the
//   id-order pool; each live beam id finds its candidate by binary search
//   in that order (beam membership, O(C log K)); a second bitonic sort
//   orders the surviving candidates by (key, id); merge-path binary
//   searches, four interleaved per lane, place beam and candidates; a
//   ballot pops.  The sort is one function that is not inlined: two
//   inlined copies of every unrolled network overflowed the instruction
//   cache.  Ids at or above 2^30 trap (__trap()).
//
// Tie order (the plain version's, exactly): candidates by (key, id); the
// beam entry before the candidate on equal keys.  Candidates whose key is
// +inf never enter the truncated merge, so their order is free.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

typedef unsigned long long u64;

constexpr int kMaxWarps = 8;           // warps per CTA
constexpr int kThreads = kMaxWarps * 32;
constexpr int kGroup = 8;              // lanes per row on the fast path
constexpr int kUnroll = 4;             // rows in flight per warp, generic path
constexpr int kStage = 4;              // staging loads in flight per thread
constexpr int kWarpsPerSm = 8;         // below this many queries a SM, split
constexpr int kCtasPerSm = 4;          // for small B: CTAs a SM at least
constexpr int kVisBit = 1 << 30;
constexpr int kIdMask = kVisBit - 1;
constexpr int kIntBig = 0x7fffffff;
constexpr int kL2 = 0, kMip = 1;
constexpr unsigned kFull = 0xffffffffu;
constexpr u64 kNoKey = ~0ull;          // sorts after every candidate

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Four consecutive elements starting at a 4-element-aligned address.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  uint2 raw = *reinterpret_cast<const uint2*>(p);
  __nv_bfloat162 lo, hi;
  memcpy(&lo, &raw.x, sizeof(lo));
  memcpy(&hi, &raw.y, sizeof(hi));
  float2 a = __bfloat1622float2(lo);
  float2 b = __bfloat1622float2(hi);
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

__device__ __forceinline__ float key_of(int metric, float qn, float s,
                                        float n2) {
  if (metric == kMip) return -s;
  if (metric == kL2) return fmaxf(qn - 2.f * s + n2, 0.f);
  return -s / (sqrtf(fmaxf(qn, 1e-30f)) * sqrtf(fmaxf(n2, 1e-30f)));
}

// A float's bits as an unsigned int in the float order (-0 counts as +0).
__device__ __forceinline__ unsigned ord_of(float f) {
  const unsigned u = __float_as_uint(f + 0.f);
  return (u >> 31) ? ~u : (u | 0x80000000u);
}
__device__ __forceinline__ float float_of(unsigned o) {
  return __uint_as_float((o >> 31) ? (o & 0x7fffffffu) : ~o);
}

constexpr int kSearch = 4;             // binary searches run side by side

// For each u: the number of entries of the ascending a[0:P] (P a power
// of two) that are < x[u].  Branchless, kSearch searches interleaved.
__device__ __forceinline__ void count_below(const u64* a, int P,
                                            const u64 (&x)[kSearch],
                                            int (&pos)[kSearch]) {
#pragma unroll
  for (int u = 0; u < kSearch; ++u) pos[u] = 0;
  for (int step = P >> 1; step > 0; step >>= 1) {
#pragma unroll
    for (int u = 0; u < kSearch; ++u)
      if (a[pos[u] + step - 1] < x[u]) pos[u] += step;
  }
#pragma unroll
  for (int u = 0; u < kSearch; ++u) pos[u] += a[pos[u]] < x[u];
}

// For each u: the number of entries of the ascending a[0:n] that are
// <= v[u] (cp: a power of two >= n).
__device__ __forceinline__ void at_most(const float* a, int n, int cp,
                                        const float (&v)[kSearch],
                                        int (&pos)[kSearch]) {
#pragma unroll
  for (int u = 0; u < kSearch; ++u) pos[u] = 0;
  for (int step = cp >> 1; step > 0; step >>= 1) {
#pragma unroll
    for (int u = 0; u < kSearch; ++u) {
      const int t = pos[u] + step - 1;
      if (t < n && a[t] <= v[u]) pos[u] += step;
    }
  }
#pragma unroll
  for (int u = 0; u < kSearch; ++u)
    pos[u] += pos[u] < n && a[pos[u]] <= v[u];
}

// ---- warp-wide bitonic sorts of P 64-bit keys (ascending) ---------------
// In registers: element lane * E + r sits in register r of `lane`;
// partners closer than E are register swaps, farther ones a shuffle.
template <int E>
__device__ __forceinline__ void sort_regs(u64* buf, int lane) {
  constexpr int P = 32 * E;
  u64 v[E];
#pragma unroll
  for (int r = 0; r < E; ++r) v[r] = buf[lane * E + r];
#pragma unroll
  for (int k = 2; k <= P; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      if (j >= E) {
#pragma unroll
        for (int r = 0; r < E; ++r) {
          const int idx = lane * E + r;
          const u64 o = __shfl_xor_sync(kFull, v[r], j / E);
          const bool keep_min = ((idx & j) == 0) == ((idx & k) == 0);
          if ((o < v[r]) == keep_min) v[r] = o;   // equal: either
        }
      } else {
#pragma unroll
        for (int r = 0; r < E; ++r) {
          if ((r & j) == 0) {
            const bool asc = ((lane * E + r) & k) == 0;
            const int r2 = (r | j) & (E - 1);   // r | j: in range here
            const u64 a = v[r], b = v[r2];
            if ((a > b) == asc) {
              v[r] = b;
              v[r2] = a;
            }
          }
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < E; ++r) buf[lane * E + r] = v[r];
  __syncwarp();
}

// The same network in shared memory, for P above 128.
__device__ void sort_smem(u64* buf, int P, int lane) {
  for (int k = 2; k <= P; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int t = lane; t < P / 2; t += 32) {
        const int i = ((t & ~(j - 1)) << 1) | (t & (j - 1));
        const bool asc = (i & k) == 0;
        const u64 a = buf[i], b = buf[i + j];
        if ((a > b) == asc) {
          buf[i] = b;
          buf[i + j] = a;
        }
      }
      __syncwarp();
    }
  }
}

// Sorts buf[0:P] (P a power of two, 32..1024); every lane returns with
// the sorted array visible.  Not inlined: both sorts of a query share one
// copy of the unrolled networks, which keeps the kernel's code small
// enough for the instruction cache.
__device__ __noinline__ void warp_sort(u64* buf, int P, int lane) {
  __syncwarp();
  switch (P) {
    case 32: sort_regs<1>(buf, lane); break;
    case 64: sort_regs<2>(buf, lane); break;
    case 128: sort_regs<4>(buf, lane); break;
    default: sort_smem(buf, P, lane);
  }
}

// ---- launch constants and the per-query shared-memory region -----------
struct Step {
  const float* mean;          // (d) LVQ mean, else null
  const float* beam_keys;     // (B, C)
  const int* beam_packed;     // (B, C)
  const int* cand_ids;        // (B, K)
  const void* queries;        // (B, d)
  float* out_keys;            // (B, C)
  int* out_packed;            // (B, C)
  int* popped;                // (B, m)
  float* pool_keys;           // (B, pool_stride)
  int* pool_ids;              // (B, pool_stride)
  int B, C, K, d, d_al, metric, window, m, pool_stride;
  int P;                      // sort width: a power of two >= max(K, 32)
  int qpc, wpq;               // queries per CTA, warps per query
  int fast;                   // the row block takes the fast stream
};

// Offsets (in 4-byte words) inside one query's region; the region starts
// 16-byte aligned, and so do buf (u64) and q (float4 reads).
struct Layout {
  int buf, q, ck, cid, sc, bi, bk, bp, nk, np, hit, red, words;
};

__host__ __device__ inline Layout layout_of(int d_al, int K, int C, int P,
                                            int wpq, bool lvq) {
  Layout L;
  int o = 0;
  L.buf = o; o += 2 * P;
  L.q = o; o += d_al;
  L.ck = o; o += K;
  L.cid = o; o += K;
  L.sc = o; o += lvq ? K : 0;
  L.bi = o; o += lvq ? K : 0;
  L.bk = o; o += C;
  L.bp = o; o += C;
  L.nk = o; o += C;
  L.np = o; o += C;
  L.hit = o; o += P;
  L.red = o; o += wpq;
  L.words = (o + 3) & ~3;
  return L;
}

// What a row loader sees of its query.
struct Query {
  int row, K, d, lane, sub, wpq, metric;
  float qn;
  const float* q_s;       // (d_al) the query in f32
  const float* mean_s;    // (d_al) the LVQ mean
  const int* cid_s;       // (K) candidate ids
  const float* sc_s;      // (K) LVQ scales
  const float* bi_s;      // (K) LVQ biases
  float* ck_s;            // (K) out: candidate keys, +inf when invalid
};

// Writes the key of row j (all lanes call it; lane `writer` stores).
__device__ __forceinline__ void put_key(const Query& x, int j, float dot,
                                        float x2, bool writer) {
  if (writer && j < x.K)
    x.ck_s[j] = x.cid_s[j] >= 0 ? key_of(x.metric, x.qn, dot, x2)
                                : __int_as_float(0x7f800000);
}

// Sum over the kGroup lanes of a row (xor partners stay inside the group).
__device__ __forceinline__ void group_sum(float& a, float& b) {
#pragma unroll
  for (int o = kGroup >> 1; o > 0; o >>= 1) {
    a += __shfl_xor_sync(kFull, a, o);
    b += __shfl_xor_sync(kFull, b, o);
  }
}

// ---- row loaders --------------------------------------------------------
// Dense f32/bf16 rows.
template <typename VecT>
struct DenseRows {
  static constexpr bool kScores = true;
  static constexpr bool kLvq = false;
  static constexpr int kElems = 16 / sizeof(VecT);   // per 16-byte chunk
  static constexpr int kLoads = 8;                   // in flight per lane
  const VecT* vecs;  // (B, K, d)
  int vec4;          // d % 4 == 0 and 4-element-aligned rows

  // Fast path: 8 lanes per row, each on chunks c0 + 8 i (i < kCpl).
  template <int kCpl>
  __device__ __forceinline__ void stream(const Query& x) const {
    constexpr int kPasses = kLoads / kCpl;     // rows per lane per batch
    constexpr int kRows = kPasses * (32 / kGroup);
    const int g = x.lane / kGroup, c0 = x.lane % kGroup;
    float qr[kCpl * kElems];
#pragma unroll
    for (int i = 0; i < kCpl; ++i)
#pragma unroll
      for (int e = 0; e < kElems; ++e)
        qr[i * kElems + e] = x.q_s[(c0 + kGroup * i) * kElems + e];
    const VecT* block = vecs + static_cast<size_t>(x.row) * x.K * x.d;
    for (int j0 = x.sub * kRows; j0 < x.K; j0 += x.wpq * kRows) {
      int4 raw[kLoads];
#pragma unroll
      for (int u = 0; u < kPasses; ++u) {
        const int j = j0 + u * (32 / kGroup) + g;
        const bool live = j < x.K && x.cid_s[j] >= 0;
        const int4* rp = reinterpret_cast<const int4*>(
            block + static_cast<size_t>(j) * x.d);
#pragma unroll
        for (int i = 0; i < kCpl; ++i) {
          if (live) raw[u * kCpl + i] = __ldg(rp + c0 + kGroup * i);
          else raw[u * kCpl + i] = make_int4(0, 0, 0, 0);
        }
      }
#pragma unroll
      for (int u = 0; u < kPasses; ++u) {
        float dot = 0.f, x2 = 0.f;
#pragma unroll
        for (int i = 0; i < kCpl; ++i) {
          const int4 w = raw[u * kCpl + i];
          const int words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            if constexpr (sizeof(VecT) == 4) {
              const float v = __int_as_float(words[k]);
              const float q = qr[i * kElems + k];
              dot = fmaf(v, q, dot);
              x2 = fmaf(v, v, x2);
            } else {
              const unsigned w2 = static_cast<unsigned>(words[k]);
              const float lo = __uint_as_float(w2 << 16);
              const float hi = __uint_as_float(w2 & 0xffff0000u);
              dot = fmaf(lo, qr[i * kElems + 2 * k], dot);
              dot = fmaf(hi, qr[i * kElems + 2 * k + 1], dot);
              x2 = fmaf(lo, lo, x2);
              x2 = fmaf(hi, hi, x2);
            }
          }
        }
        group_sum(dot, x2);
        put_key(x, j0 + u * (32 / kGroup) + g, dot, x2, c0 == 0);
      }
    }
  }

  // Generic path: the whole warp on a row, kUnroll rows in flight.
  __device__ __forceinline__ void stream_generic(const Query& x) const {
    const VecT* block = vecs + static_cast<size_t>(x.row) * x.K * x.d;
    for (int j0 = x.sub * kUnroll; j0 < x.K; j0 += x.wpq * kUnroll) {
      float dot[kUnroll], x2[kUnroll];
      bool live[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        dot[u] = x2[u] = 0.f;
        live[u] = j0 + u < x.K && x.cid_s[j0 + u] >= 0;
      }
      if (vec4) {
        for (int t = x.lane * 4; t < x.d; t += 128) {
          const float4 qq = *reinterpret_cast<const float4*>(x.q_s + t);
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            if (live[u]) {
              const float4 v = load4(block + static_cast<size_t>(j0 + u) * x.d
                                     + t);
              dot[u] += v.x * qq.x + v.y * qq.y + v.z * qq.z + v.w * qq.w;
              x2[u] += v.x * v.x + v.y * v.y + v.z * v.z + v.w * v.w;
            }
          }
        }
      } else {
        for (int t = x.lane; t < x.d; t += 32) {
          const float qq = x.q_s[t];
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            if (live[u]) {
              const float v = to_f32(block[static_cast<size_t>(j0 + u) * x.d
                                           + t]);
              dot[u] += v * qq;
              x2[u] += v * v;
            }
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        put_key(x, j0 + u, warp_sum(dot[u]), warp_sum(x2[u]), x.lane == 0);
      }
    }
  }
};

// LVQ-8 code rows: v = (mean[t] + bias) + scale * code, decoded in
// registers with the plain version's rounding (no fused multiply-add); the
// zero-padded lanes decode to bias, so the row's summed x2 then loses
// (n_dead * bias) * bias, rounded as the plain version rounds it.
struct LvqRows {
  static constexpr bool kScores = true;
  static constexpr bool kLvq = true;
  static constexpr int kElems = 16;
  static constexpr int kLoads = 4;       // 8 spills: fewer warps fit
  const int8_t* codes;   // (B, K, d)
  const float* scales;   // (B, K)
  const float* biases;   // (B, K)
  int n_dead;
  int vec16;             // d % 16 == 0 and 16-byte-aligned rows

  __device__ __forceinline__ static void decode_add(float code, float mean,
                                                    float q, float sc, float bi,
                                                    float& dot, float& x2) {
    const float v = __fadd_rn(__fadd_rn(mean, bi), __fmul_rn(sc, code));
    dot = fmaf(v, q, dot);
    x2 = fmaf(v, v, x2);
  }

  __device__ __forceinline__ float dead(float bi) const {
    return __fmul_rn(__fmul_rn(static_cast<float>(n_dead), bi), bi);
  }

  // Fast path: 8 lanes on a row, kCpl 16-code chunks per lane and row
  // (d = 128 kCpl); the lane's slices of the query and the mean stay in
  // registers.
  template <int kCpl>
  __device__ __forceinline__ void stream(const Query& x) const {
    constexpr int kPasses = kLoads / kCpl;
    constexpr int kRows = kPasses * (32 / kGroup);
    const int g = x.lane / kGroup, c0 = x.lane % kGroup;
    float qr[kCpl * kElems], mr[kCpl * kElems];
#pragma unroll
    for (int i = 0; i < kCpl; ++i)
#pragma unroll
      for (int e = 0; e < kElems; ++e) {
        qr[i * kElems + e] = x.q_s[(c0 + kGroup * i) * kElems + e];
        mr[i * kElems + e] = x.mean_s[(c0 + kGroup * i) * kElems + e];
      }
    const int8_t* block = codes + static_cast<size_t>(x.row) * x.K * x.d;
    for (int j0 = x.sub * kRows; j0 < x.K; j0 += x.wpq * kRows) {
      int4 raw[kLoads];
#pragma unroll
      for (int u = 0; u < kPasses; ++u) {
        const int j = j0 + u * (32 / kGroup) + g;
        const bool live = j < x.K && x.cid_s[j] >= 0;
        const int4* rp = reinterpret_cast<const int4*>(
            block + static_cast<size_t>(j) * x.d);
#pragma unroll
        for (int i = 0; i < kCpl; ++i) {
          if (live) raw[u * kCpl + i] = __ldg(rp + c0 + kGroup * i);
          else raw[u * kCpl + i] = make_int4(0, 0, 0, 0);
        }
      }
#pragma unroll
      for (int u = 0; u < kPasses; ++u) {
        const int j = j0 + u * (32 / kGroup) + g;
        const int jj = j < x.K ? j : 0;
        const float sc = x.sc_s[jj], bi = x.bi_s[jj];
        float dot = 0.f, x2 = 0.f;
#pragma unroll
        for (int i = 0; i < kCpl; ++i) {
          const int4 w = raw[u * kCpl + i];
          // offset binary: byte b + 128 in a float's mantissa is 2^23 +
          // b + 128, and one exact subtraction gives b
          const unsigned words[4] = {
              static_cast<unsigned>(w.x) ^ 0x80808080u,
              static_cast<unsigned>(w.y) ^ 0x80808080u,
              static_cast<unsigned>(w.z) ^ 0x80808080u,
              static_cast<unsigned>(w.w) ^ 0x80808080u};
#pragma unroll
          for (int k = 0; k < 4; ++k) {
#pragma unroll
            for (int b = 0; b < 4; ++b) {
              const float code = __uint_as_float(
                  __byte_perm(words[k], 0x4b000000u, 0x7540u | b))
                  - 8388736.f;
              const int e = i * kElems + 4 * k + b;
              decode_add(code, mr[e], qr[e], sc, bi, dot, x2);
            }
          }
        }
        group_sum(dot, x2);
        put_key(x, j, dot, __fsub_rn(x2, dead(bi)), c0 == 0);
      }
    }
  }

  // Generic path: G lanes (a power of two, at most 32 and at most the
  // chunk count) share a row, so a warp scores 32 / G rows per pass.
  __device__ __forceinline__ void stream_generic(const Query& x) const {
    const int width = vec16 ? 16 : 1;    // codes per load
    const int n_chunks = x.d / width;
    int G = 32;
    while (G > n_chunks) G >>= 1;
    const int per_pass = 32 / G;          // rows scored per pass
    const int sub_row = x.lane / G, c0 = x.lane & (G - 1);
    const int8_t* block = codes + static_cast<size_t>(x.row) * x.K * x.d;
    for (int j0 = x.sub * kUnroll; j0 < x.K; j0 += x.wpq * kUnroll) {
      for (int pass = 0; pass * per_pass < kUnroll; ++pass) {
        const int u_me = pass * per_pass + sub_row;
        const int j = j0 + u_me;
        float pd = 0.f, px = 0.f, dd = 0.f;
        if (u_me < kUnroll && j < x.K && x.cid_s[j] >= 0) {
          const float sc = x.sc_s[j], bi = x.bi_s[j];
          dd = dead(bi);
          const int8_t* crow = block + static_cast<size_t>(j) * x.d;
          for (int c = c0; c < n_chunks; c += G) {
            if (vec16) {
              const int t = c * 16;
              const int4 raw = *reinterpret_cast<const int4*>(crow + t);
              const int words[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
              for (int w = 0; w < 4; ++w) {
                const float4 qq =
                    *reinterpret_cast<const float4*>(x.q_s + t + 4 * w);
                const float4 mm =
                    *reinterpret_cast<const float4*>(x.mean_s + t + 4 * w);
                const int word = words[w];
                decode_add(static_cast<float>(static_cast<int8_t>(word & 0xff)),
                           mm.x, qq.x, sc, bi, pd, px);
                decode_add(static_cast<float>(
                               static_cast<int8_t>((word >> 8) & 0xff)),
                           mm.y, qq.y, sc, bi, pd, px);
                decode_add(static_cast<float>(
                               static_cast<int8_t>((word >> 16) & 0xff)),
                           mm.z, qq.z, sc, bi, pd, px);
                decode_add(static_cast<float>(
                               static_cast<int8_t>((word >> 24) & 0xff)),
                           mm.w, qq.w, sc, bi, pd, px);
              }
            } else {
              decode_add(static_cast<float>(crow[c]), x.mean_s[c], x.q_s[c],
                         sc, bi, pd, px);
            }
          }
        }
        for (int o = G >> 1; o > 0; o >>= 1) {
          pd += __shfl_xor_sync(kFull, pd, o);
          px += __shfl_xor_sync(kFull, px, o);
        }
        px = __fsub_rn(px, dd);   // after the sum, as the plain version
        if (u_me < kUnroll) put_key(x, j, pd, px, c0 == 0);
      }
    }
  }
};

// Candidates scored beforehand (beam_update): the keys are read as given.
// A candidate is valid when its id is >= 0 and its key finite, as in the
// JAX kernel; the pool then keeps only the candidates that enter the merge
// (not repeated within the iteration, not already in the beam).
struct KeyRows {
  static constexpr bool kScores = false;
  static constexpr bool kLvq = false;
  const float* keys;     // (B, K)
};

// Barrier of the wpq warps of one query (named barrier 1 + its index).
__device__ __forceinline__ void query_sync(int ql, int wpq) {
  if (wpq == 1) {
    __syncwarp();
  } else {
    asm volatile("bar.sync %0, %1;" ::"r"(1 + ql), "r"(wpq * 32) : "memory");
  }
}

template <class Rows, typename QT, int kCpl>
// At most 80 registers: three CTAs of kMaxWarps warps fit an SM, so the
// build's 2500 queries are resident in one wave.
__global__ void __launch_bounds__(kThreads, 3)
beam_step_kernel(Rows rows_in, Step s) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  constexpr bool lvq = Rows::kLvq;
  const int d_al = s.d_al;
  const float inf = __int_as_float(0x7f800000);

  // the LVQ mean, shared by the CTA's queries
  float* mean_s = smem;
  if (lvq) {
    for (int t = tid; t < d_al; t += blockDim.x)
      mean_s[t] = t < s.d ? s.mean[t] : 0.f;
    __syncthreads();
  }
  const int ql = warp / s.wpq, sub = warp % s.wpq;
  const int row = blockIdx.x * s.qpc + ql;
  // Leaving through a vote keeps the exit provably warp-uniform, so the
  // compiler emits the shuffles below without divergent fallback copies.
  if (__any_sync(kFull, row >= s.B)) return;   // whole query groups leave
  const int C = s.C, K = s.K, P = s.P;
  const Layout L = layout_of(d_al, K, C, P, s.wpq, lvq);
  float* region = smem + (lvq ? d_al : 0) + ql * L.words;
  u64* buf = reinterpret_cast<u64*>(region + L.buf);
  float* q_s = region + L.q;
  float* ck = region + L.ck;
  int* cid = reinterpret_cast<int*>(region + L.cid);
  float* sc_s = region + L.sc;
  float* bi_s = region + L.bi;
  float* bk = region + L.bk;
  int* bp = reinterpret_cast<int*>(region + L.bp);
  float* nk = region + L.nk;
  int* np_ = reinterpret_cast<int*>(region + L.np);
  int* hit = reinterpret_cast<int*>(region + L.hit);
  float* red = region + L.red;

  // ---- 0. stage the query, the candidate ids, the beam ------------------
  // kStage elements of each array a thread, every load issued before
  // the first store, so that staging costs one round trip to memory
  const int gt = sub * 32 + lane, gn = s.wpq * 32;
  const int n_stage = max(max(K, C), Rows::kScores ? d_al : 0);
  const QT* q = static_cast<const QT*>(s.queries)
                + static_cast<size_t>(row) * s.d;
  const float* beam_k = s.beam_keys + static_cast<size_t>(row) * C;
  const int* beam_p = s.beam_packed + static_cast<size_t>(row) * C;
  const size_t cand_row = static_cast<size_t>(row) * K;
  float part = 0.f;
  for (int t0 = gt; t0 < n_stage; t0 += kStage * gn) {
    float qv[kStage], bkv[kStage], a[kStage], b[kStage];
    int c[kStage], bpv[kStage];
#pragma unroll
    for (int u = 0; u < kStage; ++u) {
      const int t = t0 + u * gn;
      if constexpr (Rows::kScores)
        qv[u] = t < s.d ? to_f32(q[t]) : 0.f;
      if (t < K) {
        c[u] = s.cand_ids[cand_row + t];
        if constexpr (!Rows::kScores) {
          a[u] = rows_in.keys[cand_row + t];
        } else if constexpr (lvq) {
          a[u] = rows_in.scales[cand_row + t];
          b[u] = rows_in.biases[cand_row + t];
        }
      }
      if (t < C) {
        bkv[u] = beam_k[t];
        bpv[u] = beam_p[t];
      }
    }
#pragma unroll
    for (int u = 0; u < kStage; ++u) {
      const int t = t0 + u * gn;
      if constexpr (Rows::kScores) {
        if (t < d_al) {
          q_s[t] = qv[u];
          part += qv[u] * qv[u];
        }
      }
      if (t < K) {
        if (c[u] >= kVisBit) __trap();     // would collide with the bit
        cid[t] = c[u];
        if constexpr (!Rows::kScores) {
          ck[t] = c[u] >= 0 && isfinite(a[u]) ? a[u] : inf;
        } else if constexpr (lvq) {
          sc_s[t] = a[u];
          bi_s[t] = b[u];
        }
      }
      if (t < C) {
        bk[t] = bkv[u];
        bp[t] = bpv[u];
      }
    }
  }
  part = warp_sum(part);
  if (lane == 0) red[sub] = part;
  query_sync(ql, s.wpq);
  float qn = 0.f;
  for (int w = 0; w < s.wpq; ++w) qn += red[w];

  // ---- 1. score (split over the query's warps) --------------------------
  if constexpr (Rows::kScores) {
    const Query x{row, K, s.d, lane, sub, s.wpq, s.metric, qn, q_s, mean_s,
                  cid, sc_s, bi_s, ck};
    if (kCpl > 0 && s.fast) rows_in.template stream<(kCpl > 0 ? kCpl : 1)>(x);
    else rows_in.stream_generic(x);
    query_sync(ql, s.wpq);
  }
  if (__any_sync(kFull, sub != 0)) return;

  // ---- 2. the core, on the query's first warp ---------------------------
  // id order: (sort id, column); invalid candidates and padding last
  for (int idx = lane; idx < P; idx += 32) {
    int sortid = kIntBig;
    if (idx < K) {
      const int c = cid[idx];
      if (c >= 0 && (Rows::kScores || ck[idx] < inf)) sortid = c;
    }
    buf[idx] = (static_cast<u64>(sortid) << 10) | static_cast<u64>(idx);
    hit[idx] = 0;
  }
  warp_sort(buf, P, lane);

  // beam membership: each live beam id marks the first sorted candidate
  // of that id, if there is one (a binary search of the id order)
  for (int i0 = lane; i0 < C; i0 += 32 * kSearch) {
    u64 x[kSearch];
    int pos[kSearch];
#pragma unroll
    for (int u = 0; u < kSearch; ++u) {
      const int i = i0 + 32 * u;
      x[u] = i < C && isfinite(bk[i])
                 ? static_cast<u64>(bp[i] & kIdMask) << 10 : kNoKey;
    }
    count_below(buf, P, x, pos);
#pragma unroll
    for (int u = 0; u < kSearch; ++u) {
      if (x[u] != kNoKey && pos[u] < P && (buf[pos[u]] >> 10) == (x[u] >> 10))
        hit[pos[u]] = 1;
    }
  }
  __syncwarp();

  // dedup (a copy of its left neighbour's id), the pool, beam membership;
  // then the key-order composite (ordered key, id), kNoKey for +inf
  const size_t pool_row = static_cast<size_t>(row) * s.pool_stride;
  if constexpr (!Rows::kScores) {
    for (int i = K + lane; i < s.pool_stride; i += 32) {
      s.pool_keys[pool_row + i] = inf;
      s.pool_ids[pool_row + i] = -1;
    }
  }
  int carry = -1;
  for (int base = 0; base < P; base += 32) {
    const int idx = base + lane;
    const u64 v = buf[idx];
    const int sid = static_cast<int>(v >> 10);
    const int col = static_cast<int>(v & 1023);
    int left = __shfl_up_sync(kFull, sid, 1);
    if (lane == 0) left = carry;
    carry = __shfl_sync(kFull, sid, 31);
    u64 comp = kNoKey;
    if (idx < K) {
      const bool dup = sid == left && sid != kIntBig;
      float key = dup ? inf : ck[col];
      const int id = cid[col];
      if constexpr (Rows::kScores) {
        s.pool_keys[pool_row + idx] = key;
        s.pool_ids[pool_row + idx] = id;
      }
      if (sid != kIntBig && key < inf && hit[idx]) key = inf;
      if constexpr (!Rows::kScores) {
        s.pool_keys[pool_row + idx] = key;
        s.pool_ids[pool_row + idx] = key < inf ? id : -1;
      }
      if (key < inf)
        comp = (static_cast<u64>(ord_of(key)) << 32)
               | static_cast<unsigned>(id);
    }
    buf[idx] = comp;
  }
  warp_sort(buf, P, lane);

  // ---- 3. merge into the beam, truncated to C -------------------------
  // Each element's merged position is its own index plus the number of
  // elements of the other list ahead of it (beam first on equal keys).
  for (int i0 = lane; i0 < C; i0 += 32 * kSearch) {
    u64 x[kSearch];
    int pos[kSearch];
#pragma unroll
    for (int u = 0; u < kSearch; ++u) {
      const int i = i0 + 32 * u;
      x[u] = i < C ? static_cast<u64>(ord_of(bk[i])) << 32 : 0ull;
    }
    count_below(buf, P, x, pos);
#pragma unroll
    for (int u = 0; u < kSearch; ++u) {
      const int i = i0 + 32 * u;
      if (i < C && i + pos[u] < C) {
        nk[i + pos[u]] = bk[i];
        np_[i + pos[u]] = bp[i];
      }
    }
  }
  const int cp = 1 << (32 - __clz(C - 1));   // (C = 1: cp 1)
  for (int j0 = lane; j0 < K; j0 += 32 * kSearch) {
    u64 v[kSearch];
    float key[kSearch];
    int pos[kSearch];
#pragma unroll
    for (int u = 0; u < kSearch; ++u) {
      const int j = j0 + 32 * u;
      v[u] = j < K ? buf[j] : kNoKey;
      key[u] = v[u] == kNoKey ? __int_as_float(0x7fc00000)   // NaN: no match
                              : float_of(static_cast<unsigned>(v[u] >> 32));
    }
    at_most(bk, C, cp, key, pos);
#pragma unroll
    for (int u = 0; u < kSearch; ++u) {
      const int j = j0 + 32 * u;
      if (v[u] != kNoKey && j + pos[u] < C) {
        nk[j + pos[u]] = key[u];
        np_[j + pos[u]] = static_cast<int>(v[u] & 0xffffffffu);
      }
    }
  }
  __syncwarp();

  // ---- 4. pop the first m unvisited finite slots inside the window ------
  const int lim = min(s.window, C);
  const int m = s.m;
  int found = 0;
  for (int base = 0; base < lim && found < m; base += 32) {
    const int i = base + lane;
    const bool ok = i < lim && isfinite(nk[i]) && ((np_[i] >> 30) == 0);
    const unsigned mask = __ballot_sync(kFull, ok);
    const int r = found + __popc(mask & ((1u << lane) - 1u));
    if (ok && r < m) {
      s.popped[static_cast<size_t>(row) * m + r] = np_[i] & kIdMask;
      np_[i] |= kVisBit;
    }
    found += __popc(mask);
  }
  for (int r = found + lane; r < m; r += 32)
    s.popped[static_cast<size_t>(row) * m + r] = -1;
  __syncwarp();
  for (int i = lane; i < C; i += 32) {
    s.out_keys[static_cast<size_t>(row) * C + i] = nk[i];
    s.out_packed[static_cast<size_t>(row) * C + i] = np_[i];
  }
}

int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    if (count <= 0) count = 132;
  }
  return count;
}

// Chooses warps per query (more when B queries would leave SMs thin) and
// queries per CTA (as many as fit kMaxWarps warps and the shared memory).
template <class Rows, typename QT, int kCpl>
cudaError_t launch(Rows rows, Step s, cudaStream_t stream) {
  constexpr bool lvq = Rows::kLvq;
  s.d_al = (s.d + 3) & ~3;
  s.P = pow2_at_least(s.K < 32 ? 32 : s.K);
  s.wpq = 1;
  if (Rows::kScores) {
    while (s.wpq < kMaxWarps && s.B * s.wpq < kWarpsPerSm * sm_count())
      s.wpq *= 2;
  }
  // queries per CTA: where B is small, small CTAs (at least kCtasPerSm
  // a SM) spread the queries over every SM
  s.qpc = kMaxWarps / s.wpq;
  while (s.B < kWarpsPerSm * sm_count() && s.qpc > 1
         && (s.B + s.qpc - 1) / s.qpc < kCtasPerSm * sm_count())
    s.qpc >>= 1;
  constexpr int kMaxSmem = 227 * 1024;
  size_t smem = 0;
  for (;; s.qpc >>= 1) {
    const Layout L = layout_of(s.d_al, s.K, s.C, s.P, s.wpq, lvq);
    smem = sizeof(float) * ((lvq ? s.d_al : 0)
                            + static_cast<size_t>(s.qpc) * L.words);
    if (smem <= kMaxSmem || s.qpc == 1) break;
  }
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  auto kernel = beam_step_kernel<Rows, QT, kCpl>;
  static size_t smem_set = 48 * 1024;    // per instance: raise it once
  if (smem > smem_set) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return err;
    smem_set = kMaxSmem;
  }
  const int grid = (s.B + s.qpc - 1) / s.qpc;
  kernel<<<grid, s.qpc * s.wpq * 32, smem, stream>>>(rows, s);
  return cudaGetLastError();
}

Step make_step(const void* beam_keys, const void* beam_packed,
               const void* cand_ids, const void* queries, const float* mean,
               void* out_keys, void* out_packed, void* popped,
               void* pool_keys, void* pool_ids, int B, int C, int K, int d,
               int metric, int window, int m, int pool_stride) {
  Step s{};
  s.mean = mean;
  s.beam_keys = static_cast<const float*>(beam_keys);
  s.beam_packed = static_cast<const int*>(beam_packed);
  s.cand_ids = static_cast<const int*>(cand_ids);
  s.queries = queries;
  s.out_keys = static_cast<float*>(out_keys);
  s.out_packed = static_cast<int*>(out_packed);
  s.popped = static_cast<int*>(popped);
  s.pool_keys = static_cast<float*>(pool_keys);
  s.pool_ids = static_cast<int*>(pool_ids);
  s.B = B; s.C = C; s.K = K; s.d = d;
  s.metric = metric; s.window = window; s.m = m;
  s.pool_stride = pool_stride;
  return s;
}

}  // namespace

// Plain C entry points (loaded with ctypes).  Each returns the cudaError_t
// of its launch: 0 on success.
extern "C" int svt_beam_step(const void* beam_keys, const void* beam_packed,
                             const void* vecs, int vecs_bf16,
                             const void* cand_ids, const void* queries,
                             int queries_bf16, void* out_keys, void* out_packed,
                             void* popped, void* pool_keys, void* pool_ids,
                             int B, int C, int K, int d, int metric, int window,
                             int m, int vec4, void* stream) {
  if (B == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Step s = make_step(beam_keys, beam_packed, cand_ids, queries, nullptr,
                     out_keys, out_packed, popped, pool_keys, pool_ids, B, C,
                     K, d, metric, window, m, K);
  // fast stream: rows of 8 * kCpl 16-byte chunks on a 16-byte-aligned base
  const uintptr_t base = reinterpret_cast<uintptr_t>(vecs);
  const size_t row_bytes = static_cast<size_t>(d) * (vecs_bf16 ? 2 : 4);
  const int chunks = static_cast<int>(row_bytes / 16);
  s.fast = vec4 && base % 16 == 0 && row_bytes % 16 == 0;
#define SVT_LAUNCH(V, Q, CPL)                                               \
  launch<DenseRows<V>, Q, CPL>(DenseRows<V>{static_cast<const V*>(vecs),    \
                                            vec4}, s, st)
  cudaError_t err;
  if (vecs_bf16) {
    s.fast = s.fast && chunks == kGroup * 2;
    err = queries_bf16 ? SVT_LAUNCH(__nv_bfloat16, __nv_bfloat16, 2)
                       : SVT_LAUNCH(__nv_bfloat16, float, 2);
  } else {
    s.fast = s.fast && chunks == kGroup * 4;
    err = queries_bf16 ? SVT_LAUNCH(float, __nv_bfloat16, 4)
                       : SVT_LAUNCH(float, float, 4);
  }
#undef SVT_LAUNCH
  return static_cast<int>(err);
}

// LVQ-8: codes (B, K, d) int8, scales/biases (B, K) f32, mean (d) f32,
// queries (B, d) f32.
extern "C" int svt_beam_step_lvq(const void* beam_keys, const void* beam_packed,
                                 const void* codes, const void* scales,
                                 const void* biases, const void* mean,
                                 const void* cand_ids, const void* queries,
                                 void* out_keys, void* out_packed, void* popped,
                                 void* pool_keys, void* pool_ids, int B, int C,
                                 int K, int d, int metric, int window, int m,
                                 int n_dead, int vec16, void* stream) {
  if (B == 0) return 0;
  Step s = make_step(beam_keys, beam_packed, cand_ids, queries,
                     static_cast<const float*>(mean), out_keys, out_packed,
                     popped, pool_keys, pool_ids, B, C, K, d, metric, window,
                     m, K);
  s.fast = vec16 && reinterpret_cast<uintptr_t>(codes) % 16 == 0
           && d == 16 * kGroup;
  const LvqRows rows{static_cast<const int8_t*>(codes),
                     static_cast<const float*>(scales),
                     static_cast<const float*>(biases), n_dead, vec16};
  return static_cast<int>(launch<LvqRows, float, 1>(
      rows, s, static_cast<cudaStream_t>(stream)));
}

// beam_update: cand_keys (B, K) f32 scored beforehand, cand_ids (B, K);
// pool_keys / pool_ids are (B, C + K).
extern "C" int svt_beam_update(const void* beam_keys, const void* beam_packed,
                               const void* cand_keys, const void* cand_ids,
                               void* out_keys, void* out_packed, void* popped,
                               void* pool_keys, void* pool_ids, int B, int C,
                               int K, int window, int m, void* stream) {
  if (B == 0) return 0;
  Step s = make_step(beam_keys, beam_packed, cand_ids, nullptr, nullptr,
                     out_keys, out_packed, popped, pool_keys, pool_ids, B, C,
                     K, 0, 0, window, m, C + K);
  const KeyRows rows{static_cast<const float*>(cand_keys)};
  return static_cast<int>(launch<KeyRows, float, 0>(
      rows, s, static_cast<cudaStream_t>(stream)));
}

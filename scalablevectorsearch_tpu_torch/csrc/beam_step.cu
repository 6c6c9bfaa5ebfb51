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
// What bounds it: bytes.  Reading the (B, K, d) gathered rows dominates:
// 128 * 128 * 4 B = 64 KB per row per iteration at f32 (half that at bf16,
// a quarter as LVQ-8 codes), against a few hundred bytes of beam state.  The
// design reads every gathered row exactly once, straight into registers
// (16-byte loads), keeps the query, the LVQ mean, the candidates and the
// beam in shared memory, and writes nothing intermediate to device memory:
// the only stores are the five outputs.  LVQ rows are decoded in registers
// (mean + bias + scale * code), so the f32 rows never exist in memory.
// beam_update reads a few kilobytes per query (keys, ids, beam) and is
// bound by its rank steps and launch latency, not by bytes.
//
// Layout: one CTA of 256 threads per query row.  Warps score candidates
// with a stride, four rows in flight per warp.  The dedup, the sort and the
// merge are rank computations in shared memory (each element counts the
// elements that precede it), which give one fixed total order:
//   candidates: by (key, id); beam before candidates on equal keys.
// The plain PyTorch version produces the same order with stable sorts, so
// the two agree exactly whenever their keys agree.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;             // candidate rows in flight per warp
constexpr int kVisBit = 1 << 30;
constexpr int kIdMask = kVisBit - 1;
constexpr int kIntBig = 0x7fffffff;
constexpr int kL2 = 0, kMip = 1;

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
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Strict total order on candidates: key, then id, then column.
__device__ __forceinline__ bool cand_before(float ka, int ia, int ja, float kb,
                                            int ib, int jb) {
  if (ka != kb) return ka < kb;
  if (ia != ib) return ia < ib;
  return ja < jb;
}

// Number of entries of the ascending array a[0:n] that are < v (or <= v).
__device__ __forceinline__ int count_below(const float* a, int n, float v,
                                           bool or_equal) {
  int lo = 0, hi = n;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    bool below = or_equal ? (a[mid] <= v) : (a[mid] < v);
    if (below) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Dense f32/bf16 rows: the whole warp on one row, four rows in flight.
template <typename VecT>
struct DenseRows {
  static constexpr bool kScores = true;
  const VecT* vecs;  // (B, K, d)
  int vec4;          // d % 4 == 0 and 4-element-aligned rows

  // dot[u], x2[u] of rows j0 + u (u < kUnroll) against the staged query,
  // complete in every lane.
  __device__ __forceinline__ void score(int row, int j0, int K, int d,
                                        const float* q_s, const float*, int lane,
                                        float (&dot)[kUnroll],
                                        float (&x2)[kUnroll]) const {
    const VecT* rows = vecs + static_cast<size_t>(row) * K * d;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) dot[u] = x2[u] = 0.f;
    if (vec4) {
      for (int t = lane * 4; t < d; t += 128) {
        const float4 qq = *reinterpret_cast<const float4*>(q_s + t);
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (j0 + u < K) {
            const float4 v = load4(rows + static_cast<size_t>(j0 + u) * d + t);
            dot[u] += v.x * qq.x + v.y * qq.y + v.z * qq.z + v.w * qq.w;
            x2[u] += v.x * v.x + v.y * v.y + v.z * v.z + v.w * v.w;
          }
        }
      }
    } else {
      for (int t = lane; t < d; t += 32) {
        const float qq = q_s[t];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (j0 + u < K) {
            const float v = to_f32(rows[static_cast<size_t>(j0 + u) * d + t]);
            dot[u] += v * qq;
            x2[u] += v * v;
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      dot[u] = warp_sum(dot[u]);
      x2[u] = warp_sum(x2[u]);
    }
  }
};

// LVQ-8 code rows: v = (mean[t] + bias) + scale * code, decoded in
// registers with the plain version's rounding (no fused multiply-add); the
// zero-padded lanes decode to bias, so the row's summed x2 then loses
// (n_dead * bias) * bias, rounded as the plain version rounds it.  A row of d int8 codes is d / 16 16-byte chunks; G lanes (a power
// of two, at most 32 and at most the chunk count) share one row, so a warp
// scores 32 / G rows per pass (4 rows at d = 128, one chunk per lane).
struct LvqRows {
  static constexpr bool kScores = true;
  const int8_t* codes;   // (B, K, d)
  const float* scales;   // (B, K)
  const float* biases;   // (B, K)
  int n_dead;
  int vec16;             // d % 16 == 0 and 16-byte-aligned rows

  __device__ __forceinline__ static void decode_add(float code, float mean,
                                                    float q, float sc, float bi,
                                                    float& dot, float& x2) {
    const float v = __fadd_rn(__fadd_rn(mean, bi), __fmul_rn(sc, code));
    dot += v * q;
    x2 += v * v;
  }

  __device__ __forceinline__ void score(int row, int j0, int K, int d,
                                        const float* q_s, const float* mean_s,
                                        int lane, float (&dot)[kUnroll],
                                        float (&x2)[kUnroll]) const {
    const int width = vec16 ? 16 : 1;    // codes per load
    const int n_chunks = d / width;
    int G = 32;
    while (G > n_chunks) G >>= 1;
    const int per_pass = 32 / G;          // rows scored per pass
    const int sub = lane / G, c0 = lane & (G - 1);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) dot[u] = x2[u] = 0.f;
    for (int pass = 0; pass * per_pass < kUnroll; ++pass) {
      const int u_me = pass * per_pass + sub;
      const int j = j0 + u_me;
      float pd = 0.f, px = 0.f, dead = 0.f;
      if (u_me < kUnroll && j < K) {
        const size_t off = static_cast<size_t>(row) * K + j;
        const float sc = scales[off], bi = biases[off];
        dead = __fmul_rn(__fmul_rn(static_cast<float>(n_dead), bi), bi);
        const int8_t* crow = codes + off * d;
        for (int c = c0; c < n_chunks; c += G) {
          if (vec16) {
            const int t = c * 16;
            const int4 raw = *reinterpret_cast<const int4*>(crow + t);
            const int words[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
            for (int w = 0; w < 4; ++w) {
              const float4 qq = *reinterpret_cast<const float4*>(q_s + t + 4 * w);
              const float4 mm = *reinterpret_cast<const float4*>(mean_s + t + 4 * w);
              const int word = words[w];
              decode_add(static_cast<float>(static_cast<int8_t>(word & 0xff)),
                         mm.x, qq.x, sc, bi, pd, px);
              decode_add(static_cast<float>(static_cast<int8_t>((word >> 8) & 0xff)),
                         mm.y, qq.y, sc, bi, pd, px);
              decode_add(static_cast<float>(static_cast<int8_t>((word >> 16) & 0xff)),
                         mm.z, qq.z, sc, bi, pd, px);
              decode_add(static_cast<float>(static_cast<int8_t>((word >> 24) & 0xff)),
                         mm.w, qq.w, sc, bi, pd, px);
            }
          } else {
            decode_add(static_cast<float>(crow[c]), mean_s[c], q_s[c], sc, bi,
                       pd, px);
          }
        }
      }
      for (int o = G >> 1; o > 0; o >>= 1) {
        pd += __shfl_xor_sync(0xffffffffu, pd, o);
        px += __shfl_xor_sync(0xffffffffu, px, o);
      }
      px = __fsub_rn(px, dead);   // after the sum, as the plain version
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (u / per_pass == pass) {   // warp-uniform
          dot[u] = __shfl_sync(0xffffffffu, pd, (u % per_pass) * G);
          x2[u] = __shfl_sync(0xffffffffu, px, (u % per_pass) * G);
        }
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
  const float* keys;     // (B, K)
};

template <class Rows, typename QT>
__global__ void __launch_bounds__(kThreads)
beam_step_kernel(Rows rows_in, const float* __restrict__ mean,
                 const float* __restrict__ beam_keys,
                 const int* __restrict__ beam_packed,
                 const int* __restrict__ cand_ids,
                 const QT* __restrict__ queries,
                 float* __restrict__ out_keys, int* __restrict__ out_packed,
                 int* __restrict__ popped, float* __restrict__ pool_keys,
                 int* __restrict__ pool_ids, int C, int K, int d, int metric,
                 int window, int m, int pool_stride) {
  extern __shared__ __align__(16) float smem[];
  const int d_al = (d + 3) & ~3;
  float* q_s = smem;                                  // d_al  query (f32)
  float* mean_s = q_s + d_al;                         // d_al  mean (LVQ only)
  float* ck = mean_s + (mean ? d_al : 0);             // K     candidate keys
  int* cid = reinterpret_cast<int*>(ck + K);          // K     candidate ids
  int* sortid = cid + K;                              // K     id sort key
  float* sk = reinterpret_cast<float*>(sortid + K);   // K     keys, sorted
  int* sid = reinterpret_cast<int*>(sk + K);          // K     ids, sorted
  float* bk = reinterpret_cast<float*>(sid + K);      // C     beam keys
  int* bp = reinterpret_cast<int*>(bk + C);           // C     beam packed
  float* nk = reinterpret_cast<float*>(bp + C);       // C     merged keys
  int* np_ = reinterpret_cast<int*>(nk + C);          // C     merged packed
  float* red = reinterpret_cast<float*>(np_ + C);     // kWarps

  const int row = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float inf = __int_as_float(0x7f800000);

  // ---- 0. stage the query, the mean, the beam and the candidate ids -----
  const QT* q = queries + static_cast<size_t>(row) * d;
  float part = 0.f;
  for (int t = tid; t < d_al; t += kThreads) {
    float v = t < d ? to_f32(q[t]) : 0.f;
    q_s[t] = v;
    part += v * v;
    if (mean) mean_s[t] = t < d ? mean[t] : 0.f;
  }
  for (int i = tid; i < C; i += kThreads) {
    bk[i] = beam_keys[static_cast<size_t>(row) * C + i];
    bp[i] = beam_packed[static_cast<size_t>(row) * C + i];
  }
  for (int j = tid; j < K; j += kThreads)
    cid[j] = cand_ids[static_cast<size_t>(row) * K + j];
  part = warp_sum(part);
  if (lane == 0) red[warp] = part;
  __syncthreads();
  float qn = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) qn += red[w];

  // ---- 1. score: kUnroll rows per warp step ------------------------------
  if constexpr (!Rows::kScores) {
    for (int j = tid; j < K; j += kThreads) {
      const float key = rows_in.keys[static_cast<size_t>(row) * K + j];
      const bool valid = cid[j] >= 0 && isfinite(key);
      ck[j] = valid ? key : inf;
      sortid[j] = valid ? cid[j] : kIntBig;
    }
  } else
  for (int j0 = warp * kUnroll; j0 < K; j0 += kWarps * kUnroll) {
    float dot[kUnroll], x2[kUnroll];
    rows_in.score(row, j0, K, d, q_s, mean_s, lane, dot, x2);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = j0 + u;
      const float s = dot[u];
      const float n2 = x2[u];
      if (lane == 0 && j < K) {
        float key;
        if (metric == kMip) {
          key = -s;
        } else if (metric == kL2) {
          key = fmaxf(qn - 2.f * s + n2, 0.f);
        } else {
          key = -s / (sqrtf(fmaxf(qn, 1e-30f)) * sqrtf(fmaxf(n2, 1e-30f)));
        }
        ck[j] = cid[j] >= 0 ? key : inf;
        sortid[j] = cid[j] >= 0 ? cid[j] : kIntBig;
      }
    }
  }
  __syncthreads();

  // ---- 2. id order: dedup within the iteration, pool outputs ------------
  // rank = position in the stable sort by id (invalid ids last); the first
  // copy of an id keeps its key, later copies get +inf.  beam_step's pool
  // is written here (in-beam candidates stay); beam_update's after step 3,
  // with +inf / -1 for every candidate that does not enter the merge, and
  // its last C columns empty.
  const size_t pool_row = static_cast<size_t>(row) * pool_stride;
  if constexpr (!Rows::kScores) {
    for (int i = tid; i < pool_stride - K; i += kThreads) {
      pool_keys[pool_row + K + i] = inf;
      pool_ids[pool_row + K + i] = -1;
    }
  }
  for (int j = tid; j < K; j += kThreads) {
    const int sj = sortid[j];
    int rank = 0;
    bool dup = false;
    for (int i = 0; i < K; ++i) {
      const int si = sortid[i];
      rank += (si < sj) || (si == sj && i < j);
      dup |= (si == sj) && (i < j);
    }
    float key = (dup && sj != kIntBig) ? inf : ck[j];
    if constexpr (Rows::kScores) {
      pool_keys[pool_row + rank] = key;
      pool_ids[pool_row + rank] = cid[j];
    }
    // ---- 3. beam membership: candidates already in the beam ------------
    if (sj != kIntBig && key < inf) {
      for (int i = 0; i < C; ++i) {
        if (isfinite(bk[i]) && (bp[i] & kIdMask) == sj) {
          key = inf;
          break;
        }
      }
    }
    if constexpr (!Rows::kScores) {
      pool_keys[pool_row + rank] = key;
      pool_ids[pool_row + rank] = key < inf ? cid[j] : -1;
    }
    ck[j] = key;
  }
  __syncthreads();

  // ---- 4. candidates by (key, id) --------------------------------------
  for (int j = tid; j < K; j += kThreads) {
    const float kj = ck[j];
    const int ij = cid[j];
    int rank = 0;
    for (int i = 0; i < K; ++i) rank += cand_before(ck[i], cid[i], i, kj, ij, j);
    sk[rank] = kj;
    sid[rank] = ij;
  }
  __syncthreads();

  // ---- 5. merge into the beam, truncated to C -------------------------
  // Each element's merged position is its own index plus the number of
  // elements of the other list ahead of it (beam first on equal keys).
  for (int i = tid; i < C; i += kThreads) {
    const int pos = i + count_below(sk, K, bk[i], false);
    if (pos < C) {
      nk[pos] = bk[i];
      np_[pos] = bp[i];
    }
  }
  for (int j = tid; j < K; j += kThreads) {
    const int pos = j + count_below(bk, C, sk[j], true);
    if (pos < C) {
      nk[pos] = sk[j];
      np_[pos] = sid[j];
    }
  }
  __syncthreads();

  // ---- 6. pop the first m unvisited finite slots inside the window ------
  if (warp == 0) {
    const int lim = min(window, C);
    int found = 0;
    for (int base = 0; base < lim && found < m; base += 32) {
      const int i = base + lane;
      const bool ok = i < lim && isfinite(nk[i]) && ((np_[i] >> 30) == 0);
      const unsigned mask = __ballot_sync(0xffffffffu, ok);
      const int r = found + __popc(mask & ((1u << lane) - 1u));
      if (ok && r < m) {
        popped[static_cast<size_t>(row) * m + r] = np_[i] & kIdMask;
        np_[i] |= kVisBit;
      }
      found += __popc(mask);
    }
    for (int r = found + lane; r < m; r += 32)
      popped[static_cast<size_t>(row) * m + r] = -1;
  }
  __syncthreads();
  for (int i = tid; i < C; i += kThreads) {
    out_keys[static_cast<size_t>(row) * C + i] = nk[i];
    out_packed[static_cast<size_t>(row) * C + i] = np_[i];
  }
}

template <class Rows, typename QT>
cudaError_t launch(Rows rows, const float* mean, const void* beam_keys,
                   const void* beam_packed, const void* cand_ids,
                   const void* queries, void* out_keys, void* out_packed,
                   void* popped, void* pool_keys, void* pool_ids, int B, int C,
                   int K, int d, int metric, int window, int m,
                   int pool_stride, cudaStream_t stream) {
  const int d_al = (d + 3) & ~3;
  const size_t smem =
      sizeof(float) * ((mean ? 2 : 1) * d_al + 5 * K + 4 * C + kWarps);
  auto kernel = beam_step_kernel<Rows, QT>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<B, kThreads, smem, stream>>>(
      rows, mean, static_cast<const float*>(beam_keys),
      static_cast<const int*>(beam_packed), static_cast<const int*>(cand_ids),
      static_cast<const QT*>(queries), static_cast<float*>(out_keys),
      static_cast<int*>(out_packed), static_cast<int*>(popped),
      static_cast<float*>(pool_keys), static_cast<int*>(pool_ids), C, K, d,
      metric, window, m, pool_stride);
  return cudaGetLastError();
}

template <typename VecT>
DenseRows<VecT> dense_rows(const void* vecs, int vec4) {
  return DenseRows<VecT>{static_cast<const VecT*>(vecs), vec4};
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SVT_LAUNCH(V, Q)                                                      \
  launch<DenseRows<V>, Q>(dense_rows<V>(vecs, vec4), nullptr, beam_keys,      \
                          beam_packed, cand_ids, queries, out_keys,           \
                          out_packed, popped, pool_keys, pool_ids, B, C, K, d, \
                          metric, window, m, K, s)
  cudaError_t err;
  if (vecs_bf16) {
    err = queries_bf16 ? SVT_LAUNCH(__nv_bfloat16, __nv_bfloat16)
                       : SVT_LAUNCH(__nv_bfloat16, float);
  } else {
    err = queries_bf16 ? SVT_LAUNCH(float, __nv_bfloat16)
                       : SVT_LAUNCH(float, float);
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
  const LvqRows rows{static_cast<const int8_t*>(codes),
                     static_cast<const float*>(scales),
                     static_cast<const float*>(biases), n_dead, vec16};
  return static_cast<int>(launch<LvqRows, float>(
      rows, static_cast<const float*>(mean), beam_keys, beam_packed, cand_ids,
      queries, out_keys, out_packed, popped, pool_keys, pool_ids, B, C, K, d,
      metric, window, m, K, static_cast<cudaStream_t>(stream)));
}

// beam_update: cand_keys (B, K) f32 scored beforehand, cand_ids (B, K);
// pool_keys / pool_ids are (B, C + K).
extern "C" int svt_beam_update(const void* beam_keys, const void* beam_packed,
                               const void* cand_keys, const void* cand_ids,
                               void* out_keys, void* out_packed, void* popped,
                               void* pool_keys, void* pool_ids, int B, int C,
                               int K, int window, int m, void* stream) {
  if (B == 0) return 0;
  const KeyRows rows{static_cast<const float*>(cand_keys)};
  return static_cast<int>(launch<KeyRows, float>(
      rows, nullptr, beam_keys, beam_packed, cand_ids, nullptr, out_keys,
      out_packed, popped, pool_keys, pool_ids, B, C, K, 0, 0, window, m,
      C + K, static_cast<cudaStream_t>(stream)));
}

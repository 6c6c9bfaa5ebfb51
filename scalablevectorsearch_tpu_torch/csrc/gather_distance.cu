// Candidate scoring over rows, on Hopper.
//
// Replaces two Pallas kernels of scalablevectorsearch_tpu/ops/pallas/
// gather_distance.py:
//   score_rows: (<q, x>, ||x||^2) over pre-gathered rows (B, K, d) f32;
//   gather_score_l2_partial: ||x||^2 - 2 <q, x> over rows read by id from
//     an (N, d) table, never written to a (B, K, d) block.
// The TPU kernel takes an f32 table; this one also takes float16, bfloat16,
// int8 and uint8 tables and converts each element to f32 in registers (what
// the JAX package's data.get_f32 followed by gathered_keys computes).  The
// Python wrappers and the plain PyTorch versions are in
// scalablevectorsearch_tpu_torch/ops/kernels/gather_distance.py.
//
// What bounds both: bytes, then instructions.  Each gathered row meets one
// query (a matrix-vector product, about one operation per byte), so tensor
// cores have nothing to do; each row is read once with 16-byte loads (512 B
// per f32 row at d = 128, 128 B as int8) against 4 bytes of output per row.
// Products and sums are f32 (the gather's byte rows sum x2 exactly in
// int32).  The gather reads its rows at random from the table: a launch
// pays two dependent round trips (ids, then rows) before any arithmetic,
// and at int8 the bytes are so few that the element converts and
// multiply-adds are most of the work (PERF.md, section 6).
//
// gather_score_l2_partial, fast path (gather_kernel: 16-byte-aligned table
// and queries, rows of 8 * kCpl 16-byte chunks with a query slice of at
// most 32 floats a lane, e.g. d = 128 and 256 for every element type):
// - One warp per (query, segment of its rows); no block barrier anywhere.
//   A CTA holds four warps.  Below 16 warps a SM (B 2112 on an H100: the
//   serving batches of 1672 and 2048 queries, the compacted tail of 418),
//   a query's rows are split over 2 or 4 warps, each on its own segment;
//   no warp waits for another.
// - Ids: the warp loads 32 of its ids at a time, one coalesced 4-byte load a
//   lane, clamps them to [0, N) (no read leaves the table) and hands them to
//   the row lanes by shuffle; the next 32 ids are loaded before the current
//   rows, so the id round trip hides behind the row loads.
// - 8 lanes share a row, each on chunks c0 + 8 i (i < kCpl) with its slice
//   of the query in registers.  A batch is 8 independent 16-byte loads a
//   lane (8 / kCpl rows); two batches are in flight, since the next batch's
//   loads go out before this one's arithmetic.  The 8 lanes reduce dot and
//   x2 with a reduce-scatter (7 shuffles each for 8 rows, not 24), which
//   leaves each row's result in one lane: one coalesced store per batch.
// - Exact, cheap converts: int8 / uint8 bytes go into a float's mantissa by
//   one byte permute (0x4b000000: 2^23 + byte; int8 flips the sign bit
//   first) and one exact subtraction, not the quarter-rate I2F, and their
//   x2 is one dp4a per 4 bytes (exact); bfloat16 is a shift or a mask;
//   float16 pairs go through __half22float2.
// Tried and dropped, each slower at every shape (PERF.md): each warp's rows
// moved into a two-stage shared-memory ring by one cp.async.bulk per row,
// completing on an mbarrier; a bulk L2 prefetch of the next 32 rows;
// registers capped so more warps stay resident (they spill).
// Other rows (not whole 128-byte multiples, a wider query slice, or
// unaligned) take the generic score_kernel: one CTA of 256 threads per
// query row, G lanes (a power of two, at most 32 and at most the chunk
// count) on a row, the query in shared memory.  score_rows uses the same
// kernel over its (B, K, d) block.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;   // passes of row loads in flight per warp
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(int8_t v) {
  return static_cast<float>(v);
}
__device__ __forceinline__ float to_f32(uint8_t v) {
  return static_cast<float>(v);
}

// One 16-byte chunk of a row against the matching query values.
template <typename T>
__device__ __forceinline__ void add_chunk(const T* p, const float* q,
                                          float& dot, float& x2) {
  constexpr int kElems = 16 / sizeof(T);
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  T v[kElems];
  memcpy(v, &raw, sizeof(raw));
#pragma unroll
  for (int e = 0; e < kElems; e += 4) {
    const float4 qq = *reinterpret_cast<const float4*>(q + e);
    const float a = to_f32(v[e]), b = to_f32(v[e + 1]);
    const float c = to_f32(v[e + 2]), w = to_f32(v[e + 3]);
    dot += a * qq.x + b * qq.y + c * qq.z + w * qq.w;
    x2 += a * a + b * b + c * c + w * w;
  }
}

// kGather: rows are src[clamp(ids[row, j])] of an (n_rows, d) table and the
// output is x2 - 2 dot; otherwise rows are src[row, j] of a (B, K, d) block
// and the outputs are dot and x2.
template <typename T, bool kGather>
__global__ void __launch_bounds__(kThreads)
score_kernel(const T* __restrict__ src, const int* __restrict__ ids,
             int n_rows, const float* __restrict__ queries,
             float* __restrict__ out_a, float* __restrict__ out_b, int K,
             int d, int vec16) {
  extern __shared__ __align__(16) float q_s[];
  const int row = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int d_al = (d + 3) & ~3;
  for (int t = tid; t < d_al; t += kThreads)
    q_s[t] = t < d ? queries[static_cast<size_t>(row) * d + t] : 0.f;
  __syncthreads();

  constexpr int kElems = 16 / sizeof(T);
  const int width = vec16 ? kElems : 1;      // elements per load
  const int n_chunks = d / width;
  int G = 32;
  while (G > n_chunks && G > 1) G >>= 1;
  const int per_pass = 32 / G;                // rows per pass of a warp
  const int sub = lane / G, c0 = lane & (G - 1);
  const int step = per_pass * kUnroll;        // rows per warp step

  for (int j0 = warp * step; j0 < K; j0 += kWarps * step) {
    float dot[kUnroll], x2[kUnroll];
    const T* ptr[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      dot[u] = x2[u] = 0.f;
      const int j = j0 + u * per_pass + sub;
      ptr[u] = nullptr;
      if (j < K) {
        size_t r;
        if (kGather) {
          const int id = ids[static_cast<size_t>(row) * K + j];
          r = static_cast<size_t>(min(max(id, 0), n_rows - 1));
        } else {
          r = static_cast<size_t>(row) * K + j;
        }
        ptr[u] = src + r * d;
      }
    }
    for (int c = c0; c < n_chunks; c += G) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (ptr[u] == nullptr) continue;
        if (vec16) {
          add_chunk(ptr[u] + c * kElems, q_s + c * kElems, dot[u], x2[u]);
        } else {
          const float x = to_f32(ptr[u][c]);
          dot[u] += x * q_s[c];
          x2[u] += x * x;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      for (int o = G >> 1; o > 0; o >>= 1) {
        dot[u] += __shfl_xor_sync(0xffffffffu, dot[u], o);
        x2[u] += __shfl_xor_sync(0xffffffffu, x2[u], o);
      }
      const int j = j0 + u * per_pass + sub;
      if (c0 == 0 && j < K) {
        const size_t o = static_cast<size_t>(row) * K + j;
        if (kGather) {
          out_a[o] = x2[u] - 2.f * dot[u];
        } else {
          out_a[o] = dot[u];
          out_b[o] = x2[u];
        }
      }
    }
  }
}

template <typename T, bool kGather>
cudaError_t launch(const void* src, const void* ids, int n_rows,
                   const void* queries, void* out_a, void* out_b, int B,
                   int K, int d, int vec16, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((d + 3) & ~3);
  score_kernel<T, kGather><<<B, kThreads, smem, stream>>>(
      static_cast<const T*>(src), static_cast<const int*>(ids), n_rows,
      static_cast<const float*>(queries), static_cast<float*>(out_a),
      static_cast<float*>(out_b), K, d, vec16);
  return cudaGetLastError();
}

// ---- gather_score_l2_partial, fast path -----------------------------------

constexpr int kGroup = 8;            // lanes per row
constexpr int kLoads = 8;            // 16-byte loads a lane per batch
constexpr int kFastWarps = 4;        // warps per CTA
constexpr int kMaxSplit = 4;         // warps per query at most
constexpr int kWarpsPerSm = 16;      // below this many warps a SM, split
constexpr int kMaxSlice = 32;        // query floats a lane holds at most

// int8 / uint8 rows: x2 is summed in int32 by dp4a.  Every partial sum is
// an integer below 2^24 at the fast path's widths (d <= 256: at most
// 256 * 128^2 = 2^22), so it equals the f32 sum in any order.
template <typename T>
constexpr bool kByteRows = sizeof(T) == 1;

// Dot and x2 of one 16-byte chunk of T elements against the query values
// q[0 .. 16 / sizeof(T)), each element converted to f32 exactly (byte rows
// add their x2 to x2i instead).
template <typename T>
__device__ __forceinline__ void chunk_terms(const int4& w, const float* q,
                                            float& dot, float& x2, int& x2i) {
  const unsigned words[4] = {
      static_cast<unsigned>(w.x), static_cast<unsigned>(w.y),
      static_cast<unsigned>(w.z), static_cast<unsigned>(w.w)};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if constexpr (std::is_same<T, float>::value) {
      const float v = __uint_as_float(words[k]);
      dot = fmaf(v, q[k], dot);
      x2 = fmaf(v, v, x2);
    } else if constexpr (std::is_same<T, __nv_bfloat16>::value) {
      const float lo = __uint_as_float(words[k] << 16);
      const float hi = __uint_as_float(words[k] & 0xffff0000u);
      dot = fmaf(lo, q[2 * k], dot);
      dot = fmaf(hi, q[2 * k + 1], dot);
      x2 = fmaf(lo, lo, x2);
      x2 = fmaf(hi, hi, x2);
    } else if constexpr (std::is_same<T, __half>::value) {
      __half2 h;
      memcpy(&h, &words[k], sizeof(h));
      const float2 f = __half22float2(h);
      dot = fmaf(f.x, q[2 * k], dot);
      dot = fmaf(f.y, q[2 * k + 1], dot);
      x2 = fmaf(f.x, f.x, x2);
      x2 = fmaf(f.y, f.y, x2);
    } else {
      // a byte b in a float's mantissa: 2^23 + b, and one exact
      // subtraction gives b; int8 flips the sign bit first (offset binary:
      // b + 128) and subtracts 2^23 + 128
      constexpr bool kSigned = std::is_same<T, int8_t>::value;
      const unsigned u = kSigned ? words[k] ^ 0x80808080u : words[k];
      const float magic = kSigned ? 8388736.f : 8388608.f;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const float v =
            __uint_as_float(__byte_perm(u, 0x4b000000u, 0x7540u | b)) - magic;
        dot = fmaf(v, q[4 * k + b], dot);
      }
      if constexpr (kSigned)
        x2i = __dp4a(static_cast<int>(words[k]), static_cast<int>(words[k]),
                     x2i);
      else
        x2i = static_cast<int>(__dp4a(words[k], words[k],
                                      static_cast<unsigned>(x2i)));
    }
  }
}

// Sum of v[0 .. P) over the kGroup lanes of a row group, scattered: after
// it, lane c0 holds the group's sums of slots slot_of<P>(c0) + t in v[t],
// t < max(P / 8, 1).  Each level halves the values a lane keeps (the lane
// whose bit is set keeps the upper half) until one is left, then sums it
// over the remaining lanes.
template <int P, int kLevel = 0>
__device__ __forceinline__ void group_reduce(float (&v)[P], int c0) {
  constexpr int o = kGroup >> (kLevel + 1);   // 4, 2, 1
  constexpr int n = P >> kLevel;              // values kept so far
  if constexpr (n > 1) {
    const bool up = (c0 & o) != 0;
#pragma unroll
    for (int i = 0; i < n / 2; ++i) {
      const float send = up ? v[i] : v[i + n / 2];
      const float keep = up ? v[i + n / 2] : v[i];
      v[i] = keep + __shfl_xor_sync(kFull, send, o);
    }
  } else {
    v[0] += __shfl_xor_sync(kFull, v[0], o);
  }
  if constexpr (o > 1) group_reduce<P, kLevel + 1>(v, c0);
}

// The first slot whose sum lane c0 holds after group_reduce<P>, and
// whether it is the one lane that stores it.
template <int P>
__device__ __forceinline__ int slot_of(int c0) {
  return P >= kGroup ? c0 * (P / kGroup) : c0 / (kGroup / P);
}
template <int P>
__device__ __forceinline__ bool slot_owner(int c0) {
  return P >= kGroup ? true : (c0 & (kGroup / P - 1)) == 0;
}

// One 16-byte load of a table row through the non-coherent path, not kept
// in L1 (a row is read by one warp; its repeats come from L2).
__device__ __forceinline__ int4 row_load(const int4* p) {
  int4 v;
  asm("ld.global.nc.L1::no_allocate.v4.s32 {%0, %1, %2, %3}, [%4];"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
  return v;
}

// Warp w = blockIdx.x * kFastWarps + warp-in-CTA scores query w / wpq, rows
// [s * seg, (s + 1) * seg) with s = w % wpq (seg a multiple of 32).
template <typename T, int kCpl>
__global__ void __launch_bounds__(kFastWarps * 32)
gather_kernel(const T* __restrict__ table, const int* __restrict__ ids,
              int n_rows, const float* __restrict__ queries,
              float* __restrict__ out, int B, int K, int d, int wpq,
              int seg) {
  constexpr int kElems = 16 / sizeof(T);
  constexpr int kPasses = kLoads / kCpl;          // rows per lane per batch
  constexpr int kRows = kPasses * (32 / kGroup);  // rows per warp per batch
  static_assert(32 % kRows == 0, "a batch must tile 32 rows");
  constexpr int kTake = kPasses >= kGroup ? kPasses / kGroup : 1;
  const int lane = threadIdx.x & 31;
  const int w = blockIdx.x * kFastWarps + (threadIdx.x >> 5);
  const int b = w / wpq;
  if (b >= B) return;
  const int js = (w % wpq) * seg, je = min(K, js + seg);
  if (js >= je) return;
  const int g = lane / kGroup, c0 = lane % kGroup;
  const int* id_row = ids + static_cast<size_t>(b) * K;
  int next = js + lane < je ? __ldg(id_row + js + lane) : 0;

  // the lane's query slice: chunks c0 + kGroup i
  float qr[kCpl * kElems];
  const float4* qv = reinterpret_cast<const float4*>(
      queries + static_cast<size_t>(b) * d);
#pragma unroll
  for (int i = 0; i < kCpl; ++i)
#pragma unroll
    for (int e = 0; e < kElems; e += 4) {
      const float4 f = __ldg(qv + ((c0 + kGroup * i) * kElems + e) / 4);
      qr[i * kElems + e] = f.x;
      qr[i * kElems + e + 1] = f.y;
      qr[i * kElems + e + 2] = f.z;
      qr[i * kElems + e + 3] = f.w;
    }

  float* out_row = out + static_cast<size_t>(b) * K;
  const size_t stride = static_cast<size_t>(d) / kElems;   // int4s a row
  const int4* rows = reinterpret_cast<const int4*>(table) + c0;
  // batch t covers rows js + t kRows + 4 u + g (u < kPasses); a batch lies
  // inside one 32-id chunk, whose clamped ids the lanes hold in `id`
  int jc = js;
  int id = min(max(next, 0), n_rows - 1);
  next = js + 32 + lane < je ? __ldg(id_row + js + 32 + lane) : 0;
  // Issues batch t's row loads.  Rows at or past je read a clamped row
  // that is never stored, so no load is predicated.
  auto issue = [&](int4 (&raw)[kLoads], int t) {
    const int j0 = js + t * kRows;
    if (j0 - jc >= 32) {
      jc += 32;
      id = min(max(next, 0), n_rows - 1);
      next = jc + 32 + lane < je ? __ldg(id_row + jc + 32 + lane) : 0;
    }
#pragma unroll
    for (int u = 0; u < kPasses; ++u) {
      const int rid = __shfl_sync(kFull, id, j0 - jc + u * (32 / kGroup) + g);
      const int4* rp = rows + static_cast<size_t>(rid) * stride;
#pragma unroll
      for (int i = 0; i < kCpl; ++i)
        raw[u * kCpl + i] = row_load(rp + kGroup * i);
    }
  };
  // Scores batch t from its loads and stores its rows below je.
  auto consume = [&](const int4 (&raw)[kLoads], int t) {
    const int j0 = js + t * kRows;
    float dot[kPasses], x2[kPasses];
#pragma unroll
    for (int u = 0; u < kPasses; ++u) {
      dot[u] = x2[u] = 0.f;
      int x2i = 0;
#pragma unroll
      for (int i = 0; i < kCpl; ++i)
        chunk_terms<T>(raw[u * kCpl + i], qr + i * kElems, dot[u], x2[u],
                       x2i);
      if constexpr (kByteRows<T>) x2[u] = static_cast<float>(x2i);
    }
    group_reduce<kPasses>(dot, c0);
    group_reduce<kPasses>(x2, c0);
    if (slot_owner<kPasses>(c0)) {
#pragma unroll
      for (int s = 0; s < kTake; ++s) {
        const int j = j0 + (slot_of<kPasses>(c0) + s) * (32 / kGroup) + g;
        if (j < je) out_row[j] = x2[s] - 2.f * dot[s];
      }
    }
  };
  // two batches in flight: the next one's loads go out before this one's
  // arithmetic
  const int nb = (je - js + kRows - 1) / kRows;
  int4 ra[kLoads], rb[kLoads];
  issue(ra, 0);
  for (int t = 0; t < nb; t += 2) {
    if (t + 1 < nb) issue(rb, t + 1);
    consume(ra, t);
    if (t + 1 >= nb) break;
    if (t + 2 < nb) issue(ra, t + 2);
    consume(rb, t + 1);
  }
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

template <typename T, int kCpl>
cudaError_t launch_fast(const void* table, const void* ids, int n_rows,
                        const void* queries, void* out, int B, int K, int d,
                        cudaStream_t stream) {
  int wpq = 1;
  while (wpq < kMaxSplit && wpq * 32 < K
         && static_cast<long long>(B) * wpq < kWarpsPerSm * sm_count())
    wpq *= 2;
  const int seg = ((K + wpq - 1) / wpq + 31) & ~31;
  const long long warps = static_cast<long long>(B) * wpq;
  const int grid = static_cast<int>((warps + kFastWarps - 1) / kFastWarps);
  gather_kernel<T, kCpl><<<grid, kFastWarps * 32, 0, stream>>>(
      static_cast<const T*>(table), static_cast<const int*>(ids), n_rows,
      static_cast<const float*>(queries), static_cast<float*>(out), B, K, d,
      wpq, seg);
  return cudaGetLastError();
}

// The fast path where the rows and the query allow it, else score_kernel.
template <typename T>
cudaError_t gather(const void* table, const void* ids, int n_rows,
                   const void* queries, void* out, int B, int K, int d,
                   int vec16, cudaStream_t stream) {
  constexpr int kElems = 16 / sizeof(T);
  const bool aligned = vec16
      && reinterpret_cast<uintptr_t>(table) % 16 == 0
      && reinterpret_cast<uintptr_t>(queries) % 16 == 0;
  const int cpl = d % (kGroup * kElems) == 0 ? d / (kGroup * kElems) : 0;
  if (aligned) {
    switch (cpl) {
      case 1:
        return launch_fast<T, 1>(table, ids, n_rows, queries, out, B, K, d,
                                 stream);
      case 2:
        if constexpr (2 * kElems <= kMaxSlice)
          return launch_fast<T, 2>(table, ids, n_rows, queries, out, B, K,
                                   d, stream);
        break;
      case 4:
        if constexpr (4 * kElems <= kMaxSlice)
          return launch_fast<T, 4>(table, ids, n_rows, queries, out, B, K,
                                   d, stream);
        break;
      case 8:
        if constexpr (8 * kElems <= kMaxSlice)
          return launch_fast<T, 8>(table, ids, n_rows, queries, out, B, K,
                                   d, stream);
        break;
      default:
        break;
    }
  }
  return launch<T, true>(table, ids, n_rows, queries, out, nullptr, B, K, d,
                         vec16, stream);
}

}  // namespace

// Plain C entry points (loaded with ctypes).  Each returns the cudaError_t
// of its launch: 0 on success.

// rows (B, K, d) f32, queries (B, d) f32 -> dots, x2 (B, K) f32.
extern "C" int svt_score_rows(const void* rows, const void* queries,
                              void* dots, void* x2, int B, int K, int d,
                              int vec16, void* stream) {
  if (B == 0) return 0;
  return static_cast<int>(launch<float, false>(
      rows, nullptr, 0, queries, dots, x2, B, K, d, vec16,
      static_cast<cudaStream_t>(stream)));
}

// table (n_rows, d) of dtype 0 f32 / 1 f16 / 2 bf16 / 3 int8 / 4 uint8,
// ids (B, K) int32, queries (B, d) f32 -> out (B, K) f32.
extern "C" int svt_gather_score_l2_partial(const void* table, int dtype,
                                           const void* ids, int n_rows,
                                           const void* queries, void* out,
                                           int B, int K, int d, int vec16,
                                           void* stream) {
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return static_cast<int>(gather<float>(table, ids, n_rows, queries, out,
                                            B, K, d, vec16, s));
    case 1:
      return static_cast<int>(gather<__half>(table, ids, n_rows, queries,
                                             out, B, K, d, vec16, s));
    case 2:
      return static_cast<int>(gather<__nv_bfloat16>(
          table, ids, n_rows, queries, out, B, K, d, vec16, s));
    case 3:
      return static_cast<int>(gather<int8_t>(table, ids, n_rows, queries,
                                             out, B, K, d, vec16, s));
    case 4:
      return static_cast<int>(gather<uint8_t>(table, ids, n_rows, queries,
                                              out, B, K, d, vec16, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

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
// What bounds both: bytes.  Each row is read once from device memory with
// 16-byte loads (128 x 4 B = 512 B per f32 row at d = 128), against a few
// bytes of output per row; the query sits in shared memory.  Products and
// sums are f32.
//
// Layout: one CTA of 256 threads per query row.  A row of d elements is
// d / E 16-byte chunks (E = 16 / sizeof(element)); G lanes (a power of two,
// at most 32 and at most the chunk count) share one row, so a warp covers
// 32 / G rows per pass and keeps kUnroll passes' loads in flight before the
// G-lane shuffle reductions.  Ids are clamped to [0, N) in the kernel, so no
// id reads outside the table.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;   // passes of row loads in flight per warp

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
      return static_cast<int>(launch<float, true>(
          table, ids, n_rows, queries, out, nullptr, B, K, d, vec16, s));
    case 1:
      return static_cast<int>(launch<__half, true>(
          table, ids, n_rows, queries, out, nullptr, B, K, d, vec16, s));
    case 2:
      return static_cast<int>(launch<__nv_bfloat16, true>(
          table, ids, n_rows, queries, out, nullptr, B, K, d, vec16, s));
    case 3:
      return static_cast<int>(launch<int8_t, true>(
          table, ids, n_rows, queries, out, nullptr, B, K, d, vec16, s));
    case 4:
      return static_cast<int>(launch<uint8_t, true>(
          table, ids, n_rows, queries, out, nullptr, B, K, d, vec16, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

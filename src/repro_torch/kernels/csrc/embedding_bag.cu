// embedding_bag: the weighted multi-hot embedding bag.
//
// Replaces the TPU kernel repro/kernels/embedding_bag.py:embedding_bag
// (body _bag_kernel).
//
// What it computes: out[b] = sum over s = 0..S-1 of w[b,s] * table[ids[b,s]],
// skipping slots whose id is negative, accumulated in f32 in slot order
// (the TPU kernel's grid order). Ids are not range-checked, as in the
// reference.
//
// What bounds it on an H100: bytes. Each live slot gathers one D-float row
// (1 KB at D = 256) from a table far larger than L2 (20 M rows, 20.5 GB);
// the 2 * D flops per row are negligible. The TPU kernel DMA'd one row per
// grid step, driven by scalar-prefetched ids; here each thread owns one
// 16-byte column of one bag (a bag's D / 4 threads read its rows as whole
// coalesced lines) and issues UNROLL slots' loads before it adds them, so
// many rows are in flight per thread.
//
// Row offsets are 64-bit: at D = 256 a 32-bit id * D wraps for every id
// above 8,388,607 of a 20 M-row table.
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 4;

__global__ void __launch_bounds__(THREADS)
embedding_bag_kernel(const float4* __restrict__ table,
                     const int32_t* __restrict__ ids,
                     const float* __restrict__ weights,
                     float4* __restrict__ out, int64_t n_out, int S, int d4) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  if (t >= n_out) return;
  const int64_t b = t / d4;
  const int c = static_cast<int>(t - b * d4);
  const int32_t* bag_ids = ids + b * S;
  const float* bag_w = weights + b * S;
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int s0 = 0; s0 < S; s0 += UNROLL) {
    int id[UNROLL];
    float4 row[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      id[u] = s0 + u < S ? bag_ids[s0 + u] : -1;
      row[u] = id[u] >= 0 ? table[static_cast<int64_t>(id[u]) * d4 + c]
                          : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (id[u] >= 0) {
        const float w = bag_w[s0 + u];
        acc.x += w * row[u].x;
        acc.y += w * row[u].y;
        acc.z += w * row[u].z;
        acc.w += w * row[u].w;
      }
    }
  }
  out[t] = acc;
}

}  // namespace

extern "C" int embedding_bag(const void* table, const void* ids,
                             const void* weights, void* out, long long B,
                             int S, int D, void* stream) {
  const int64_t n_out = static_cast<int64_t>(B) * (D / 4);
  if (n_out <= 0) return 0;
  const int64_t blocks = (n_out + THREADS - 1) / THREADS;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  embedding_bag_kernel<<<static_cast<unsigned>(blocks), THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(table), static_cast<const int32_t*>(ids),
      static_cast<const float*>(weights), static_cast<float4*>(out), n_out, S,
      D / 4);
  return static_cast<int>(cudaGetLastError());
}

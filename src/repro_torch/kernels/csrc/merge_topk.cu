// merge_topk: the blockwise pull of the incremental merge.
//
// Replaces the TPU kernel repro/kernels/merge_topk.py:merge_topk (body
// _merge_kernel, sorting with repro/kernels/sortnet.py:bitonic_topk_desc),
// batched over G groups (one per executor lane) and with one more output:
// the flat source index of every item taken, which pull_block needs to
// advance its per-source cursors.
//
// What it computes, per group: the top `block` of the R*W window items by
// score, descending, ties to the lower flat index (lax.top_k's order).
//
// What bounds it on an H100: neither bytes nor operations. At the main
// path's shapes a launch reads 8 x 2816 x 8 bytes and sorts 4096 slots per
// group: microseconds of work, so launch latency and the log^2 chain of
// __syncthreads() dominate. The design keeps the whole group in one block:
// (score, flat index) pairs padded to a power of two with (-inf, index) sit
// in shared memory (32 KB at 4096 slots), one bitonic sort runs over them
// with the total order of sortnet.cuh, and the keys are gathered by index
// afterwards, so they never enter shared memory.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <algorithm>

#include "sortnet.cuh"

namespace {

__global__ void merge_topk_kernel(const int32_t* __restrict__ window_keys,
                                  const float* __restrict__ window_scores,
                                  int32_t* __restrict__ out_keys,
                                  float* __restrict__ out_scores,
                                  int32_t* __restrict__ out_idx, int n,
                                  int padded, int block) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* s = reinterpret_cast<float*>(smem);
  int* p = reinterpret_cast<int*>(s + padded);
  const int64_t in_row = static_cast<int64_t>(blockIdx.x) * n;
  for (int i = threadIdx.x; i < padded; i += blockDim.x) {
    s[i] = i < n ? window_scores[in_row + i] : -CUDART_INF_F;
    p[i] = i;
  }
  __syncthreads();
  bitonic_sort_desc(s, p, padded);
  // Padding sorts after every real item (-inf ties go to the lower index)
  // and block <= n, so every index written here is a real one.
  const int64_t out_row = static_cast<int64_t>(blockIdx.x) * block;
  for (int i = threadIdx.x; i < block; i += blockDim.x) {
    const int src = p[i];
    out_idx[out_row + i] = src;
    out_scores[out_row + i] = s[i];
    out_keys[out_row + i] = window_keys[in_row + src];
  }
}

}  // namespace

extern "C" int merge_topk(const void* window_keys, const void* window_scores,
                          void* out_keys, void* out_scores, void* out_idx,
                          int G, int n, int padded, int block, void* stream) {
  if (G <= 0 || block <= 0) return 0;
  const size_t smem = static_cast<size_t>(padded) * (sizeof(float) + sizeof(int));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        merge_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int threads = std::min(1024, std::max(32, padded / 2));
  merge_topk_kernel<<<G, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(window_keys),
      static_cast<const float*>(window_scores),
      static_cast<int32_t*>(out_keys), static_cast<float*>(out_scores),
      static_cast<int32_t*>(out_idx), n, padded, block);
  return static_cast<int>(cudaGetLastError());
}

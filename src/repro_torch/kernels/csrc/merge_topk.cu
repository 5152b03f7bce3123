// merge_topk: the blockwise pull of the incremental merge, as a rank merge.
//
// Replaces the TPU kernel repro/kernels/merge_topk.py:merge_topk (body
// _merge_kernel, sorting with repro/kernels/sortnet.py:bitonic_topk_desc),
// batched over G groups (one per executor lane) and with one more output:
// the flat source index of every item taken, which pull_block needs to
// advance its per-source cursors.
//
// What it computes, per group: the top `block` of the R*W window items by
// the total order score descending, then flat index r*W + w ascending
// (lax.top_k's order). Scores must not be NaN.
//
// What bounds it on an H100: neither bytes nor operations. At the main
// path's shapes (G = 8, R = 11, W = block = 256) a launch reads 90 KB and
// writes 24 KB: microseconds of work, so the chain of dependent steps
// inside a block is the cost. A full sort of each group's 2816 items in
// one block would chain 78 block-wide barriers on 8 SMs.
//
// What the design does about it. The engine hands over rows that are
// already in the total order: each row is one source list's next window,
// stored score-descending and scaled by a weight in [0, 1], with a -inf
// tail; within a row the flat index is the position. So:
//  1. one block per (group, row): grid G*R (88 blocks at the main path);
//  2. every block loads all R rows of its group into shared memory, one
//     warp per row, and checks with a warp vote whether the row's scores
//     are non-increasing (then the row is in the total order). Only a row
//     that fails is sorted, by its warp alone: a bitonic network over the
//     row padded to a power of two, with __syncwarp between sweeps;
//  3. one __syncthreads();
//  4. each thread takes an item of the block's own row and computes its
//     rank in the group: its position in its row, plus, for each other row
//     q, the items of q that come first in the total order. Every item of
//     a lower row has a lower flat index, so that is the count of scores
//     >= the item's score there, and of scores > it in a higher row: a
//     binary search in a non-increasing array, four rows in lockstep. The
//     order is strict, so the ranks are a permutation of [0, R*W); an item
//     whose rank is below `block` writes output slot rank, its key gathered
//     from device memory by flat index. Nothing is computed on a score, so
//     the result is bit-equal to the plain version, -inf included.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <algorithm>

#include "sortnet.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;

// Sorts s[0, n) with payload p[0, n) by (s desc, p asc) with one warp;
// n a power of two. Every lane of the warp calls it.
__device__ void warp_bitonic_sort_desc(float* s, int* p, int n, int lane) {
  const int half = n >> 1;
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int t = lane; t < half; t += 32) {
        const int i = ((t & ~(j - 1)) << 1) | (t & (j - 1));
        const int l = i + j;
        const float si = s[i], sl = s[l];
        const int pi = p[i], pl = p[l];
        const bool forward = (i & k) == 0;
        const bool swap = forward ? sortnet_before(sl, pl, si, pi)
                                  : sortnet_before(si, pi, sl, pl);
        if (swap) {
          s[i] = sl;
          s[l] = si;
          p[i] = pl;
          p[l] = pi;
        }
      }
      __syncwarp();
    }
  }
}

constexpr int LOCKSTEP = 4;  // rows searched together by one thread

__global__ void merge_topk_kernel(const int32_t* __restrict__ window_keys,
                                  const float* __restrict__ window_scores,
                                  int32_t* __restrict__ out_keys,
                                  float* __restrict__ out_scores,
                                  int32_t* __restrict__ out_idx, int R,
                                  int W, int P, int block) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* s = reinterpret_cast<float*>(smem);  // R rows of P scores
  int* p = reinterpret_cast<int*>(s + R * P);  // their flat indices
  const int g = blockIdx.x / R;
  const int r = blockIdx.x - g * R;
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const int64_t in_group = static_cast<int64_t>(g) * R * W;

  for (int q = threadIdx.x >> 5; q < R; q += warps) {
    float* sq = s + q * P;
    int* pq = p + q * P;
    const float* src = window_scores + in_group + static_cast<int64_t>(q) * W;
    for (int i = lane; i < P; i += 32) {
      sq[i] = i < W ? src[i] : -CUDART_INF_F;
      pq[i] = i < W ? q * W + i : INT32_MAX;  // padding sorts last
    }
    __syncwarp();
    bool unsorted = false;
    for (int i = lane; i + 1 < W; i += 32) unsorted |= !(sq[i] >= sq[i + 1]);
    if (__any_sync(FULL, unsorted)) warp_bitonic_sort_desc(sq, pq, P, lane);
  }
  __syncthreads();

  int top = 1;  // the largest power of two <= W
  while (top * 2 <= W) top *= 2;
  const float* sr = s + r * P;
  const int own = min(W, block);  // an item at position i has rank >= i
  for (int i = threadIdx.x; i < own; i += blockDim.x) {
    const float x = sr[i];
    int rank = i;
    for (int q0 = 0; q0 < R && rank < block; q0 += LOCKSTEP) {
      int pos[LOCKSTEP];
#pragma unroll
      for (int j = 0; j < LOCKSTEP; ++j) pos[j] = 0;
      for (int step = top; step > 0; step >>= 1) {
#pragma unroll
        for (int j = 0; j < LOCKSTEP; ++j) {
          const int q = q0 + j;
          const int at = pos[j] + step;
          if (q < R && q != r && at <= W) {
            const float a = s[q * P + at - 1];
            if (q < r ? a >= x : a > x) pos[j] = at;
          }
        }
      }
#pragma unroll
      for (int j = 0; j < LOCKSTEP; ++j) rank += pos[j];
    }
    if (rank < block) {
      const int src = p[r * P + i];
      const int64_t o = static_cast<int64_t>(g) * block + rank;
      out_idx[o] = src;
      out_scores[o] = x;
      out_keys[o] = window_keys[in_group + src];
    }
  }
}

}  // namespace

extern "C" int merge_topk(const void* window_keys, const void* window_scores,
                          void* out_keys, void* out_scores, void* out_idx,
                          int G, int R, int W, int P, int block,
                          void* stream) {
  if (G <= 0 || block <= 0) return 0;
  const size_t smem =
      static_cast<size_t>(R) * P * (sizeof(float) + sizeof(int));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        merge_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int warps = std::min(32, std::max(R, (std::min(W, block) + 31) / 32));
  merge_topk_kernel<<<G * R, warps * 32, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(window_keys),
      static_cast<const float*>(window_scores),
      static_cast<int32_t*>(out_keys), static_cast<float*>(out_scores),
      static_cast<int32_t*>(out_idx), R, W, P, block);
  return static_cast<int>(cudaGetLastError());
}

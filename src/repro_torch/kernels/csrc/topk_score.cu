// topk_score_pruned: Spec-QP speculative top-k retrieval scoring.
//
// Replaces the TPU kernel repro/kernels/topk_score.py:topk_score_pruned
// (body _score_kernel, sorting with repro/kernels/sortnet.py:
// bitonic_topk_desc).
//
// What it computes, for one query q (D,) against cands (N, D) cut into
// tiles of `tile` rows and visited in order: when bound[j] > the running
// k-th score, score tile j (dot products in f32), merge its scores into the
// running top-k and count the tile; otherwise skip it. The merge sorts by
// (score desc, index asc). Buffered entries come from earlier tiles and so
// carry lower indices than the tile's, and the empty slots carry -1, so
// that order is exactly lax.top_k's over [buffer, tile], the order of
// repro/kernels/ref.py:topk_score_pruned_ref. The TPU kernel's bitonic
// network is not stable; this one follows the reference on ties.
//
// What bounds it on an H100: bytes. A scored tile is tile * D * 4 bytes
// (512 KB at the retrieval path's 512 x 256), each read once, against
// 2 * D flops per row. Which tiles are scored depends on the running k-th
// score, so the design keeps the reference's sequential order: one block
// walks every tile. The query lives in registers and the top-k buffer in
// shared memory; each warp scores a few rows at a time, lanes over D, with
// all of their 16-byte loads issued before the FMAs and a shuffle
// reduction; then sortnet.cuh's bitonic sort orders the k + tile slots,
// padded to a power of two. A tile none of whose scores beats the k-th
// cannot change the buffer (a score equal to the k-th loses on index), so
// its sort is skipped; the tile still counts as scored. One block streams
// at a small share of the card's bandwidth: scoring tiles in parallel and
// replaying the count in order is the later redesign.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <climits>

#include "sortnet.cuh"

namespace {

constexpr int THREADS = 512;
// 16-byte loads each thread has in flight while a warp scores ROWS rows:
// registers cap it, and it caps the block's streaming rate.
constexpr int LOADS = 16;

// VPL: float4 vectors per lane per row (D <= 128 * VPL, and VPL is 1 or 2,
// so D <= 256, the retrieval path's width); each warp scores
// LOADS / VPL rows at a time and issues all their loads before any FMA.
template <int VPL>
__global__ void __launch_bounds__(THREADS)
topk_score_kernel(const float4* __restrict__ query,
                  const float4* __restrict__ cands,
                  const float* __restrict__ bounds, float* __restrict__ out_s,
                  int32_t* __restrict__ out_i, int32_t* __restrict__ out_cnt,
                  int n_tiles, int tile, int d4, int k, int sort_len) {
  constexpr int ROWS = LOADS / VPL;
  extern __shared__ __align__(16) unsigned char smem[];
  float* s = reinterpret_cast<float*>(smem);
  int* p = reinterpret_cast<int*>(s + sort_len);
  for (int i = threadIdx.x; i < k; i += THREADS) {
    s[i] = -CUDART_INF_F;
    p[i] = -1;
  }
  // Padding sorts after every real and empty slot.
  for (int i = k + tile + threadIdx.x; i < sort_len; i += THREADS) {
    s[i] = -CUDART_INF_F;
    p[i] = INT_MAX;
  }
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  float4 qv[VPL];
#pragma unroll
  for (int v = 0; v < VPL; ++v) {
    qv[v] = lane + 32 * v < d4 ? query[lane + 32 * v] : zero;
  }
  __syncthreads();
  int scored = 0;
  for (int j = 0; j < n_tiles; ++j) {
    // Every thread reads the same bound and k-th: the branch is uniform.
    const float kth = s[k - 1];
    if (!(bounds[j] > kth)) continue;
    ++scored;
    const int64_t row0 = static_cast<int64_t>(j) * tile;
    for (int r0 = warp * ROWS; r0 < tile; r0 += (THREADS / 32) * ROWS) {
      float4 c[ROWS][VPL];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
#pragma unroll
        for (int v = 0; v < VPL; ++v) {
          const int col = lane + 32 * v;
          c[r][v] = r0 + r < tile && col < d4
                        ? cands[(row0 + r0 + r) * d4 + col]
                        : zero;
        }
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        float a = 0.0f;
#pragma unroll
        for (int v = 0; v < VPL; ++v) {
          a += c[r][v].x * qv[v].x + c[r][v].y * qv[v].y +
               c[r][v].z * qv[v].z + c[r][v].w * qv[v].w;
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          a += __shfl_xor_sync(0xffffffffu, a, off);
        }
        if (lane == 0 && r0 + r < tile) {
          s[k + r0 + r] = a;
          p[k + r0 + r] = static_cast<int>(row0 + r0 + r);
        }
      }
    }
    __syncthreads();
    int beats = 0;
    for (int i = threadIdx.x; i < tile; i += THREADS) beats |= s[k + i] > kth;
    if (__syncthreads_or(beats)) bitonic_sort_desc(s, p, sort_len);
  }
  for (int i = threadIdx.x; i < k; i += THREADS) {
    out_s[i] = s[i];
    out_i[i] = p[i];
  }
  if (threadIdx.x == 0) *out_cnt = scored;
}

template <int VPL>
cudaError_t launch(const void* query, const void* cands, const void* bounds,
                   void* out_s, void* out_i, void* out_cnt, int n_tiles,
                   int tile, int d4, int k, int sort_len,
                   cudaStream_t stream) {
  const size_t smem =
      static_cast<size_t>(sort_len) * (sizeof(float) + sizeof(int));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        topk_score_kernel<VPL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  topk_score_kernel<VPL><<<1, THREADS, smem, stream>>>(
      static_cast<const float4*>(query), static_cast<const float4*>(cands),
      static_cast<const float*>(bounds), static_cast<float*>(out_s),
      static_cast<int32_t*>(out_i), static_cast<int32_t*>(out_cnt), n_tiles,
      tile, d4, k, sort_len);
  return cudaGetLastError();
}

}  // namespace

// D must be a multiple of 4 and at most MAX_D (the wrapper checks).
extern "C" int topk_score_pruned(const void* query, const void* cands,
                                 const void* bounds, void* out_s, void* out_i,
                                 void* out_cnt, int n_tiles, int tile, int D,
                                 int k, int sort_len, void* stream) {
  const int d4 = D / 4;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (d4 <= 32) {
    err = launch<1>(query, cands, bounds, out_s, out_i, out_cnt, n_tiles,
                    tile, d4, k, sort_len, st);
  } else if (d4 <= 64) {
    err = launch<2>(query, cands, bounds, out_s, out_i, out_cnt, n_tiles,
                    tile, d4, k, sort_len, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

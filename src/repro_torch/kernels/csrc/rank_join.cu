// rank_join_lookup: the blocked scored equi-join probe of the rank join.
//
// Replaces the TPU kernel repro/kernels/rank_join.py:rank_join_lookup (body
// _lookup_kernel), batched over G groups: in the executor's step the groups
// are (lane x {the pulling stream's own seen ring, then each of the T
// streams' rings}), so one launch serves every probe of a trip.
//
// What it computes, per group g and probe b: the sum of the scores of the
// live seen slots whose key equals probe_keys[g, b], and whether any slot
// matched. Slot n is live iff n < seen_cnt[g] (a wrapped ring is all live)
// and its key is not PAD_KEY; PAD probes are never found.
//
// What bounds it on an H100: compares. A trip does G*B*live compare-and-add
// steps (about 168 M at G = 40, B = 256, N = 16384) on G*N*8 bytes of rings
// (5 MB), so the 32-bit ALUs, not device memory, are the limit. The TPU
// kernel contracted a (B x 512) equality matrix on the MXU; a GPU has no
// integer-equality tensor-core op, so here each thread owns one probe and
// walks the ring from shared memory, where every thread of a warp reads the
// same slot (a broadcast, no bank conflicts). Tiles of the ring are staged
// in shared memory by the whole block, coalesced. The scan stops at the live
// prefix min(N, seen_cnt), so early trips with short rings cost little.
//
// Rings hold unique live keys, so every sum has at most one non-zero term
// and the result is bit-equal to the plain version in any order.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int32_t PAD_KEY = -1;
constexpr int PROBES_PER_BLOCK = 128;  // one probe per thread
constexpr int TILE = 2048;             // ring slots staged per pass (16 KB)

__global__ void __launch_bounds__(PROBES_PER_BLOCK)
rank_join_lookup_kernel(const int32_t* __restrict__ seen_keys,
                        const float* __restrict__ seen_scores,
                        const int32_t* __restrict__ probe_keys,
                        const int32_t* __restrict__ seen_cnt,
                        float* __restrict__ out_scores,
                        uint8_t* __restrict__ out_found,
                        int N, int B) {
  __shared__ int32_t s_keys[TILE];
  __shared__ float s_scores[TILE];
  const int g = blockIdx.y;
  const int b = blockIdx.x * PROBES_PER_BLOCK + threadIdx.x;
  const int64_t ring = static_cast<int64_t>(g) * N;
  const int live = min(N, max(seen_cnt[g], 0));
  const int32_t probe =
      b < B ? probe_keys[static_cast<int64_t>(g) * B + b] : PAD_KEY;
  float acc = 0.0f;
  int hits = 0;
  for (int base = 0; base < live; base += TILE) {
    const int n = min(TILE, live - base);
    __syncthreads();  // the previous tile has been read by every thread
    for (int i = threadIdx.x; i < n; i += PROBES_PER_BLOCK) {
      s_keys[i] = seen_keys[ring + base + i];
      s_scores[i] = seen_scores[ring + base + i];
    }
    __syncthreads();
    // A PAD probe matches nothing; a non-PAD probe never equals a PAD slot.
    if (probe != PAD_KEY) {
#pragma unroll 8
      for (int i = 0; i < n; ++i) {
        if (s_keys[i] == probe) {
          acc += s_scores[i];
          ++hits;
        }
      }
    }
  }
  if (b < B) {
    const int64_t o = static_cast<int64_t>(g) * B + b;
    out_scores[o] = hits > 0 ? acc : 0.0f;
    out_found[o] = hits > 0 ? 1 : 0;
  }
}

}  // namespace

extern "C" int rank_join_lookup(const void* seen_keys, const void* seen_scores,
                                const void* probe_keys, const void* seen_cnt,
                                void* out_scores, void* out_found, int G,
                                int N, int B, void* stream) {
  if (G <= 0 || B <= 0) return 0;
  const dim3 grid((B + PROBES_PER_BLOCK - 1) / PROBES_PER_BLOCK, G);
  rank_join_lookup_kernel<<<grid, PROBES_PER_BLOCK, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(seen_keys),
      static_cast<const float*>(seen_scores),
      static_cast<const int32_t*>(probe_keys),
      static_cast<const int32_t*>(seen_cnt), static_cast<float*>(out_scores),
      static_cast<uint8_t*>(out_found), N, B);
  return static_cast<int>(cudaGetLastError());
}

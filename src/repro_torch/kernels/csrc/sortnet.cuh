// Block-wide bitonic sort in shared memory.
//
// Counterpart of repro/kernels/sortnet.py:bitonic_topk_desc. The TPU network
// compares scores with strict > / < and is therefore not stable; this one
// sorts by a total order, score descending and then payload ascending, so
// equal scores leave in payload order. With the flat source index as payload
// that is exactly the order lax.top_k gives (lower index first among ties).
#pragma once

__device__ __forceinline__ bool sortnet_before(float sa, int pa, float sb,
                                               int pb) {
  return sa > sb || (sa == sb && pa < pb);
}

// Sorts s[0, n) with payload p[0, n) by (s desc, p asc); n a power of two.
// Every thread of the block calls it after the data is in shared memory and
// a __syncthreads(); it returns after a final __syncthreads().
__device__ void bitonic_sort_desc(float* s, int* p, int n) {
  const int half = n >> 1;
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int t = threadIdx.x; t < half; t += blockDim.x) {
        // The t-th pair (i, i + j) of this sweep: i has bit j clear.
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
      __syncthreads();
    }
  }
}

// embedding_bag: the weighted multi-hot embedding bag, and its backward.
//
// The forward replaces the TPU kernel
// repro/kernels/embedding_bag.py:embedding_bag (body _bag_kernel). The
// backward (embedding_bag_backward, at the end of this file) has no TPU
// counterpart: the reference differentiates its plain embedding_bag_ref.
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

// embedding_bag_backward: the gradients of the bag.
//
// What it computes: dtable[ids[b,s]] += w[b,s] * dout[b] for every live slot
// (ids >= 0), into a (V, D) f32 gradient that the caller has zero-filled;
// and, when asked, dweights[b,s] = <table[ids[b,s]], dout[b]> for a live
// slot, 0 for a dead one. The plain version is kernels/ref.py's
// embedding_bag_backward (index_add_ of the weighted rows).
//
// What bounds it on an H100: bytes, and the atomics' rate in L2. Reading
// dout, ids and weights once and each distinct live row read and written
// once is the least traffic; the zero-fill of the dense (V, D) gradient
// (10.24 GB for a 10 M x 256 table) sits outside the kernel and is larger.
// Each thread owns one 16-byte column of one bag, as in the forward: it
// reads its float4 of dout once, then adds w * dout to the row of each live
// slot with one 128-bit float atomic (sm_90), a bag's D / 4 threads
// covering the row's coalesced line. Repeated ids add in whatever order
// the atomics land, so dtable is not bit-equal from run to run where ids
// repeat. The weights' gradient is one warp per slot: its lanes read the
// row and dout as float4s and reduce with shuffles.

namespace {

__global__ void __launch_bounds__(THREADS)
embedding_bag_table_grad_kernel(const float4* __restrict__ dout,
                                const int32_t* __restrict__ ids,
                                const float* __restrict__ weights,
                                float4* __restrict__ dtable, int64_t n_out,
                                int S, int d4) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  if (t >= n_out) return;
  const int64_t b = t / d4;
  const int c = static_cast<int>(t - b * d4);
  const int32_t* bag_ids = ids + b * S;
  const float* bag_w = weights + b * S;
  const float4 g = dout[t];
  for (int s = 0; s < S; ++s) {
    const int32_t id = bag_ids[s];
    if (id < 0) continue;
    const float w = bag_w[s];
    atomicAdd(dtable + static_cast<int64_t>(id) * d4 + c,
              make_float4(w * g.x, w * g.y, w * g.z, w * g.w));
  }
}

constexpr int WARPS = THREADS / 32;

__global__ void __launch_bounds__(THREADS)
embedding_bag_weight_grad_kernel(const float4* __restrict__ table,
                                 const int32_t* __restrict__ ids,
                                 const float4* __restrict__ dout,
                                 float* __restrict__ dweights, int64_t n_slots,
                                 int S, int d4) {
  const int64_t slot =
      static_cast<int64_t>(blockIdx.x) * WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (slot >= n_slots) return;
  const int32_t id = ids[slot];
  if (id < 0) {
    if (lane == 0) dweights[slot] = 0.0f;
    return;
  }
  const float4* row = table + static_cast<int64_t>(id) * d4;
  const float4* g = dout + (slot / S) * d4;
  float acc = 0.0f;
  for (int c = lane; c < d4; c += 32) {
    const float4 r = row[c];
    const float4 x = g[c];
    acc += r.x * x.x + r.y * x.y + r.z * x.z + r.w * x.w;
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) dweights[slot] = acc;
}

}  // namespace

// dtable (zero-filled by the caller) and dweights may each be null: that
// gradient is then not computed. table is read only for dweights.
extern "C" int embedding_bag_backward(const void* dout, const void* ids,
                                      const void* weights, const void* table,
                                      void* dtable, void* dweights,
                                      long long B, int S, int D,
                                      void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const int d4 = D / 4;
  if (dtable != nullptr) {
    const int64_t n_out = static_cast<int64_t>(B) * d4;
    if (n_out > 0) {
      const int64_t blocks = (n_out + THREADS - 1) / THREADS;
      if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
      embedding_bag_table_grad_kernel<<<static_cast<unsigned>(blocks),
                                        THREADS, 0, st>>>(
          static_cast<const float4*>(dout), static_cast<const int32_t*>(ids),
          static_cast<const float*>(weights), static_cast<float4*>(dtable),
          n_out, S, d4);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  }
  if (dweights != nullptr) {
    const int64_t n_slots = static_cast<int64_t>(B) * S;
    if (n_slots > 0) {
      const int64_t blocks = (n_slots + WARPS - 1) / WARPS;
      if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
      embedding_bag_weight_grad_kernel<<<static_cast<unsigned>(blocks),
                                         THREADS, 0, st>>>(
          static_cast<const float4*>(table), static_cast<const int32_t*>(ids),
          static_cast<const float4*>(dout), static_cast<float*>(dweights),
          n_slots, S, d4);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  }
  return 0;
}

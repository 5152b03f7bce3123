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

#include <algorithm>
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
// It replaces no TPU kernel: the reference takes jax.grad of its plain
// embedding_bag_ref (repro/kernels/ref.py:85). The plain version is
// kernels/ref.py's embedding_bag_backward (index_add_ of the weighted rows);
// kernels/ref.py's embedding_bag_backward_grouped is this file's CPU model,
// pass by pass.
//
// What it computes: dtable[ids[b,s]] += w[b,s] * dout[b] for every live slot
// (ids >= 0), into a (V, D) f32 gradient that the caller has zero-filled;
// each touched row is written once and every other row is left as it is.
// And, when asked, dweights[b,s] = <table[ids[b,s]], dout[b]> for a live
// slot, 0 for a dead one.
//
// The order of the sum: a row is the sequential sum, from 0, of the rounded
// products w[b,s] * dout[b] of its slots in ascending flat slot order
// b * S + s. That is the order of JAX's scatter-add (the transpose of the
// reference's gather, on XLA's CPU backend) and of index_add_ on the CPU,
// so the gradient equals theirs bit for bit and is the same on every run.
// Products and sums use __fmul_rn / __fadd_rn, so that nvcc cannot contract
// them into an FMA, which would round once where the reference rounds twice.
//
// How: the live slots are grouped by id with a stable LSD radix sort written
// here (8-bit digits over the low ceil(log2 V) bits of the id: 3 passes at
// V = 10 M). A pass has a (digit, tile) histogram (a tile is 1,024 slots;
// each warp counts its 128 slots with __match_any_sync), an exclusive scan
// of each digit's counts over the tiles (a block a digit), and a scatter in
// which each slot's place is the smaller digits' totals plus its (digit,
// tile) offset plus the counts of earlier warps of the tile plus its rank
// among equal digits in its chunk of 32 (match masks and popcounts). No
// place comes from an atomic, so the sort is stable and the same on every
// run. The first pass's histogram is a kernel of its own; each scatter
// counts the next pass's by integer atomics, whose sums do not depend on
// their order. The first pass drops the dead slots; the last also gathers
// each slot's weight next to it. Then the segment pass: a warp takes
// chunks of 32 sorted slots (grid-stride, a persistent grid), finds the
// runs of equal ids that begin there, and walks each run in order, its
// lanes holding two float4 columns of the row each (sweeps of 256 floats),
// keeping dout[b] in registers while consecutive slots share b. Runs that
// end within the next chunk (the training batch's, 5 to 8 slots) go to a
// kernel with few registers, so many warps keep rows in flight; a run that
// goes on past the next chunk goes to a second kernel that loads two
// windows ahead of its adds. A hot id (8,192 slots at the hot-id check) is
// thus one warp's sequential sum: the order is what buys bit-equality, and
// there is no tree inside a run. No float atomic is used and dtable is
// never read.
//
// What bounds it on an H100: bytes. dout, ids and weights read once and
// each distinct live row written once: 104.4 MB, 0.0312 ms at 3.35 TB/s,
// at the training batch's user bags (B 16,384, S 32, 81,511 distinct rows).
// The sort's own traffic (about 20 B a slot a pass) stays in L2; the
// zero-fill of the dense (V, D) gradient (10.24 GB for a 10 M x 256 table)
// sits outside the kernel and is far larger.
//
// Ids are not range-checked, as in the reference. The sort reads only the
// low ceil(log2 V) bits of an id, so an id >= V lands on row id mod
// 2^ceil(log2 V) when that row is < V, and is dropped otherwise; the
// previous kernel, by atomics, wrote outside the table.
//
// The weights' gradient is one warp per slot: its lanes read the row and
// dout as float4s and reduce with shuffles.

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int RADIX_BITS = 8;
constexpr int BINS = 1 << RADIX_BITS;
constexpr int SORT_WARPS = 8;
constexpr int SORT_THREADS = SORT_WARPS * 32;
constexpr int ITEMS = 4;                       // chunks of 32 a warp
constexpr int TILE = SORT_THREADS * ITEMS;     // 1,024 slots
constexpr int SEG_THREADS = 256;
constexpr int SEG_WARPS = SEG_THREADS / 32;
constexpr int SEG_COLS = 2;                    // float4 columns a lane a sweep
static_assert(SORT_THREADS == BINS, "one thread a digit");

// One tile's slots, ITEMS a thread: warp w holds the tile's slots
// [w * 32 * ITEMS, (w + 1) * 32 * ITEMS), chunk c of it at lane l the slot
// w * 32 * ITEMS + 32 c + l. FIRST reads ids (the slot is the flat index,
// dead slots get digit BINS); later passes read the previous pass's keys
// and slots. The digit of an empty place is BINS.
template <bool FIRST>
__device__ __forceinline__ void load_tile(const int32_t* __restrict__ keys_in,
                                          const int32_t* __restrict__ slots_in,
                                          int64_t n, int key_mask, int shift,
                                          int32_t (&key)[ITEMS],
                                          int32_t (&slot)[ITEMS],
                                          int (&dig)[ITEMS]) {
  const int lane = threadIdx.x % 32;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * TILE +
                        (threadIdx.x / 32) * (32 * ITEMS) + lane;
#pragma unroll
  for (int c = 0; c < ITEMS; ++c) {
    const int64_t i = first + 32 * c;
    key[c] = -1;
    slot[c] = 0;
    dig[c] = BINS;
    if (i < n) {
      const int32_t k = keys_in[i];
      if (FIRST) {
        slot[c] = static_cast<int32_t>(i);
        if (k >= 0) {
          key[c] = k & key_mask;
          dig[c] = (key[c] >> shift) & (BINS - 1);
        }
      } else {
        key[c] = k;
        if (slots_in != nullptr) slot[c] = slots_in[i];
        dig[c] = (k >> shift) & (BINS - 1);
      }
    }
  }
}

// Adds this warp's count of each digit over its ITEMS chunks into cnt
// (BINS ints of shared memory): a chunk's lanes of one digit elect their
// lowest lane, which adds their number.
__device__ __forceinline__ void count_warp(const int (&dig)[ITEMS], int* cnt) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int c = 0; c < ITEMS; ++c) {
    const unsigned peers = __match_any_sync(FULL, dig[c]);
    if (dig[c] < BINS && lane == __ffs(peers) - 1) cnt[dig[c]] += __popc(peers);
    __syncwarp();
  }
}

// The first pass's histogram: hist[d * n_tiles + tile] = the tile's count
// of live slots whose id has the low digit d.
__global__ void __launch_bounds__(SORT_THREADS)
bag_sort_hist_kernel(const int32_t* __restrict__ ids, int64_t n, int key_mask,
                     int32_t* __restrict__ hist, int n_tiles) {
  __shared__ int cnt[SORT_WARPS][BINS];
  for (int i = threadIdx.x; i < SORT_WARPS * BINS; i += SORT_THREADS)
    (&cnt[0][0])[i] = 0;
  __syncthreads();
  int32_t key[ITEMS], slot[ITEMS];
  int dig[ITEMS];
  load_tile<true>(ids, nullptr, n, key_mask, 0, key, slot, dig);
  count_warp(dig, cnt[threadIdx.x / 32]);
  __syncthreads();
  int total = 0;
#pragma unroll
  for (int w = 0; w < SORT_WARPS; ++w) total += cnt[w][threadIdx.x];
  hist[static_cast<int64_t>(threadIdx.x) * n_tiles + blockIdx.x] = total;
}

// Exclusive scan of v over the block's SORT_THREADS threads; *total gets
// the block's sum. warp_sums holds SORT_WARPS ints of shared memory.
__device__ __forceinline__ int block_exclusive_scan(int v, int* warp_sums,
                                                    int* total) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  int incl = v;
#pragma unroll
  for (int off = 1; off < 32; off *= 2) {
    const int up = __shfl_up_sync(FULL, incl, off);
    if (lane >= off) incl += up;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  int before = 0, all = 0;
#pragma unroll
  for (int w = 0; w < SORT_WARPS; ++w) {
    const int ws = warp_sums[w];
    if (w < warp) before += ws;
    all += ws;
  }
  __syncthreads();
  *total = all;
  return before + incl - v;
}

// Pass scan, one block a digit d: the exclusive scan of hist[d * n_tiles
// + t] over the tiles t in place, and the digit's total to totals[d]. It
// zeroes the next pass's counts (next, unless null), which this pass's
// scatter then adds up.
__global__ void __launch_bounds__(SORT_THREADS)
bag_sort_scan_kernel(int32_t* __restrict__ hist, int n_tiles,
                     int32_t* __restrict__ totals,
                     int32_t* __restrict__ next) {
  __shared__ int warp_sums[SORT_WARPS];
  const int64_t row = static_cast<int64_t>(blockIdx.x) * n_tiles;
  int32_t* h = hist + row;
  int carry = 0;
  for (int t0 = 0; t0 < n_tiles; t0 += SORT_THREADS) {
    const int t = t0 + threadIdx.x;
    const int v = t < n_tiles ? h[t] : 0;
    int sum;
    const int ex = block_exclusive_scan(v, warp_sums, &sum);
    if (t < n_tiles) {
      h[t] = carry + ex;
      if (next != nullptr) next[row + t] = 0;
    }
    carry += sum;
  }
  if (threadIdx.x == 0) totals[blockIdx.x] = carry;
}

// Pass scatter: each slot to its digit's base (the totals of the smaller
// digits) plus its (digit, tile) offset plus the counts of its digit in
// the tile's earlier warps and chunks plus its rank among its chunk's
// lanes of that digit. FIRST's block 0 writes the number of live slots to
// *n_live (later passes read it). LAST writes each slot's weight beside
// it; every other pass counts the next pass's (digit, tile) histogram into
// hist_next as it places the slots (integer atomics, one a run of equal
// targets in a chunk).
template <bool FIRST, bool LAST>
__global__ void __launch_bounds__(SORT_THREADS)
bag_sort_scatter_kernel(const int32_t* __restrict__ keys_in,
                        const int32_t* __restrict__ slots_in, int64_t n_first,
                        int32_t* __restrict__ n_live, int key_mask, int shift,
                        const int32_t* __restrict__ hist,
                        const int32_t* __restrict__ totals, int n_tiles,
                        int32_t* __restrict__ hist_next,
                        int32_t* __restrict__ keys_out,
                        int32_t* __restrict__ slots_out,
                        const float* __restrict__ weights,
                        float* __restrict__ w_out) {
  __shared__ int cnt[SORT_WARPS][BINS];
  __shared__ int warp_sums[SORT_WARPS];
  const int64_t n = FIRST ? n_first : static_cast<int64_t>(*n_live);
  if (static_cast<int64_t>(blockIdx.x) * TILE >= n) return;
  for (int i = threadIdx.x; i < SORT_WARPS * BINS; i += SORT_THREADS)
    (&cnt[0][0])[i] = 0;
  int live;
  const int digit_base = block_exclusive_scan(totals[threadIdx.x], warp_sums,
                                              &live);
  if (FIRST && blockIdx.x == 0 && threadIdx.x == 0) *n_live = live;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  int32_t key[ITEMS], slot[ITEMS];
  int dig[ITEMS];
  load_tile<FIRST>(keys_in, slots_in, n, key_mask, shift, key, slot, dig);
  count_warp(dig, cnt[warp]);
  __syncthreads();
  {
    const int d = threadIdx.x;
    int run = digit_base +
              hist[static_cast<int64_t>(d) * n_tiles + blockIdx.x];
#pragma unroll
    for (int w = 0; w < SORT_WARPS; ++w) {
      const int c = cnt[w][d];
      cnt[w][d] = run;
      run += c;
    }
  }
  __syncthreads();
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int c = 0; c < ITEMS; ++c) {
    const int d = dig[c];
    const unsigned peers = __match_any_sync(FULL, d);
    int target = -1;
    if (d < BINS) {
      const int pos = cnt[warp][d] + __popc(peers & below);
      keys_out[pos] = key[c];
      slots_out[pos] = slot[c];
      if (LAST) w_out[pos] = weights[slot[c]];
      else
        target = ((key[c] >> (shift + RADIX_BITS)) & (BINS - 1)) * n_tiles +
                 pos / TILE;
    }
    if (!LAST) {
      const unsigned same = __match_any_sync(FULL, target);
      if (target >= 0 && lane == __ffs(same) - 1)
        atomicAdd(hist_next + target, __popc(same));
    }
    __syncwarp();
    if (d < BINS && lane == __ffs(peers) - 1) cnt[warp][d] += __popc(peers);
    __syncwarp();
  }
}

__device__ __forceinline__ void add_term(float4& acc, float w, float4 g) {
  acc.x = __fadd_rn(acc.x, __fmul_rn(w, g.x));
  acc.y = __fadd_rn(acc.y, __fmul_rn(w, g.y));
  acc.z = __fadd_rn(acc.z, __fmul_rn(w, g.z));
  acc.w = __fadd_rn(acc.w, __fmul_rn(w, g.w));
}

// 32 sorted places from pos, a place a lane: id, slot, weight (-1, 0, 0
// past n).
struct Window {
  int32_t k, s;
  float w;
};

__device__ __forceinline__ Window load_window(const int32_t* __restrict__ keys,
                                              const int32_t* __restrict__ slots,
                                              const float* __restrict__ ws,
                                              int64_t n, int64_t pos) {
  Window v{-1, 0, 0.0f};
  if (pos < n) {
    v.k = keys[pos];
    v.s = slots[pos];
    v.w = ws[pos];
  }
  return v;
}

// This lane's SEG_COLS float4 columns c0 + lane + 32 i of dout[b].
__device__ __forceinline__ void load_row(float4 (&g)[SEG_COLS],
                                         const float4* __restrict__ dout,
                                         int b, int d4, int c0) {
  const float4* r = dout + static_cast<int64_t>(b) * d4;
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int i = 0; i < SEG_COLS; ++i) {
    const int col = c0 + lane + 32 * i;
    if (col < d4) g[i] = r[col];
  }
}

// Adds places j0 .. end - 1 of the window cur, in order, into acc: each
// place's weight times this lane's columns of its bag's dout row, held in
// g (g_b: its bag) and loaded again when the bag changes.
__device__ __forceinline__ void add_window(float4 (&acc)[SEG_COLS],
                                          float4 (&g)[SEG_COLS], int& g_b,
                                          const Window& cur, int j0, int end,
                                          const float4* __restrict__ dout,
                                          int S, int d4, int c0) {
  const int wb = cur.s / S;
  for (int j = j0; j < end; ++j) {
    const int bj = __shfl_sync(FULL, wb, j);
    const float wj = __shfl_sync(FULL, cur.w, j);
    if (bj != g_b) {
      g_b = bj;
      load_row(g, dout, bj, d4, c0);
    }
#pragma unroll
    for (int i = 0; i < SEG_COLS; ++i) add_term(acc[i], wj, g[i]);
  }
}

__device__ __forceinline__ void store_row(float4* __restrict__ row,
                                          const float4 (&acc)[SEG_COLS],
                                          int d4, int c0) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int i = 0; i < SEG_COLS; ++i) {
    const int col = c0 + lane + 32 * i;
    if (col < d4) row[col] = acc[i];
  }
}

// The first place at or after j0 of the window at wbase that is past n or
// holds another id than id; 32 if none.
__device__ __forceinline__ int run_end(const Window& cur, int64_t wbase,
                                       int64_t n, int32_t id, int j0) {
  const int lane = threadIdx.x % 32;
  const unsigned stop =
      __ballot_sync(FULL, wbase + lane >= n || cur.k != id) &
      ~((1u << j0) - 1u);
  return stop != 0 ? __ffs(stop) - 1 : 32;
}

// The runs of equal ids < V that begin in a warp's chunk of 32 sorted
// places at base: the chunk as a window, the runs' heads (the lanes whose
// id differs from the place before) and the id at base + 64 (-1 past n),
// which tells whether the chunk's last run goes on past the next chunk.
struct Chunk {
  Window c;
  unsigned heads;
  int32_t k64;
};

__device__ __forceinline__ Chunk load_chunk(const int32_t* __restrict__ keys,
                                            const int32_t* __restrict__ slots,
                                            const float* __restrict__ ws,
                                            int64_t n, int64_t base,
                                            int64_t V) {
  const int lane = threadIdx.x % 32;
  Chunk ch;
  ch.c = load_window(keys, slots, ws, n, base + lane);
  int32_t prev = __shfl_up_sync(FULL, ch.c.k, 1);
  int32_t k64 = -1;
  if (lane == 0) {
    prev = base > 0 ? keys[base - 1] : -1;
    if (base + 64 < n) k64 = keys[base + 64];
  }
  ch.k64 = __shfl_sync(FULL, k64, 0);
  ch.heads =
      __ballot_sync(FULL, base + lane < n && ch.c.k != prev && ch.c.k < V);
  return ch;
}

// Segment pass, short runs: each run of one id < V that begins in the
// warp's chunk and ends within the next chunk, summed in its (ascending
// slot) order from 0 and stored once into dtable. Few registers, so that
// many warps keep their loads and the rows' stores in flight; a run that
// goes on past the next chunk is bag_long_run_kernel's.
__global__ void __launch_bounds__(SEG_THREADS)
bag_segment_kernel(const int32_t* __restrict__ keys,
                   const int32_t* __restrict__ slots,
                   const float* __restrict__ ws,
                   const int32_t* __restrict__ n_live,
                   const float4* __restrict__ dout, float4* __restrict__ dtable,
                   int S, int d4, int64_t V) {
  const int64_t n = *n_live;
  const int lane = threadIdx.x % 32;
  const int64_t n_chunks = (n + 31) / 32;
  const int64_t n_warps = static_cast<int64_t>(gridDim.x) * SEG_WARPS;
  for (int64_t chunk = static_cast<int64_t>(blockIdx.x) * SEG_WARPS +
                       threadIdx.x / 32;
       chunk < n_chunks; chunk += n_warps) {
    const int64_t base = chunk * 32;
    const Chunk ch = load_chunk(keys, slots, ws, n, base, V);
    unsigned heads = ch.heads;
    while (heads != 0) {
      const int h = __ffs(heads) - 1;
      heads &= heads - 1;
      const int32_t id = __shfl_sync(FULL, ch.c.k, h);
      if (heads == 0 && id == ch.k64) break;      // a long run
      float4* row = dtable + static_cast<int64_t>(id) * d4;
      for (int c0 = 0; c0 < d4; c0 += 32 * SEG_COLS) {
        float4 acc[SEG_COLS], g[SEG_COLS];
#pragma unroll
        for (int i = 0; i < SEG_COLS; ++i)
          g[i] = acc[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        int g_b = -1;
        Window cur = ch.c;
        int j0 = h;
        for (int64_t wbase = base;; wbase += 32, j0 = 0) {
          if (wbase != base)
            cur = load_window(keys, slots, ws, n, wbase + lane);
          const int end = run_end(cur, wbase, n, id, j0);
          add_window(acc, g, g_b, cur, j0, end, dout, S, d4, c0);
          if (end < 32) break;
        }
        store_row(row, acc, d4, c0);
      }
    }
  }
}

// Sums the run of id that begins at place h of the window c at base and
// goes on past base + 64, in order, and stores it into row. A step sums
// LONG_STEP windows while the next step's dout rows and the windows of the
// step after it load, so a load has a whole step's adds to arrive in.
constexpr int LONG_STEP = 2;

__device__ __forceinline__ void walk_long_run(
    const int32_t* __restrict__ keys, const int32_t* __restrict__ slots,
    const float* __restrict__ ws, int64_t n, const float4* __restrict__ dout,
    float4* __restrict__ row, int S, int d4, int32_t id, const Window& c,
    int64_t base, int h) {
  const int lane = threadIdx.x % 32;
  constexpr int P = LONG_STEP;
  for (int c0 = 0; c0 < d4; c0 += 32 * SEG_COLS) {
    float4 acc[SEG_COLS], g[SEG_COLS];
#pragma unroll
    for (int i = 0; i < SEG_COLS; ++i)
      g[i] = acc[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    int g_b = -1;
    // This step's windows (cw) with the dout row of each one's first place
    // (cg, of bag cg_b); the next step's windows (nw).
    Window cw[P], nw[P];
    float4 cg[P][SEG_COLS];
    int cg_b[P];
    cw[0] = c;
#pragma unroll
    for (int p = 1; p < P; ++p)
      cw[p] = load_window(keys, slots, ws, n, base + 32 * p + lane);
#pragma unroll
    for (int p = 0; p < P; ++p) {
      nw[p] = load_window(keys, slots, ws, n, base + 32 * (P + p) + lane);
      cg_b[p] = __shfl_sync(FULL, cw[p].s, p == 0 ? h : 0) / S;
      load_row(cg[p], dout, cg_b[p], d4, c0);
    }
    int j0 = h;
    for (int64_t wbase = base;; wbase += 32 * P) {
      Window nnw[P];
      float4 ng[P][SEG_COLS];
      int ng_b[P];
#pragma unroll
      for (int p = 0; p < P; ++p) {
        ng_b[p] = __shfl_sync(FULL, nw[p].s, 0) / S;
        load_row(ng[p], dout, ng_b[p], d4, c0);
        nnw[p] = load_window(keys, slots, ws, n,
                             wbase + 32 * (2 * P + p) + lane);
      }
      bool done = false;
#pragma unroll
      for (int p = 0; p < P; ++p) {
        if (done) break;
        const int end = run_end(cw[p], wbase + 32 * p, n, id, j0);
        const int wb = cw[p].s / S;
        if (j0 == 0 && end == 32 && __all_sync(FULL, wb == cg_b[p])) {
#pragma unroll
          for (int j = 0; j < 32; ++j) {
            const float wj = __shfl_sync(FULL, cw[p].w, j);
#pragma unroll
            for (int i = 0; i < SEG_COLS; ++i) add_term(acc[i], wj, cg[p][i]);
          }
        } else {
          if (cg_b[p] != g_b) {
            g_b = cg_b[p];
#pragma unroll
            for (int i = 0; i < SEG_COLS; ++i) g[i] = cg[p][i];
          }
          add_window(acc, g, g_b, cw[p], j0, end, dout, S, d4, c0);
        }
        j0 = 0;
        done = end < 32;
      }
      if (done) break;
#pragma unroll
      for (int p = 0; p < P; ++p) {
        cw[p] = nw[p];
        nw[p] = nnw[p];
        cg_b[p] = ng_b[p];
#pragma unroll
        for (int i = 0; i < SEG_COLS; ++i) cg[p][i] = ng[p][i];
      }
    }
    store_row(row, acc, d4, c0);
  }
}

// Segment pass, long runs: each run that begins in a chunk and goes on
// past the next chunk (a hot id: 8,192 places at the hot-id check), summed
// in order as bag_segment_kernel sums, by walk_long_run.
__global__ void __launch_bounds__(SEG_THREADS)
bag_long_run_kernel(const int32_t* __restrict__ keys,
                    const int32_t* __restrict__ slots,
                    const float* __restrict__ ws,
                    const int32_t* __restrict__ n_live,
                    const float4* __restrict__ dout, float4* __restrict__ dtable,
                    int S, int d4, int64_t V) {
  const int64_t n = *n_live;
  const int lane = threadIdx.x % 32;
  const int64_t n_chunks = (n + 31) / 32;
  const int64_t n_warps = static_cast<int64_t>(gridDim.x) * SEG_WARPS;
  // A warp looks at 32 chunks at once, a chunk a lane: only a chunk whose
  // last place's id is also the id 64 places on can hold such a run.
  for (int64_t group = static_cast<int64_t>(blockIdx.x) * SEG_WARPS +
                       threadIdx.x / 32;
       group * 32 < n_chunks; group += n_warps) {
    const int64_t mine = (group * 32 + lane) * 32;
    unsigned todo = __ballot_sync(
        FULL, mine + 64 < n && keys[mine + 31] == keys[mine + 64]);
    for (; todo != 0; todo &= todo - 1) {
      const int64_t base = (group * 32 + __ffs(todo) - 1) * 32;
      const Chunk ch = load_chunk(keys, slots, ws, n, base, V);
      if (ch.heads == 0) continue;
      const int h = 31 - __clz(ch.heads);
      const int32_t id = __shfl_sync(FULL, ch.c.k, h);
      if (id != ch.k64) continue;
      walk_long_run(keys, slots, ws, n, dout,
                    dtable + static_cast<int64_t>(id) * d4, S, d4, id, ch.c,
                    base, h);
    }
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

// Bits of an id the sort reads: ceil(log2 V), at most 31 (ids are int32).
int id_bits(long long V) {
  int bits = 0;
  while (bits < 31 && (1ll << bits) < V) ++bits;
  return bits;
}

int64_t n_tiles_of(int64_t n) { return (n + TILE - 1) / TILE; }

}  // namespace

// Bytes of scratch the table gradient needs for B * S = n slots: two key
// and slot buffers, the sorted weights, two (digit, tile) count buffers,
// the digits' totals and the live count, all 32-bit.
extern "C" long long embedding_bag_backward_scratch_bytes(long long n) {
  return 4ll * (5 * n + 2 * BINS * n_tiles_of(n) + BINS + 1);
}

// dtable (zero where no live slot writes) and dweights may each be null:
// that gradient is then not computed. table is read for dweights only.
// For dtable, scratch holds scratch_bytes bytes (at least
// embedding_bag_backward_scratch_bytes(B * S)) and B * S < 2^31; V < 1
// leaves dtable as it is. Returns the first launch's error, else 0.
extern "C" int embedding_bag_backward(const void* dout, const void* ids,
                                      const void* weights, const void* table,
                                      void* dtable, void* dweights,
                                      long long B, int S, int D, long long V,
                                      void* scratch, long long scratch_bytes,
                                      void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const int d4 = D / 4;
  const int64_t n = static_cast<int64_t>(B) * S;
  if (dtable != nullptr && n > 0 && V > 0) {
    if (n > INT_MAX || scratch == nullptr ||
        scratch_bytes < embedding_bag_backward_scratch_bytes(n))
      return static_cast<int>(cudaErrorInvalidValue);
    const int64_t n_tiles = n_tiles_of(n);
    if (n_tiles * BINS > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
    int32_t* base = static_cast<int32_t*>(scratch);
    int32_t* keys[2] = {base, base + n};
    int32_t* slot_buf[2] = {base + 2 * n, base + 3 * n};
    float* w_sorted = reinterpret_cast<float*>(base + 4 * n);
    int32_t* hist[2] = {base + 5 * n, base + 5 * n + n_tiles * BINS};
    int32_t* totals = hist[1] + n_tiles * BINS;
    int32_t* n_live = totals + BINS;
    const int bits = id_bits(V);
    const int key_mask = static_cast<int>((1ll << bits) - 1);
    const int passes = bits > RADIX_BITS ? (bits + RADIX_BITS - 1) / RADIX_BITS
                                         : 1;
    const auto* id_in = static_cast<const int32_t*>(ids);
    const auto* w_in = static_cast<const float*>(weights);
    const unsigned tiles = static_cast<unsigned>(n_tiles);
    const int nt = static_cast<int>(n_tiles);
    cudaError_t err;
    // Pass p sorts by the digit at p * RADIX_BITS: its histogram is
    // hist[p % 2] (counted by a kernel of its own in the first pass, by
    // the previous pass's scatter after that), its keys and slots go to
    // keys[p % 2] and slot_buf[p % 2].
    bag_sort_hist_kernel<<<tiles, SORT_THREADS, 0, st>>>(id_in, n, key_mask,
                                                         hist[0], nt);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    for (int p = 0; p < passes; ++p) {
      const int shift = p * RADIX_BITS;
      const bool first = p == 0, last = p == passes - 1;
      const int32_t* kin = first ? id_in : keys[(p - 1) % 2];
      const int32_t* sprev = first ? nullptr : slot_buf[(p - 1) % 2];
      int32_t* h = hist[p % 2];
      int32_t* h_next = last ? nullptr : hist[(p + 1) % 2];
      bag_sort_scan_kernel<<<BINS, SORT_THREADS, 0, st>>>(h, nt, totals,
                                                         h_next);
      if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
      int32_t* kout = keys[p % 2];
      int32_t* sout = slot_buf[p % 2];
#define BAG_SCATTER(F, L)                                                    \
  bag_sort_scatter_kernel<F, L><<<tiles, SORT_THREADS, 0, st>>>(            \
      kin, sprev, n, n_live, key_mask, shift, h, totals, nt, h_next, kout,  \
      sout, w_in, w_sorted)
      if (first && last) BAG_SCATTER(true, true);
      else if (first) BAG_SCATTER(true, false);
      else if (last) BAG_SCATTER(false, true);
      else BAG_SCATTER(false, false);
#undef BAG_SCATTER
      if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    }
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const int64_t want = (n + 32 * SEG_WARPS - 1) / (32 * SEG_WARPS);
    const int64_t blocks =
        std::min<int64_t>(want, static_cast<int64_t>(std::max(sms, 1)) *
                                    (2048 / SEG_THREADS));
    const int32_t* k_sorted = keys[(passes - 1) % 2];
    const int32_t* s_sorted = slot_buf[(passes - 1) % 2];
    bag_segment_kernel<<<static_cast<unsigned>(blocks), SEG_THREADS, 0, st>>>(
        k_sorted, s_sorted, w_sorted, n_live,
        static_cast<const float4*>(dout), static_cast<float4*>(dtable), S, d4,
        V);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    bag_long_run_kernel<<<static_cast<unsigned>(blocks), SEG_THREADS, 0,
                          st>>>(
        k_sorted, s_sorted, w_sorted, n_live,
        static_cast<const float4*>(dout), static_cast<float4*>(dtable), S, d4,
        V);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  if (dweights != nullptr) {
    const int64_t n_slots = n;
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

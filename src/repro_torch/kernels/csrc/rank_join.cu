// rank_join_lookup: the blocked scored equi-join probe of the rank join, as a
// split-ring probe of sorted probes.
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
// What bounds it on an H100: bytes, in principle: a trip reads each live
// ring slot once (8 bytes; 5 MB at G = 40, N = 16384) and B probes, and
// writes 5 bytes a probe, about 1 us at 3.35 TB/s. The TPU kernel
// compared every probe with every slot on the MXU; on a GPU, with no
// integer-equality tensor-core op, that is G*B*live compares (about 168 M),
// far more work than the function needs.
//
// What the design does about it:
//  - each group gets one thread block cluster of CHUNKS blocks; the live
//    prefix min(N, seen_cnt[g]) is split into CHUNKS equal chunks (a
//    multiple of 4 slots), so G*CHUNKS blocks stream the rings, with
//    16-byte loads where the rings allow; a block whose chunk is empty
//    streams nothing, and a cluster whose ring is empty leaves at once, so
//    short rings cost little;
//  - every block holds the group's B probe keys sorted, as a table in
//    shared memory. The cluster builds it together by a counting rank (a
//    key's position is the number of keys below it, ties by probe index):
//    each block ranks an eighth of the probes, eight lanes to a probe, and
//    writes each entry into every block's table through distributed shared
//    memory, so no block does the whole O(B^2) count. Duplicate keys share
//    the entry at their first position (the count of keys below), which a
//    lower-bound search finds; the ranking lane also sends each probe's
//    entry to block 0 for the answer. PAD keys stay in the table, no PAD
//    slot searches it and PAD probes are answered not found. The first ring
//    loads are issued before the table is built, so they overlap it;
//  - each live non-PAD slot first tests a 2^13-bit filter of the probe
//    keys (one hashed bit a probe, built by each block from its copy of the
//    probes). A slot whose bit is clear matches no probe; the others join a
//    queue in shared memory (a warp vote and one atomic a warp), and whole
//    warps then take the queue, each slot lower-bound searching the table
//    (ceil(log2 B) + 1 shared-memory steps, no worst case). The queue is
//    there because a search in place would hold the whole warp for one
//    lane's rare match, and at step s every lane reads an index = s - 1 mod
//    s, so a warp's reads fall on few banks. A hit adds the slot's score
//    into its entry's accumulator and counts it;
//  - each block then pushes its chunk's entries that have hits into block
//    0's shared memory, one array a chunk (the rest stay 0); after the
//    cluster's second barrier the other blocks leave, and block 0 adds each
//    probe's entry over the chunks in chunk order, 0.0f + chunk 0 + chunk 1
//    + ..., and writes its sum (0 where nothing matched) and found flag.
//    One launch, three cluster barriers (the first only proves that every
//    block has started), no scratch in device memory.
//
// Rings hold unique live keys on the engine's path, so every sum has one
// non-zero term and the result is bit-equal to the plain version and across
// runs. With duplicate live keys, found is exact and the sums may differ
// from the plain version's in the last bits (another order), and from run
// to run (shared-memory atomics within a chunk).
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int32_t PAD_KEY = -1;
constexpr unsigned FULL = 0xffffffffu;
constexpr int CHUNKS = 8;    // blocks per group: one cluster
constexpr int THREADS = 256;
constexpr int QUADS = 2;     // 4-slot groups a thread holds per pass
constexpr int PASS = QUADS * THREADS * 4;  // ring slots a block takes a pass
constexpr int FILTER_BITS = 13;  // a 2^13-bit filter of the probe keys
constexpr int FILTER_WORDS = (1 << FILTER_BITS) / 32;

__device__ __forceinline__ uint32_t filter_bit(int32_t key) {
  return (static_cast<uint32_t>(key) * 2654435761u) >> (32 - FILTER_BITS);
}

struct __align__(8) Entry {
  float sum;
  int hits;
};

struct Quad {
  int4 k;
  float4 s;
};

// Slots [base, base + 4) of a ring, PAD_KEY at and past hi.
__device__ __forceinline__ Quad load_quad(const int32_t* keys,
                                          const float* scores, int base,
                                          int hi, bool vec) {
  Quad q;
  if (vec && base + 4 <= hi) {
    q.k = __ldg(reinterpret_cast<const int4*>(keys + base));
    q.s = __ldg(reinterpret_cast<const float4*>(scores + base));
    return q;
  }
  int k[4];
  float s[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const bool in = base + j < hi;
    k[j] = in ? __ldg(keys + base + j) : PAD_KEY;
    s[j] = in ? __ldg(scores + base + j) : 0.0f;
  }
  q.k = make_int4(k[0], k[1], k[2], k[3]);
  q.s = make_float4(s[0], s[1], s[2], s[3]);
  return q;
}

// First position of tk[0, n) (sorted ascending) whose key is >= key; top is
// the largest power of two <= n (0 when n == 0).
__device__ __forceinline__ int lower_bound(const int32_t* tk, int n, int top,
                                           int32_t key) {
  int pos = 0;
  for (int step = top; step > 0; step >>= 1)
    if (pos + step <= n && tk[pos + step - 1] < key) pos += step;
  return pos;
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

__global__ void __cluster_dims__(CHUNKS, 1, 1) __launch_bounds__(THREADS)
rank_join_lookup_kernel(const int32_t* __restrict__ seen_keys,
                        const float* __restrict__ seen_scores,
                        const int32_t* __restrict__ probe_keys,
                        const int32_t* __restrict__ seen_cnt,
                        float* __restrict__ out_scores,
                        uint8_t* __restrict__ out_found, int N, int B,
                        bool vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int Bq = (B + 3) & ~3;  // B rounded up to whole 16-byte words
  // Per entry: a chunk's sum of scores and count of hits, side by side.
  Entry* acc = reinterpret_cast<Entry*>(smem);  // this block's chunk
  Entry* part = acc + Bq;  // block 0: every chunk's, pushed by its block
  int2* cand = reinterpret_cast<int2*>(part + CHUNKS * Bq);  // (key, score)
  int32_t* pk = reinterpret_cast<int32_t*>(cand + PASS);  // probes, as given
  int32_t* tk = pk + Bq;    // the sorted table
  int* entry = tk + Bq;     // block 0: each probe's table entry
  uint32_t* filter = reinterpret_cast<uint32_t*>(entry + Bq);
  int* n_cand = reinterpret_cast<int*>(filter + FILTER_WORDS);  // 2 passes

  cg::cluster_group cluster = cg::this_cluster();
  const int c = static_cast<int>(cluster.block_rank());
  const int g = blockIdx.y;
  // The probes load beside the ring count, not after it.
  const int32_t* probes = probe_keys + static_cast<int64_t>(g) * B;
  for (int b = threadIdx.x; b < B; b += THREADS) pk[b] = probes[b];
  const int live = min(N, max(seen_cnt[g], 0));
  if (live == 0) {
    // Nothing is live: the whole cluster leaves, block 0 answers.
    if (c == 0) {
      for (int b = threadIdx.x; b < B; b += THREADS) {
        const int64_t o = static_cast<int64_t>(g) * B + b;
        out_scores[o] = 0.0f;
        out_found[o] = 0;
      }
    }
    return;
  }
  // Every block of the cluster has started once this barrier completes;
  // only then may a block write another's shared memory.
  cluster_arrive_relaxed();
  const int chunk = ((live + CHUNKS - 1) / CHUNKS + 3) & ~3;
  const int lo = min(live, c * chunk);
  const int hi = min(live, lo + chunk);
  const int32_t* ring_k = seen_keys + static_cast<int64_t>(g) * N;
  const float* ring_s = seen_scores + static_cast<int64_t>(g) * N;

  // This pass's ring slots first: the loads fly while the table is built.
  Quad q[QUADS];
#pragma unroll
  for (int j = 0; j < QUADS; ++j)
    q[j] = load_quad(ring_k, ring_s, lo + (j * THREADS + threadIdx.x) * 4,
                     hi, vec);
  for (int b = threadIdx.x; b < Bq; b += THREADS) {
    if (b >= B) pk[b] = 0;  // never counted: see the rank below
    acc[b] = Entry{0.0f, 0};
  }
  if (c == 0)
    for (int i = threadIdx.x; i < CHUNKS * Bq; i += THREADS)
      part[i] = Entry{0.0f, 0};
  for (int w = threadIdx.x; w < FILTER_WORDS; w += THREADS) filter[w] = 0;
  if (threadIdx.x < 2) n_cand[threadIdx.x] = 0;
  __syncthreads();
  // A slot whose key has no bit here matches no probe and is not searched.
  for (int b = threadIdx.x; b < B; b += THREADS) {
    const uint32_t bit = filter_bit(pk[b]);
    atomicOr(filter + (bit >> 5), 1u << (bit & 31));
  }
  cluster_wait();

  // The table, ranked by the whole cluster: block c ranks probes c, c +
  // CHUNKS, ...; CHUNKS neighbouring lanes share a probe, each counting the
  // keys before it in its share of pk, and lane j of the group writes the
  // entry into block j's table.
  constexpr int PER_PASS = THREADS / CHUNKS * CHUNKS;  // probes per pass
  const int share = threadIdx.x % CHUNKS;
  const int4* pk4 = reinterpret_cast<const int4*>(pk);
  for (int b0 = 0; b0 < B; b0 += PER_PASS) {
    const int b = b0 + threadIdx.x / CHUNKS * CHUNKS + c;
    const int32_t key = b < B ? pk[b] : 0;
    int below = 0, before = 0;  // keys < key; keys == key at lower b
    if (b < B) {
#pragma unroll 4
      for (int w = share; w < Bq / 4; w += CHUNKS) {
        const int4 o = pk4[w];
        const int i = 4 * w;
        below += (o.x < key) + (i + 1 < B && o.y < key) +
                 (i + 2 < B && o.z < key) + (i + 3 < B && o.w < key);
        before += (o.x == key && i < b) + (o.y == key && i + 1 < b) +
                  (o.z == key && i + 2 < b) + (o.w == key && i + 3 < b);
      }
    }
#pragma unroll
    for (int m = 1; m < CHUNKS; m <<= 1) {
      below += __shfl_xor_sync(FULL, below, m);
      before += __shfl_xor_sync(FULL, before, m);
    }
    if (b < B) {
      *cluster.map_shared_rank(tk + below + before, share) = key;
      // A key's entry is its first place in the table, where a lower-bound
      // search from a ring slot lands.
      if (share == 0) *cluster.map_shared_rank(entry + b, 0) = below;
    }
  }
  cluster.sync();  // every block's table is complete

  int top = 1;  // the largest power of two <= B
  while (top * 2 <= B) top *= 2;
  const int lane = threadIdx.x & 31;
  for (int base = lo, pass = 0; base < hi; ++pass) {
    // The slots that pass the filter join a queue, a warp at a time ...
    int* count = n_cand + (pass & 1);
#pragma unroll
    for (int j = 0; j < QUADS; ++j) {
      const int32_t k[4] = {q[j].k.x, q[j].k.y, q[j].k.z, q[j].k.w};
      const float v[4] = {q[j].s.x, q[j].s.y, q[j].s.z, q[j].s.w};
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const uint32_t bit = filter_bit(k[m]);
        const bool in = k[m] != PAD_KEY &&
                        (filter[bit >> 5] >> (bit & 31) & 1u);
        const unsigned mask = __ballot_sync(FULL, in);
        if (!mask) continue;
        int at = 0;
        if (lane == 0) at = atomicAdd(count, __popc(mask));
        at = __shfl_sync(FULL, at, 0) + __popc(mask & ((1u << lane) - 1u));
        if (in) cand[at] = make_int2(k[m], __float_as_int(v[m]));
      }
    }
    __syncthreads();
    // ... and whole warps search the queue.
    const int n = *count;
    for (int i = threadIdx.x; i < n; i += THREADS) {
      const int2 kv = cand[i];
      const int e = lower_bound(tk, B, top, kv.x);
      if (e < B && tk[e] == kv.x) {
        atomicAdd(&acc[e].sum, __int_as_float(kv.y));
        atomicAdd(&acc[e].hits, 1);
      }
    }
    if (threadIdx.x == 0) n_cand[(pass + 1) & 1] = 0;
    __syncthreads();
    base += PASS;
    if (base >= hi) break;
#pragma unroll
    for (int j = 0; j < QUADS; ++j)
      q[j] = load_quad(ring_k, ring_s, base + (j * THREADS + threadIdx.x) * 4,
                       hi, vec);
  }
  // Push this chunk's hits to block 0; the rest of its part stays 0.
  for (int e = threadIdx.x; e < B; e += THREADS)
    if (acc[e].hits) *cluster.map_shared_rank(part + c * Bq + e, 0) = acc[e];
  cluster.sync();  // every chunk's accumulators are with block 0
  if (c != 0) return;

  for (int b = threadIdx.x; b < B; b += THREADS) {
    const int32_t key = pk[b];
    float sum = 0.0f;
    int hits = 0;
    if (key != PAD_KEY) {
      const int e = entry[b];
#pragma unroll
      for (int r = 0; r < CHUNKS; ++r) {  // in chunk order
        sum += part[r * Bq + e].sum;
        hits += part[r * Bq + e].hits;
      }
    }
    const int64_t o = static_cast<int64_t>(g) * B + b;
    out_scores[o] = hits > 0 ? sum : 0.0f;
    out_found[o] = hits > 0 ? 1 : 0;
  }
}

}  // namespace

extern "C" int rank_join_lookup(const void* seen_keys, const void* seen_scores,
                                const void* probe_keys, const void* seen_cnt,
                                void* out_scores, void* out_found, int G,
                                int N, int B, void* stream) {
  if (G <= 0 || B <= 0) return 0;
  const size_t Bq = static_cast<size_t>((B + 3) & ~3);
  const size_t smem = Bq * (1 + CHUNKS) * sizeof(Entry) + PASS * sizeof(int2) +
                      Bq * 3 * sizeof(int32_t) +
                      FILTER_WORDS * sizeof(uint32_t) + 2 * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        rank_join_lookup_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // 16-byte ring loads need 16-byte aligned rows.
  const bool vec = N % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(seen_keys) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(seen_scores) % 16 == 0;
  rank_join_lookup_kernel<<<dim3(CHUNKS, G), THREADS, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(seen_keys),
      static_cast<const float*>(seen_scores),
      static_cast<const int32_t*>(probe_keys),
      static_cast<const int32_t*>(seen_cnt), static_cast<float*>(out_scores),
      static_cast<uint8_t*>(out_found), N, B, vec);
  return static_cast<int>(cudaGetLastError());
}

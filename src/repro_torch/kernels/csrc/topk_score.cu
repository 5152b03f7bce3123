// topk_score_pruned: Spec-QP speculative top-k retrieval scoring.
//
// Replaces the TPU kernel repro/kernels/topk_score.py:topk_score_pruned
// (body _score_kernel, sorting with repro/kernels/sortnet.py:
// bitonic_topk_desc).
//
// What it computes, for one query q (D,) against cands (N, D) cut into
// tiles of `tile` rows and visited in order: when bound[j] > the running
// k-th score, score tile j (dot products in f32), merge its scores into the
// running top-k and count the tile; otherwise skip it. The merge orders by
// (score desc, index asc). Buffered entries come from earlier tiles and so
// carry lower indices than the tile's, and the empty slots carry -1, so
// that order is exactly lax.top_k's over [buffer, tile], the order of
// repro/kernels/ref.py:topk_score_pruned_ref. The TPU kernel's bitonic
// network is not stable; this one follows the reference on ties.
//
// What bounds it on an H100: bytes. A scored tile is tile * D * 4 bytes
// (512 KB at the retrieval path's 512 x 256), each read once, against
// 2 * D flops per row; streaming them takes every SM. Which tiles count
// depends on the running k-th before tile j, kth_j, but kth_j never
// decreases as j grows. The design is a persistent kernel built on that:
//  - every block but block 0 claims tiles in order from an atomic ticket
//    and reads a tile only when its bound beats the k-th that block 0 last
//    published. That k-th is some kth_i with i <= j, so a tile skipped here
//    is skipped in order too, whatever the bounds. A read tile's dots
//    (one warp a few rows at a time, lanes over D, all 16-byte loads issued
//    before the FMAs) above the published k-th are sorted by (score desc,
//    index asc) with sortnet.cuh's network; the first min(k, tile) go to the
//    tile's list in a workspace, then the tile's flag is released. An entry
//    outside that list cannot enter the top-k: a later equal score loses on
//    index.
//  - block 0 replays the sequential loop in tile order over the flags: a
//    read tile counts when bound > kth, and its list is merged into the
//    top-k buffer only then, and only when its first entry beats the k-th.
//    A tile read speculatively that fails the test is neither counted nor
//    merged, so unsound bounds give the sequential answer too. Runs of
//    tiles are merged in one batch where that provably gives the same
//    buffer and count (see replay()). After each merge it publishes the
//    new k-th. When the next tile is neither ready nor claimed, block 0
//    scores it itself: it waits only on tiles that running blocks have
//    claimed, and those never wait, so the grid may exceed what is
//    resident.
// A tile's dots come from the same code whichever block reads it, so two
// runs give equal bits. The wrapper allocates the workspace; the launcher
// zeroes its head (ticket, published k-th, flags) on the stream each call.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <algorithm>
#include <climits>

#include "sortnet.cuh"

namespace {

// One block of 512 threads an SM: block 0, the replay, has its SM to
// itself.
constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
// 16-byte loads each thread has in flight while a warp scores ROWS rows:
// 64 KB an SM, enough to stream at the card's rate; more only lengthens
// the queues that the replay's own loads wait in.
constexpr int LOADS = 8;
// A tile's flag: 0 undecided, SKIPPED not read, SCORED + m read, with m
// entries in its list; the high 32 bits hold the list's first score.
constexpr int SKIPPED = 1;
constexpr int SCORED = 2;
// A list longer than this has its entry at PROBE read with its flag: at or
// below the k-th, only the first PROBE entries can still enter.
constexpr int PROBE = 15;
// Fewest lists the replay merges as one batch: a batch costs a radix select
// and a sort of about k slots, a list alone one bitonic merge.
constexpr int BATCH_MIN = 4;
// The published k-th is stored XOR these bits, so zeroed memory reads -inf.
constexpr unsigned NEG_INF_BITS = 0xff800000u;

// Head of the workspace, zeroed before each launch; the flags follow it.
struct Ctrl {
  int ticket;      // next tile to claim
  unsigned kth;    // last k-th block 0 published, XOR NEG_INF_BITS
  int tiles_read;  // tiles read, written by block 0 at the end
  int pad;         // keeps the 64-bit flags that follow aligned
};

struct Args {
  const float4* query;
  const float4* cands;
  const float* bounds;
  float* out_s;
  int32_t* out_i;
  int32_t* out_cnt;
  Ctrl* ctrl;
  unsigned long long* flags;
  float* list_s;  // n_tiles lists of mk (score, index) pairs
  int* list_i;
  int n_tiles, tile, d4, k, mk, tile_pow2, slots;
};

__device__ __forceinline__ unsigned long long ld_acquire(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned long long* p,
                                           unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long flag_of(int m, float top) {
  return (static_cast<unsigned long long>(__float_as_uint(top)) << 32) |
         static_cast<unsigned>(SCORED + m);
}

__device__ __forceinline__ unsigned ld_relaxed(const void* p) {
  unsigned v;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ float published_kth(const Ctrl* c) {
  return __uint_as_float(ld_relaxed(&c->kth) ^ NEG_INF_BITS);
}

__device__ __forceinline__ void publish_kth(Ctrl* c, float kth) {
  asm volatile("st.relaxed.gpu.global.u32 [%0], %1;"
               :: "l"(&c->kth), "r"(__float_as_uint(kth) ^ NEG_INF_BITS)
               : "memory");
}

// Tile j's dots into s[0, tile), their row indices into p, pads (-inf,
// INT_MAX) up to tile_pow2. Every thread calls it; it ends in a barrier.
template <int VPL>
__device__ void score_tile(const Args& a, const float4 (&qv)[VPL], int j,
                           float* s, int* p) {
  constexpr int ROWS = LOADS / VPL;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const int64_t row0 = static_cast<int64_t>(j) * a.tile;
  for (int r0 = warp * ROWS; r0 < a.tile; r0 += WARPS * ROWS) {
    float4 c[ROWS][VPL];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
#pragma unroll
      for (int v = 0; v < VPL; ++v) {
        const int col = lane + 32 * v;
        c[r][v] = r0 + r < a.tile && col < a.d4
                      ? a.cands[(row0 + r0 + r) * a.d4 + col]
                      : zero;
      }
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      float acc = 0.0f;
#pragma unroll
      for (int v = 0; v < VPL; ++v) {
        acc += c[r][v].x * qv[v].x + c[r][v].y * qv[v].y +
               c[r][v].z * qv[v].z + c[r][v].w * qv[v].w;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      }
      if (lane == 0 && r0 + r < a.tile) {
        s[r0 + r] = acc;
        p[r0 + r] = static_cast<int>(row0 + r0 + r);
      }
    }
  }
  for (int i = a.tile + threadIdx.x; i < a.tile_pow2; i += THREADS) {
    s[i] = -CUDART_INF_F;
    p[i] = INT_MAX;
  }
  __syncthreads();
}

// Keeps tile j's dots above kth, sorts them, writes the first min(k, tile)
// to its list and releases its flag. *cnt is 0 on entry.
__device__ void publish_tile(const Args& a, int j, float kth, float* s,
                             int* p, int* cnt) {
  int mine = 0;
  for (int i = threadIdx.x; i < a.tile; i += THREADS) {
    if (s[i] > kth) {
      ++mine;
    } else {
      s[i] = -CUDART_INF_F;
      p[i] = INT_MAX;
    }
  }
  if (mine) atomicAdd(cnt, mine);
  __syncthreads();
  const int m = min(*cnt, a.mk);
  if (m > 0) {
    bitonic_sort_desc(s, p, a.tile_pow2);
    float* ls = a.list_s + static_cast<int64_t>(j) * a.mk;
    int* li = a.list_i + static_cast<int64_t>(j) * a.mk;
    for (int i = threadIdx.x; i < m; i += THREADS) {
      ls[i] = s[i];
      li[i] = p[i];
    }
    __threadfence();
  }
  __syncthreads();
  if (threadIdx.x == 0) st_release(a.flags + j, flag_of(m, s[0]));
}

// Every block but 0: claim tiles until none is left.
template <int VPL>
__device__ void stream_tiles(const Args& a, const float4 (&qv)[VPL],
                             float* s, int* p) {
  __shared__ int s_j, s_run, s_cnt;
  __shared__ float s_kth;
  for (;;) {
    if (threadIdx.x == 0) {
      const int j = atomicAdd(&a.ctrl->ticket, 1);
      int run = 0;
      if (j < a.n_tiles) {
        run = a.bounds[j] > published_kth(a.ctrl);
        if (!run) st_release(a.flags + j, SKIPPED);
      }
      s_j = j;
      s_run = run;
      s_cnt = 0;
    }
    __syncthreads();
    const int j = s_j;
    if (j >= a.n_tiles) return;
    if (s_run) {
      score_tile<VPL>(a, qv, j, s, p);
      // A fresher k-th than the decision's filters more of the dots.
      if (threadIdx.x == 0) s_kth = published_kth(a.ctrl);
      __syncthreads();
      publish_tile(a, j, s_kth, s, p, &s_cnt);
    }
    __syncthreads();
  }
}

// Merges tile j's list of m entries into the top-k buffer s[0, k): the
// buffer (descending), pads, then the list reversed form a bitonic
// sequence of n = 2^ceil(log2(k + m)) slots, which log2(n) half-cleaning
// sweeps sort. Ends in a barrier.
__device__ void merge_list(const Args& a, int j, int m, float* s, int* p) {
  int n = 2;
  while (n < a.k + m) n <<= 1;
  const float* ls = a.list_s + static_cast<int64_t>(j) * a.mk;
  const int* li = a.list_i + static_cast<int64_t>(j) * a.mk;
  for (int t = threadIdx.x; t < m; t += THREADS) {
    s[n - 1 - t] = __ldcg(ls + t);
    p[n - 1 - t] = __ldcg(li + t);
  }
  for (int t = a.k + threadIdx.x; t < n - m; t += THREADS) {
    s[t] = -CUDART_INF_F;
    p[t] = INT_MAX;
  }
  __syncthreads();
  for (int h = n >> 1; h > 0; h >>= 1) {
    for (int t = threadIdx.x; t < (n >> 1); t += THREADS) {
      const int i = ((t & ~(h - 1)) << 1) | (t & (h - 1));
      const int l = i + h;
      const float si = s[i], sl = s[l];
      const int pi = p[i], pl = p[l];
      if (sortnet_before(sl, pl, si, pi)) {
        s[i] = sl;
        s[l] = si;
        p[i] = pl;
        p[l] = pi;
      }
    }
    __syncthreads();
  }
}

// The replay's shared state for one window of tiles and one batch.
struct Window {
  int flag[THREADS];
  int live[THREADS];  // list entries that may beat the k-th, at most
  float bound[THREADS], top[THREADS];
  int cb[THREADS];   // window places of the batch's tiles to merge
  int off[THREADS];  // where each one's list starts among the batch's
  int hist[256];  // radix select's digit counts
  int ready, at, B, C, n, end, help, cnt, digit, above;
  bool sure;
  float minb;
  // The merged k-th of the window's last batch that did not hold, and
  // where that batch ended: no batch before then can merge to a larger one.
  float fail_kth;
  int fail_end;
};

// Warp 0: the batch from `at`, the next tile to merge under the current
// k-th `kth`. Following tiles join while the batch's lists hold at most
// `room` entries: a read tile whose bound beats kth counts, and merges when
// its first entry does too; the batch ends after its last list. With
// `sure`, a list joins only if C, the entries of the batch's lists up to
// it, is below k and every tile after `at` that counts up to it has bound >
// buf[k - 1 - C]: at most C list entries reach the merged top-k, so its
// k-th is no larger, and the batch holds. Otherwise a tile that counts
// joins only if its bound is above `limit`. Sets cb, off, B, C (the lists'
// entries), n (the tiles after `at` that count), minb (their least bound)
// and end.
__device__ void plan_batch(Window& w, const float* buf, int k, int at,
                           int ready, float kth, float limit, bool sure,
                           int room) {
  const int lane = threadIdx.x & 31;
  int B = 1, n = 0, end = at + 1, pend_n = 0, C = w.live[at];
  float minb = CUDART_INF_F, pend_minb = CUDART_INF_F;
  if (lane == 0) {
    w.cb[0] = at;
    w.off[0] = 0;
  }
  for (int base = at + 1; base < ready && C < room; base += 32) {
    const int t = base + lane;
    const int f = t < ready ? w.flag[t] : 0;
    const bool counted = f >= SCORED && w.bound[t] > kth;
    const bool merge = counted && f > SCORED && w.top[t] > kth;
    const int m = merge ? w.live[t] : 0;
    // Inclusive prefixes over the lanes: list entries, least bound.
    int c = m;
    float lb = counted ? w.bound[t] : CUDART_INF_F;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, c, off);
      const float z = __shfl_up_sync(0xffffffffu, lb, off);
      if (lane >= off) {
        c += y;
        lb = fminf(lb, z);
      }
    }
    const int entries = C + c;
    const float least = fminf(fminf(minb, pend_minb), lb);
    const bool ok =
        sure ? !merge ||
                   (entries <= room && entries < k &&
                    least > buf[k - 1 - entries])
             : !(merge && entries > room) &&
                   !(counted && !(w.bound[t] > limit));
    const unsigned oks = __ballot_sync(0xffffffffu, ok);
    // Lanes before the first that may not join.
    const int stop = ~oks ? __ffs(~oks) - 1 : 32;
    const unsigned in = stop == 32 ? 0xffffffffu : (1u << stop) - 1u;
    const unsigned mbits = __ballot_sync(0xffffffffu, merge) & in;
    const unsigned cbits = __ballot_sync(0xffffffffu, counted) & in;
    if ((mbits >> lane) & 1u) {
      const int b = B + __popc(mbits & ((1u << lane) - 1u));
      w.cb[b] = t;
      w.off[b] = entries - m;
    }
    const int last = mbits ? 31 - __clz(mbits) : -1;
    const unsigned upto = last < 0     ? 0u
                          : last == 31 ? 0xffffffffu
                                       : (2u << last) - 1u;
    const bool mine = (cbits >> lane) & 1u;
    float before = mine && lane <= last ? w.bound[t] : CUDART_INF_F;
    float after = mine && lane > last ? w.bound[t] : CUDART_INF_F;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      before = fminf(before, __shfl_xor_sync(0xffffffffu, before, off));
      after = fminf(after, __shfl_xor_sync(0xffffffffu, after, off));
    }
    if (mbits) {
      n += pend_n + __popc(cbits & upto);
      minb = fminf(minb, fminf(pend_minb, before));
      pend_n = __popc(cbits & ~upto);
      pend_minb = after;
      B += __popc(mbits);
      C = __shfl_sync(0xffffffffu, entries, last);
      end = base + last + 1;
    } else {
      pend_n += __popc(cbits);
      pend_minb = fminf(pend_minb, after);
    }
    if (stop < 32) break;
  }
  if (lane == 0) {
    w.at = at;
    w.B = B;
    w.C = C;
    w.n = n;
    w.end = end;
    w.minb = minb;
    w.sure = sure;
  }
}

// Order-preserving unsigned key of a float score; -0 and +0 share one, as
// they compare equal.
__device__ __forceinline__ unsigned score_key(float x) {
  const unsigned u = __float_as_uint(x + 0.0f);
  return (u & 0x80000000u) ? ~u : u | 0x80000000u;
}

// Merges the batch's B lists with the top-k buffer s[0, k). Shared memory
// behind the buffer: the lists staged (`room` slots), then the gathered
// entries (room + k slots, a power of two). All list loads go out at once:
// one round trip to L2, which the streaming blocks keep busy. A radix
// select over the buffer and the staged entries above kth (four passes of
// 8 bits) finds the k-th largest score x; the entries scoring >= x, k and
// any ties at x, are gathered and sorted (sortnet.cuh's order), and the
// merged buffer is the first k of them: returned. Ends in a barrier.
__device__ const float* merge_batch(const Args& a, Window& w, int next,
                                    float kth, float* s, int* p, int room) {
  constexpr int UNROLL = 16;
  const int k = a.k, B = w.B, total = w.C;
  float* st_s = s + k;
  int* st_p = p + k;
  float* g_s = st_s + room;
  int* g_p = st_p + room;
  for (int base = 0; base < total; base += THREADS * UNROLL) {
    float v[UNROLL];
    int id[UNROLL];
#pragma unroll
    for (int r = 0; r < UNROLL; ++r) {
      const int f = base + r * THREADS + threadIdx.x;
      if (f < total) {
        int lo = 0, hi = B - 1;  // the list holding entry f
        while (lo < hi) {
          const int mid = (lo + hi + 1) >> 1;
          if (w.off[mid] <= f) {
            lo = mid;
          } else {
            hi = mid - 1;
          }
        }
        const int64_t at = static_cast<int64_t>(next + w.cb[lo]) * a.mk +
                           (f - w.off[lo]);
        v[r] = __ldcg(a.list_s + at);
        id[r] = __ldcg(a.list_i + at);
      }
    }
#pragma unroll
    for (int r = 0; r < UNROLL; ++r) {
      const int f = base + r * THREADS + threadIdx.x;
      if (f < total) {
        st_s[f] = v[r] > kth ? v[r] : -CUDART_INF_F;
        st_p[f] = id[r];
      }
    }
  }
  // Radix select: `want` counts down the rank of x among the candidates
  // that share the key bits fixed so far.
  unsigned prefix = 0, fixed = 0;
  int want = k;
  for (int shift = 24; shift >= 0; shift -= 8) {
    if (threadIdx.x < 256) w.hist[threadIdx.x] = 0;
    __syncthreads();
    // Most candidates share the high digits: one atomic per warp and digit.
    for (int base = threadIdx.x & ~31; base < k + total; base += THREADS) {
      const int i = base + (threadIdx.x & 31);
      const float x = i < k ? s[i] : i < k + total ? st_s[i - k] : kth;
      const unsigned key = score_key(x);
      const int digit = (i < k || x > kth) && (key & fixed) == prefix
                            ? static_cast<int>((key >> shift) & 0xffu)
                            : -1;
      const unsigned peers = __match_any_sync(0xffffffffu, digit);
      if (digit >= 0 && (threadIdx.x & 31) == __ffs(peers) - 1) {
        atomicAdd(&w.hist[digit], __popc(peers));
      }
    }
    __syncthreads();
    if (threadIdx.x < 32) {
      // Lane l holds digits 255 - 8l down to 248 - 8l.
      const int lane = threadIdx.x;
      int tot = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) tot += w.hist[255 - 8 * lane - j];
      int above = tot;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, above, off);
        if (lane >= off) above += y;
      }
      above -= tot;  // candidates in the digits above this lane's
      if (above < want && want <= above + tot) {
        int d = 255 - 8 * lane;
        while (above + w.hist[d] < want) above += w.hist[d--];
        w.digit = d;
        w.above = above;
      }
    }
    __syncthreads();
    prefix |= static_cast<unsigned>(w.digit) << shift;
    fixed |= 0xffu << shift;
    want -= w.above;
    __syncthreads();
  }
  if (threadIdx.x == 0) w.cnt = 0;
  __syncthreads();
  for (int i = threadIdx.x; i < k + total; i += THREADS) {
    const float x = i < k ? s[i] : st_s[i - k];
    if ((i < k || x > kth) && score_key(x) >= prefix) {
      const int at = atomicAdd(&w.cnt, 1);
      g_s[at] = x;
      g_p[at] = i < k ? p[i] : st_p[i - k];
    }
  }
  __syncthreads();
  const int got = w.cnt;
  int n = 2;
  while (n < got) n <<= 1;
  for (int i = got + threadIdx.x; i < n; i += THREADS) {
    g_s[i] = -CUDART_INF_F;
    g_p[i] = INT_MAX;
  }
  __syncthreads();
  bitonic_sort_desc(g_s, g_p, n);
  return g_s;
}

// Block 0: the in-order replay. The top-k buffer is s[0, k); a tile it
// scores itself goes to s[k, k + tile_pow2), a batch to s[k, slots).
//
// Between merges the k-th is constant, so warp 0 counts 32 tiles a ballot
// up to the next tile to merge, `at`. The following tiles join one batch
// (plan_batch): a tile whose bound is at or below the current k-th is
// neither counted nor merged (the k-th only grows); the others count, and
// merge when their first entry beats the k-th. The batch holds if each of
// its tiles after `at` that counts has bound > the merged k-th, the largest
// k-th any of them can meet in order. Where `at`'s list is shorter than k
// the batch is planned so that it must hold (plan_batch's `sure`).
// Otherwise, if it does not hold, it is planned again up to its first tile
// with bound <= the merged k-th: the shorter batch's k-th is no larger, so
// it holds. Every batch planned later inside the failed one's tiles merges
// a part of what it merged, so that k-th bounds it too, and it is planned
// with that limit and holds. A batch of fewer than BATCH_MIN lists is not merged at once:
// `at` alone is merged by merge_list.
template <int VPL>
__device__ void replay(const Args& a, const float4 (&qv)[VPL], float* s,
                       int* p) {
  __shared__ Window w;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  // Batch layout behind the buffer (see merge_batch): `room` staged list
  // entries, then room + k gathered slots, a power of two.
  int gather = 1;
  while (gather * 2 <= a.slots / 2) gather *= 2;
  const int room = gather - a.k;
  for (int i = threadIdx.x; i < a.k; i += THREADS) {
    s[i] = -CUDART_INF_F;
    p[i] = -1;
  }
  int count = 0;  // kept by warp 0
  int read = 0;
  int next = 0;   // first tile not replayed
  __syncthreads();
  while (next < a.n_tiles) {
    // The flags and bounds of the next THREADS tiles; `ready` is how many
    // lead them decided.
    if (threadIdx.x == 0) {
      w.ready = THREADS;
      w.fail_end = 0;
    }
    __syncthreads();
    const int t = next + threadIdx.x;
    const unsigned long long fw = t < a.n_tiles ? ld_acquire(a.flags + t)
                                                : 0ull;
    const float bound = t < a.n_tiles ? a.bounds[t] : 0.0f;
    const int f = static_cast<int>(fw & 0xffffffffu);
    if (f == 0) atomicMin(&w.ready, static_cast<int>(threadIdx.x));
    w.flag[threadIdx.x] = f;
    w.bound[threadIdx.x] = bound;
    w.top[threadIdx.x] = __uint_as_float(static_cast<unsigned>(fw >> 32));
    int live = f - SCORED;
    if (live > PROBE && !(__ldcg(a.list_s + static_cast<int64_t>(t) * a.mk +
                                 PROBE) > s[a.k - 1])) {
      live = PROBE;
    }
    w.live[threadIdx.x] = live;
    __syncthreads();
    const int ready = w.ready;
    if (ready == 0) {
      if (threadIdx.x == 0) {
        w.help = -1;
        w.cnt = 0;
        if (static_cast<int>(ld_relaxed(&a.ctrl->ticket)) <= next) {
          w.help = atomicAdd(&a.ctrl->ticket, 1);
        } else {
          __nanosleep(200);
        }
      }
      __syncthreads();
      const int j = w.help;
      if (j >= 0 && j < a.n_tiles) {
        // The buffer holds kth_next exactly, and j >= next.
        const float kth = s[a.k - 1];
        if (a.bounds[j] > kth) {
          score_tile<VPL>(a, qv, j, s + a.k, p + a.k);
          publish_tile(a, j, kth, s + a.k, p + a.k, &w.cnt);
        } else if (threadIdx.x == 0) {
          st_release(a.flags + j, SKIPPED);
        }
      }
      continue;
    }
    for (int pos = 0; pos < ready;) {
      const float kth = s[a.k - 1];
      if (warp == 0) {
        int at = ready;
        for (int base = pos; base < ready; base += 32) {
          const int i = base + lane;
          const int fi = i < ready ? w.flag[i] : 0;
          const bool counted = fi >= SCORED && w.bound[i] > kth;
          const bool merge = counted && fi > SCORED && w.top[i] > kth;
          const unsigned cbits = __ballot_sync(0xffffffffu, counted);
          const unsigned mbits = __ballot_sync(0xffffffffu, merge);
          if (mbits) {
            const int first = __ffs(mbits) - 1;
            count += __popc(cbits & ((1u << first) - 1u)) + 1;
            at = base + first;
            break;
          }
          count += __popc(cbits);
        }
        if (at < w.fail_end) {
          plan_batch(w, s, a.k, at, w.fail_end, kth, w.fail_kth, false,
                     room);
        } else if (at < ready) {
          plan_batch(w, s, a.k, at, ready, kth, kth, w.live[at] < a.k,
                     room);
        } else if (lane == 0) {
          w.at = ready;
        }
      }
      __syncthreads();
      const int at = w.at;
      if (at == ready) break;
      bool held = false;
      if (w.B >= BATCH_MIN) {
        const float* merged = merge_batch(a, w, next, kth, s, p, room);
        if (!w.sure && !(w.minb > merged[a.k - 1])) {
          const float limit = merged[a.k - 1];
          const int failed_end = w.end;
          __syncthreads();
          if (warp == 0) {
            plan_batch(w, s, a.k, at, ready, kth, limit, false, room);
            if (lane == 0) {
              w.fail_kth = limit;
              w.fail_end = failed_end;
            }
          }
          __syncthreads();
          if (w.B >= BATCH_MIN) {
            merged = merge_batch(a, w, next, kth, s, p, room);
          }
        }
        held = w.B >= BATCH_MIN;
        if (held) {
          const int* merged_p = p + (merged - s);
          for (int i = threadIdx.x; i < a.k; i += THREADS) {
            s[i] = merged[i];
            p[i] = merged_p[i];
          }
          if (warp == 0) count += w.n;
          pos = w.end;
        }
        __syncthreads();
      }
      if (!held) {
        merge_list(a, next + at, w.live[at], s, p);
        pos = at + 1;
      }
      if (threadIdx.x == 0) publish_kth(a.ctrl, s[a.k - 1]);
    }
    read += __syncthreads_count(static_cast<int>(threadIdx.x) < ready &&
                                w.flag[threadIdx.x] >= SCORED);
    next += ready;
  }
  for (int i = threadIdx.x; i < a.k; i += THREADS) {
    a.out_s[i] = s[i];
    a.out_i[i] = p[i];
  }
  if (threadIdx.x == 0) {
    *a.out_cnt = count;
    a.ctrl->tiles_read = read;
  }
}

// VPL: float4 vectors per lane per row (D <= 128 * VPL, and VPL is 1 or 2,
// so D <= 256, the retrieval path's width); each warp scores
// LOADS / VPL rows at a time and issues all their loads before any FMA.
template <int VPL>
__global__ void __launch_bounds__(THREADS, 1) topk_score_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* s = reinterpret_cast<float*>(smem);
  int* p = reinterpret_cast<int*>(s + a.slots);
  const int lane = threadIdx.x & 31;
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  float4 qv[VPL];
#pragma unroll
  for (int v = 0; v < VPL; ++v) {
    qv[v] = lane + 32 * v < a.d4 ? a.query[lane + 32 * v] : zero;
  }
  if (blockIdx.x == 0) {
    replay<VPL>(a, qv, s, p);
  } else {
    stream_tiles<VPL>(a, qv, s, p);
  }
}

template <int VPL>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(a.slots) * (sizeof(float) +
                                                      sizeof(int));
  cudaError_t err = cudaFuncSetAttribute(
      topk_score_kernel<VPL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, topk_score_kernel<VPL>, THREADS, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  // As many blocks as are resident at once, and no more than the tiles
  // need (block 0 replays).
  const int grid = static_cast<int>(std::min<int64_t>(
      static_cast<int64_t>(per_sm) * sms,
      static_cast<int64_t>(a.n_tiles) + 1));
  err = cudaMemsetAsync(a.ctrl, 0,
                        sizeof(Ctrl) + static_cast<size_t>(a.n_tiles) *
                                           sizeof(unsigned long long),
                        stream);
  if (err != cudaSuccess) return err;
  topk_score_kernel<VPL><<<grid, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// D must be a multiple of 4 and at most 256; `slots` is the shared-memory
// slot count the wrapper checked. The workspace holds the Ctrl head, then
// n_tiles flags, then n_tiles * min(k, tile) scores and as many indices.
extern "C" int topk_score_pruned(const void* query, const void* cands,
                                 const void* bounds, void* out_s, void* out_i,
                                 void* out_cnt, void* workspace, int n_tiles,
                                 int tile, int D, int k, int slots,
                                 void* stream) {
  Args a;
  a.query = static_cast<const float4*>(query);
  a.cands = static_cast<const float4*>(cands);
  a.bounds = static_cast<const float*>(bounds);
  a.out_s = static_cast<float*>(out_s);
  a.out_i = static_cast<int32_t*>(out_i);
  a.out_cnt = static_cast<int32_t*>(out_cnt);
  a.ctrl = static_cast<Ctrl*>(workspace);
  a.flags = reinterpret_cast<unsigned long long*>(a.ctrl + 1);
  a.mk = std::min(k, tile);
  a.list_s = reinterpret_cast<float*>(a.flags + n_tiles);
  a.list_i = reinterpret_cast<int*>(a.list_s +
                                    static_cast<int64_t>(n_tiles) * a.mk);
  a.n_tiles = n_tiles;
  a.tile = tile;
  a.d4 = D / 4;
  a.k = k;
  a.tile_pow2 = 2;
  while (a.tile_pow2 < tile) a.tile_pow2 <<= 1;
  a.slots = slots;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (a.d4 <= 32) {
    err = launch<1>(a, st);
  } else if (a.d4 <= 64) {
    err = launch<2>(a, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

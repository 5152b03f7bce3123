// flash_attention_bwd: the attention backward, bf16 in and out.
//
// No TPU kernel to replace: the reference computes this backward in XLA
// under jax.custom_vjp (repro/models/attention.py:_flash_bwd). It is the
// port's own kernel behind csrc/flash_attention.cu, as
// embedding_bag_backward is behind embedding_bag.
//
// What it computes: from q (B, Hq, Sq, D), k, v (B, Hkv, Sk, D), the
// forward's o and each row's lse (natural log, f32, (B, Hq, Sq)) and do
// (like o): with query i at key position Sk - Sq + i, query head h
// reading KV head h / (Hq / Hkv), x the forward's logit and p = exp(x -
// lse) over the visible keys (the forward's mask: causal, window, keys
// < Sk),
//   delta = sum_d do * o,  ds = p * (do . v - delta) [* (1 - tanh^2)],
//   dq = scale * ds . k,   dk = scale * ds^T . q (summed over the group),
//   dv = p^T . do          (summed over the group).
// A row with no visible key contributes 0.
//
// What bounds it on an H100: operations. A visible (q, k) pair costs
// 10 * D flops a head at the least (q.k, do.v, p^T.do, ds^T.q, ds.k),
// against 989 TFLOP/s of bf16 tensor cores; the bytes (q, k, v, o, do
// read once, dq, dk, dv written once) take a sixth of that at gemma2-2b's
// layer at S = 4096. This design spends 14 * D: its dQ pass computes q.k
// and do.v again.
//
// Design: Hopper's own, after the forward (csrc/flash_attention.cu).
// Every product is a wgmma with f32 accumulators; every tile comes by TMA
// (4-D tensor maps over (D, S, H, B) built from the caller's strides,
// 128-byte swizzle, rows past S zero-filled) into an mbarrier ring kept
// full by one producer thread; a block is a producer warpgroup, whose
// registers setmaxnreg gives to two consumer warpgroups. p is recomputed
// as the forward has it, in the log2 domain (ex2.approx of cexp * s, or
// of cexp * tanh.approx(mul * s), minus lse * log2 e). Three launches on
// the caller's stream:
// 1. delta_kernel: one warp a row, writes each row's lse * log2 e and
//    delta = sum_d do * o (f32 from the bf16 o and do) into a scratch
//    stat buffer (B, Hq, 2, Sqp), Sqp = Sq rounded up to 128, zeros past
//    Sq, so that the passes bring a tile's 64 or 128 values with one
//    bulk copy each.
// 2. dkdv_kernel: a block owns BN keys of one (b, KV head) and walks the g
//    query heads and the 64-row q tiles of its keys' band (longest band
//    first across blocks). K and V stay in shared memory; Q, dO and the
//    tile's stat values come through a STAGES-deep ring. S^T = K Q^T and
//    dP^T = V dO^T (M = keys, both operands K-major); p and ds from them;
//    then dV += P^T dO and dK += dS^T Q with dO and Q MN-major, dK and dV
//    f32 in registers. D sets the split between the two consumers:
//    - D = 64 or 128, BN = 128: each consumer owns 64 keys and all of D.
//      Its S^T and dP^T fragments, rounded to bf16, are the A operands of
//      its dV and dK products as they are (registers, no shared memory,
//      no barrier between the consumers).
//    - D = 192 or 256, BN = 64: dK and dV of 64 keys x D columns are D
//      f32 a thread (192 at D = 192, and with S^T and dP^T 256, more than
//      the 240 a consumer has), so the consumers split D: consumer 0 owns
//      the 64 keys x columns 0-127, consumer 1 the rest (128 columns at
//      D = 256, 64 at D = 192). The split is by whole 64-column chunks:
//      a 96 / 96 split at D = 192 would start consumer 1's MN-major dO and
//      Q operands 64 bytes into a 128-byte swizzle row, where the wgmma
//      descriptor's start address no longer names a whole atom's row; a
//      128 / 64 split needs no such offset, at the cost of consumer 1
//      doing half of consumer 0's dK / dV products. wgmma's M of 64 then
//      splits S^T and dP^T by q columns (32 each); each consumer writes
//      its P^T and dS^T columns in bf16 to shared memory (128-byte
//      swizzle, double-buffered), the two meet at one named barrier a
//      tile, and both read the whole P^T and dS^T as the A operands of
//      their dV and dK products.
// 3. dq_kernel (route (a): a separate dQ pass): a block owns 128 q rows of
//    one (b, q head), 64 a consumer, with Q, dO and their stat values
//    resident, and walks the 64-key tiles of each consumer's band through
//    a K ring and a V ring (V released as soon as dP is computed): S = Q
//    K^T, dP = dO V^T, ds, then dQ += dS K with dS's fragments in bf16 as
//    the A operand and K MN-major. Why not FA3's one pass (dQ partials
//    added into an f32 buffer): the card's checks want two runs bit-equal,
//    so the adds would need a fixed order (a counter per q tile that
//    serialises its key tiles), and each 64 x 64 visit would read and
//    write 64 KB of f32 partials at D = 256 (8.6 GB at the global layer
//    of the checks, B 4, S 4096); route (a) pays 4 * D flops a pair
//    instead, 0.28 ms of tensor-core time there.
// No atomics: every output element is summed by one thread in a fixed
// order, so two runs are bit-equal. A tile's mask is tested once; only
// tiles that meet the band's edge or the ragged ends are masked per
// element. kernels/ref.py's flash_attention_bwd_tiles lists every
// consumer's 64 x 64 tiles in order and flash_attention_bwd_blocked
// models the arithmetic.
#include "hopper.cuh"

namespace {

constexpr int THREADS = 3 * 128;   // producer + 2 consumer warpgroups
constexpr int CONSUMER_WARPS = 8;  // arrivals on an empty barrier
constexpr int BM = 64;             // q rows of a dK/dV visit, keys of a dQ tile
constexpr int QROWS = 128;         // q rows of a dQ block
constexpr float LOG2E = 1.4426950408889634f;

// The dK/dV pass: keys a block and ring stages, by D (see the header).
template <int D>
struct KvTile;
template <>
struct KvTile<64> {
  static constexpr int BN = 128;
  static constexpr int STAGES = 4;
};
template <>
struct KvTile<128> {
  static constexpr int BN = 128;
  static constexpr int STAGES = 2;
};
template <>
struct KvTile<192> {
  static constexpr int BN = 64;
  static constexpr int STAGES = 2;
};
template <>
struct KvTile<256> {
  static constexpr int BN = 64;
  static constexpr int STAGES = 2;
};

// The dQ pass: K and V ring stages, by D (D = 256 has room for one V).
template <int D>
struct QTile;
template <>
struct QTile<64> {
  static constexpr int KS = 2, VS = 2;
};
template <>
struct QTile<128> {
  static constexpr int KS = 2, VS = 2;
};
template <>
struct QTile<192> {
  static constexpr int KS = 2, VS = 2;
};
template <>
struct QTile<256> {
  static constexpr int KS = 2, VS = 1;
};

enum { Q = 0, K, V, O, DO, DQ, DK, DV };

struct Args {
  const __nv_bfloat16 *o, *dout;
  const float* lse;
  float* stat;  // (B, Hq, 2, Sqp): lse * log2 e, then delta
  __nv_bfloat16 *dq, *dk, *dv;
  long long st[8][3];  // (batch, head, seq) element strides, by the enum
  int B, Hq, Hkv, Sq, Sk, Sqp, group, causal, window;
  float scale, mul, cexp;  // mul = scale / cap (CAP), cexp = (cap or
                           // scale) * log2 e: the forward's
};

// Shared memory of the dK/dV pass, in bytes from a 1024-aligned base. A
// tile of R rows is D / 64 column chunks of R rows x 128 bytes, as TMA's
// 128-byte swizzle lays it out: 8-row atoms of 1024 bytes.
template <int D>
struct KvLayout {
  static constexpr bool SPLIT = D >= 192;  // consumers split D
  static constexpr int BN = KvTile<D>::BN, STAGES = KvTile<D>::STAGES;
  static constexpr int CHUNKS = D / 64;
  static constexpr int K_CHUNK = BN * 128;
  static constexpr int Q_CHUNK = BM * 128;
  static constexpr int Q_TILE = CHUNKS * Q_CHUNK;
  static constexpr int PT_TILE = BM * 128;  // 64 keys x 64 q, bf16
  static constexpr int K = 0;
  static constexpr int V = K + CHUNKS * K_CHUNK;
  static constexpr int Q = V + CHUNKS * K_CHUNK;  // [STAGES]
  static constexpr int DO = Q + STAGES * Q_TILE;  // [STAGES]
  static constexpr int PT = DO + STAGES * Q_TILE;  // P^T[2], dS^T[2]
  static constexpr int STAT = PT + (SPLIT ? 4 * PT_TILE : 0);  // [STAGES]
  static constexpr int BAR = STAT + STAGES * 2 * BM * 4;  // kv, full, empty
  static constexpr int BYTES = BAR + 8 * (1 + 2 * STAGES) + 1024;
  static_assert(BYTES <= 232448, "more shared memory than a block has");
};

// Shared memory of the dQ pass.
template <int D>
struct QLayout {
  static constexpr int KS = QTile<D>::KS, VS = QTile<D>::VS;
  static constexpr int CHUNKS = D / 64;
  static constexpr int Q_CHUNK = QROWS * 128;
  static constexpr int KV_CHUNK = BM * 128;
  static constexpr int KV_TILE = CHUNKS * KV_CHUNK;
  static constexpr int Q = 0;
  static constexpr int DO = Q + CHUNKS * Q_CHUNK;
  static constexpr int K = DO + CHUNKS * Q_CHUNK;  // [KS]
  static constexpr int V = K + KS * KV_TILE;       // [VS]
  static constexpr int STAT = V + VS * KV_TILE;    // lse2[128], delta[128]
  static constexpr int BAR = STAT + 2 * QROWS * 4;  // q, k full/empty, v
  static constexpr int BYTES = BAR + 8 * (1 + 2 * KS + 2 * VS) + 1024;
  static_assert(BYTES <= 232448, "more shared memory than a block has");
};

// The recomputed p and ds of one accumulator element: s its q.k, dp its
// do.v, lse2 its row's lse in log2 units, delta its row's delta.
template <bool CAP>
__device__ __forceinline__ void p_ds(float s, float dp, float lse2,
                                     float delta, bool visible,
                                     const Args& a, float& p, float& ds) {
  float x, dcap = 1.0f;
  if (CAP) {
    const float th = tanh_fast(s * a.mul);
    x = th * a.cexp;
    dcap = 1.0f - th * th;
  } else {
    x = s * a.cexp;
  }
  p = visible ? ex2(x - lse2) : 0.0f;
  ds = p * (dp - delta) * dcap;
}

__device__ __forceinline__ bool visible(int qi, int key, const Args& a) {
  const int qpos = a.Sk - a.Sq + qi;
  return qi < a.Sq && key < a.Sk && (!a.causal || key <= qpos) &&
         (a.window <= 0 || key > qpos - a.window);
}

// Whether the 64 q rows from r0 and the 64 keys from k0 hold a pair that
// is not visible: the tile is then masked per element.
__device__ __forceinline__ bool tile_edge(int r0, int k0, const Args& a) {
  const int off = a.Sk - a.Sq;
  return r0 + BM > a.Sq || k0 + BM > a.Sk ||
         (a.causal && k0 + BM - 1 > off + r0) ||
         (a.window > 0 && k0 <= off + r0 + BM - 1 - a.window);
}

// The 64-row q tiles [lo, hi] that see any of keys [k_first, k_last].
__device__ __forceinline__ void q_band(int k_first, int k_last,
                                       const Args& a, int& lo, int& hi) {
  const int off = a.Sk - a.Sq;
  const int q_lo = a.causal ? max(0, k_first - off) : 0;
  const int q_hi = a.window > 0 ? min(a.Sq - 1, k_last + a.window - 1 - off)
                                : a.Sq - 1;
  if (k_first > k_last || q_hi < q_lo) {
    lo = 0;
    hi = -1;
  } else {
    lo = q_lo / BM;
    hi = q_hi / BM;
  }
}

// The 64-key tiles [lo, hi] that q rows [r0, r0 + 64) see.
__device__ __forceinline__ void k_band(int r0, const Args& a, int& lo,
                                       int& hi) {
  const int r1 = min(r0 + BM, a.Sq);
  const int off = a.Sk - a.Sq;
  const int k_lo = a.window > 0 ? max(0, off + r0 - a.window + 1) : 0;
  const int k_hi = a.causal ? min(a.Sk - 1, off + r1 - 1) : a.Sk - 1;
  if (r0 >= r1 || k_hi < k_lo) {
    lo = 0;
    hi = -1;
  } else {
    lo = k_lo / BM;
    hi = k_hi / BM;
  }
}

// d (64 x N) = X . Y^T over D: X (64 rows from xs) and Y (N rows from ys)
// both K-major in shared memory, their 64-column chunks XC and YC bytes
// apart; D / 16 wgmmas that step 32 bytes through each 128-byte swizzle
// row, then to the next chunk.
template <int D, int N, int XC, int YC>
__device__ __forceinline__ void gemm_nt(float (&d)[N / 2], uint32_t xs,
                                        uint32_t ys) {
  uint64_t dx = sw128_desc(xs, 16, 1024), dy = sw128_desc(ys, 16, 1024);
  asm volatile("" : "+l"(dx), "+l"(dy));
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint64_t x = dx + (((kk / 4) * XC + (kk % 4) * 32) >> 4);
    const uint64_t y = dy + (((kk / 4) * YC + (kk % 4) * 32) >> 4);
    if constexpr (N == 32)
      wgmma_ss32(d, x, y, kk > 0);
    else
      wgmma_ss64(d, x, y, kk > 0);
  }
}

// d (64 x N, N = 64, 128, 192 or 256) += A . Y over 64 rows of Y: A's k-slices
// of 16 in registers, Y (64 rows from ys) MN-major, its 64-column chunks
// YC bytes apart; 4 wgmmas, each 16 rows (two 8-row atoms, 2048 bytes).
template <int N, int YC>
__device__ __forceinline__ void gemm_rs(float (&d)[N / 2],
                                        const uint32_t (&a)[4][4],
                                        uint32_t ys) {
  uint64_t dy = sw128_desc(ys, YC, 1024);
  asm volatile("" : "+l"(dy));
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if constexpr (N == 256)
      wgmma_rs256(d, a[kk], dy + ((kk * 2048) >> 4));
    else if constexpr (N == 192)
      wgmma_rs192(d, a[kk], dy + ((kk * 2048) >> 4));
    else if constexpr (N == 128)
      wgmma_rs128(d, a[kk], dy + ((kk * 2048) >> 4));
    else
      wgmma_rs64(d, a[kk], dy + ((kk * 2048) >> 4));
  }
}

// d (64 x N, N = 64 or 128) += X . Y over 64: X (64 x 64 bf16 from xs,
// K-major, one 128-byte row a row) and Y (64 rows from ys, MN-major,
// chunks YC bytes apart) both in shared memory.
template <int N, int YC>
__device__ __forceinline__ void gemm_ss(float (&d)[N / 2], uint32_t xs,
                                        uint32_t ys) {
  uint64_t dx = sw128_desc(xs, 16, 1024), dy = sw128_desc(ys, YC, 1024);
  asm volatile("" : "+l"(dx), "+l"(dy));
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if constexpr (N == 128)
      wgmma_ss128t(d, dx + ((kk * 32) >> 4), dy + ((kk * 2048) >> 4), 1);
    else
      wgmma_ss64t(d, dx + ((kk * 32) >> 4), dy + ((kk * 2048) >> 4), 1);
  }
}

// Accumulator fragments (element i at column 8 (i / 4) + 2 (lane % 4) +
// (i & 1)) rounded to bf16: the A operand of a k-slice of 16 columns.
template <int N>
__device__ __forceinline__ void pack_a(uint32_t (&r)[N / 16][4],
                                       const float (&s)[N / 2]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      r[kk][j] = pack_bf16(s[8 * kk + 2 * j], s[8 * kk + 2 * j + 1]);
}

// Stores c (64 rows x N columns of f32 fragments, times mul) in bf16 at
// (r0, c0) of a matrix whose rows are ss elements apart, rows below nrows.
template <int N>
__device__ __forceinline__ void store_tile(const float (&c)[N / 2], float mul,
                                           __nv_bfloat16* base, long long ss,
                                           int r0, int c0, int nrows) {
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 16 * warp + lane / 4 + 8 * r;
    if (row >= nrows) continue;
    __nv_bfloat16* dst = base + row * ss + c0 + 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
      *reinterpret_cast<uint32_t*>(dst + 8 * j) =
          pack_bf16(c[4 * j + 2 * r] * mul, c[4 * j + 2 * r + 1] * mul);
  }
}

template <int D>
__global__ void delta_kernel(const Args a) {
  const long long w = (static_cast<long long>(blockIdx.x) * blockDim.x +
                       threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (w >= static_cast<long long>(a.B) * a.Hq * a.Sqp) return;
  const int i = static_cast<int>(w % a.Sqp);
  const long long bh = w / a.Sqp;
  const int h = static_cast<int>(bh % a.Hq);
  const int b = static_cast<int>(bh / a.Hq);
  float s = 0.0f, l2 = 0.0f;
  if (i < a.Sq) {
    const __nv_bfloat16* o = a.o + b * a.st[O][0] + h * a.st[O][1] +
                             i * a.st[O][2];
    const __nv_bfloat16* d = a.dout + b * a.st[DO][0] + h * a.st[DO][1] +
                             i * a.st[DO][2];
#pragma unroll
    for (int c = 2 * lane; c < D; c += 64) {
      const float2 x =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(o + c));
      const float2 y =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(d + c));
      s = fmaf(x.x, y.x, s);
      s = fmaf(x.y, y.y, s);
    }
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) s += __shfl_xor_sync(0xffffffffu, s, m);
    l2 = a.lse[bh * a.Sq + i] * LOG2E;
  }
  if (lane == 0) {
    a.stat[2 * bh * a.Sqp + i] = l2;
    a.stat[(2 * bh + 1) * a.Sqp + i] = s;
  }
}

// One consumer warpgroup (w) of the dK/dV pass: its S^T and dP^T, and its
// DN columns of dK and dV from column c0 (all D without the split; with
// it 128 for consumer 0 and D - 128 for consumer 1).
template <int D, bool CAP, int DN>
__device__ __forceinline__ void dkdv_consumer(const Args& a, uint32_t base,
                                              const float* stat, int w,
                                              int k0, int qlo, int qhi,
                                              int nqt, int visits, int hk,
                                              int b) {
  using L = KvLayout<D>;
  constexpr bool SPLIT = L::SPLIT;
  constexpr int STAGES = L::STAGES;
  constexpr int QN = SPLIT ? 32 : 64;  // S^T columns a consumer computes
  const uint32_t kv_full = base + L::BAR, full = kv_full + 8;
  const uint32_t empty = full + 8 * STAGES;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  // The consumer's keys (rows of its S^T), its S^T columns (q rows of
  // the tile), its band and its first dK / dV column; with the split both
  // consumers share the keys.
  const int kw = SPLIT ? 0 : 64 * w, qc = SPLIT ? 32 * w : 0;
  const int ka = k0 + kw, c0 = SPLIT ? 128 * w : 0;
  int wlo = qlo, whi = qhi;
  if (!SPLIT) q_band(ka, min(ka + 63, a.Sk - 1), a, wlo, whi);
  const int row = 16 * warp + lane / 4;  // + 8 r: its S^T rows
  const int col = 2 * (lane % 4);        // + 8 j + e: its S^T columns
  float dk[DN / 2], dv[DN / 2];
#pragma unroll
  for (int j = 0; j < DN / 2; ++j) dk[j] = dv[j] = 0.0f;
  bool kv_ready = false;

  for (int i = 0; i < visits; ++i) {
    const int st = i % STAGES, ph = (i / STAGES) & 1;
    const int qt = qlo + i % nqt, q0 = qt * BM;
    mbar_wait(full + 8 * st, ph);
    if (qt < wlo || qt > whi) {  // none of this consumer's keys: release
      if (lane == 0) mbar_arrive(empty + 8 * st);
      continue;
    }
    if (!kv_ready) {
      mbar_wait(kv_full, 0);
      kv_ready = true;
    }
    const uint32_t qs = base + L::Q + st * L::Q_TILE;
    const uint32_t dos = base + L::DO + st * L::Q_TILE;
    float s[QN / 2], dp[QN / 2];
    wgmma_fence();
    gemm_nt<D, QN, L::K_CHUNK, L::Q_CHUNK>(s, base + L::K + kw * 128,
                                           qs + qc * 128);
    gemm_nt<D, QN, L::K_CHUNK, L::Q_CHUNK>(dp, base + L::V + kw * 128,
                                           dos + qc * 128);
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(s);
    reg_fence(dp);
    // p into s, ds into dp.
    const float* lse2 = stat + st * 2 * BM;
    const float* dlt = lse2 + BM;
    const bool edge = tile_edge(q0, ka, a);
#pragma unroll
    for (int e = 0; e < QN / 2; ++e) {
      const int ql = qc + 8 * (e / 4) + col + (e & 1);
      const int key = ka + row + 8 * ((e >> 1) & 1);
      p_ds<CAP>(s[e], dp[e], lse2[ql], dlt[ql],
                !edge || visible(q0 + ql, key, a), a, s[e], dp[e]);
    }
    if constexpr (SPLIT) {
      // This consumer's columns of P^T and dS^T into buffer i & 1, at
      // the 128-byte swizzle's places; then the whole of both.
      const uint32_t pt = base + L::PT + (i & 1) * L::PT_TILE;
      const uint32_t dst = pt + 2 * L::PT_TILE;
#pragma unroll
      for (int e = 0; e < QN / 2; e += 2) {
        const int r = row + 8 * ((e >> 1) & 1);
        const int c = qc + 8 * (e / 4) + col;
        const uint32_t at =
            r * 128 + ((((c >> 3) ^ (r & 7)) << 4) | ((c & 7) << 1));
        asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(pt + at),
                     "r"(pack_bf16(s[e], s[e + 1]))
                     : "memory");
        asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(dst + at),
                     "r"(pack_bf16(dp[e], dp[e + 1]))
                     : "memory");
      }
      fence_async_smem();
      asm volatile("bar.sync 1, 256;\n" ::: "memory");
      wgmma_fence();
      gemm_ss<DN, L::Q_CHUNK>(dv, pt, dos + c0 / 64 * L::Q_CHUNK);
      gemm_ss<DN, L::Q_CHUNK>(dk, dst, qs + c0 / 64 * L::Q_CHUNK);
    } else {
      uint32_t pa[4][4], da[4][4];
      pack_a<64>(pa, s);
      pack_a<64>(da, dp);
      wgmma_fence();
      gemm_rs<DN, L::Q_CHUNK>(dv, pa, dos);
      gemm_rs<DN, L::Q_CHUNK>(dk, da, qs);
    }
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(dk);
    reg_fence(dv);
    if (lane == 0) mbar_arrive(empty + 8 * st);
  }
  store_tile<DN>(dk, a.scale, a.dk + b * a.st[DK][0] + hk * a.st[DK][1],
                 a.st[DK][2], ka, c0, a.Sk);
  store_tile<DN>(dv, 1.0f, a.dv + b * a.st[DV][0] + hk * a.st[DV][1],
                 a.st[DV][2], ka, c0, a.Sk);
}

template <int D, bool CAP>
__global__ void __launch_bounds__(THREADS, 1)
dkdv_kernel(const __grid_constant__ CUtensorMap tq,
            const __grid_constant__ CUtensorMap tk,
            const __grid_constant__ CUtensorMap tv,
            const __grid_constant__ CUtensorMap tdo, const Args a) {
  using L = KvLayout<D>;
  constexpr bool SPLIT = L::SPLIT;
  constexpr int BN = L::BN, STAGES = L::STAGES;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const float* stat = reinterpret_cast<const float*>(smem_raw + (base - raw) +
                                                     L::STAT);
  const uint32_t kv_full = base + L::BAR, full = kv_full + 8;
  const uint32_t empty = full + 8 * STAGES;

  // Blocks in key-tile order across every (b, KV head): under a causal
  // mask the first key tiles have the longest bands and start first.
  const int nk = (a.Sk + BN - 1) / BN;
  const int nhb = static_cast<int>(gridDim.x) / nk;
  const int kt = static_cast<int>(blockIdx.x) / nhb;
  const int hb = static_cast<int>(blockIdx.x) % nhb;
  const int hk = hb % a.Hkv, b = hb / a.Hkv;
  const int k0 = kt * BN;
  int qlo, qhi;
  q_band(k0, min(k0 + BN, a.Sk) - 1, a, qlo, qhi);
  const int nqt = qhi >= qlo ? qhi - qlo + 1 : 0;
  const int visits = nqt * a.group;
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128,
                             0);

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
#pragma unroll
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full + 8 * st, 1);
      mbar_init(empty + 8 * st, CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // Producer: K and V once, then Q, dO and the stat values of each
    // visit (head-major, q tiles ascending) through the ring.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0 && visits > 0) {
      mbar_expect_tx(kv_full, 2 * BN * D * 2);
#pragma unroll
      for (int c = 0; c < L::CHUNKS; ++c)
#pragma unroll
        for (int r = 0; r < BN / 64; ++r) {
          const int at = c * L::K_CHUNK + r * 64 * 128;
          tma_load(base + L::K + at, &tk, kv_full, 64 * c, k0 + 64 * r, hk,
                   b);
          tma_load(base + L::V + at, &tv, kv_full, 64 * c, k0 + 64 * r, hk,
                   b);
        }
      for (int i = 0; i < visits; ++i) {
        const int st = i % STAGES, ph = (i / STAGES) & 1;
        const int h = hk * a.group + i / nqt, q0 = (qlo + i % nqt) * BM;
        mbar_wait(empty + 8 * st, ph ^ 1);
        mbar_expect_tx(full + 8 * st, 2 * BM * D * 2 + 2 * BM * 4);
#pragma unroll
        for (int c = 0; c < L::CHUNKS; ++c) {
          const int at = st * L::Q_TILE + c * L::Q_CHUNK;
          tma_load(base + L::Q + at, &tq, full + 8 * st, 64 * c, q0, h, b);
          tma_load(base + L::DO + at, &tdo, full + 8 * st, 64 * c, q0, h, b);
        }
        const float* srow =
            a.stat + 2 * (static_cast<long long>(b) * a.Hq + h) * a.Sqp + q0;
        const uint32_t sdst = base + L::STAT + st * 2 * BM * 4;
        bulk_load(sdst, srow, BM * 4, full + 8 * st);
        bulk_load(sdst + BM * 4, srow + a.Sqp, BM * 4, full + 8 * st);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int w = wg - 1;
    if constexpr (!SPLIT)
      dkdv_consumer<D, CAP, D>(a, base, stat, w, k0, qlo, qhi, nqt, visits,
                               hk, b);
    else if (D == 256 || w == 0)
      dkdv_consumer<D, CAP, 128>(a, base, stat, w, k0, qlo, qhi, nqt,
                                 visits, hk, b);
    else
      dkdv_consumer<D, CAP, D - 128>(a, base, stat, w, k0, qlo, qhi, nqt,
                                     visits, hk, b);
  }
}

template <int D, bool CAP>
__global__ void __launch_bounds__(THREADS, 1)
dq_kernel(const __grid_constant__ CUtensorMap tq,
          const __grid_constant__ CUtensorMap tk,
          const __grid_constant__ CUtensorMap tv,
          const __grid_constant__ CUtensorMap tdo, const Args a) {
  using L = QLayout<D>;
  constexpr int KS = L::KS, VS = L::VS;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const float* stat = reinterpret_cast<const float*>(smem_raw + (base - raw) +
                                                     L::STAT);
  const uint32_t q_full = base + L::BAR;
  const uint32_t k_full = q_full + 8, k_empty = k_full + 8 * KS;
  const uint32_t v_full = k_empty + 8 * KS, v_empty = v_full + 8 * VS;

  // Longest first, as the forward: the last q tile of every (b, h), then
  // the one before.
  const int nq = (a.Sq + QROWS - 1) / QROWS;
  const int nhb = static_cast<int>(gridDim.x) / nq;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x) / nhb) * QROWS;
  const int hb = static_cast<int>(blockIdx.x) % nhb;
  const int h = hb % a.Hq, b = hb / a.Hq, hk = h / a.group;
  // Each consumer's band, and the block's: their union.
  int lo0, hi0, lo1, hi1;
  k_band(q0, a, lo0, hi0);
  k_band(q0 + BM, a, lo1, hi1);
  const int t_lo = hi0 >= lo0 ? lo0 : lo1;
  const int t_hi = hi1 >= lo1 ? hi1 : hi0;
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128,
                             0);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int st = 0; st < KS; ++st) {
      mbar_init(k_full + 8 * st, 1);
      mbar_init(k_empty + 8 * st, CONSUMER_WARPS);
    }
#pragma unroll
    for (int st = 0; st < VS; ++st) {
      mbar_init(v_full + 8 * st, 1);
      mbar_init(v_empty + 8 * st, CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // Producer: Q, dO and their stat values once, then K_t and V_t in
    // tile order through their rings.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0 && t_lo <= t_hi) {
      mbar_expect_tx(q_full, 2 * QROWS * D * 2 + 2 * QROWS * 4);
#pragma unroll
      for (int c = 0; c < L::CHUNKS; ++c)
#pragma unroll
        for (int r = 0; r < QROWS / 64; ++r) {
          const int at = c * L::Q_CHUNK + r * 64 * 128;
          tma_load(base + L::Q + at, &tq, q_full, 64 * c, q0 + 64 * r, h, b);
          tma_load(base + L::DO + at, &tdo, q_full, 64 * c, q0 + 64 * r, h,
                   b);
        }
      const float* srow =
          a.stat + 2 * (static_cast<long long>(b) * a.Hq + h) * a.Sqp + q0;
      bulk_load(base + L::STAT, srow, QROWS * 4, q_full);
      bulk_load(base + L::STAT + QROWS * 4, srow + a.Sqp, QROWS * 4, q_full);
      for (int t = t_lo; t <= t_hi; ++t) {
        const int i = t - t_lo;
        const int ks = i % KS, vs = i % VS;
        mbar_wait(k_empty + 8 * ks, ((i / KS) & 1) ^ 1);
        mbar_expect_tx(k_full + 8 * ks, L::KV_TILE);
#pragma unroll
        for (int c = 0; c < L::CHUNKS; ++c)
          tma_load(base + L::K + ks * L::KV_TILE + c * L::KV_CHUNK, &tk,
                   k_full + 8 * ks, 64 * c, t * BM, hk, b);
        mbar_wait(v_empty + 8 * vs, ((i / VS) & 1) ^ 1);
        mbar_expect_tx(v_full + 8 * vs, L::KV_TILE);
#pragma unroll
        for (int c = 0; c < L::CHUNKS; ++c)
          tma_load(base + L::V + vs * L::KV_TILE + c * L::KV_CHUNK, &tv,
                   v_full + 8 * vs, 64 * c, t * BM, hk, b);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int w = wg - 1;
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int row0 = q0 + w * BM;
    const int col = 2 * (lane % 4);
    const uint32_t qs = base + L::Q + w * BM * 128;
    const uint32_t dos = base + L::DO + w * BM * 128;
    // This consumer's tiles [lo, hi]; the block's others are only released.
    int lo = w == 0 ? lo0 : lo1, hi = w == 0 ? hi0 : hi1;
    if (hi < lo) {
      lo = t_hi + 1;
      hi = t_hi;
    }
    float dq[D / 2];
#pragma unroll
    for (int j = 0; j < D / 2; ++j) dq[j] = 0.0f;
    float lse2[2], dlt[2];
    if (lo <= hi) {
      mbar_wait(q_full, 0);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int rl = w * BM + 16 * warp + lane / 4 + 8 * r;
        lse2[r] = stat[rl];
        dlt[r] = stat[QROWS + rl];
      }
    }
    for (int t = t_lo; t <= t_hi; ++t) {
      const int i = t - t_lo;
      const int ks = i % KS, kph = (i / KS) & 1;
      const int vs = i % VS, vph = (i / VS) & 1;
      mbar_wait(k_full + 8 * ks, kph);
      mbar_wait(v_full + 8 * vs, vph);
      if (t < lo || t > hi) {
        if (lane == 0) {
          mbar_arrive(v_empty + 8 * vs);
          mbar_arrive(k_empty + 8 * ks);
        }
        continue;
      }
      const uint32_t kts = base + L::K + ks * L::KV_TILE;
      float s[32], dp[32];
      wgmma_fence();
      gemm_nt<D, 64, L::Q_CHUNK, L::KV_CHUNK>(s, qs, kts);
      gemm_nt<D, 64, L::Q_CHUNK, L::KV_CHUNK>(
          dp, dos, base + L::V + vs * L::KV_TILE);
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(s);
      reg_fence(dp);
      if (lane == 0) mbar_arrive(v_empty + 8 * vs);
      const bool edge = tile_edge(row0, t * BM, a);
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int r = (e >> 1) & 1;
        const int qi = row0 + 16 * warp + lane / 4 + 8 * r;
        const int key = t * BM + 8 * (e / 4) + col + (e & 1);
        float p;
        p_ds<CAP>(s[e], dp[e], lse2[r], dlt[r], !edge || visible(qi, key, a),
                  a, p, dp[e]);
      }
      uint32_t da[4][4];
      pack_a<64>(da, dp);
      wgmma_fence();
      gemm_rs<D, L::KV_CHUNK>(dq, da, kts);
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(dq);
      if (lane == 0) mbar_arrive(k_empty + 8 * ks);
    }
    store_tile<D>(dq, a.scale, a.dq + b * a.st[DQ][0] + h * a.st[DQ][1],
                  a.st[DQ][2], row0, 0, a.Sq);
  }
}

template <int D, bool CAP>
int launch(const Args& a, const void* q, const void* k, const void* v,
           cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo;
  // With no rows or no keys nothing is loaded: the maps only need to be
  // valid.
  const int Sqm = a.Sq > 0 ? a.Sq : 1, Skm = a.Sk > 0 ? a.Sk : 1;
  if (!make_map(&tq, q, D, Sqm, a.Hq, a.B, a.st[Q], 64) ||
      !make_map(&tdo, a.dout, D, Sqm, a.Hq, a.B, a.st[DO], 64) ||
      !make_map(&tk, k, D, Skm, a.Hkv, a.B, a.st[K], 64) ||
      !make_map(&tv, v, D, Skm, a.Hkv, a.B, a.st[V], 64))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long rows = static_cast<long long>(a.B) * a.Hq * a.Sqp;
  cudaError_t err;
  if (rows > 0) {
    delta_kernel<D><<<static_cast<unsigned>((rows * 32 + 255) / 256), 256,
                      0, stream>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (a.Sk > 0) {
    using L = KvLayout<D>;
    err = cudaFuncSetAttribute(dkdv_kernel<D, CAP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               L::BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((a.Sk + L::BN - 1) / L::BN * a.Hkv * a.B);
    dkdv_kernel<D, CAP><<<grid, THREADS, L::BYTES, stream>>>(tq, tk, tv, tdo,
                                                             a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (a.Sq == 0) return 0;
  using L = QLayout<D>;
  err = cudaFuncSetAttribute(dq_kernel<D, CAP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             L::BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.Sq + QROWS - 1) / QROWS * a.Hq * a.B);
  dq_kernel<D, CAP><<<grid, THREADS, L::BYTES, stream>>>(tq, tk, tv, tdo, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// strides: 24 element strides, (batch, head, seq) of q, k, v, o, do, dq,
// dk and dv in that order; the last axis of each is contiguous, every
// stride a multiple of 8 and every start 16-byte aligned (TMA's rules).
// lse: the forward's (B, Hq, Sq) f32; stat: a (B, Hq, 2, Sqp) f32 scratch
// buffer, Sqp = Sq rounded up to a multiple of 128.
extern "C" int flash_attention_bwd_bf16(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* stat, void* dq, void* dk,
    void* dv, int B, int Hq, int Hkv, int Sq, int Sk, int D,
    const long long* strides, float scale, int causal, int window,
    float cap, void* stream) {
  if (B <= 0 || Sq < 0 || Sk < 0) return 0;
  const long long Sqp = (Sq + QROWS - 1) / QROWS * QROWS;
  if (Hkv <= 0 || Hq % Hkv || B > 65535 || Hq > 65535 ||
      static_cast<long long>((Sq + QROWS - 1) / QROWS) * Hq * B > 0x7fffffff ||
      static_cast<long long>((Sk + 63) / 64) * Hkv * B > 0x7fffffff ||
      static_cast<long long>(B) * Hq * Sqp * 32 / 256 > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  if (Sq == 0 && Sk == 0) return 0;
  Args a;
  a.o = static_cast<const __nv_bfloat16*>(o);
  a.dout = static_cast<const __nv_bfloat16*>(dout);
  a.lse = lse;
  a.stat = stat;
  a.dq = static_cast<__nv_bfloat16*>(dq);
  a.dk = static_cast<__nv_bfloat16*>(dk);
  a.dv = static_cast<__nv_bfloat16*>(dv);
  for (int t = 0; t < 8; ++t)
    for (int i = 0; i < 3; ++i) a.st[t][i] = strides[3 * t + i];
  a.B = B;
  a.Hq = Hq;
  a.Hkv = Hkv;
  a.Sq = Sq;
  a.Sk = Sk;
  a.Sqp = static_cast<int>(Sqp);
  a.group = Hq / Hkv;
  a.causal = causal;
  a.window = window;
  a.scale = scale;
  a.mul = cap > 0.0f ? scale / cap : 0.0f;
  a.cexp = (cap > 0.0f ? cap : scale) * LOG2E;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return cap > 0.0f ? launch<64, true>(a, q, k, v, s)
                        : launch<64, false>(a, q, k, v, s);
    case 128:
      return cap > 0.0f ? launch<128, true>(a, q, k, v, s)
                        : launch<128, false>(a, q, k, v, s);
    case 192:
      return cap > 0.0f ? launch<192, true>(a, q, k, v, s)
                        : launch<192, false>(a, q, k, v, s);
    case 256:
      return cap > 0.0f ? launch<256, true>(a, q, k, v, s)
                        : launch<256, false>(a, q, k, v, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// flash_attention: the online-softmax attention forward, bf16 in and out.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py:flash_attention
// (body _attn_kernel).
//
// What it computes: for q (B, Hq, Sq, D) and k, v (B, Hkv, Sk, D), with
// query i at key position Sk - Sq + i and query head h reading KV head
// h / (Hq / Hkv): softmax over the visible keys of cap * tanh(s / cap),
// s = scale * q.k (no tanh when cap is 0), times v. A key is visible when
// it is < Sk, at or before the query (causal) and inside (pos - W, pos]
// (window W > 0). A query with no visible key gives 0.
//
// What bounds it on an H100: operations, at prefill lengths. Each visible
// (q, k) pair costs 4 * D flops per head (q.k and p.v), 1,024 at D = 256,
// against 989 TFLOP/s of bf16 tensor cores; the bytes (q, k, v read once,
// o written once) take far less time than that at S = 8192. Beside the
// tensor cores, each pair costs one ex2 (and one tanh with the softcap) on
// the 16-a-clock special-function unit: half the tensor cores' time at
// D = 256, about as much as theirs at D = 64, so it has to run while they
// do. D is 64, 128, 192 or 256. At D = 192 (MLA's q.k width, with v
// padded from 128 by the caller) the padded half of p.v is work the
// function does not need: its bound counts 2 * (192 + 128) flops a pair.
//
// Design. The TPU kernel's grid was (B, Hq, Sq/tq, Sk/tk) with the key
// axis sequential and (m, l, acc) in VMEM. Here a block of three
// warpgroups owns BM = 128 query rows of one (b, h) and walks, in order,
// the BN-key tiles of the live causal / window band (the TPU kernel's
// block-level test), so a window-W layer does O(S * W) work:
// - warpgroup 0 is the producer: one thread loads Q once and then K and V
//   tile by tile with TMA (4-D tensor maps over (D, S, H, B) built from
//   the caller's strides, 128-byte swizzle, rows past S zero-filled) into
//   a ring of STAGES K and STAGES V buffers, each with a full and an empty
//   mbarrier;
// - warpgroups 1 and 2 are consumers of 64 rows each (setmaxnreg moves
//   registers from the producer to them). Each visits only the tiles of
//   its own rows' band. S = Q.K^T is a wgmma with both operands K-major
//   in shared memory; O += P.V a wgmma with P from registers (S's
//   accumulator fragments rounded to bf16 are the A fragments as they
//   are) and V MN-major in shared memory. The next tile's Q.K^T and this
//   tile's P.V are issued before the softmax of the next tile, so the
//   exp / tanh work runs while the tensor cores do (and the two consumer
//   warpgroups interleave their products and softmaxes on the SM).
// The softmax works in the log2 domain: scale * log2(e) (or cap * log2 e
// after tanh.approx of s * scale / cap) is folded into the one multiply
// before ex2.approx. The running max m, the partial sums l and the
// (64, D) accumulator stay in registers, in f32, with the TPU kernel's
// m_safe / alpha handling of -inf and the final division by
// max(l, 1e-30). With an lse pointer the epilogue also writes each row's
// log-sum-exp for the backward (csrc/flash_attention_bwd.cu): the one
// conversion from the log2 domain to natural log, lse = (m_safe * cexp +
// log2(l)) * ln 2, -inf for a row with no visible key; o is computed
// exactly as without it. Tiles that straddle the band's edge or the
// ragged end of the keys are masked per element; rows past Sq are
// computed and not stored. Blocks are numbered longest first across every (b, h): the
// last query tile of each head and batch, then the one before, so that
// the longest causal rows start first and no long block starts last.
// kernels/ref.py's flash_attention_tiles lists the tiles visited and
// flash_attention_blocked models the arithmetic.
#include "hopper.cuh"

namespace {

constexpr int BM = 128;             // query rows per block
constexpr int WG_ROWS = 64;         // query rows per consumer warpgroup
constexpr int THREADS = 3 * 128;    // producer + 2 consumer warpgroups
constexpr int STAGES = 2;           // K and V buffers each
constexpr int CONSUMER_WARPS = 8;   // arrivals on an empty barrier
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// Keys per tile. At D = 256 a consumer thread holds the (64, 256) f32
// accumulator (128 registers), S (BN / 2) and P (BN / 4): 80 fits in 240
// registers and the ring (Q 64 KB + 2 x 2 x 40 KB) in 227 KB. At D = 192
// shared memory sets it: Q takes 48 KB and each K or V tile 3 x BN x
// 128 B, so 48 KB + 4 x 384 B x BN <= 227 KB leaves BN <= 118; 112 (a
// multiple of 16 for the p.v steps) takes 217 KB and 96 + 56 + 28 = 180
// registers for the accumulator, S and P, below D = 256's 188. D = 128
// has room for 128; D = 64 (one 128-byte column chunk, a 32-register
// accumulator) keeps 128 too.
template <int D>
struct Tile;
template <>
struct Tile<64> {
  static constexpr int BN = 128;
};
template <>
struct Tile<128> {
  static constexpr int BN = 128;
};
template <>
struct Tile<192> {
  static constexpr int BN = 112;
};
template <>
struct Tile<256> {
  static constexpr int BN = 80;
};

// Shared memory, in bytes from a 1024-aligned base. A tile of R rows is
// D / 64 column chunks of R rows x 128 bytes (64 bf16), each as TMA's
// 128-byte swizzle lays it out: 8-row atoms of 1024 bytes.
template <int D>
struct Layout {
  static constexpr int BN = Tile<D>::BN;
  static constexpr int CHUNKS = D / 64;
  static constexpr int Q_CHUNK = BM * 128;
  static constexpr int KV_CHUNK = BN * 128;
  static constexpr int KV_TILE = CHUNKS * KV_CHUNK;
  static constexpr int Q = 0;
  static constexpr int K = Q + CHUNKS * Q_CHUNK;
  static constexpr int V = K + STAGES * KV_TILE;
  static constexpr int BAR = V + STAGES * KV_TILE;  // q_full, then per stage
  static constexpr int BYTES = BAR + 8 * (1 + 4 * STAGES) + 1024;
  static_assert(KV_CHUNK % 1024 == 0, "tiles must hold whole swizzle atoms");
  static_assert(BYTES <= 232448, "more shared memory than a block has");
};

// The key tiles [lo, hi] that query rows [r0, r1) of one (b, h) see (the
// TPU kernel's block test, :42-46); hi < lo when they see none.
template <int BN>
__device__ __forceinline__ void band(int r0, int r1, int Sq, int Sk,
                                     int causal, int window, int& lo,
                                     int& hi) {
  r1 = min(r1, Sq);
  const int off = Sk - Sq;
  const int k_lo = window > 0 ? max(0, off + r0 - window + 1) : 0;
  const int k_hi = causal ? min(Sk - 1, off + r1 - 1) : Sk - 1;
  if (r0 >= r1 || k_hi < k_lo) {
    lo = 0;
    hi = -1;
  } else {
    lo = k_lo / BN;
    hi = k_hi / BN;
  }
}

// s = Q.K^T for the warpgroup's 64 rows and one tile: D / 16 wgmmas that
// step 32 bytes through each 128-byte swizzle row, then to the next chunk.
template <int D>
__device__ __forceinline__ void issue_qk(float (&s)[Tile<D>::BN / 2],
                                         uint32_t qs, uint32_t ks) {
  using L = Layout<D>;
  uint64_t da = sw128_desc(qs, 16, 1024), db = sw128_desc(ks, 16, 1024);
  // Built anew for every tile: held across the loop, the D / 16 pairs of
  // descriptors would take registers that the accumulators need.
  asm volatile("" : "+l"(da), "+l"(db));
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    // The start address is the descriptor's low field, in 16-byte units.
    const uint64_t a = da + (((kk / 4) * L::Q_CHUNK + (kk % 4) * 32) >> 4);
    const uint64_t b = db + (((kk / 4) * L::KV_CHUNK + (kk % 4) * 32) >> 4);
    if constexpr (L::BN == 80)
      wgmma_ss80(s, a, b, kk > 0);
    else if constexpr (L::BN == 112)
      wgmma_ss112(s, a, b, kk > 0);
    else
      wgmma_ss128(s, a, b, kk > 0);
  }
}

// acc += P.V: BN / 16 wgmmas, each 16 keys (two 8-row atoms, 1024 bytes
// apart) by all D columns (64-column chunks KV_CHUNK bytes apart).
template <int D>
__device__ __forceinline__ void issue_pv(float (&acc)[D / 2],
                                         const uint32_t (&p)[Tile<D>::BN /
                                                             16][4],
                                         uint32_t vs) {
  using L = Layout<D>;
  uint64_t db = sw128_desc(vs, L::KV_CHUNK, 1024);
  asm volatile("" : "+l"(db));
#pragma unroll
  for (int kk = 0; kk < L::BN / 16; ++kk) {
    const uint64_t b = db + ((kk * 16 * 128) >> 4);
    if constexpr (D == 256)
      wgmma_rs256(acc, p[kk], b);
    else if constexpr (D == 192)
      wgmma_rs192(acc, p[kk], b);
    else if constexpr (D == 128)
      wgmma_rs128(acc, p[kk], b);
    else
      wgmma_rs64(acc, p[kk], b);
  }
}

// One tile's online softmax on S's accumulator fragments: element i of a
// thread is key 8 * (i / 4) + kcol + (i & 1) of the tile and row
// qpos0 + 8 * ((i >> 1) & 1). Leaves p = 2^(x - m) in s, the rescale of
// the earlier tiles in alpha, and m and the thread's partial sums l
// updated; x = log2(e) * logit, as cexp * (tanh(mul * s) or s).
template <int BN, bool CAP>
__device__ __forceinline__ void softmax_tile(float (&s)[BN / 2], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2],
                                             bool edge, int k0, int kcol,
                                             int qpos0, int Sk, int causal,
                                             int window, float mul,
                                             float cexp) {
  if (CAP) {
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) s[i] = tanh_fast(s[i] * mul);
  }
  if (edge) {
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      const int key = k0 + 8 * (i / 4) + kcol + (i & 1);
      const int qpos = qpos0 + 8 * ((i >> 1) & 1);
      if (key >= Sk || (causal && key > qpos) ||
          (window > 0 && key <= qpos - window))
        s[i] = -INFINITY;
    }
  }
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int i = 0; i < BN / 2; ++i)
    mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
  float ms[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    ms[r] = mx[r] == -INFINITY ? 0.0f : mx[r] * cexp;   // m_safe
    alpha[r] = ex2(fmaf(m[r], cexp, -ms[r]));           // 0 from m = -inf
    m[r] = mx[r];
  }
  float rs[2] = {0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) {
    s[i] = ex2(fmaf(s[i], cexp, -ms[(i >> 1) & 1]));
    rs[(i >> 1) & 1] += s[i];
  }
  l[0] = l[0] * alpha[0] + rs[0];
  l[1] = l[1] * alpha[1] + rs[1];
}

// p rounded to bf16: S's accumulator fragments of keys 16 kk .. 16 kk + 15
// are the A fragment of the kk-th P.V wgmma as they are.
template <int BN>
__device__ __forceinline__ void pack_p(uint32_t (&p)[BN / 16][4],
                                       const float (&s)[BN / 2]) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      p[kk][j] = pack_bf16(s[8 * kk + 2 * j], s[8 * kk + 2 * j + 1]);
}

template <int D, bool CAP>
__global__ void __launch_bounds__(THREADS, 1)
flash_attention_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       __nv_bfloat16* __restrict__ o,
                       float* __restrict__ lse, int Sq, int Sk,
                       int Hq, int group, int64_t osb, int64_t osh,
                       int64_t oss, float mul, float cexp, int causal,
                       int window) {
  using L = Layout<D>;
  constexpr int BN = L::BN;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_full = base + L::BAR;
  const uint32_t k_full = q_full + 8, k_empty = k_full + 8 * STAGES;
  const uint32_t v_full = k_empty + 8 * STAGES;
  const uint32_t v_empty = v_full + 8 * STAGES;

  const int nq = (Sq + BM - 1) / BM;
  const int nhb = static_cast<int>(gridDim.x) / nq;  // Hq * B
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x) / nhb) * BM;
  const int hb = static_cast<int>(blockIdx.x) % nhb;
  const int h = hb % Hq, b = hb / Hq, hk = h / group;
  // Each consumer's band, and the block's: their union.
  int lo0, hi0, lo1, hi1;
  band<BN>(q0, q0 + WG_ROWS, Sq, Sk, causal, window, lo0, hi0);
  band<BN>(q0 + WG_ROWS, q0 + BM, Sq, Sk, causal, window, lo1, hi1);
  const int t_lo = hi0 >= lo0 ? lo0 : lo1;
  const int t_hi = hi1 >= lo1 ? hi1 : hi0;
  // The warpgroup, broadcast from lane 0 so that the compiler sees it
  // (and the loop bounds drawn from it) uniform across the warp.
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128,
                             0);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(k_full + 8 * st, 1);
      mbar_init(v_full + 8 * st, 1);
      mbar_init(k_empty + 8 * st, CONSUMER_WARPS);
      mbar_init(v_empty + 8 * st, CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // Producer: Q once, then K_t and V_t in tile order through the ring.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0 && t_lo <= t_hi) {
      mbar_expect_tx(q_full, BM * D * 2);
#pragma unroll
      for (int c = 0; c < L::CHUNKS; ++c)
        tma_load(base + L::Q + c * L::Q_CHUNK, &tq, q_full, 64 * c, q0, h,
                 b);
      for (int t = t_lo; t <= t_hi; ++t) {
        const int i = t - t_lo, st = i % STAGES, ph = (i / STAGES) & 1;
        mbar_wait(k_empty + 8 * st, ph ^ 1);
        mbar_expect_tx(k_full + 8 * st, L::KV_TILE);
#pragma unroll
        for (int c = 0; c < L::CHUNKS; ++c)
          tma_load(base + L::K + st * L::KV_TILE + c * L::KV_CHUNK, &tk,
                   k_full + 8 * st, 64 * c, t * BN, hk, b);
        mbar_wait(v_empty + 8 * st, ph ^ 1);
        mbar_expect_tx(v_full + 8 * st, L::KV_TILE);
#pragma unroll
        for (int c = 0; c < L::CHUNKS; ++c)
          tma_load(base + L::V + st * L::KV_TILE + c * L::KV_CHUNK, &tv,
                   v_full + 8 * st, 64 * c, t * BN, hk, b);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int w = wg - 1;
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int row0 = q0 + w * WG_ROWS, rend = min(row0 + WG_ROWS, Sq);
    const int off = Sk - Sq;
    const int qpos0 = off + row0 + 16 * warp + lane / 4;  // and qpos0 + 8
    const int kcol = 2 * (lane % 4);
    const uint32_t qs = base + L::Q + w * WG_ROWS * 128;
    // This warpgroup's tiles [a, z]; the block's others are only released.
    int a = w == 0 ? lo0 : lo1, z = w == 0 ? hi0 : hi1;
    if (z < a) {
      a = t_hi + 1;
      z = t_hi;
    }
    // The tile meets the band's edge or the ragged end: mask per element.
    auto edge = [&](int k0) {
      return k0 + BN > Sk || (causal && k0 + BN - 1 > off + row0) ||
             (window > 0 && k0 <= off + rend - 1 - window);
    };
    float acc[D / 2], s[BN / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) s[i] = 0.0f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f}, alpha[2];
    uint32_t p[BN / 16][4];

    // A tile of the block outside this warpgroup's band: released unread.
    auto skip = [&](int t) {
      const int i = t - t_lo, st = i % STAGES, ph = (i / STAGES) & 1;
      mbar_wait(k_full + 8 * st, ph);
      if (lane == 0) mbar_arrive(k_empty + 8 * st);
      mbar_wait(v_full + 8 * st, ph);
      if (lane == 0) mbar_arrive(v_empty + 8 * st);
    };
    for (int t = t_lo; t < a; ++t) skip(t);
    if (a <= z) {
      mbar_wait(q_full, 0);
      {  // The first tile: q.k^T, softmax.
        const int i = a - t_lo, st = i % STAGES, ph = (i / STAGES) & 1;
        mbar_wait(k_full + 8 * st, ph);
        wgmma_fence();
        issue_qk<D>(s, qs, base + L::K + st * L::KV_TILE);
        wgmma_commit();
        wgmma_wait<0>();
        reg_fence(s);
        if (lane == 0) mbar_arrive(k_empty + 8 * st);
        softmax_tile<BN, CAP>(s, m, l, alpha, edge(a * BN), a * BN, kcol,
                              qpos0, Sk, causal, window, mul, cexp);
        pack_p<BN>(p, s);
      }
      for (int t = a + 1; t <= z; ++t) {
        // This tile's q.k^T, then the previous tile's p.v, which runs
        // under this tile's softmax.
        const int i = t - t_lo, st = i % STAGES, ph = (i / STAGES) & 1;
        const int sp = (i - 1) % STAGES, pp = ((i - 1) / STAGES) & 1;
        mbar_wait(k_full + 8 * st, ph);
        wgmma_fence();
        issue_qk<D>(s, qs, base + L::K + st * L::KV_TILE);
        wgmma_commit();
        mbar_wait(v_full + 8 * sp, pp);
        issue_pv<D>(acc, p, base + L::V + sp * L::KV_TILE);
        wgmma_commit();
        wgmma_wait<1>();
        reg_fence(s);
        if (lane == 0) mbar_arrive(k_empty + 8 * st);
        softmax_tile<BN, CAP>(s, m, l, alpha, edge(t * BN), t * BN, kcol,
                              qpos0, Sk, causal, window, mul, cexp);
        wgmma_wait<0>();
        reg_fence(acc);
        reg_fence(p);
        if (lane == 0) mbar_arrive(v_empty + 8 * sp);
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          acc[4 * j] *= alpha[0];
          acc[4 * j + 1] *= alpha[0];
          acc[4 * j + 2] *= alpha[1];
          acc[4 * j + 3] *= alpha[1];
        }
        pack_p<BN>(p, s);
      }
      // The last tile's p.v.
      const int i = z - t_lo, st = i % STAGES, ph = (i / STAGES) & 1;
      mbar_wait(v_full + 8 * st, ph);
      wgmma_fence();
      issue_pv<D>(acc, p, base + L::V + st * L::KV_TILE);
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(acc);
      if (lane == 0) mbar_arrive(v_empty + 8 * st);
    }
    for (int t = z + 1; t <= t_hi; ++t) skip(t);

    // out = acc / max(l, 1e-30), rows below Sq only; lse where asked.
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      const int row = row0 + 16 * warp + lane / 4 + 8 * r;
      if (lse != nullptr && kcol == 0 && row < rend) {
        // m and l are the row's, reduced across its four threads above.
        const float ms = m[r] == -INFINITY ? 0.0f : m[r] * cexp;
        lse[(static_cast<int64_t>(b) * Hq + h) * Sq + row] =
            (ms + log2f(l[r])) * LN2;
      }
      l[r] = 1.0f / fmaxf(l[r], 1e-30f);
    }
    __nv_bfloat16* ob = o + b * osb + h * osh;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 16 * warp + lane / 4 + 8 * r;
      if (row >= rend) continue;
      __nv_bfloat16* orow = ob + row * oss + kcol;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(orow + 8 * j) =
            pack_bf16(acc[4 * j + 2 * r] * l[r], acc[4 * j + 2 * r + 1] * l[r]);
    }
  }
}

template <int D, bool CAP>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B,
           int Hq, int Hkv, int Sq, int Sk, const long long* st, float scale,
           int causal, int window, float cap, cudaStream_t stream) {
  using L = Layout<D>;
  CUtensorMap tq, tk, tv;
  // With no keys no tile is loaded: the maps only need to be valid.
  const int Skm = Sk > 0 ? Sk : 1;
  if (!make_map(&tq, q, D, Sq, Hq, B, st, BM) ||
      !make_map(&tk, k, D, Skm, Hkv, B, st + 3, L::BN) ||
      !make_map(&tv, v, D, Skm, Hkv, B, st + 6, L::BN))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<D, CAP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float mul = CAP ? scale / cap : 0.0f;
  const float cexp = (CAP ? cap : scale) * LOG2E;
  const dim3 grid((Sq + BM - 1) / BM * Hq * B);
  flash_attention_kernel<D, CAP><<<grid, THREADS, L::BYTES, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), lse, Sq, Sk, Hq, Hq / Hkv,
      st[9], st[10], st[11], mul, cexp, causal, window);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_d(const void* q, const void* k, const void* v, void* o, float* lse,
             int B,
             int Hq, int Hkv, int Sq, int Sk, const long long* st,
             float scale, int causal, int window, float cap,
             cudaStream_t stream) {
  return cap > 0.0f
             ? launch<D, true>(q, k, v, o, lse, B, Hq, Hkv, Sq, Sk, st,
                               scale, causal, window, cap, stream)
             : launch<D, false>(q, k, v, o, lse, B, Hq, Hkv, Sq, Sk, st,
                                scale, causal, window, cap, stream);
}

}  // namespace

// strides: 12 element strides, (batch, head, seq) of q, k, v and o in that
// order; the last axis of each is contiguous, every stride a multiple of 8
// and every start 16-byte aligned (TMA's rules). lse: nullptr, or a
// contiguous (B, Hq, Sq) f32 buffer for each row's log-sum-exp.
extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* o, float* lse,
                                    int B, int Hq,
                                    int Hkv, int Sq, int Sk, int D,
                                    const long long* strides, float scale,
                                    int causal, int window, float cap,
                                    void* stream) {
  if (B <= 0 || Sq <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv || B > 65535 || Hq > 65535 ||
      static_cast<long long>((Sq + BM - 1) / BM) * Hq * B > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch_d<64>(q, k, v, o, lse, B, Hq, Hkv, Sq, Sk, strides,
                          scale, causal, window, cap, s);
    case 128:
      return launch_d<128>(q, k, v, o, lse, B, Hq, Hkv, Sq, Sk, strides,
                           scale, causal, window, cap, s);
    case 192:
      return launch_d<192>(q, k, v, o, lse, B, Hq, Hkv, Sq, Sk, strides,
                           scale, causal, window, cap, s);
    case 256:
      return launch_d<256>(q, k, v, o, lse, B, Hq, Hkv, Sq, Sk, strides,
                           scale, causal, window, cap, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

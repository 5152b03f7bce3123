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
// D = 256, so it has to run while they do.
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
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
// registers and the ring (Q 64 KB + 2 x 2 x 40 KB) in 227 KB. D = 128
// has room for 128.
template <int D>
struct Tile;
template <>
struct Tile<128> {
  static constexpr int BN = 128;
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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of a 4-D tensor map into shared memory; completes on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (in 16-byte units), layout 1.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Orders the compiler's uses of a register after the wgmma wait before it.
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float tanh_fast(float x) {
  float y;
  asm("tanh.approx.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

#define F4(a, i) "+f"(a[i]), "+f"(a[i + 1]), "+f"(a[i + 2]), "+f"(a[i + 3])
#define F8(a, i) F4(a, i), F4(a, i + 4)
#define F32(a, i) F8(a, i), F8(a, i + 8), F8(a, i + 16), F8(a, i + 24)
#define F40(a) F32(a, 0), F8(a, 32)
#define F64(a) F32(a, 0), F32(a, 32)
#define F128(a) F32(a, 0), F32(a, 32), F32(a, 64), F32(a, 96)

// d (64 x 80 f32) = a (64 x 16) * b (16 x 80), + d where acc is nonzero;
// a and b in shared memory, K-major.
__device__ __forceinline__ void wgmma_ss80(float (&d)[40], uint64_t da,
                                          uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %42, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39}, %40, %41, p, 1, 1, 0, 0;\n}\n"
      : F40(d)
      : "l"(da), "l"(db), "r"(acc));
}

// d (64 x 128 f32) = a (64 x 16) * b (16 x 128), + d where acc is nonzero;
// a and b in shared memory, K-major.
__device__ __forceinline__ void wgmma_ss128(float (&d)[64], uint64_t da,
                                          uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : F64(d)
      : "l"(da), "l"(db), "r"(acc));
}

// d (64 x 128 f32) += a (64 x 16, registers) * b (16 x 128, shared memory,
// MN-major).
__device__ __forceinline__ void wgmma_rs128(float (&d)[64],
                                           const uint32_t (&a)[4],
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : F64(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 256 f32) += a (64 x 16, registers) * b (16 x 256, shared memory,
// MN-major).
__device__ __forceinline__ void wgmma_rs256(float (&d)[128],
                                           const uint32_t (&a)[4],
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, "
      "%74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "
      "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, "
      "%118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : F128(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

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
    else
      wgmma_rs128(acc, p[kk], b);
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

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime (no -lcuda).
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A 4-D map over (D, S, H, B) bf16 with element strides st = (batch, head,
// seq), boxes of 64 columns x `rows` rows, 128-byte swizzle, rows past S
// read as zeros. A stride of an axis of length 1 is never used; it is
// replaced by a valid one.
bool make_map(CUtensorMap* map, const void* ptr, int D, int S, int H, int B,
              const long long* st, int rows) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t ss = S > 1 ? st[2] * 2 : D * 2;
  const cuuint64_t sh = H > 1 ? st[1] * 2 : ss * S;
  const cuuint64_t sb = B > 1 ? st[0] * 2 : sh * H;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {ss, sh, sb};
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
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
    case 128:
      return launch_d<128>(q, k, v, o, lse, B, Hq, Hkv, Sq, Sk, strides,
                           scale, causal, window, cap, s);
    case 256:
      return launch_d<256>(q, k, v, o, lse, B, Hq, Hkv, Sq, Sk, strides,
                           scale, causal, window, cap, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

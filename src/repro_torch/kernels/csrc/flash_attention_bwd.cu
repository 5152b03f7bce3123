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
// against 989 TFLOP/s of bf16 tensor cores; this design spends 14 * D
// (the dQ kernel computes q.k and do.v again).
//
// Design: a simple first kernel; wgmma, TMA and warp specialisation are
// later work. Three launches on the caller's stream:
// 1. delta_kernel: one warp a row, delta = sum_d do * o in f32 from the
//    bf16 o and do.
// 2. dkdv_kernel: a block of 8 warps per (b, KV head, 64-key tile) keeps
//    the tile's K and V in shared memory and walks the g query heads and
//    the 64-row q tiles of the band that sees its keys, Q, dO, lse and
//    delta double-buffered with cp.async. Per q tile: S^T = K Q^T and
//    dP^T = V dO^T (bf16 mma.sync m16n8k16, f32 accumulators; a warp owns
//    16 keys x 32 queries), p recomputed from lse in the log2 domain as
//    the forward has it (ex2, tanh.approx, the same mask), ds = p (dp -
//    delta) (times 1 - tanh^2 under the softcap), both written in bf16 to
//    shared memory; then dV += P^T dO and dK += dS^T Q (a warp owns 16
//    keys x D/2 columns, f32 accumulators in registers).
// 3. dq_kernel: a block of 8 warps per (b, q head, 64-row q tile) keeps Q
//    and dO and walks the band's 64-key tiles (K and V double-buffered):
//    S = Q K^T, dP = dO V^T, dS as above into shared memory, dQ += dS K.
// No atomics: each output element is summed by one thread in a fixed
// order, so two runs are bit-equal. Shared rows are padded by 8 bf16, so
// ldmatrix and the fragment stores touch 32 distinct banks.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BT = 64;          // query rows and keys per tile
constexpr int THREADS = 256;    // 8 warps
constexpr int PAD = 8;          // bf16 per shared row beyond the data
constexpr int PLD = BT + PAD;   // row of a P or dS tile, in bf16
constexpr float LOG2E = 1.4426950408889634f;

enum { Q = 0, K, V, O, DO, DQ, DK, DV };

struct Args {
  const __nv_bfloat16 *q, *k, *v, *o, *dout;
  const float* lse;
  float* delta;
  __nv_bfloat16 *dq, *dk, *dv;
  long long st[8][3];  // (batch, head, seq) element strides, by the enum
  int B, Hq, Hkv, Sq, Sk, group, causal, window;
  float scale, mul, cexp;  // mul = scale / cap (CAP), cexp = (cap or
                           // scale) * log2 e: the forward's
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, zeros where !valid.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm4t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c (16 x 8 f32) += a (16 x 16 bf16, row) * b (16 x 8 bf16, col).
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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

// Rows [r0, r0 + BT) of a matrix whose rows are `ss` elements apart into
// shared memory (rows of D + PAD); rows at or past `nrows` read as zeros.
template <int D>
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          const __nv_bfloat16* base,
                                          long long ss, int r0, int nrows) {
  constexpr int CPR = D / 8;  // 16-byte chunks a row
  for (int c = threadIdx.x; c < BT * CPR; c += THREADS) {
    const int r = c / CPR, col = (c % CPR) * 8;
    const bool ok = r0 + r < nrows;
    cp_async16(dst + ((r * (D + PAD) + col) << 1),
               ok ? base + (r0 + r) * ss + col : base, ok);
  }
}

// c[j] (16 x 8) = X[r0 .. r0 + 15] . Y[c0 + 8j .. c0 + 8j + 7]^T, j < 4:
// X and Y row-major in shared memory with rows of D + PAD, summed over D.
template <int D>
__device__ __forceinline__ void gemm_nt(float (&c)[4][4], uint32_t xs,
                                        int r0, uint32_t ys, int c0,
                                        int lane) {
  constexpr int LD = D + PAD;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] = 0.0f;
  const uint32_t xa = xs + (((r0 + (lane & 15)) * LD + (lane >> 4) * 8) << 1);
  const uint32_t ya =
      ys + (((c0 + ((lane >> 4) << 3) + (lane & 7)) * LD +
             ((lane >> 3) & 1) * 8)
            << 1);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4], b0[4], b1[4];
    ldsm4(a, xa + kk * 32);
    ldsm4(b0, ya + kk * 32);
    ldsm4(b1, ya + 16 * LD * 2 + kk * 32);
    mma(c[0], a, b0[0], b0[1]);
    mma(c[1], a, b0[2], b0[3]);
    mma(c[2], a, b1[0], b1[1]);
    mma(c[3], a, b1[2], b1[3]);
  }
}

// c[j] (16 x 8) += P[r0 .. r0 + 15, 0 .. BT) . Y[0 .. BT, n0 + 8j ..], j <
// D / 16: P row-major with rows of PLD, Y row-major with rows of D + PAD
// (read transposed by ldmatrix).
template <int D>
__device__ __forceinline__ void gemm_nn(float (&c)[D / 16][4], uint32_t ps,
                                        int r0, uint32_t ys, int n0,
                                        int lane) {
  constexpr int LD = D + PAD;
  const uint32_t pa = ps + (((r0 + (lane & 15)) * PLD + (lane >> 4) * 8) << 1);
  const uint32_t ya = ys + (((((lane >> 3) & 1) * 8 + (lane & 7)) * LD + n0 +
                             (lane >> 4) * 8)
                            << 1);
#pragma unroll
  for (int kk = 0; kk < BT / 16; ++kk) {
    uint32_t a[4];
    ldsm4(a, pa + kk * 32);
#pragma unroll
    for (int j = 0; j < D / 32; ++j) {
      uint32_t b[4];
      ldsm4t(b, ya + ((kk * 16 * LD + 16 * j) << 1));
      mma(c[2 * j], a, b[0], b[1]);
      mma(c[2 * j + 1], a, b[2], b[3]);
    }
  }
}

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

// Stores c (16 rows x D/2 columns at (r0, n0), times mul) in bf16, rows
// below nrows only.
template <int D>
__device__ __forceinline__ void store_rows(const float (&c)[D / 16][4],
                                           float mul, __nv_bfloat16* base,
                                           long long ss, int r0, int n0,
                                           int nrows, int lane) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = r0 + (lane >> 2) + 8 * half;
    if (row >= nrows) continue;
    __nv_bfloat16* dst = base + row * ss + n0 + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < D / 16; ++j)
      *reinterpret_cast<uint32_t*>(dst + 8 * j) =
          pack_bf16(c[j][2 * half] * mul, c[j][2 * half + 1] * mul);
  }
}

template <int D>
__global__ void delta_kernel(const Args a) {
  const long long w = (static_cast<long long>(blockIdx.x) * blockDim.x +
                       threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (w >= static_cast<long long>(a.B) * a.Hq * a.Sq) return;
  const int i = static_cast<int>(w % a.Sq);
  const int h = static_cast<int>((w / a.Sq) % a.Hq);
  const int b = static_cast<int>(w / (static_cast<long long>(a.Sq) * a.Hq));
  const __nv_bfloat16* o = a.o + b * a.st[O][0] + h * a.st[O][1] +
                           i * a.st[O][2];
  const __nv_bfloat16* d = a.dout + b * a.st[DO][0] + h * a.st[DO][1] +
                           i * a.st[DO][2];
  float s = 0.0f;
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
  if (lane == 0) a.delta[w] = s;
}

template <int D>
struct DkdvSmem {
  static constexpr int TILE = BT * (D + PAD) * 2;
  static constexpr int KS = 0, VS = TILE, QS = 2 * TILE;  // QS[2], DOS[2]
  static constexpr int DOS = 4 * TILE, PS = 6 * TILE;
  static constexpr int DSS = PS + BT * PLD * 2;
  static constexpr int STAT = DSS + BT * PLD * 2;  // lse2[2][BT], delta[2][BT]
  static constexpr int BYTES = STAT + 4 * BT * 4;
  static_assert(BYTES <= 232448, "more shared memory than a block has");
};

template <int D, bool CAP>
__global__ void __launch_bounds__(THREADS, 1) dkdv_kernel(const Args a) {
  using L = DkdvSmem<D>;
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t base = smem_u32(smem);
  float* stat = reinterpret_cast<float*>(smem + L::STAT);

  // Blocks in key-tile order across every (b, KV head): under a causal
  // mask the first key tiles have the longest bands and start first.
  const int nk = (a.Sk + BT - 1) / BT;
  const int nhb = static_cast<int>(gridDim.x) / nk;
  const int kt = static_cast<int>(blockIdx.x) / nhb;
  const int hb = static_cast<int>(blockIdx.x) % nhb;
  const int hk = hb % a.Hkv, b = hb / a.Hkv;
  const int k0 = kt * BT, k_last = min(k0 + BT, a.Sk) - 1;
  const int off = a.Sk - a.Sq;
  // The q rows that see any of these keys.
  const int q_lo = a.causal ? max(0, k0 - off) : 0;
  const int q_hi =
      a.window > 0 ? min(a.Sq - 1, k_last + a.window - 1 - off) : a.Sq - 1;
  const int qt_lo = q_lo / BT;
  const int nqt = q_hi >= q_lo ? q_hi / BT - qt_lo + 1 : 0;
  const int visits = nqt * a.group;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int kr = 16 * (warp & 3);        // the warp's 16 keys
  const int qc = 32 * (warp >> 2);       // phase A: its 32 queries
  const int dc = (D / 2) * (warp >> 2);  // phase B: its D / 2 columns
  float dk[D / 16][4], dv[D / 16][4];
#pragma unroll
  for (int j = 0; j < D / 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.0f;

  // Q, dO, lse and delta of visit i into buffer i & 1.
  auto prefetch = [&](int i) {
    const int h = hk * a.group + i / nqt, q0 = (qt_lo + i % nqt) * BT;
    const int buf = i & 1;
    load_tile<D>(base + L::QS + buf * L::TILE,
                 a.q + b * a.st[Q][0] + h * a.st[Q][1], a.st[Q][2], q0, a.Sq);
    load_tile<D>(base + L::DOS + buf * L::TILE,
                 a.dout + b * a.st[DO][0] + h * a.st[DO][1], a.st[DO][2], q0,
                 a.Sq);
    if (threadIdx.x < BT) {
      const int row = q0 + threadIdx.x;
      const long long at = (static_cast<long long>(b) * a.Hq + h) * a.Sq + row;
      stat[buf * BT + threadIdx.x] =
          row < a.Sq ? a.lse[at] * LOG2E : INFINITY;
      stat[2 * BT + buf * BT + threadIdx.x] = row < a.Sq ? a.delta[at] : 0.0f;
    }
  };

  if (visits > 0) {
    load_tile<D>(base + L::KS, a.k + b * a.st[K][0] + hk * a.st[K][1],
                 a.st[K][2], k0, a.Sk);
    load_tile<D>(base + L::VS, a.v + b * a.st[V][0] + hk * a.st[V][1],
                 a.st[V][2], k0, a.Sk);
    prefetch(0);
    cp_commit();
    for (int i = 0; i < visits; ++i) {
      if (i + 1 < visits) {
        prefetch(i + 1);
        cp_commit();
        cp_wait<1>();
      } else {
        cp_wait<0>();
      }
      __syncthreads();
      const int buf = i & 1, q0 = (qt_lo + i % nqt) * BT;
      const uint32_t qs = base + L::QS + buf * L::TILE;
      const uint32_t dos = base + L::DOS + buf * L::TILE;
      const float* lse2 = stat + buf * BT;
      const float* dlt = stat + 2 * BT + buf * BT;
      {  // Phase A: P^T and dS^T of the warp's 16 keys x 32 queries.
        float sT[4][4], dpT[4][4];
        gemm_nt<D>(sT, base + L::KS, kr, qs, qc, lane);
        gemm_nt<D>(dpT, base + L::VS, kr, dos, qc, lane);
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int kl = kr + (lane >> 2) + 8 * half;
            const int ql = qc + 8 * j + 2 * (lane & 3);
            float p[2], ds[2];
#pragma unroll
            for (int e = 0; e < 2; ++e)
              p_ds<CAP>(sT[j][2 * half + e], dpT[j][2 * half + e],
                        lse2[ql + e], dlt[ql + e],
                        visible(q0 + ql + e, k0 + kl, a), a, p[e], ds[e]);
            *reinterpret_cast<uint32_t*>(smem + L::PS + (kl * PLD + ql) * 2) =
                pack_bf16(p[0], p[1]);
            *reinterpret_cast<uint32_t*>(smem + L::DSS +
                                         (kl * PLD + ql) * 2) =
                pack_bf16(ds[0], ds[1]);
          }
      }
      __syncthreads();
      // Phase B: dV += P^T dO, dK += dS^T Q.
      gemm_nn<D>(dv, base + L::PS, kr, dos, dc, lane);
      gemm_nn<D>(dk, base + L::DSS, kr, qs, dc, lane);
      __syncthreads();
    }
  }
  store_rows<D>(dk, a.scale, a.dk + b * a.st[DK][0] + hk * a.st[DK][1],
                a.st[DK][2], k0 + kr, dc, a.Sk, lane);
  store_rows<D>(dv, 1.0f, a.dv + b * a.st[DV][0] + hk * a.st[DV][1],
                a.st[DV][2], k0 + kr, dc, a.Sk, lane);
}

template <int D>
struct DqSmem {
  static constexpr int TILE = BT * (D + PAD) * 2;
  static constexpr int QS = 0, DOS = TILE, KS = 2 * TILE;  // KS[2], VS[2]
  static constexpr int VS = 4 * TILE, DSS = 6 * TILE;
  static constexpr int STAT = DSS + BT * PLD * 2;  // lse2[BT], delta[BT]
  static constexpr int BYTES = STAT + 2 * BT * 4;
  static_assert(BYTES <= 232448, "more shared memory than a block has");
};

template <int D, bool CAP>
__global__ void __launch_bounds__(THREADS, 1) dq_kernel(const Args a) {
  using L = DqSmem<D>;
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t base = smem_u32(smem);
  float* stat = reinterpret_cast<float*>(smem + L::STAT);

  // Longest first, as the forward: the last q tile of every (b, h), then
  // the one before.
  const int nq = (a.Sq + BT - 1) / BT;
  const int nhb = static_cast<int>(gridDim.x) / nq;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x) / nhb) * BT;
  const int hb = static_cast<int>(blockIdx.x) % nhb;
  const int h = hb % a.Hq, b = hb / a.Hq, hk = h / a.group;
  const int off = a.Sk - a.Sq, r1 = min(q0 + BT, a.Sq);
  const int k_lo = a.window > 0 ? max(0, off + q0 - a.window + 1) : 0;
  const int k_hi = a.causal ? min(a.Sk - 1, off + r1 - 1) : a.Sk - 1;
  const int kt_lo = k_lo / BT;
  const int visits = k_hi >= k_lo ? k_hi / BT - kt_lo + 1 : 0;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int qr = 16 * (warp & 3);        // the warp's 16 queries
  const int kc = 32 * (warp >> 2);       // phase A: its 32 keys
  const int dc = (D / 2) * (warp >> 2);  // phase B: its D / 2 columns
  float dq[D / 16][4];
#pragma unroll
  for (int j = 0; j < D / 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[j][e] = 0.0f;

  auto prefetch = [&](int i) {
    const int kb = (kt_lo + i) * BT, buf = i & 1;
    load_tile<D>(base + L::KS + buf * L::TILE,
                 a.k + b * a.st[K][0] + hk * a.st[K][1], a.st[K][2], kb, a.Sk);
    load_tile<D>(base + L::VS + buf * L::TILE,
                 a.v + b * a.st[V][0] + hk * a.st[V][1], a.st[V][2], kb, a.Sk);
  };

  if (visits > 0) {
    load_tile<D>(base + L::QS, a.q + b * a.st[Q][0] + h * a.st[Q][1],
                 a.st[Q][2], q0, a.Sq);
    load_tile<D>(base + L::DOS, a.dout + b * a.st[DO][0] + h * a.st[DO][1],
                 a.st[DO][2], q0, a.Sq);
    if (threadIdx.x < BT) {
      const int row = q0 + threadIdx.x;
      const long long at = (static_cast<long long>(b) * a.Hq + h) * a.Sq + row;
      stat[threadIdx.x] = row < a.Sq ? a.lse[at] * LOG2E : INFINITY;
      stat[BT + threadIdx.x] = row < a.Sq ? a.delta[at] : 0.0f;
    }
    prefetch(0);
    cp_commit();
    for (int i = 0; i < visits; ++i) {
      if (i + 1 < visits) {
        prefetch(i + 1);
        cp_commit();
        cp_wait<1>();
      } else {
        cp_wait<0>();
      }
      __syncthreads();
      const int buf = i & 1, kb = (kt_lo + i) * BT;
      const uint32_t ks = base + L::KS + buf * L::TILE;
      {  // Phase A: dS of the warp's 16 queries x 32 keys.
        float s[4][4], dp[4][4];
        gemm_nt<D>(s, base + L::QS, qr, ks, kc, lane);
        gemm_nt<D>(dp, base + L::DOS, qr, base + L::VS + buf * L::TILE, kc,
                   lane);
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int ql = qr + (lane >> 2) + 8 * half;
            const int kl = kc + 8 * j + 2 * (lane & 3);
            float p[2], ds[2];
#pragma unroll
            for (int e = 0; e < 2; ++e)
              p_ds<CAP>(s[j][2 * half + e], dp[j][2 * half + e], stat[ql],
                        stat[BT + ql], visible(q0 + ql, kb + kl + e, a), a,
                        p[e], ds[e]);
            *reinterpret_cast<uint32_t*>(smem + L::DSS +
                                         (ql * PLD + kl) * 2) =
                pack_bf16(ds[0], ds[1]);
          }
      }
      __syncthreads();
      gemm_nn<D>(dq, base + L::DSS, qr, ks, dc, lane);  // dQ += dS K
      __syncthreads();
    }
  }
  store_rows<D>(dq, a.scale, a.dq + b * a.st[DQ][0] + h * a.st[DQ][1],
                a.st[DQ][2], q0 + qr, dc, a.Sq, lane);
}

template <int D, bool CAP>
int launch(const Args& a, cudaStream_t stream) {
  const long long rows = static_cast<long long>(a.B) * a.Hq * a.Sq;
  cudaError_t err;
  if (rows > 0) {
    delta_kernel<D><<<static_cast<unsigned>((rows * 32 + 255) / 256), 256,
                      0, stream>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (a.Sk > 0) {
    err = cudaFuncSetAttribute(dkdv_kernel<D, CAP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               DkdvSmem<D>::BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((a.Sk + BT - 1) / BT * a.Hkv * a.B);
    dkdv_kernel<D, CAP><<<grid, THREADS, DkdvSmem<D>::BYTES, stream>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (a.Sq == 0) return 0;
  err = cudaFuncSetAttribute(dq_kernel<D, CAP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             DqSmem<D>::BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.Sq + BT - 1) / BT * a.Hq * a.B);
  dq_kernel<D, CAP><<<grid, THREADS, DqSmem<D>::BYTES, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// strides: 24 element strides, (batch, head, seq) of q, k, v, o, do, dq,
// dk and dv in that order; the last axis of each is contiguous, every
// stride a multiple of 8 and every start 16-byte aligned. lse: the
// forward's (B, Hq, Sq) f32; delta: a (B, Hq, Sq) f32 scratch buffer.
extern "C" int flash_attention_bwd_bf16(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* delta, void* dq, void* dk,
    void* dv, int B, int Hq, int Hkv, int Sq, int Sk, int D,
    const long long* strides, float scale, int causal, int window,
    float cap, void* stream) {
  if (B <= 0 || Sq < 0 || Sk < 0) return 0;
  if (Hkv <= 0 || Hq % Hkv || B > 65535 || Hq > 65535 ||
      static_cast<long long>((Sq + BT - 1) / BT) * Hq * B > 0x7fffffff ||
      static_cast<long long>((Sk + BT - 1) / BT) * Hkv * B > 0x7fffffff ||
      static_cast<long long>(B) * Hq * Sq * 32 / 256 > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  if (Sq == 0 && Sk == 0) return 0;
  Args a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.o = static_cast<const __nv_bfloat16*>(o);
  a.dout = static_cast<const __nv_bfloat16*>(dout);
  a.lse = lse;
  a.delta = delta;
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
  a.group = Hq / Hkv;
  a.causal = causal;
  a.window = window;
  a.scale = scale;
  a.mul = cap > 0.0f ? scale / cap : 0.0f;
  a.cexp = (cap > 0.0f ? cap : scale) * LOG2E;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 128:
      return cap > 0.0f ? launch<128, true>(a, s) : launch<128, false>(a, s);
    case 256:
      return cap > 0.0f ? launch<256, true>(a, s) : launch<256, false>(a, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

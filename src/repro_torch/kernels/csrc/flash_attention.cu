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
// o written once) take far less time than that at S = 8192.
//
// Design. The TPU kernel's grid was (B, Hq, Sq/tq, Sk/tk) with the key
// axis sequential and (m, l, acc) in VMEM. Here one block of 4 warps owns
// 64 query rows of one (b, h); a loop inside the block walks only the
// 64-key tiles of the live causal / window band (the TPU kernel's
// block-level test), so a window-W layer does O(S * W) work. Each warp
// owns 16 rows: q.k^T and p.v run on the tensor cores as mma.sync
// m16n8k16 (bf16 in, f32 accumulate); the running max m, the partial sums
// l and the (16, D) accumulator stay in registers, in f32, with the TPU
// kernel's m_safe / alpha handling of -inf and the final division by
// max(l, 1e-30). Q, K and V tiles sit in shared memory with rows padded by
// 8 elements (conflict-free fragment loads); K and V arrive by cp.async in
// two groups, so V's copy overlaps q.k^T. Tiles that straddle the band's
// edge or the ragged end of the keys are masked per element; rows past Sq
// are computed and not stored. Query tiles are scheduled last-first, so
// the longest causal rows start first. The layout comes in through element
// strides: the model passes (B, S, H, D) activations without a transpose.
// Not done yet: wgmma, TMA, a ring of tiles and warp specialisation.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;       // query rows per block
constexpr int BN = 64;       // keys per tile
constexpr int WARPS = 4;     // 16 query rows each
constexpr int THREADS = WARPS * 32;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// c (16x8 f32) += a (16x16 bf16, row) * b (16x8 bf16, col).
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 bf16 matrices from shared memory, transposed on the way.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const __nv_bfloat16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// rows x D tile of a (rows, D) slab at `src` (row stride `rs` elements)
// into shared memory (row stride D + 8); rows >= n_valid are zero-filled.
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          int64_t rs, int row0, int n_valid) {
  constexpr int LD = D + 8;
  constexpr int VPR = D / 8;  // 16-byte vectors per row
#pragma unroll
  for (int i = threadIdx.x; i < ROWS * VPR; i += THREADS) {
    const int r = i / VPR, c = (i % VPR) * 8;
    const int gr = row0 + r;
    const bool ok = gr < n_valid;
    cp_async16(dst + r * LD + c, src + (ok ? gr : 0) * rs + c, ok ? 16 : 0);
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       __nv_bfloat16* __restrict__ o, int Sq, int Sk,
                       int group, int64_t qsb, int64_t qsh, int64_t qss,
                       int64_t ksb, int64_t ksh, int64_t kss, int64_t vsb,
                       int64_t vsh, int64_t vss, int64_t osb, int64_t osh,
                       int64_t oss, float scale, int causal, int window,
                       float cap) {
  constexpr int LD = D + 8;
  constexpr int NT = D / 8;  // accumulator n-tiles
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Ks = Qs + BM * LD;
  __nv_bfloat16* Vs = Ks + BN * LD;

  const int nq = (Sq + BM - 1) / BM;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x)) * BM;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / group;
  const __nv_bfloat16* qb = q + b * qsb + h * qsh;
  const __nv_bfloat16* kb = k + b * ksb + hk * ksh;
  const __nv_bfloat16* vb = v + b * vsb + hk * vsh;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tig = lane % 4;
  const int r0 = warp * 16 + g;  // this thread's rows: r0 and r0 + 8

  load_tile<D, BM>(Qs, qb, qss, q0, Sq);
  cp_async_commit();

  // The live key band of this block's rows (TPU kernel :42-46).
  const int off = Sk - Sq;
  const int pos_lo = off + q0;
  const int pos_hi = off + min(q0 + BM, Sq) - 1;
  const int k_lo = window > 0 ? max(0, pos_lo - window + 1) : 0;
  const int k_hi = causal ? min(Sk - 1, pos_hi) : Sk - 1;
  const int t_lo = k_lo / BN;
  const int t_hi = k_hi >= k_lo ? k_hi / BN : t_lo - 1;

  float acc[NT][4];
#pragma unroll
  for (int t = 0; t < NT; ++t)
    acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.0f, 0.0f};
  const int qpos0 = off + q0 + r0;

  for (int kt = t_lo; kt <= t_hi; ++kt) {
    const int k0 = kt * BN;
    __syncthreads();  // the previous tile's K and V are no longer read
    load_tile<D, BN>(Ks, kb, kss, k0, Sk);
    cp_async_commit();
    load_tile<D, BN>(Vs, vb, vss, k0, Sk);
    cp_async_commit();
    cp_async_wait<1>();  // Q and K have landed
    __syncthreads();

    // s = q . k^T for this warp's 16 rows and the tile's 64 keys.
    float s[BN / 8][4];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      uint32_t a[4];
      const __nv_bfloat16* qa = Qs + r0 * LD + kc * 16 + tig * 2;
      a[0] = lds32(qa);
      a[1] = lds32(qa + 8 * LD);
      a[2] = lds32(qa + 8);
      a[3] = lds32(qa + 8 * LD + 8);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const __nv_bfloat16* kp = Ks + (j * 8 + g) * LD + kc * 16 + tig * 2;
        mma_bf16(s[j], a, lds32(kp), lds32(kp + 8));
      }
    }

    // Scale, softcap, mask (only where the tile meets an edge of the band).
    const bool edge = (k0 + BN > Sk) || (causal && k0 + BN - 1 > pos_lo) ||
                      (window > 0 && k0 <= off + q0 + BM - 1 - window);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale;
        if (cap > 0.0f) x = cap * tanhf(x / cap);
        if (edge) {
          const int key = k0 + j * 8 + tig * 2 + (e & 1);
          const int qpos = qpos0 + (e >> 1) * 8;
          const bool ok = key < Sk && (!causal || key <= qpos) &&
                          (window <= 0 || key > qpos - window);
          if (!ok) x = -INFINITY;
        }
        s[j][e] = x;
      }
    }

    // Online softmax, rows r0 (e = 0, 1) and r0 + 8 (e = 2, 3); the four
    // threads of a row group share each row.
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
    }
    float m_safe[2], alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      m_safe[r] = m_new == -INFINITY ? 0.0f : m_new;
      alpha[r] = m[r] == -INFINITY ? 0.0f : __expf(m[r] - m_safe[r]);
      m[r] = m_new;
    }
    float rs[2] = {0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = __expf(s[j][e] - m_safe[e >> 1]);
        rs[e >> 1] += s[j][e];
      }
    }
    l[0] = l[0] * alpha[0] + rs[0];
    l[1] = l[1] * alpha[1] + rs[1];
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      acc[t][0] *= alpha[0];
      acc[t][1] *= alpha[0];
      acc[t][2] *= alpha[1];
      acc[t][3] *= alpha[1];
    }

    cp_async_wait<0>();  // V has landed
    __syncthreads();

    // acc += p . v; p's accumulator fragments are the A operand as they are.
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const __nv_bfloat16* vrow =
          Vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
          (lane >> 4) * 8;
#pragma unroll
      for (int dt = 0; dt < D / 16; ++dt) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, vrow + dt * 16);
        mma_bf16(acc[2 * dt], pa, bv[0], bv[1]);
        mma_bf16(acc[2 * dt + 1], pa, bv[2], bv[3]);
      }
    }
  }
  cp_async_wait<0>();  // Q's copy, where the band held no tile

  // out = acc / max(l, 1e-30), rows below Sq only.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = 1.0f / fmaxf(l[r], 1e-30f);
  }
  __nv_bfloat16* ob = o + b * osb + h * osh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r0 + r * 8;
    if (row >= Sq) continue;
    __nv_bfloat16* orow = ob + row * oss + tig * 2;
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      *reinterpret_cast<uint32_t*>(orow + t * 8) =
          pack_bf16(acc[t][2 * r] * l[r], acc[t][2 * r + 1] * l[r]);
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Hq, int Hkv, int Sq, int Sk, const long long* st, float scale,
           int causal, int window, float cap, cudaStream_t stream) {
  const int smem = (BM + 2 * BN) * (D + 8) * 2;
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + BM - 1) / BM, Hq, B);
  flash_attention_kernel<D><<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      Sq, Sk, Hq / Hkv, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
      st[7], st[8], st[9], st[10], st[11], scale, causal, window, cap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// strides: 12 element strides, (batch, head, seq) of q, k, v and o in that
// order; the last axis of each is contiguous.
extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* o, int B, int Hq,
                                    int Hkv, int Sq, int Sk, int D,
                                    const long long* strides, float scale,
                                    int causal, int window, float cap,
                                    void* stream) {
  if (B <= 0 || Sq <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv || B > 65535 || Hq > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 128:
      return launch<128>(q, k, v, o, B, Hq, Hkv, Sq, Sk, strides, scale,
                         causal, window, cap, s);
    case 256:
      return launch<256>(q, k, v, o, B, Hq, Hkv, Sq, Sk, strides, scale,
                         causal, window, cap, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

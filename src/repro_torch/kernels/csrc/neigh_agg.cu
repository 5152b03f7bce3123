// neigh_softmax_agg: fused edge softmax + neighbourhood aggregation (GAT)
// on the padded-degree layout.
//
// Replaces the TPU kernel repro/kernels/neigh_agg.py:neigh_softmax_agg
// (body _agg_kernel).
//
// What it computes, for each row r (a node, or a node and head):
//   mx   = max of logits[r, j] over the live slots j (mask[r, j] != 0),
//          0 where no slot is live;
//   e_j  = exp(logits[r, j] - mx) on live slots, 0 elsewhere;
//   w_j  = e_j / max(sum_j e_j, 1e-30);
//   out[r, :] = sum_j w_j * feats[r, j, :].
// A row with no live slot gives exactly 0.
//
// What bounds it on an H100: bytes. Each row reads its MAXD logits and
// mask bytes and the D feature floats of each live slot once (32 B a slot
// at D 8, 188 B at D 47), for 2 flops a float. HBM3 fetches 64 B at a
// time, so a lone live 32-byte slot at D 8 costs 64 B; reading whole rows
// costs more still (measured: every slot live takes 1.5x the time of
// GAT's 45 %), so only live slots are read. The TPU kernel tiled 128 rows
// into VMEM and contracted every slot on the MXU. Here the limit was how
// many bytes each SM keeps in flight, so the design removes the round
// trips a row waits on:
//   - A warp owns a group of RPW = 32 / LPR rows at once (LPR lanes a row:
//     8 at D <= 32 in 16-byte vectors, so four rows at GAT's D 8; 32 at
//     D 47). Warps walk the row groups of the whole launch (a persistent
//     grid, as many blocks as are resident).
//   - A row's logits and mask (contiguous, 280 B at MAXD 56) are loaded
//     together, one slot a lane per step, never one behind the other. The
//     next group's logits and mask are issued as soon as this group's
//     weights are made, so they arrive while this group's features stream:
//     a group waits on one round trip, its features.
//   - A ballot per step packs each row's live slots, in slot order, into a
//     per-warp list of slot ids and weights in shared memory. The row's
//     lanes then split into G = LPR / LPS groups of LPS lanes a slot (D 8:
//     two lanes of float4, four slots a step; D 47: 16 lanes of three
//     floats, two slots a step), and every lane issues the loads of BATCH
//     steps (16 floats) before it adds any of them: at GAT's widths a
//     row's live features go out in two rounds, with 24 warps an SM.
//   - Only live slots' features are read, with streaming loads (each is
//     read once), and a masked slot's value (NaN included) never reaches
//     the sum (the reference's product gives NaN for it; the plain version
//     keeps that).
//   - Sums run in a fixed order: a lane adds its slots in list order, then
//     the G groups' partial sums meet in a fixed xor tree, so two runs are
//     bit-equal.
// Rows longer than CHUNK slots take CHUNK slots a pass, with the max and
// the sum found over all passes first. Columns beyond a row's lanes (more
// than 128 vectors) are split over gridDim.y. Offsets are 64-bit:
// R * MAXD * D passes 2**31 floats beyond about 816,000 rows at MAXD 56,
// D 47. kernels/ref.py's neigh_softmax_agg_grouped is this schedule on the
// CPU.
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <climits>
#include <math.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
// Three blocks an SM (at most 85 registers a thread): 24 warps. Two
// (more registers, deeper batches) and four (spills) were slower.
constexpr int BLOCKS_PER_SM = 3;
constexpr int CHUNK = 64;  // slots of a row a pass takes
constexpr unsigned FULL = 0xffffffffu;

template <int VEC>
struct Vec;
template <>
struct Vec<4> {
  using T = float4;
  static __device__ __forceinline__ T zero() {
    return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  static __device__ __forceinline__ T fma(float w, T v, T a) {
    return make_float4(fmaf(w, v.x, a.x), fmaf(w, v.y, a.y),
                       fmaf(w, v.z, a.z), fmaf(w, v.w, a.w));
  }
  static __device__ __forceinline__ T add(T a, T b) {
    return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
  }
  static __device__ __forceinline__ T shfl_xor(T a, int o) {
    return make_float4(__shfl_xor_sync(FULL, a.x, o),
                       __shfl_xor_sync(FULL, a.y, o),
                       __shfl_xor_sync(FULL, a.z, o),
                       __shfl_xor_sync(FULL, a.w, o));
  }
};
template <>
struct Vec<2> {
  using T = float2;
  static __device__ __forceinline__ T zero() { return make_float2(0.0f, 0.0f); }
  static __device__ __forceinline__ T fma(float w, T v, T a) {
    return make_float2(fmaf(w, v.x, a.x), fmaf(w, v.y, a.y));
  }
  static __device__ __forceinline__ T add(T a, T b) {
    return make_float2(a.x + b.x, a.y + b.y);
  }
  static __device__ __forceinline__ T shfl_xor(T a, int o) {
    return make_float2(__shfl_xor_sync(FULL, a.x, o),
                       __shfl_xor_sync(FULL, a.y, o));
  }
};
template <>
struct Vec<1> {
  using T = float;
  static __device__ __forceinline__ T zero() { return 0.0f; }
  static __device__ __forceinline__ T fma(float w, T v, T a) {
    return fmaf(w, v, a);
  }
  static __device__ __forceinline__ T add(T a, T b) { return a + b; }
  static __device__ __forceinline__ T shfl_xor(T a, int o) {
    return __shfl_xor_sync(FULL, a, o);
  }
};

struct Args {
  const float* logits;
  const uint8_t* mask;
  const float* feats;
  float* out;
  int64_t R;
  int MAXD, D;
  int lps;  // lanes a slot: a power of two, at most LPR
};

// Loads of step t of pass `ch` of row r: slot ch * CHUNK + t * LPR + l.
template <int LPR>
__device__ __forceinline__ void load_pass(const Args& a, int64_t r, int ch,
                                          int l, float (&lg)[CHUNK / LPR],
                                          int (&mk)[CHUNK / LPR]) {
  const bool row_ok = r < a.R;
  const int64_t base = r * a.MAXD;
#pragma unroll
  for (int t = 0; t < CHUNK / LPR; ++t) {
    const int j = ch * CHUNK + t * LPR + l;
    const bool ok = row_ok && j < a.MAXD;
    lg[t] = ok ? __ldg(a.logits + base + j) : 0.0f;
    mk[t] = ok ? __ldg(a.mask + base + j) : 0;
  }
}

// Max, then sum, over the row's LPR lanes (a fixed xor tree).
template <int LPR>
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = LPR / 2; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}
template <int LPR>
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = LPR / 2; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

template <int VEC, int KC, int LPR>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
neigh_agg_kernel(const Args a) {
  using V = Vec<VEC>;
  using VT = typename V::T;
  constexpr int RPW = 32 / LPR;          // rows a warp holds at once
  constexpr int T = CHUNK / LPR;         // logits a lane loads a pass
  // Slot steps a lane loads before it adds them: 16 floats in flight.
  constexpr int BATCH = 16 / (KC * VEC) > 1 ? 16 / (KC * VEC) : 1;
  __shared__ int list_j[WARPS][RPW * CHUNK];
  __shared__ float list_w[WARPS][RPW * CHUNK];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int q = lane / LPR;       // row of the group
  const int l = lane % LPR;       // lane within the row
  const int g = l / a.lps;        // slot group within the row
  const int c = l % a.lps;        // vector column within a slot
  const int G = LPR / a.lps;
  const unsigned row_bits = LPR == 32 ? FULL : ((1u << LPR) - 1u);
  const unsigned below = (1u << l) - 1u;
  const int units = a.D / VEC;    // vectors a slot
  const int u0 = blockIdx.y * a.lps * KC + c;
  int* lj = &list_j[warp][q * CHUNK];
  float* lw = &list_w[warp][q * CHUNK];
  const VT* fv = reinterpret_cast<const VT*>(a.feats);

  const int nch = (a.MAXD + CHUNK - 1) / CHUNK;
  const int64_t n_groups = (a.R + RPW - 1) / RPW;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * WARPS;
  int64_t gi = static_cast<int64_t>(blockIdx.x) * WARPS + warp;
  float lg[T];
  int mk[T];
  load_pass<LPR>(a, gi * RPW + q, 0, l, lg, mk);
  for (; gi < n_groups; gi += stride) {
    const int64_t r = gi * RPW + q;
    // The masked max and the sum of exponentials over every pass.
    float mx = -INFINITY;
    for (int ch = 0; ch < nch; ++ch) {
      if (ch > 0) load_pass<LPR>(a, r, ch, l, lg, mk);
#pragma unroll
      for (int t = 0; t < T; ++t)
        if (mk[t]) mx = fmaxf(mx, lg[t]);
    }
    mx = row_max<LPR>(mx);
    if (mx == -INFINITY) mx = 0.0f;
    float den = 0.0f;
    for (int ch = 0; ch < nch; ++ch) {
      if (nch > 1) load_pass<LPR>(a, r, ch, l, lg, mk);
#pragma unroll
      for (int t = 0; t < T; ++t)
        if (mk[t]) den += expf(lg[t] - mx);
    }
    den = fmaxf(row_sum<LPR>(den), 1e-30f);

    VT acc[KC];
#pragma unroll
    for (int k = 0; k < KC; ++k) acc[k] = V::zero();
    const VT* fr = fv + r * a.MAXD * units + u0;
    for (int ch = 0; ch < nch; ++ch) {
      if (nch > 1) load_pass<LPR>(a, r, ch, l, lg, mk);
      // This pass's live slots of each row, in slot order.
      int cnt = 0;
#pragma unroll
      for (int t = 0; t < T; ++t) {
        const unsigned bits =
            (__ballot_sync(FULL, mk[t] != 0) >> (q * LPR)) & row_bits;
        if (mk[t]) {
          const int s = cnt + __popc(bits & below);
          lj[s] = ch * CHUNK + t * LPR + l;
          lw[s] = expf(lg[t] - mx) / den;
        }
        cnt += __popc(bits);
      }
      __syncwarp();
      // The weights are made: the next group's logits and mask go out now
      // and arrive while this group's features stream.
      if (ch == nch - 1)
        load_pass<LPR>(a, (gi + stride) * RPW + q, 0, l, lg, mk);
      for (int k0 = 0; __any_sync(FULL, k0 * G < cnt); k0 += BATCH) {
        VT v[BATCH][KC];
        float w[BATCH];
#pragma unroll
        for (int b = 0; b < BATCH; ++b) {
          const int s = (k0 + b) * G + g;
          const bool live = s < cnt;
          w[b] = live ? lw[s] : 0.0f;
          const VT* p = fr + static_cast<int64_t>(live ? lj[s] : 0) * units;
#pragma unroll
          for (int k = 0; k < KC; ++k)
            v[b][k] = (live && u0 + a.lps * k < units)
                          ? __ldcs(p + a.lps * k) : V::zero();
        }
#pragma unroll
        for (int b = 0; b < BATCH; ++b)
#pragma unroll
          for (int k = 0; k < KC; ++k) acc[k] = V::fma(w[b], v[b][k], acc[k]);
      }
      __syncwarp();  // the list is rewritten by the next pass or group
    }
    // The row's G groups' partial sums, in a fixed xor tree.
#pragma unroll
    for (int k = 0; k < KC; ++k)
      for (int o = a.lps; o < LPR; o <<= 1)
        acc[k] = V::add(acc[k], V::shfl_xor(acc[k], o));
    if (r < a.R && g == 0) {
      VT* o = reinterpret_cast<VT*>(a.out) + r * units + u0;
#pragma unroll
      for (int k = 0; k < KC; ++k)
        if (u0 + a.lps * k < units) o[a.lps * k] = acc[k];
    }
  }
}

template <int VEC, int KC, int LPR>
cudaError_t launch(const Args& a, unsigned tiles, cudaStream_t st) {
  // Resident blocks a card: found once per process for each instance.
  static int resident = 0;
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, neigh_agg_kernel<VEC, KC, LPR>, THREADS, 0);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    resident = per_sm * sms;
  }
  constexpr int RPW = 32 / LPR;
  const int64_t blocks = std::min<int64_t>(
      (a.R + int64_t{RPW} * WARPS - 1) / (int64_t{RPW} * WARPS),
      std::max<int64_t>(resident / static_cast<int64_t>(tiles), 1));
  neigh_agg_kernel<VEC, KC, LPR>
      <<<dim3(static_cast<unsigned>(blocks), tiles), THREADS, 0, st>>>(a);
  return cudaGetLastError();
}

template <int VEC>
cudaError_t dispatch(const Args& a, cudaStream_t st) {
  const int units = a.D / VEC;
  if (units <= 32) {
    // LPS lanes a slot, the next power of two; at least 8 lanes a row.
    int lps = 1;
    while (lps < units) lps <<= 1;
    Args b = a;
    b.lps = lps;
    if (lps <= 8) return launch<VEC, 1, 8>(b, 1, st);
    if (lps == 16) return launch<VEC, 1, 16>(b, 1, st);
    return launch<VEC, 1, 32>(b, 1, st);
  }
  Args b = a;
  if (units <= 48) {  // D 47: 16 lanes x 3 columns, two slots a step
    b.lps = 16;
    return launch<VEC, 3, 32>(b, 1, st);
  }
  b.lps = 32;
  if (units <= 64) return launch<VEC, 2, 32>(b, 1, st);
  const int64_t tiles = (units + 127) / 128;
  if (tiles > 65535) return cudaErrorInvalidValue;
  return launch<VEC, 4, 32>(b, static_cast<unsigned>(tiles), st);
}

}  // namespace

extern "C" int neigh_softmax_agg(const void* logits, const void* mask,
                                 const void* feats, void* out, long long R,
                                 int MAXD, int D, void* stream) {
  if (R <= 0 || D <= 0) return 0;
  if (MAXD <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const float*>(logits),
               static_cast<const uint8_t*>(mask),
               static_cast<const float*>(feats), static_cast<float*>(out),
               R, MAXD, D, 1};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  // The widest vector that every slot's and every output row's start
  // keeps aligned.
  const uintptr_t al = reinterpret_cast<uintptr_t>(feats) |
                       reinterpret_cast<uintptr_t>(out);
  cudaError_t err;
  if (D % 4 == 0 && al % 16 == 0)
    err = dispatch<4>(a, st);
  else if (D % 2 == 0 && al % 8 == 0)
    err = dispatch<2>(a, st);
  else
    err = dispatch<1>(a, st);
  return static_cast<int>(err);
}

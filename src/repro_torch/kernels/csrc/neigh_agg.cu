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
// mask bytes and the D feature floats of each live slot once (188 B a slot
// at D 47), for 2 flops a float. The TPU kernel tiled 128 rows into VMEM
// and contracted every slot on the MXU; here one warp owns one row: a
// first pass over the row's MAXD logits (32 slots a step) finds the max
// and the sum, then the features of the live slots only, in chunks of 32
// slots: a ballot packs each chunk's live slots, in slot order, into a
// per-warp list of slot ids and weights in shared memory, and the warp
// streams just those slots. A masked slot's features are never read, so a
// non-finite value there does not reach the output (the reference's
// product gives NaN for it; the plain version keeps that). Lanes lie along
// D: for D <= 32, 32 / D groups of D lanes take every (32/D)-th live slot
// (D = 8: four slots a step, all 32 lanes busy), and their partial sums
// are added in group order; for D > 32 each lane takes the columns
// lane + 32k, k < KC, of a column tile of 32 * KC (D = 47: two columns a
// lane, one tile). Slots go in a fixed order, so the result is the same in
// every run. UNROLL slots' loads are issued before they are added, so
// several lines are in flight per lane.
//
// Offsets are 64-bit: R * MAXD * D passes 2**31 floats beyond about
// 816,000 rows at MAXD 56, D 47.
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>
#include <math.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int UNROLL = 4;
constexpr unsigned FULL = 0xffffffffu;

template <int KC>
__global__ void __launch_bounds__(THREADS)
neigh_agg_kernel(const float* __restrict__ logits,
                 const uint8_t* __restrict__ mask,
                 const float* __restrict__ feats, float* __restrict__ out,
                 int64_t R, int MAXD, int D, int dw, int groups) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t r = static_cast<int64_t>(blockIdx.x) * WARPS + warp;
  if (r >= R) return;  // whole warps leave together
  __shared__ int live_slot[WARPS][32];
  __shared__ float live_w[WARPS][32];
  const float* lg = logits + r * MAXD;
  const uint8_t* mk = mask + r * MAXD;

  // Pass 1: the masked max, then the sum of the exponentials.
  float mx = -INFINITY;
  for (int j = lane; j < MAXD; j += 32)
    if (mk[j]) mx = fmaxf(mx, lg[j]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, o));
  if (mx == -INFINITY) mx = 0.0f;
  float den = 0.0f;
  for (int j = lane; j < MAXD; j += 32)
    if (mk[j]) den += expf(lg[j] - mx);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) den += __shfl_xor_sync(FULL, den, o);
  den = fmaxf(den, 1e-30f);

  // Pass 2: stream the features. Lane = (group g, column c).
  const int g = lane / dw;
  const int c = lane - g * dw;
  const bool active = g < groups;
  const int col0 = blockIdx.y * 32 * KC + c;
  const float* fr = feats + r * MAXD * static_cast<int64_t>(D) + col0;
  float acc[KC];
#pragma unroll
  for (int k = 0; k < KC; ++k) acc[k] = 0.0f;
  for (int base = 0; base < MAXD; base += 32) {
    const int j_own = base + lane;
    const bool own_live = j_own < MAXD && mk[j_own];
    const unsigned bits = __ballot_sync(FULL, own_live);
    const int cnt = __popc(bits);
    if (own_live) {
      const int rank = __popc(bits & ((1u << lane) - 1u));
      live_slot[warp][rank] = j_own;
      live_w[warp][rank] = expf(lg[j_own] - mx) / den;
    }
    __syncwarp();
    for (int s0 = 0; s0 < cnt; s0 += groups * UNROLL) {
      float v[UNROLL][KC];
      float w[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int s = s0 + u * groups + g;
        const bool live = active && s < cnt;
        w[u] = live ? live_w[warp][s] : 0.0f;
        const float* p =
            fr + static_cast<int64_t>(live ? live_slot[warp][s] : 0) * D;
#pragma unroll
        for (int k = 0; k < KC; ++k)
          v[u][k] = (live && col0 + 32 * k < D) ? p[32 * k] : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
#pragma unroll
        for (int k = 0; k < KC; ++k) acc[k] = fmaf(w[u], v[u][k], acc[k]);
    }
    __syncwarp();  // the list is rewritten by the next chunk
  }
  // Add the groups' partial sums in group order into group 0's lanes.
#pragma unroll
  for (int k = 0; k < KC; ++k) {
    float tot = acc[k];
    for (int q = 1; q < groups; ++q)
      tot += __shfl_sync(FULL, acc[k], c + q * dw);
    acc[k] = tot;
  }
  if (g == 0) {
    float* o = out + r * D;
#pragma unroll
    for (int k = 0; k < KC; ++k)
      if (col0 + 32 * k < D) o[col0 + 32 * k] = acc[k];
  }
}

}  // namespace

extern "C" int neigh_softmax_agg(const void* logits, const void* mask,
                                 const void* feats, void* out, long long R,
                                 int MAXD, int D, void* stream) {
  if (R <= 0 || D <= 0) return 0;
  if (MAXD <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = (R + WARPS - 1) / WARPS;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* lg = static_cast<const float*>(logits);
  const uint8_t* mk = static_cast<const uint8_t*>(mask);
  const float* ft = static_cast<const float*>(feats);
  float* o = static_cast<float*>(out);
  if (D <= 32) {
    neigh_agg_kernel<1><<<dim3(static_cast<unsigned>(blocks), 1), THREADS,
                          0, st>>>(lg, mk, ft, o, R, MAXD, D, D, 32 / D);
  } else {
    constexpr int KC = 2;
    const unsigned tiles = static_cast<unsigned>((D + 32 * KC - 1) /
                                                 (32 * KC));
    if (tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
    neigh_agg_kernel<KC><<<dim3(static_cast<unsigned>(blocks), tiles),
                           THREADS, 0, st>>>(lg, mk, ft, o, R, MAXD, D, 32,
                                             1);
  }
  return static_cast<int>(cudaGetLastError());
}

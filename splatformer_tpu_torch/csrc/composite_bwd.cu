// Tile alpha-compositing backward (K2) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel `bwd_kernel` of
// splatformer_tpu/ops/pallas/raster.py (_make_calls, launched by
// pl.pallas_call there). Inputs are K1's: entries depth-sorted and packed
// transposed as (16, budget) f32 rows [x, y, conic0, conic1, conic2,
// opacity, r, g, b, pad...], tile t owning the unpadded range
// [tile_start[t], tile_start[t+1]); plus K1's saved out (num_tiles, 256, 4)
// = [sum rgb, T], its walked (num_tiles, 256) counts and the cotangent
// g_out (num_tiles, 256, 4).
//
// Output: d_packed (16, budget), zeroed by the caller over the whole
// budget; this kernel writes rows 0-8 = [dx, dy, dconic0, dconic1,
// dconic2, dopacity, dr, dg, db] of the entries its tiles replay. Each
// pixel replays exactly its first `walked` entries; an entry with alpha
// below the threshold contributes nothing, and the terminating entry (the
// pixel's `walked`-th) is never reached. gsplat's back-to-front suffix
// sums are recovered front to back from S_total = g_rgb . rgb_acc:
//   da = T_excl (g_rgb . c) - (S_total - sum_{i<=j} g_rgb . c_i vis_i
//                              + g_T T_final) / (1 - a).
// The max-alpha clamp gates d-alpha (raw < max_alpha); the sigma clamp at
// 0 takes the full derivative (raster.py, the NOTE in _chunk_quantities).
//
// What bounds it on this card: FP32 work over the live (pixel, entry)
// pairs (alpha at or above the threshold), about 18 operations to recompute
// sigma and alpha and ~46 more: the T and S recurrences, d-alpha, d-sigma,
// the 9 products and their sums over the tile's pixels. Bytes are small: 9
// floats read and 9 written per entry, 36 bytes read per pixel. Built with
// -fmad=false (each pixel's values round as the plain version's separate
// operations do), so no product fuses and the FP32 pipes run at half the
// rate the 67 TFLOP/s peak counts; only 8% of the replayed pairs are live,
// so skipping dead ones is the way down.
//
// Design (layout, staging, cull and tile order: composite_common.cuh, as
// in K1): entries are staged in batches of kBatch by cp.async into one of
// two shared buffers while the other is consumed, and the CTA computes the
// exact keep bit per (entry, warp box). A culled entry is dead at every
// pixel of the box, so its contribution there is exactly zero. Each warp
// replays only its kept entries below its longest walk, kGroup at a time:
// sigma and alpha of the group first (instruction-level parallelism), then
// each pixel's serial T and S updates and its 9 values per entry, and one
// reduction of the group's 27 values over the warp by halving exchanges
// (31 shuffles; lane l ends with slot l's sum, in a fixed order). An entry
// column belongs to exactly one tile, so the per-entry sum over the tile's
// pixels needs no atomics: each warp parks its partials of its kept entries
// in shared memory, and after the batch one thread per (row, entry) adds
// the partials of the warps that replayed it, in warp order, and does one
// plain store. A tile stops after its longest walk; columns past it keep
// the caller's zeros. Tiles are taken heaviest first, so the longest
// replays do not trail the launch. Deterministic: every sum has a fixed
// order.
#include "composite_common.cuh"

namespace {

constexpr int kBatch = 64;               // entries staged per batch
constexpr int kGroup = 3;                // entries reduced together
constexpr int kSlots = 32;               // kGroup * kRows values, padded
constexpr int kPartStride = kBatch + 1;  // conflict-free partial stores
static_assert(kGroup * kRows <= kSlots, "a group's values fill the slots");

// One halving step of the warp reduction: lanes with bit `kWidth` set keep
// the upper half of v[0, 2 kWidth), the others the lower half, each adding
// its partner's copy.
template <int kWidth>
__device__ __forceinline__ void halve(float (&v)[kSlots], int lane) {
  const bool up = lane & kWidth;
#pragma unroll
  for (int i = 0; i < kWidth; ++i) {
    const float send = up ? v[i] : v[i + kWidth];
    const float keep = up ? v[i + kWidth] : v[i];
    v[i] = keep + __shfl_xor_sync(kFull, send, kWidth);
  }
}

__global__ void __launch_bounds__(kPixels)
composite_bwd_kernel(const float* __restrict__ packed, long long budget,
                     const int* __restrict__ tile_start, int tiles_x,
                     int tiles_img, float alpha_threshold, float max_alpha,
                     const float* __restrict__ out,
                     const int* __restrict__ walked,
                     const float* __restrict__ g_out,
                     float* __restrict__ d_packed) {
  __shared__ Batch<kBatch> s_ent[2];
  __shared__ uint8_t s_keep[kWarps][kBatch];
  __shared__ float s_part[kWarps][kRows][kPartStride];
  __shared__ int s_wmax[kWarps];

  const int t = heaviest_first(tile_start);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int local = t % tiles_img;
  const int tx0 = (local % tiles_x) * kTile;
  const int ty0 = (local / tiles_x) * kTile;
  const int col = 8 * (warp & 1) + (lane & 7);
  const int row = 4 * (warp >> 1) + (lane >> 3);
  const float px = static_cast<float>(tx0 + col);
  const float py = static_cast<float>(ty0 + row);
  const int start = tile_start[t];
  const long long pix = static_cast<long long>(t) * kPixels + row * kTile + col;
  const int n_walk = walked[pix];
  const float thr_cull = cull_threshold(alpha_threshold);

  const int wmax = __reduce_max_sync(kFull, n_walk);
  if (lane == 0) s_wmax[warp] = wmax;
  __syncthreads();
  int longest = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) longest = max(longest, s_wmax[w]);
  const int stop = start + longest;

  const float g0 = g_out[pix * 4 + 0];
  const float g1 = g_out[pix * 4 + 1];
  const float g2 = g_out[pix * 4 + 2];
  const float gt_term = g_out[pix * 4 + 3] * out[pix * 4 + 3];
  float s_rem = g0 * out[pix * 4 + 0] + g1 * out[pix * 4 + 1]
                + g2 * out[pix * 4 + 2];
  float T = 1.f;

  if (start < stop) stage(s_ent[0], packed, budget, start, min(kBatch, stop - start));
  for (int base = start, buf = 0; base < stop; base += kBatch, buf ^= 1) {
    const int n = min(kBatch, stop - base);
    cp_async_wait_all();
    // barrier: this batch has landed for every thread, and the previous
    // batch's keep bits and partials are consumed
    __syncthreads();
    const Batch<kBatch>& s = s_ent[buf];
    cull_batch(s, n, tx0, ty0, thr_cull, s_keep);
    if (base + kBatch < stop) {
      stage(s_ent[buf ^ 1], packed, budget, base + kBatch,
            min(kBatch, stop - base - kBatch));
    }
    __syncthreads();

    // this warp's pixels replay entries j < limit of the batch
    const int limit = min(n, wmax - (base - start));
    for (int c = 0; c * 32 < limit; ++c) {
      unsigned word = __ballot_sync(
          kFull, c * 32 + lane < limit && s_keep[warp][c * 32 + lane] != 0);
      while (word) {  // warp-uniform
        int jj[kGroup];
        float4 ea[kGroup], eb[kGroup];
        float ex[kGroup], raw[kGroup], alpha[kGroup], dx[kGroup], dy[kGroup];
#pragma unroll
        for (int q = 0; q < kGroup; ++q) {
          jj[q] = word ? c * 32 + __ffs(word) - 1 : -1;
          word &= word - 1;
        }
#pragma unroll
        for (int q = 0; q < kGroup; ++q) {
          const int j = jj[q] >= 0 ? jj[q] : jj[0];
          ea[q] = s.a[j];
          eb[q] = s.b[j];
          dx[q] = ea[q].x - px;
          dy[q] = ea[q].y - py;
          float sigma = 0.5f * (ea[q].z * dx[q] * dx[q]
                                + eb[q].x * dy[q] * dy[q])
                        + ea[q].w * dx[q] * dy[q];
          sigma = fmaxf(sigma, 0.f);
          ex[q] = expf(-sigma);
          raw[q] = eb[q].y * ex[q];
          alpha[q] = fminf(max_alpha, raw[q]);
        }
        float v[kSlots];
#pragma unroll
        for (int i = 0; i < kSlots; ++i) v[i] = 0.f;
        bool any = false;
#pragma unroll
        for (int q = 0; q < kGroup; ++q) {
          if (jj[q] < 0 || base - start + jj[q] >= n_walk
              || alpha[q] < alpha_threshold) {
            continue;
          }
          any = true;
          const float c0 = ea[q].z, c1 = ea[q].w, c2 = eb[q].x;
          const float gc = g0 * eb[q].z + g1 * eb[q].w + g2 * s.c[jj[q]];
          const float vis = alpha[q] * T;
          s_rem = s_rem - gc * vis;
          const float da = T * gc - (s_rem + gt_term) / (1.f - alpha[q]);
          T = T * (1.f - alpha[q]);
          float* vq = v + q * kRows;
          if (raw[q] < max_alpha) {
            const float dsig = -raw[q] * da;
            vq[0] = dsig * (c0 * dx[q] + c1 * dy[q]);
            vq[1] = dsig * (c1 * dx[q] + c2 * dy[q]);
            vq[2] = 0.5f * dsig * dx[q] * dx[q];
            vq[3] = dsig * dx[q] * dy[q];
            vq[4] = 0.5f * dsig * dy[q] * dy[q];
            vq[5] = da * ex[q];
          }
          vq[6] = g0 * vis;
          vq[7] = g1 * vis;
          vq[8] = g2 * vis;
        }
        if (__any_sync(kFull, any)) {
          halve<16>(v, lane);
          halve<8>(v, lane);
          halve<4>(v, lane);
          halve<2>(v, lane);
          halve<1>(v, lane);
        }
        // lane l holds slot l's sum: row l % 9 of group entry l / 9 (all
        // zeros when no lane replayed the group live)
        if (lane < kGroup * kRows) {
          const int q = lane / kRows;
          const int j = q == 0 ? jj[0] : (q == 1 ? jj[1] : jj[2]);
          if (j >= 0) s_part[warp][lane - q * kRows][j] = v[0];
        }
      }
    }
    __syncthreads();

    for (int i = tid; i < kRows * kBatch; i += kPixels) {
      const int k = i / kBatch;
      const int e = i % kBatch;
      if (e < n) {
        const int rel = base - start + e;
        float acc = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
          if (s_keep[w][e] && rel < s_wmax[w]) acc += s_part[w][k][e];
        }
        d_packed[k * budget + base + e] = acc;
      }
    }
  }
}

}  // namespace

// Plain C entry point for ctypes. Launches on `stream` and does not
// synchronise; returns the launch's cudaError_t (0 = cudaSuccess).
extern "C" int composite_bwd(const float* packed, long long budget,
                             const int* tile_start, int num_tiles,
                             int tiles_x, int tiles_img,
                             float alpha_threshold, float max_alpha,
                             const float* out, const int* walked,
                             const float* g_out, float* d_packed,
                             void* stream) {
  if (num_tiles > 0) {
    composite_bwd_kernel<<<num_tiles, kPixels, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        packed, budget, tile_start, tiles_x, tiles_img, alpha_threshold,
        max_alpha, out, walked, g_out, d_packed);
  }
  return static_cast<int>(cudaGetLastError());
}

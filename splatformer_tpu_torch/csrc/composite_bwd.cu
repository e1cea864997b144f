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
// What bounds it on this card: FP32 work over the replayed (pixel, entry)
// pairs -- K1's ~18 operations to recompute sigma and alpha for every one,
// and for each live pair (alpha above the threshold) ~46 more: the T and S
// recurrences, d-alpha, d-sigma, the 9 products and their sums over the
// tile's pixels -- plus a 9-value warp reduction per entry and warp.
// Bytes are small: 9 floats read and 9 written per entry, 36 bytes read
// per pixel. Design: one CTA per 16x16 tile, one thread per pixel, entries
// staged through shared memory in batches of 128. An entry column belongs
// to exactly one tile (entries are (Gaussian, tile) pairs and tile ranges
// are disjoint), so the per-entry sum over 256 pixels is local to the CTA
// and needs no atomics: each warp reduces the 9 values with shuffles (and
// skips the shuffles when none of its lanes contributes), lane 0 parks
// the warp partial in shared memory, and after the batch one thread per
// entry adds the 8 partials and does a plain store. The TPU kernel's seam
// read-add-write existed only because its sequential grid shared DMA
// chunks between tiles; it has no counterpart here. A tile stops after its
// longest `walked`; the columns past it keep the caller's zeros. Built
// with -fmad=false, so each pixel's values round exactly as the plain
// PyTorch version's separate operations do; only the order of the sum
// over pixels differs.
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;
constexpr int kPixels = kTile * kTile;  // threads per CTA
constexpr int kWarps = kPixels / 32;
constexpr int kBatch = 128;             // entries staged per batch
constexpr int kRows = 9;                // attribute rows used of the 16

__global__ void __launch_bounds__(kPixels)
composite_bwd_kernel(const float* __restrict__ packed, long long budget,
                     const int* __restrict__ tile_start, int tiles_x,
                     int tiles_img, float alpha_threshold, float max_alpha,
                     const float* __restrict__ out,
                     const int* __restrict__ walked,
                     const float* __restrict__ g_out,
                     float* __restrict__ d_packed) {
  __shared__ float s_ent[kRows][kBatch];
  __shared__ float s_part[kWarps][kRows][kBatch];
  __shared__ int s_max_walked;

  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int lane = p & 31;
  const int warp = p >> 5;
  const int local = t % tiles_img;
  const float px = static_cast<float>((local % tiles_x) * kTile + p % kTile);
  const float py = static_cast<float>((local / tiles_x) * kTile + p / kTile);
  const int start = tile_start[t];
  const long long pix = static_cast<long long>(t) * kPixels + p;
  const int n_walk = walked[pix];

  if (p == 0) s_max_walked = 0;
  __syncthreads();
  atomicMax(&s_max_walked, n_walk);
  __syncthreads();
  const int stop = start + s_max_walked;

  const float g0 = g_out[pix * 4 + 0];
  const float g1 = g_out[pix * 4 + 1];
  const float g2 = g_out[pix * 4 + 2];
  const float gt_term = g_out[pix * 4 + 3] * out[pix * 4 + 3];
  float s_rem = g0 * out[pix * 4 + 0] + g1 * out[pix * 4 + 1]
                + g2 * out[pix * 4 + 2];
  float T = 1.f;

  for (int base = start; base < stop; base += kBatch) {
    const int n = min(kBatch, stop - base);
    // barrier: the previous batch's entries and partials are consumed
    __syncthreads();
    for (int i = p; i < kRows * kBatch; i += kPixels) {
      const int k = i / kBatch;
      const int jj = i % kBatch;
      if (jj < n) s_ent[k][jj] = packed[k * budget + base + jj];
    }
    __syncthreads();
    for (int jj = 0; jj < n; ++jj) {
      float v[kRows];
#pragma unroll
      for (int k = 0; k < kRows; ++k) v[k] = 0.f;
      bool live = false;
      if (base + jj - start < n_walk) {
        const float dx = s_ent[0][jj] - px;
        const float dy = s_ent[1][jj] - py;
        const float c0 = s_ent[2][jj];
        const float c1 = s_ent[3][jj];
        const float c2 = s_ent[4][jj];
        float sigma = 0.5f * (c0 * dx * dx + c2 * dy * dy) + c1 * dx * dy;
        sigma = fmaxf(sigma, 0.f);
        const float ex = expf(-sigma);
        const float raw = s_ent[5][jj] * ex;
        const float alpha = fminf(max_alpha, raw);
        if (alpha >= alpha_threshold) {
          live = true;
          const float gc = g0 * s_ent[6][jj] + g1 * s_ent[7][jj]
                           + g2 * s_ent[8][jj];
          const float vis = alpha * T;
          s_rem = s_rem - gc * vis;
          const float da = T * gc - (s_rem + gt_term) / (1.f - alpha);
          T = T * (1.f - alpha);
          if (raw < max_alpha) {
            const float dsig = -raw * da;
            v[0] = dsig * (c0 * dx + c1 * dy);
            v[1] = dsig * (c1 * dx + c2 * dy);
            v[2] = 0.5f * dsig * dx * dx;
            v[3] = dsig * dx * dy;
            v[4] = 0.5f * dsig * dy * dy;
            v[5] = da * ex;
          }
          v[6] = g0 * vis;
          v[7] = g1 * vis;
          v[8] = g2 * vis;
        }
      }
      // warp-uniform: every lane iterates the same jj
      if (__any_sync(0xffffffffu, live)) {
#pragma unroll
        for (int k = 0; k < kRows; ++k) {
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) {
            v[k] += __shfl_xor_sync(0xffffffffu, v[k], off);
          }
        }
      }
      if (lane == 0) {
#pragma unroll
        for (int k = 0; k < kRows; ++k) s_part[warp][k][jj] = v[k];
      }
    }
    __syncthreads();
    if (p < n) {
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        float acc = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) acc += s_part[w][k][p];
        d_packed[k * budget + base + p] = acc;
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

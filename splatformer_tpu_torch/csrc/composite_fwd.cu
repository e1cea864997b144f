// Tile alpha-compositing forward (K1) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel `fwd_kernel` of
// splatformer_tpu/ops/pallas/raster.py (_make_calls, launched by
// pl.pallas_call there). Same contract: entries are depth-sorted and packed
// transposed as (16, budget) f32 rows [x, y, conic0, conic1, conic2,
// opacity, r, g, b, pad...]; tile t owns the UNPADDED entry range
// [tile_start[t], tile_start[t+1]); V views are flattened into one grid of
// num_tiles = V * tiles_img tiles, and tile t's pixel p is
// (tx * 16 + p % 16, ty * 16 + p / 16) of view t / tiles_img.
//
// Per (pixel, entry): sigma = 0.5 (c0 dx^2 + c2 dy^2) + c1 dx dy clamped at
// 0, alpha = min(max_alpha, op exp(-sigma)), skipped below alpha_threshold;
// front-to-back compositing that breaks BEFORE the entry that would take
// T to <= transmittance_eps (gsplat v0.1.11 forward.cu).
//
// Outputs: out (num_tiles, 256, 4) = [sum rgb, T] and walked
// (num_tiles, 256) int32 = how many leading entries of the tile's range the
// pixel consumed (composited or skipped below the alpha threshold): the
// index of the terminating entry, or the range length if the pixel never
// terminated. It replaces the TPU kernel's per-tile kstop for the backward.
//
// What bounds it on this card: FP32 and SFU work over (pixel, entry) pairs,
// about 25 operations and one expf per pair, against 9 floats read per
// entry and 20 bytes written per pixel -- operations, not bytes. Design:
// one CTA per 16x16 tile, one thread per pixel (gsplat's layout); entries
// are staged through shared memory in batches of 256, one coalesced load
// per attribute row per thread, so each entry is read from device memory
// once per tile; a CTA leaves as soon as every pixel has terminated
// (__syncthreads_count). sigma is the direct per-pixel quadratic: the TPU
// kernel's expanded quadratic and log-domain triangular matmuls existed
// only to feed the TPU's matrix unit. The build uses -fmad=false so every
// product and sum rounds as the plain PyTorch version's separate ops do.
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;
constexpr int kPixels = kTile * kTile;  // threads per CTA = entries per batch
constexpr int kRows = 9;                // attribute rows used of the 16

__global__ void __launch_bounds__(kPixels)
composite_fwd_kernel(const float* __restrict__ packed, long long budget,
                     const int* __restrict__ tile_start, int tiles_x,
                     int tiles_img, float alpha_threshold, float max_alpha,
                     float transmittance_eps, float* __restrict__ out,
                     int* __restrict__ walked) {
  __shared__ float s_ent[kRows][kPixels];

  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int local = t % tiles_img;
  const float px = static_cast<float>((local % tiles_x) * kTile + p % kTile);
  const float py = static_cast<float>((local / tiles_x) * kTile + p / kTile);
  const int start = tile_start[t];
  const int end = tile_start[t + 1];

  float r = 0.f, g = 0.f, b = 0.f, T = 1.f;
  int n_walked = 0;
  int done = 0;

  for (int base = start; base < end; base += kPixels) {
    // barrier: the previous batch is consumed by every thread before the
    // shared buffer is overwritten, and the whole tile leaves together
    if (__syncthreads_count(done) == kPixels) break;
    const int idx = base + p;
    if (idx < end) {
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        s_ent[k][p] = packed[k * budget + idx];
      }
    }
    __syncthreads();
    const int n = min(kPixels, end - base);
    for (int j = 0; j < n && !done; ++j) {
      const float dx = s_ent[0][j] - px;
      const float dy = s_ent[1][j] - py;
      const float c0 = s_ent[2][j];
      const float c1 = s_ent[3][j];
      const float c2 = s_ent[4][j];
      float sigma = 0.5f * (c0 * dx * dx + c2 * dy * dy) + c1 * dx * dy;
      sigma = fmaxf(sigma, 0.f);
      const float alpha = fminf(max_alpha, s_ent[5][j] * expf(-sigma));
      if (alpha < alpha_threshold) {
        ++n_walked;
        continue;
      }
      const float next_T = T * (1.f - alpha);
      if (next_T <= transmittance_eps) {
        done = 1;
        break;
      }
      const float vis = alpha * T;
      r = r + vis * s_ent[6][j];
      g = g + vis * s_ent[7][j];
      b = b + vis * s_ent[8][j];
      T = next_T;
      ++n_walked;
    }
  }

  float* o = out + (static_cast<long long>(t) * kPixels + p) * 4;
  o[0] = r;
  o[1] = g;
  o[2] = b;
  o[3] = T;
  walked[static_cast<long long>(t) * kPixels + p] = n_walked;
}

}  // namespace

// Plain C entry point for ctypes. Launches on `stream` and does not
// synchronise; returns the launch's cudaError_t (0 = cudaSuccess).
extern "C" int composite_fwd(const float* packed, long long budget,
                             const int* tile_start, int num_tiles, int tiles_x,
                             int tiles_img, float alpha_threshold,
                             float max_alpha, float transmittance_eps,
                             float* out, int* walked, void* stream) {
  if (num_tiles > 0) {
    composite_fwd_kernel<<<num_tiles, kPixels, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        packed, budget, tile_start, tiles_x, tiles_img, alpha_threshold,
        max_alpha, transmittance_eps, out, walked);
  }
  return static_cast<int>(cudaGetLastError());
}

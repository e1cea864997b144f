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
// What bounds it on this card: the work any correct kernel must do is
// small -- 9 floats read per entry, 20 bytes written per pixel, and about
// 18 operations for each live pair (alpha at or above the threshold) --
// and bytes bind it. Evaluating every walked pair instead costs about 25
// operations and one expf a pair, and the build uses -fmad=false, so that
// every product and sum rounds as the plain PyTorch version's separate ops
// do (walked and out bit for bit): no product fuses, and the FP32 pipes
// issue half the operations a clock that the 67 TFLOP/s peak counts. Most
// walked pairs are dead, so the way down is not to evaluate them.
//
// Design (layout, staging, cull and tile order: composite_common.cuh):
// entries are staged in batches of kBatch by cp.async into one of two
// shared buffers while the other is consumed. For each batch the CTA
// computes a keep bit per (entry, warp box) by the exact cull; each warp
// walks only its kept entries (ballot words, set bits in order), and the
// culled ones are counted in walked by construction (walked is the index of
// the terminating entry, or the range length). Each step evaluates sigma
// and alpha for kGroup kept entries before their serial T and rgb updates,
// for instruction-level parallelism; the arithmetic of each pair is the
// plain version's, in its order (two at a time measured faster than one
// or four: composite_experiments.py). A warp stops when all its pixels
// have terminated, the CTA when all 256 have (__syncthreads_count). Tiles
// are taken heaviest first, so the longest walks do not trail the launch.
#include "composite_common.cuh"

namespace {

constexpr int kBatch = 128;  // entries staged per batch
constexpr int kGroup = 2;    // kept entries evaluated together

__global__ void __launch_bounds__(kPixels)
composite_fwd_kernel(const float* __restrict__ packed, long long budget,
                     const int* __restrict__ tile_start, int tiles_x,
                     int tiles_img, float alpha_threshold, float max_alpha,
                     float transmittance_eps, float* __restrict__ out,
                     int* __restrict__ walked) {
  __shared__ Batch<kBatch> s_ent[2];
  __shared__ uint8_t s_keep[kWarps][kBatch];

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
  const int end = tile_start[t + 1];
  const float thr_cull = cull_threshold(alpha_threshold);

  float r = 0.f, g = 0.f, b = 0.f, T = 1.f;
  int n_walked = end - start;  // unless the pixel terminates
  int done = 0;

  if (start < end) stage(s_ent[0], packed, budget, start, min(kBatch, end - start));
  for (int base = start, buf = 0; base < end; base += kBatch, buf ^= 1) {
    cp_async_wait_all();
    // barrier: this batch has landed for every thread, the previous batch
    // and its keep bits are consumed, and the whole tile leaves together
    if (__syncthreads_count(done) == kPixels) break;
    const int n = min(kBatch, end - base);
    const Batch<kBatch>& s = s_ent[buf];
    cull_batch(s, n, tx0, ty0, thr_cull, s_keep);
    if (base + kBatch < end) {
      stage(s_ent[buf ^ 1], packed, budget, base + kBatch,
            min(kBatch, end - base - kBatch));
    }
    __syncthreads();

    for (int c = 0; c * 32 < n; ++c) {
      if (__all_sync(kFull, done)) break;
      unsigned word = __ballot_sync(kFull, s_keep[warp][c * 32 + lane] != 0);
      while (word) {  // warp-uniform
        int jj[kGroup];
        float alpha[kGroup];
        float4 ent_b[kGroup];
#pragma unroll
        for (int q = 0; q < kGroup; ++q) {
          jj[q] = word ? c * 32 + __ffs(word) - 1 : -1;
          word &= word - 1;
        }
#pragma unroll
        for (int q = 0; q < kGroup; ++q) {
          const int j = jj[q] >= 0 ? jj[q] : jj[0];
          const float4 ea = s.a[j];
          ent_b[q] = s.b[j];
          const float dx = ea.x - px;
          const float dy = ea.y - py;
          float sigma = 0.5f * (ea.z * dx * dx + ent_b[q].x * dy * dy)
                        + ea.w * dx * dy;
          sigma = fmaxf(sigma, 0.f);
          alpha[q] = fminf(max_alpha, ent_b[q].y * expf(-sigma));
        }
#pragma unroll
        for (int q = 0; q < kGroup; ++q) {
          if (jj[q] < 0 || done || alpha[q] < alpha_threshold) continue;
          const float next_T = T * (1.f - alpha[q]);
          if (next_T <= transmittance_eps) {
            done = 1;
            n_walked = base + jj[q] - start;
            continue;
          }
          const float vis = alpha[q] * T;
          r = r + vis * ent_b[q].z;
          g = g + vis * ent_b[q].w;
          b = b + vis * s.c[jj[q]];
          T = next_T;
        }
      }
    }
  }

  const long long pix = static_cast<long long>(t) * kPixels + row * kTile + col;
  reinterpret_cast<float4*>(out)[pix] = make_float4(r, g, b, T);
  walked[pix] = n_walked;
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

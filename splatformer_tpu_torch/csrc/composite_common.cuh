// Device code shared by the compositing kernels K1 (composite_fwd.cu) and
// K2 (composite_bwd.cu): the tile layout, the cp.async staging of entries,
// the exact warp-box cull and the heaviest-first tile order.
//
// Layout: one CTA per 16x16 tile, 8 warps, warp w owning the 8x4 pixel box
// at columns 8 (w % 2) .. +7, rows 4 (w / 2) .. +3, lane l its pixel
// (l % 8, l / 8).
//
// The cull: a box is culled for an entry only when
// op exp(-sigma_lb) < alpha_threshold (1 - kCullShare), sigma_lb being the
// continuous minimum of the quadratic over the box of pixel centres (0 when
// the Gaussian's centre lies inside it, else the least of its four edges'
// clamped minima) less a margin of kCullRel of the terms' size + kCullAbs,
// far above the rounding of both the test and the pair's own sigma. A box is
// always kept unless c0 > 0, c2 > 0, c0 c2 > c1^2 and every value is finite.
// A culled entry is below the threshold at every pixel of the box, so it
// never composites and never terminates a pixel there.
// kernels/composite.py:warp_box_keep_plain is its plain version and reads
// the kCull* constants from this file.
#pragma once

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kTile = 16;
constexpr int kPixels = kTile * kTile;  // threads per CTA
constexpr int kWarps = kPixels / 32;    // one 8x4 pixel box each
constexpr int kRows = 9;                // attribute rows used of the 16
constexpr unsigned kFull = 0xffffffffu;

constexpr float kCullShare = 1e-4f;  // threshold cut
constexpr float kCullRel = 1e-5f;    // margin, relative to the terms' size
constexpr float kCullAbs = 1e-6f;    // margin, absolute
constexpr float kCullMaxSize = 1e30f;  // larger terms: the box is kept

// One staged batch of entries: [x, y, c0, c1] | [c2, op, r, g] | b (two
// 16-byte loads and one 4-byte load an entry).
template <int kBatch>
struct Batch {
  float4 a[kBatch];
  float4 b[kBatch];
  float c[kBatch];
};

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Start the copy of rows 0-8 of entries [base, base + n) into `s`.
template <int kBatch>
__device__ __forceinline__ void stage(Batch<kBatch>& s,
                                      const float* __restrict__ packed,
                                      long long budget, int base, int n) {
  for (int q = threadIdx.x; q < kRows * kBatch; q += kPixels) {
    const int k = q / kBatch;
    const int e = q % kBatch;
    if (e < n) {
      float* dst = k < 4   ? reinterpret_cast<float*>(&s.a[e]) + k
                   : k < 8 ? reinterpret_cast<float*>(&s.b[e]) + (k - 4)
                           : &s.c[e];
      cp_async4(dst, packed + k * budget + base + e);
    }
  }
  cp_async_commit();
}

__device__ __forceinline__ float quad(float c0, float c1, float c2, float dx,
                                      float dy) {
  return 0.5f * (c0 * dx * dx + c2 * dy * dy) + c1 * dx * dy;
}

__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return fminf(fmaxf(v, lo), hi);
}

// The alpha under which a box is culled; none is when the threshold is not
// positive.
__device__ __forceinline__ float cull_threshold(float alpha_threshold) {
  return alpha_threshold > 0.f ? alpha_threshold * (1.f - kCullShare)
                               : -INFINITY;
}

// Whether an entry (centre mx, my; conic c0, c1, c2 with c0 > 0, c2 > 0,
// c0 c2 > c1^2, all finite; kx = c1 / c2 and ky = c1 / c0 finite) stays
// below `thr_cull` at every pixel of the box [bx, bx + 7] x [by, by + 3].
__device__ __forceinline__ bool box_culled(float mx, float my, float c0,
                                           float c1, float c2, float op,
                                           float kx, float ky, float bx,
                                           float by, float thr_cull) {
  // dx = mx - px over the box's pixels lies in [xlo, xhi], as the pair's
  // own subtraction rounds it (rounding is monotone)
  const float xlo = mx - (bx + 7.f);
  const float xhi = mx - bx;
  const float ylo = my - (by + 3.f);
  const float yhi = my - by;
  float s = 0.f;
  if (xlo > 0.f || xhi < 0.f || ylo > 0.f || yhi < 0.f) {
    // the centre lies outside: the least of the four edges' minima, each at
    // its clamped critical point
    s = fminf(fminf(quad(c0, c1, c2, xlo, clampf(-(kx * xlo), ylo, yhi)),
                    quad(c0, c1, c2, xhi, clampf(-(kx * xhi), ylo, yhi))),
              fminf(quad(c0, c1, c2, clampf(-(ky * ylo), xlo, xhi), ylo),
                    quad(c0, c1, c2, clampf(-(ky * yhi), xlo, xhi), yhi)));
  }
  const float ax = fmaxf(fabsf(xlo), fabsf(xhi));
  const float ay = fmaxf(fabsf(ylo), fabsf(yhi));
  const float size = 0.5f * c0 * ax * ax + fabsf(c1) * ax * ay
                     + 0.5f * c2 * ay * ay;
  const float lb = fmaxf(s - (kCullRel * size + kCullAbs), 0.f);
  return size <= kCullMaxSize && op * expf(-lb) < thr_cull;
}

// Keep bits of a staged batch of n entries for the 8 boxes of the tile whose
// first pixel is (tx0, ty0), written to keep[w][e], 0 past the batch: thread
// tid tests entry tid % kBatch against its share of the boxes.
template <int kBatch>
__device__ __forceinline__ void cull_batch(const Batch<kBatch>& s, int n,
                                           int tx0, int ty0, float thr_cull,
                                           uint8_t (*keep)[kBatch]) {
  static_assert(kWarps * kBatch % kPixels == 0, "boxes split evenly");
  constexpr int kBoxesPerThread = kWarps * kBatch / kPixels;
  // signed: from the unsigned threadIdx.x, ptxas gave K1 a stack frame and
  // K1 took 8% longer on an H100
  const int tid = threadIdx.x;
  const int e = tid % kBatch;
  const int w0 = (tid / kBatch) * kBoxesPerThread;
  if (e >= n) {
#pragma unroll
    for (int i = 0; i < kBoxesPerThread; ++i) keep[w0 + i][e] = 0;
    return;
  }
  const float4 a = s.a[e];
  const float c2 = s.b[e].x;
  const float op = s.b[e].y;
  const float kx = a.w / c2;
  const float ky = a.w / a.z;
  const bool testable = isfinite(a.x) && isfinite(a.y) && isfinite(a.z)
                        && isfinite(a.w) && isfinite(c2) && isfinite(op)
                        && a.z > 0.f && c2 > 0.f && a.z * c2 > a.w * a.w
                        && isfinite(kx) && isfinite(ky);
#pragma unroll
  for (int i = 0; i < kBoxesPerThread; ++i) {
    const int w = w0 + i;
    keep[w][e] = !(testable
                   && box_culled(a.x, a.y, a.z, a.w, c2, op, kx, ky,
                                 tx0 + 8.f * (w & 1), ty0 + 4.f * (w >> 1),
                                 thr_cull));
  }
}

// Exclusive prefix sum of v over the CTA's threads, in thread order (all
// threads call it; `s_warp` holds kWarps ints).
__device__ __forceinline__ int cta_exclusive_scan(int v, int* s_warp) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) s_warp[warp] = x;
  __syncthreads();
  int off = 0;
  for (int w = 0; w < warp; ++w) off += s_warp[w];
  __syncthreads();
  return off + x - v;
}

// Tile i's sort key: ascending is longest entry range first.
__device__ __forceinline__ int order_key(const int* __restrict__ tile_start,
                                         int i) {
  return 65535 - min(tile_start[i + 1] - tile_start[i], 65535);
}

// The tile this CTA composites. Tiles are taken heaviest first: CTA b takes
// the tile of rank b by entry range length (longest first, clamped at
// 65535; ties by index), so the longest walks start in the first wave
// instead of trailing the launch. Each CTA finds its tile by a radix select
// over all range lengths (two 8-bit passes, then the rank among equal keys),
// which costs no launch; blockIdx -> tile is a permutation.
__device__ __forceinline__ int heaviest_first(
    const int* __restrict__ tile_start) {
  __shared__ int s_hist[kPixels];
  __shared__ int s_warp[kWarps];
  __shared__ int s_pick[2];
  const int num_tiles = gridDim.x;
  const int tid = threadIdx.x;
  const int per = (num_tiles + kPixels - 1) / kPixels;  // contiguous tiles
  const int lo = min(tid * per, num_tiles);
  const int hi = min(lo + per, num_tiles);
  int want = blockIdx.x;  // rank among the tiles whose key has `prefix`
  int prefix = 0;
  for (int pass = 0; pass < 2; ++pass) {
    s_hist[tid] = 0;
    __syncthreads();
    for (int i = lo; i < hi; ++i) {
      const int key = order_key(tile_start, i);
      if (pass == 0) {
        atomicAdd(&s_hist[key >> 8], 1);
      } else if ((key >> 8) == prefix) {
        atomicAdd(&s_hist[key & 255], 1);
      }
    }
    __syncthreads();
    const int count = s_hist[tid];
    const int before = cta_exclusive_scan(count, s_warp);
    if (before <= want && want < before + count) {
      s_pick[0] = tid;
      s_pick[1] = want - before;
    }
    __syncthreads();
    prefix = pass == 0 ? s_pick[0] : (prefix << 8) | s_pick[0];
    want = s_pick[1];
    __syncthreads();
  }
  int count = 0;
  for (int i = lo; i < hi; ++i) {
    count += order_key(tile_start, i) == prefix;
  }
  const int before = cta_exclusive_scan(count, s_warp);
  if (before <= want && want < before + count) {
    for (int i = lo, seen = before; i < hi; ++i) {
      if (order_key(tile_start, i) == prefix && seen++ == want) {
        s_pick[0] = i;
      }
    }
  }
  __syncthreads();
  return s_pick[0];
}

}  // namespace

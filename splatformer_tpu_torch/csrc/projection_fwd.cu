// The render's projection over all V views in one launch (P1, forward),
// for Hopper, sm_90a.
//
// Replaces no TPU kernel: the JAX package leaves the projection to XLA,
// which fuses its elementwise chain into one pass per view
// (splatformer_tpu/ops/projection.py, vmapped over the views in
// splatformer_tpu/ops/render.py). In PyTorch the same chain is some 300
// launches of 2-3 us of device work each, one view at a time, and the host
// that launches them leaves the card idle. This kernel is that chain fused,
// for every view at once. Its function is the plain version in
// kernels/projection.py (project_views_plain), whose arithmetic
// csrc/projection_common.cuh repeats operation for operation.
//
// One thread per (view, slot) pair: the view is blockIdx.y, the slot g of
// the scene's N (padded to n_pad) is blockIdx.x * 256 + threadIdx.x. Thread
// 0 of each block derives its view's camera (the OpenGL -> OpenCV flip, the
// analytic inverse of c2w, the frustum limits) into shared memory. Each
// thread then activates its raw Gaussian (exp, the quaternion normalised
// twice with its fallback, sigmoid, the mask), builds cov3d, projects it
// (near cull, EWA with the frustum clamp and the +0.3 blur, the conic, the
// opacity-aware extents, the tile bbox and count) and evaluates its SH
// colour, and writes column v * n_pad + g of the flat layout that the
// binning and the entry gather read: the packed entry table (16, V * n_pad)
// rows [x, y, conic0-2, opacity, r, g, b, 0 ...], depths, radii, tile
// counts, per-axis extents and the view's tile offset. Pad slots g >= N
// get radius 0, depth inf and zero rows.
//
// What bounds it: bytes. Each pair reads its Gaussian (about 92 B at SH
// degree 1; the 10 MB scene stays in L2 across the V blocks that read it)
// and writes 92 B; its ~400 operations are far under the FP32 pipes'
// rate. It is built with -fmad=false, like K1 and K2, so that each product
// and sum rounds as the plain version's separate ops do.
#include "projection_common.cuh"

namespace {

using namespace projection;

constexpr int kThreads = 256;

template <int D>
__global__ void __launch_bounds__(kThreads)
projection_fwd_kernel(const float* __restrict__ means,
                      const float* __restrict__ scales,
                      const float* __restrict__ quats,
                      const float* __restrict__ opacities,
                      const float* __restrict__ features_dc,
                      const float* __restrict__ features_rest,
                      const uint8_t* __restrict__ mask,
                      const float* __restrict__ c2w, long long c2w_stride,
                      const float* __restrict__ fx, const float* __restrict__ fy,
                      const float* __restrict__ cx, const float* __restrict__ cy,
                      int n, int n_pad, int width, int height, int tile_size,
                      float clip_thresh, float inv_athr,
                      float* __restrict__ packed, float* __restrict__ depths,
                      int* __restrict__ radii, int* __restrict__ num_tiles_hit,
                      float* __restrict__ radii_xy,
                      int* __restrict__ tile_offset) {
  __shared__ Camera s_cam;
  const int v = blockIdx.y;
  if (threadIdx.x == 0) {
    s_cam = make_camera(c2w + v * c2w_stride, fx[v], fy[v], cx[v], cy[v],
                        width, height);
  }
  __syncthreads();
  const int g = blockIdx.x * kThreads + threadIdx.x;
  if (g >= n_pad) return;

  const int tiles_x = (width + tile_size - 1) / tile_size;
  const int tiles_y = (height + tile_size - 1) / tile_size;
  const long long col = static_cast<long long>(v) * n_pad + g;
  const long long row = static_cast<long long>(gridDim.y) * n_pad;
  tile_offset[col] = v * tiles_x * tiles_y;
  if (g >= n) {  // pad slot: never binned
#pragma unroll
    for (int r = 0; r < kPackW; ++r) packed[r * row + col] = 0.f;
    depths[col] = __int_as_float(0x7f800000);
    radii[col] = 0;
    num_tiles_hit[col] = 0;
    reinterpret_cast<float2*>(radii_xy)[col] = make_float2(0.f, 0.f);
    return;
  }

  const Camera& cam = s_cam;
  const Gaussian a =
      load_gaussian(means, scales, quats, opacities, mask, g, inv_athr);
  const View o = project(a, cam, clip_thresh);

  const float conic0 = o.b11 * o.inv_det;
  const float conic1 = -o.v01 * o.inv_det;
  const float conic2 = o.b00 * o.inv_det;

  const float ds = o.det_ok ? o.det : 1.f;
  const float bmid = F(0.5) * (o.b00 + o.b11);
  const float disc = sqrtf(fmaxf(bmid * bmid - ds, F(0.1)));
  const float v1 = bmid + disc;
  const float v2 = bmid - disc;
  const float radius_f = ceilf(a.k_ext * sqrtf(fmaxf(fmaxf(v1, v2), 0.f)));
  float rx = ceilf(a.k_ext * sqrtf(fmaxf(o.b00, 0.f)));
  float ry = ceilf(a.k_ext * sqrtf(fmaxf(o.b11, 0.f)));

  const float xs = cam.fx * o.p[0] * o.rz + cam.cx;
  const float ys = cam.fy * o.p[1] * o.rz + cam.cy;

  const bool valid = o.valid && o.det_ok;
  const int radius = valid ? static_cast<int>(radius_f) : 0;
  rx = valid ? rx : 0.f;
  ry = valid ? ry : 0.f;

  // tile_bbox: clamp in float, truncate, clamp again; on the card PyTorch
  // divides by the tile size as a product with its float reciprocal
  const float inv_ts = 1.f / static_cast<float>(tile_size);
  const auto cell = [](float x, int hi) {
    const int i = static_cast<int>(
        fminf(fmaxf(x, -1.f), static_cast<float>(hi + 1)));
    return min(max(i, 0), hi);
  };
  const int tmin_x = cell((xs - rx) * inv_ts, tiles_x);
  const int tmax_x = cell((xs + rx) * inv_ts + 1.f, tiles_x);
  const int tmin_y = cell((ys - ry) * inv_ts, tiles_y);
  const int tmax_y = cell((ys + ry) * inv_ts + 1.f, tiles_y);
  const int span = (tmax_x - tmin_x) * (tmax_y - tmin_y);

  float rgb[3];
  if constexpr (D == 0) {
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) rgb[ch] = sigmoid(features_dc[3 * g + ch]);
  } else {
    float coef[3 * Sh<D>::kBases];
    load_coefs<D>(features_dc, features_rest, g, coef);
    float dir[3];
    view_dir(a.m, cam, dir);
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      rgb[ch] = fmaxf(sh_value<D>(dir, coef, ch), 0.f);
    }
  }

  packed[0 * row + col] = xs;
  packed[1 * row + col] = ys;
  packed[2 * row + col] = conic0;
  packed[3 * row + col] = conic1;
  packed[4 * row + col] = conic2;
  packed[5 * row + col] = a.op;
  packed[6 * row + col] = rgb[0];
  packed[7 * row + col] = rgb[1];
  packed[8 * row + col] = rgb[2];
#pragma unroll
  for (int r = 9; r < kPackW; ++r) packed[r * row + col] = 0.f;
  depths[col] = valid ? o.p[2] : __int_as_float(0x7f800000);
  radii[col] = radius;
  num_tiles_hit[col] = radius > 0 ? span : 0;
  reinterpret_cast<float2*>(radii_xy)[col] = make_float2(rx, ry);
}

template <int D>
cudaError_t launch(const float* means, const float* scales, const float* quats,
                   const float* opacities, const float* features_dc,
                   const float* features_rest, const uint8_t* mask,
                   const float* c2w, long long c2w_stride, const float* fx,
                   const float* fy, const float* cx, const float* cy, int n,
                   int n_pad, int v, int width, int height, int tile_size,
                   float clip_thresh, float inv_athr, float* packed,
                   float* depths, int* radii, int* num_tiles_hit,
                   float* radii_xy, int* tile_offset, cudaStream_t stream) {
  const dim3 grid((n_pad + kThreads - 1) / kThreads, v);
  projection_fwd_kernel<D><<<grid, kThreads, 0, stream>>>(
      means, scales, quats, opacities, features_dc, features_rest, mask, c2w,
      c2w_stride, fx, fy, cx, cy, n, n_pad, width, height, tile_size,
      clip_thresh, inv_athr, packed, depths, radii, num_tiles_hit, radii_xy,
      tile_offset);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes. `mask` may be null (every slot live) and
// `features_rest` is null at SH degree 0. Launches on `stream` and does not
// synchronise; returns the launch's cudaError_t (0 = cudaSuccess).
extern "C" int projection_fwd(
    const float* means, const float* scales, const float* quats,
    const float* opacities, const float* features_dc,
    const float* features_rest, const uint8_t* mask, const float* c2w,
    long long c2w_stride, const float* fx, const float* fy, const float* cx,
    const float* cy, int n, int n_pad, int v, int degree, int width,
    int height, int tile_size, float clip_thresh, float inv_athr,
    float* packed, float* depths, int* radii, int* num_tiles_hit,
    float* radii_xy, int* tile_offset, void* stream) {
  if (n_pad <= 0 || v <= 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
#define SF_PROJECTION_FWD(D)                                                 \
  launch<D>(means, scales, quats, opacities, features_dc, features_rest,     \
            mask, c2w, c2w_stride, fx, fy, cx, cy, n, n_pad, v, width,       \
            height, tile_size, clip_thresh, inv_athr, packed, depths, radii, \
            num_tiles_hit, radii_xy, tile_offset, s)
  cudaError_t err;
  switch (degree) {
    case 0: err = SF_PROJECTION_FWD(0); break;
    case 1: err = SF_PROJECTION_FWD(1); break;
    case 2: err = SF_PROJECTION_FWD(2); break;
    case 3: err = SF_PROJECTION_FWD(3); break;
    case 4: err = SF_PROJECTION_FWD(4); break;
    default: err = cudaErrorInvalidValue;
  }
#undef SF_PROJECTION_FWD
  return static_cast<int>(err);
}

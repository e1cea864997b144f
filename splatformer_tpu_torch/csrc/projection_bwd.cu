// The backward of the fused projection (P1, backward), for Hopper, sm_90a.
//
// Replaces no TPU kernel: on the TPU, autograd of the XLA-fused projection
// is XLA's own fused pass. In PyTorch autograd replays the forward's ~300
// launches a view backwards; this kernel is that replay fused, for every
// view at once. Its function is the autograd of the plain version in
// kernels/projection.py (project_views_plain).
//
// Input: the cotangent of the packed entry table (16, V * n_pad), of which
// rows 0-8 (x, y, conic0-2, opacity, r, g, b) carry gradient; it arrives
// through the entry gather's index_add_ from K2. Output: the gradients of
// the six raw scene attributes (means, log-scales, wxyz quats, opacity
// logits, features_dc, features_rest).
//
// One thread per slot g < N loops over the V views (their cameras staged
// in shared memory by the block), recomputes the forward's intermediates
// from the raw inputs (nothing of size V * N is saved) and sums the views'
// contributions in registers: no atomics, so the result is deterministic
// and identical from run to run. The chain is the plain version's
// autograd: no colour gradient reaches the means (the SH direction is
// detached); torch.maximum and torch.minimum ties give half the gradient to
// each side (the colour clamp at 0, the frustum clamp of tx and ty);
// where() masks, the near cull, a zero determinant and the degenerate
// quaternion fallback pass zero; at SH degree 0 the colour is
// sigmoid(features_dc) and takes the sigmoid's gradient. A view whose
// rows carry no gradient (the Gaussian was not binned there) skips its
// projection's backward: its terms would all be zero.
//
// What bounds it: bytes, as the forward. Each slot reads 36 B of cotangent
// a view and its raw Gaussian once, and writes its gradients once.
#include "projection_common.cuh"

namespace {

using namespace projection;

constexpr int kThreads = 128;

// torch.maximum(a, b) / torch.minimum(a, b): the share of the gradient that
// goes to a (1, 1/2 at a tie, else 0); b takes the rest.
__device__ inline float max_share(float a, float b) {
  return a > b ? 1.f : (a == b ? 0.5f : 0.f);
}
__device__ inline float min_share(float a, float b) {
  return a < b ? 1.f : (a == b ? 0.5f : 0.f);
}

// d(q / |q|) for normalize_quats: zero where the fallback was taken.
__device__ inline void normalize_bwd(const float q[4], const Normalized& n,
                                     const float g_out[4], float g_in[4]) {
  if (!n.ok) {
#pragma unroll
    for (int k = 0; k < 4; ++k) g_in[k] = 0.f;
    return;
  }
  float gq = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) gq += g_out[k] * q[k];
  const float d = n.denom;
  const float g_denom = -gq / (d * d);
  const float g_sq = g_denom / (2.f * d);
#pragma unroll
  for (int k = 0; k < 4; ++k) g_in[k] = g_out[k] / d + 2.f * q[k] * g_sq;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
projection_bwd_kernel(const float* __restrict__ means,
                      const float* __restrict__ scales,
                      const float* __restrict__ quats,
                      const float* __restrict__ opacities,
                      const float* __restrict__ features_dc,
                      const float* __restrict__ features_rest,
                      const uint8_t* __restrict__ mask,
                      const float* __restrict__ c2w, long long c2w_stride,
                      const float* __restrict__ fx, const float* __restrict__ fy,
                      const float* __restrict__ cx, const float* __restrict__ cy,
                      const float* __restrict__ g_packed, int n, int n_pad,
                      int num_views, int width, int height, float clip_thresh,
                      float* __restrict__ g_means, float* __restrict__ g_scales,
                      float* __restrict__ g_quats,
                      float* __restrict__ g_opacities,
                      float* __restrict__ g_features_dc,
                      float* __restrict__ g_features_rest) {
  extern __shared__ Camera s_cams[];
  for (int v = threadIdx.x; v < num_views; v += kThreads) {
    s_cams[v] = make_camera(c2w + v * c2w_stride, fx[v], fy[v], cx[v], cy[v],
                            width, height);
  }
  __syncthreads();
  const int g = blockIdx.x * kThreads + threadIdx.x;
  if (g >= n) return;

  constexpr int kB = Sh<D>::kBases;
  // the extents take no gradient, so the threshold does not matter here
  const Gaussian a =
      load_gaussian(means, scales, quats, opacities, mask, g, 1.f);
  float coef[3 * kB];
  if constexpr (D > 0) load_coefs<D>(features_dc, features_rest, g, coef);

  float gm[3] = {0.f, 0.f, 0.f};
  float gc[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  float g_op = 0.f;
  float g_coef[3 * kB];
#pragma unroll
  for (int k = 0; k < 3 * kB; ++k) g_coef[k] = 0.f;

  const long long row = static_cast<long long>(num_views) * n_pad;
  for (int v = 0; v < num_views; ++v) {
    const Camera& cam = s_cams[v];
    const long long col = static_cast<long long>(v) * n_pad + g;
    float gp[9];
#pragma unroll
    for (int r = 0; r < 9; ++r) gp[r] = g_packed[r * row + col];
    g_op += gp[5];

    // colour: rows 6-8
    if constexpr (D == 0) {
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) g_coef[ch] += gp[6 + ch];
    } else if (gp[6] != 0.f || gp[7] != 0.f || gp[8] != 0.f) {
      float dir[3];
      view_dir(a.m, cam, dir);
      float w[kB];
      sh_weights<D>(dir, w);
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        const float gr = gp[6 + ch] * max_share(sh_value<D>(dir, coef, ch), 0.f);
#pragma unroll
        for (int k = 0; k < kB; ++k) g_coef[3 * k + ch] += gr * w[k];
      }
    }

    // projection: rows 0-4
    if (gp[0] == 0.f && gp[1] == 0.f && gp[2] == 0.f && gp[3] == 0.f &&
        gp[4] == 0.f) {
      continue;
    }
    const View o = project(a, cam, clip_thresh);
    const float gx = gp[0], gy = gp[1];
    // conic = (b11, -v01, b00) * inv_det
    const float g_inv = gp[2] * o.b11 + gp[3] * -o.v01 + gp[4] * o.b00;
    float g_b11 = gp[2] * o.inv_det;
    float g_v01 = -(gp[3] * o.inv_det);
    float g_b00 = gp[4] * o.inv_det;
    const float g_det = o.det_ok ? -g_inv * (o.inv_det * o.inv_det) : 0.f;
    // det = b00 b11 - v01 v01
    g_b00 += g_det * o.b11;
    g_b11 += g_det * o.b00;
    g_v01 -= 2.f * (g_det * o.v01);
    const float g_v00 = g_b00, g_v11 = g_b11;
    // v00 = T0' C T0, v01 = T0' C T1, v11 = T1' C T1
    float gT0[3], gT1[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      gT0[j] = 2.f * g_v00 * o.CT0[j] + g_v01 * o.CT1[j];
      gT1[j] = g_v01 * o.CT0[j] + 2.f * g_v11 * o.CT1[j];
    }
    const float* T0 = o.T0;
    const float* T1 = o.T1;
    gc[0] += g_v00 * T0[0] * T0[0] + g_v01 * T0[0] * T1[0] +
             g_v11 * T1[0] * T1[0];
    gc[1] += 2.f * g_v00 * T0[0] * T0[1] +
             g_v01 * (T0[0] * T1[1] + T0[1] * T1[0]) +
             2.f * g_v11 * T1[0] * T1[1];
    gc[2] += 2.f * g_v00 * T0[0] * T0[2] +
             g_v01 * (T0[0] * T1[2] + T0[2] * T1[0]) +
             2.f * g_v11 * T1[0] * T1[2];
    gc[3] += g_v00 * T0[1] * T0[1] + g_v01 * T0[1] * T1[1] +
             g_v11 * T1[1] * T1[1];
    gc[4] += 2.f * g_v00 * T0[1] * T0[2] +
             g_v01 * (T0[1] * T1[2] + T0[2] * T1[1]) +
             2.f * g_v11 * T1[1] * T1[2];
    gc[5] += g_v00 * T0[2] * T0[2] + g_v01 * T0[2] * T1[2] +
             g_v11 * T1[2] * T1[2];
    // T0 = J00 R0 + J02 R2, T1 = J11 R1 + J12 R2
    float g_J00 = 0.f, g_J02 = 0.f, g_J11 = 0.f, g_J12 = 0.f;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      g_J00 += gT0[j] * cam.R[0][j];
      g_J02 += gT0[j] * cam.R[2][j];
      g_J11 += gT1[j] * cam.R[1][j];
      g_J12 += gT1[j] * cam.R[2][j];
    }
    // J00 = fx rz, J02 = (-fx tx) rz2, J11 = fy rz, J12 = (-fy ty) rz2,
    // xs = fx p0 rz + cx, ys = fy p1 rz + cy
    float g_rz = g_J00 * cam.fx + g_J11 * cam.fy +
                 gx * (cam.fx * o.p[0]) + gy * (cam.fy * o.p[1]);
    const float g_rz2 = g_J02 * o.nfx_tx + g_J12 * o.nfy_ty;
    const float g_tx = g_J02 * o.rz2 * -cam.fx;
    const float g_ty = g_J12 * o.rz2 * -cam.fy;
    float g_p0 = gx * o.rz * cam.fx;
    float g_p1 = gy * o.rz * cam.fy;
    g_rz += 2.f * o.rz * g_rz2;
    float g_tzs = -g_rz * (o.rz * o.rz);
    // tx = min(max(p0, lo), hi), lo = -lim tzs, hi = lim tzs
    {
      const float s_ax = min_share(o.ax, o.hi_x);
      const float g_ax = g_tx * s_ax;
      const float g_hi = g_tx * (1.f - s_ax);
      const float s_p = max_share(o.p[0], o.lo_x);
      g_p0 += g_ax * s_p;
      const float g_lo = g_ax * (1.f - s_p);
      g_tzs += g_hi * cam.lim_x - g_lo * cam.lim_x;
    }
    {
      const float s_ay = min_share(o.ay, o.hi_y);
      const float g_ay = g_ty * s_ay;
      const float g_hi = g_ty * (1.f - s_ay);
      const float s_p = max_share(o.p[1], o.lo_y);
      g_p1 += g_ay * s_p;
      const float g_lo = g_ay * (1.f - s_p);
      g_tzs += g_hi * cam.lim_y - g_lo * cam.lim_y;
    }
    const float g_p2 = o.valid ? g_tzs : 0.f;
    // p = R m + t
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      gm[j] += g_p0 * cam.R[0][j] + g_p1 * cam.R[1][j] + g_p2 * cam.R[2][j];
    }
  }

  // opacity: where(mask, sigmoid(logit), 0)
  g_opacities[g] = a.live ? g_op * (1.f - a.sig) * a.sig : 0.f;

  // colours
  if constexpr (D == 0) {
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      const float s = sigmoid(features_dc[3 * g + ch]);
      g_features_dc[3 * g + ch] = g_coef[ch] * (1.f - s) * s;
    }
  } else {
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) g_features_dc[3 * g + ch] = g_coef[ch];
#pragma unroll
    for (int k = 0; k < 3 * (kB - 1); ++k) {
      g_features_rest[static_cast<long long>(g) * 3 * (kB - 1) + k] =
          g_coef[3 + k];
    }
  }

  // cov3d = M M' from the rows of M = R diag(s)
  float gM[3][3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    gM[0][j] = 2.f * gc[0] * a.M[0][j] + gc[1] * a.M[1][j] + gc[2] * a.M[2][j];
    gM[1][j] = gc[1] * a.M[0][j] + 2.f * gc[3] * a.M[1][j] + gc[4] * a.M[2][j];
    gM[2][j] = gc[2] * a.M[0][j] + gc[4] * a.M[1][j] + 2.f * gc[5] * a.M[2][j];
  }
  float gR[3][3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    float gs = 0.f;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      gR[i][j] = gM[i][j] * a.s[j];
      gs += gM[i][j] * a.R[i][j];
    }
    g_scales[3 * g + j] = gs * a.s[j];  // exp
  }
  // quat_to_rotmat of q2 = normalize(q1), q1 = normalize(raw)
  const float w = a.q2.q[0], x = a.q2.q[1], y = a.q2.q[2], z = a.q2.q[3];
  float g_q2[4];
  g_q2[0] = 2.f * (-z * gR[0][1] + y * gR[0][2] + z * gR[1][0] -
                   x * gR[1][2] - y * gR[2][0] + x * gR[2][1]);
  g_q2[1] = 2.f * (y * gR[0][1] + z * gR[0][2] + y * gR[1][0] -
                   w * gR[1][2] + z * gR[2][0] + w * gR[2][1]) -
            4.f * x * (gR[1][1] + gR[2][2]);
  g_q2[2] = 2.f * (x * gR[0][1] + w * gR[0][2] + x * gR[1][0] +
                   z * gR[1][2] - w * gR[2][0] + z * gR[2][1]) -
            4.f * y * (gR[0][0] + gR[2][2]);
  g_q2[3] = 2.f * (-w * gR[0][1] + x * gR[0][2] + w * gR[1][0] +
                   y * gR[1][2] + x * gR[2][0] + y * gR[2][1]) -
            4.f * z * (gR[0][0] + gR[1][1]);
  float g_q1[4], g_q[4], raw[4];
  normalize_bwd(a.q1.q, a.q2, g_q2, g_q1);
#pragma unroll
  for (int k = 0; k < 4; ++k) raw[k] = quats[4 * g + k];
  normalize_bwd(raw, a.q1, g_q1, g_q);
#pragma unroll
  for (int k = 0; k < 4; ++k) g_quats[4 * g + k] = g_q[k];
#pragma unroll
  for (int j = 0; j < 3; ++j) g_means[3 * g + j] = gm[j];
}

template <int D>
cudaError_t launch(const float* means, const float* scales, const float* quats,
                   const float* opacities, const float* features_dc,
                   const float* features_rest, const uint8_t* mask,
                   const float* c2w, long long c2w_stride, const float* fx,
                   const float* fy, const float* cx, const float* cy,
                   const float* g_packed, int n, int n_pad, int v, int width,
                   int height, float clip_thresh, float* g_means,
                   float* g_scales, float* g_quats, float* g_opacities,
                   float* g_features_dc, float* g_features_rest,
                   cudaStream_t stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  const size_t smem = static_cast<size_t>(v) * sizeof(Camera);
  projection_bwd_kernel<D><<<blocks, kThreads, smem, stream>>>(
      means, scales, quats, opacities, features_dc, features_rest, mask, c2w,
      c2w_stride, fx, fy, cx, cy, g_packed, n, n_pad, v, width, height,
      clip_thresh, g_means, g_scales, g_quats, g_opacities, g_features_dc,
      g_features_rest);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes. `mask` may be null (every slot live);
// `features_rest` and `g_features_rest` are null at SH degree 0. The V
// cameras must fit the default 48 KB of shared memory: at most 585 views.
// Launches on `stream` and does not synchronise; returns the launch's
// cudaError_t (0 = cudaSuccess).
extern "C" int projection_bwd(
    const float* means, const float* scales, const float* quats,
    const float* opacities, const float* features_dc,
    const float* features_rest, const uint8_t* mask, const float* c2w,
    long long c2w_stride, const float* fx, const float* fy, const float* cx,
    const float* cy, const float* g_packed, int n, int n_pad, int v,
    int degree, int width, int height, float clip_thresh, float* g_means,
    float* g_scales, float* g_quats, float* g_opacities, float* g_features_dc,
    float* g_features_rest, void* stream) {
  if (n <= 0) return 0;
  if (v <= 0 || static_cast<size_t>(v) * sizeof(Camera) > 48 * 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
#define SF_PROJECTION_BWD(D)                                                   \
  launch<D>(means, scales, quats, opacities, features_dc, features_rest, mask, \
            c2w, c2w_stride, fx, fy, cx, cy, g_packed, n, n_pad, v, width,     \
            height, clip_thresh, g_means, g_scales, g_quats, g_opacities,      \
            g_features_dc, g_features_rest, s)
  cudaError_t err;
  switch (degree) {
    case 0: err = SF_PROJECTION_BWD(0); break;
    case 1: err = SF_PROJECTION_BWD(1); break;
    case 2: err = SF_PROJECTION_BWD(2); break;
    case 3: err = SF_PROJECTION_BWD(3); break;
    case 4: err = SF_PROJECTION_BWD(4); break;
    default: err = cudaErrorInvalidValue;
  }
#undef SF_PROJECTION_BWD
  return static_cast<int>(err);
}

// Device code shared by the fused projection kernels (P1):
// csrc/projection_fwd.cu and csrc/projection_bwd.cu.
//
// Each function repeats, operation for operation and in the same order, the
// plain PyTorch version of ops/projection.py (activate_gaussians,
// scale_quat_to_cov3d, project_gaussians, tile_bbox, compute_colors) and
// ops/camera.py (opengl_c2w_to_opencv_w2c, normalize_quats,
// quat_to_rotmat), so that, built with -fmad=false (no product fused into
// a sum), every product and sum rounds as PyTorch's separate elementwise
// ops round it. PyTorch's own rules are kept where they differ from the
// obvious C:
//   * a Python scalar is rounded to float before the operation: F(x);
//   * `c / tensor` is reciprocal(tensor) * c (Tensor.__rtruediv__);
//   * on the card, `tensor / python_scalar` is tensor * (1 / scalar) with
//     the reciprocal taken in float (ATen's div_true_kernel_cuda); the
//     plain version therefore divides only by powers of two that way, and
//     multiplies by 1 / alpha_threshold, passed in as a float;
//   * sigmoid(x) is 1 / (1 + exp(-x)) (ATen's sigmoid_kernel_cuda);
//   * a sum that the plain version once took with torch.sum or a norm
//     follows PyTorch's CUDA reduction: over a contiguous row, three
//     elements as (a0 + a2) + a1 and four as (a0 + a2) + (a1 + a3) (the
//     threads of a row take elements a stride of two apart, then combine
//     by warp shuffles); over a strided one (the camera's -R^T t, whose
//     R^T is a transposed view), left to right.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace projection {

constexpr int kPackW = 16;  // packed entry rows (ops/raster.py PACK_W)

// A Python float as PyTorch applies it to a float32 tensor: cast to float.
__host__ __device__ constexpr float F(double x) {
  return static_cast<float>(x);
}

// ops/sh.py's constants, gsplat v0.1.11
constexpr double kC0 = 0.28209479177387814;
constexpr double kC1 = 0.4886025119029199;
constexpr double kC2_0 = 1.0925484305920792, kC2_1 = -1.0925484305920792,
                 kC2_2 = 0.31539156525252005, kC2_3 = -1.0925484305920792,
                 kC2_4 = 0.5462742152960396;
constexpr double kC3_0 = -0.5900435899266435, kC3_1 = 2.890611442640554,
                 kC3_2 = -0.4570457994644658, kC3_3 = 0.3731763325901154,
                 kC3_4 = -0.4570457994644658, kC3_5 = 1.445305721320277,
                 kC3_6 = -0.5900435899266435;
constexpr double kC4_0 = 2.5033429417967046, kC4_1 = -1.7701307697799304,
                 kC4_2 = 0.9461746957575601, kC4_3 = -0.6690465435572892,
                 kC4_4 = 0.10578554691520431, kC4_5 = -0.6690465435572892,
                 kC4_6 = 0.47308734787878004, kC4_7 = -1.7701307697799304,
                 kC4_8 = 0.6258357354491761;

template <int D>
struct Sh {
  static constexpr int kBases = (D + 1) * (D + 1);
};

// One view, derived from its OpenGL c2w (3 x 4, row-major) and intrinsics
// as ops/camera.py and ops/projection.py derive it.
struct Camera {
  float R[3][3];  // OpenCV world-to-camera rotation
  float t[3];
  float fx, fy, cx, cy;
  float lim_x, lim_y;  // 1.3 tan(fov / 2), the frustum clamp
  float pos[3];        // camera centre: the c2w translation
};

__device__ inline Camera make_camera(const float* c2w, float fx, float fy,
                                     float cx, float cy, int width,
                                     int height) {
  Camera c;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      // row i of R^T is column i of R; the y and z axes are flipped
      const float r = c2w[j * 4 + i];
      c.R[i][j] = i == 0 ? r : -r;
    }
  }
  const float t0 = c2w[3], t1 = c2w[7], t2 = c2w[11];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    c.t[i] = -(c.R[i][0] * t0 + c.R[i][1] * t1 + c.R[i][2] * t2);
  }
  c.fx = fx;
  c.fy = fy;
  c.cx = cx;
  c.cy = cy;
  c.lim_x = ((1.f / fx) * F(0.5 * width)) * F(1.3);
  c.lim_y = ((1.f / fy) * F(0.5 * height)) * F(1.3);
  c.pos[0] = t0;
  c.pos[1] = t1;
  c.pos[2] = t2;
  return c;
}

__device__ inline float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

// normalize_quats: q / |q|, or the fallback [0, 0, 0, 1] at |q|^2 <= 1e-12
struct Normalized {
  float q[4];
  float denom;
  bool ok;
};

__device__ inline Normalized normalize_quat(const float q[4]) {
  Normalized n;
  const float sq = (q[0] * q[0] + q[2] * q[2]) + (q[1] * q[1] + q[3] * q[3]);
  n.ok = sq > F(1e-12);
  n.denom = sqrtf(n.ok ? sq : 1.f);
#pragma unroll
  for (int k = 0; k < 4; ++k) n.q[k] = n.ok ? q[k] / n.denom : 0.f;
  if (!n.ok) n.q[3] = 1.f;
  return n;
}

// quat_to_rotmat, wxyz
__device__ inline void rotmat(const float q[4], float R[3][3]) {
  const float w = q[0], x = q[1], y = q[2], z = q[3];
  R[0][0] = 1.f - 2.f * (y * y + z * z);
  R[0][1] = 2.f * (x * y - w * z);
  R[0][2] = 2.f * (x * z + w * y);
  R[1][0] = 2.f * (x * y + w * z);
  R[1][1] = 1.f - 2.f * (x * x + z * z);
  R[1][2] = 2.f * (y * z - w * x);
  R[2][0] = 2.f * (x * z - w * y);
  R[2][1] = 2.f * (y * z + w * x);
  R[2][2] = 1.f - 2.f * (x * x + y * y);
}

// What the projection needs of one Gaussian, independent of the view.
struct Gaussian {
  float m[3];
  float c[6];   // cov3d [c00, c01, c02, c11, c12, c22]
  float op;     // sigmoid opacity, 0 where masked
  float k_ext;  // extent multiplier of the alpha gate
  bool live;    // the scene's mask
  // for the backward
  float s[3];   // exp(log-scales)
  float M[3][3];
  float R[3][3];
  Normalized q1, q2;  // activate_gaussians' normalisation, then cov3d's
  float sig;          // sigmoid of the opacity logit, unmasked
};

__device__ inline Gaussian load_gaussian(
    const float* __restrict__ means, const float* __restrict__ scales,
    const float* __restrict__ quats, const float* __restrict__ opacities,
    const uint8_t* __restrict__ mask, int g, float inv_athr) {
  Gaussian a;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    a.m[k] = means[3 * g + k];
    a.s[k] = expf(scales[3 * g + k]);
  }
  float q[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) q[k] = quats[4 * g + k];
  a.q1 = normalize_quat(q);
  a.q2 = normalize_quat(a.q1.q);
  rotmat(a.q2.q, a.R);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) a.M[i][j] = a.R[i][j] * a.s[j];
  }
  const auto rowdot = [&](int i, int j) {
    return a.M[i][0] * a.M[j][0] + a.M[i][1] * a.M[j][1] +
           a.M[i][2] * a.M[j][2];
  };
  a.c[0] = rowdot(0, 0);
  a.c[1] = rowdot(0, 1);
  a.c[2] = rowdot(0, 2);
  a.c[3] = rowdot(1, 1);
  a.c[4] = rowdot(1, 2);
  a.c[5] = rowdot(2, 2);
  a.live = mask == nullptr || mask[g] != 0;
  a.sig = sigmoid(opacities[g]);
  a.op = a.live ? a.sig : 0.f;
  const float ratio = a.op * inv_athr;
  a.k_ext = ratio > 1.f ? sqrtf(2.f * logf(fmaxf(ratio, 1.f))) : 0.f;
  return a;
}

// The view-dependent part of project_gaussians up to the conic: what the
// forward writes and what the backward differentiates.
struct View {
  float p[3];  // camera-space centre
  bool valid;  // in front of the near plane and live
  float tzs;   // z where valid, else 1
  float lo_x, hi_x, ax, tx;  // the frustum clamp: ax = max(p0, lo), min(ax, hi)
  float lo_y, hi_y, ay, ty;
  float rz, rz2;
  float nfx_tx, nfy_ty;  // -fx tx, -fy ty
  float T0[3], T1[3];    // J W, the two rows
  float CT0[3], CT1[3];  // cov3d T0, cov3d T1
  float v00, v01, v11;
  float b00, b11, det;
  bool det_ok;
  float inv_det;
};

__device__ inline void cov_times(const float c[6], const float v[3],
                                 float out[3]) {
  out[0] = c[0] * v[0] + c[1] * v[1] + c[2] * v[2];
  out[1] = c[1] * v[0] + c[3] * v[1] + c[4] * v[2];
  out[2] = c[2] * v[0] + c[4] * v[1] + c[5] * v[2];
}

__device__ inline float dot3(const float u[3], const float w[3]) {
  return u[0] * w[0] + u[1] * w[1] + u[2] * w[2];
}

__device__ inline View project(const Gaussian& a, const Camera& cam,
                               float clip_thresh) {
  View o;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    o.p[i] = (a.m[0] * cam.R[i][0] + a.m[2] * cam.R[i][2]) +
             a.m[1] * cam.R[i][1] + cam.t[i];
  }
  o.valid = o.p[2] > clip_thresh && a.live;
  o.tzs = o.valid ? o.p[2] : 1.f;
  o.lo_x = -cam.lim_x * o.tzs;
  o.hi_x = cam.lim_x * o.tzs;
  o.ax = fmaxf(o.p[0], o.lo_x);
  o.tx = fminf(o.ax, o.hi_x);
  o.lo_y = -cam.lim_y * o.tzs;
  o.hi_y = cam.lim_y * o.tzs;
  o.ay = fmaxf(o.p[1], o.lo_y);
  o.ty = fminf(o.ay, o.hi_y);
  o.rz = 1.f / o.tzs;
  o.rz2 = o.rz * o.rz;
  const float J00 = cam.fx * o.rz;
  o.nfx_tx = -cam.fx * o.tx;
  const float J02 = o.nfx_tx * o.rz2;
  const float J11 = cam.fy * o.rz;
  o.nfy_ty = -cam.fy * o.ty;
  const float J12 = o.nfy_ty * o.rz2;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    o.T0[j] = J00 * cam.R[0][j] + J02 * cam.R[2][j];
    o.T1[j] = J11 * cam.R[1][j] + J12 * cam.R[2][j];
  }
  cov_times(a.c, o.T0, o.CT0);
  cov_times(a.c, o.T1, o.CT1);
  o.v00 = dot3(o.T0, o.CT0);
  o.v01 = dot3(o.T0, o.CT1);
  o.v11 = dot3(o.T1, o.CT1);
  o.b00 = o.v00 + F(0.3);
  o.b11 = o.v11 + F(0.3);
  o.det = o.b00 * o.b11 - o.v01 * o.v01;
  o.det_ok = o.det != 0.f;
  o.inv_det = 1.f / (o.det_ok ? o.det : 1.f);
  return o;
}

// The SH view direction: camera -> mean, normalised, [0, 0, 1] at the camera.
__device__ inline void view_dir(const float m[3], const Camera& cam,
                                float d[3]) {
  const float dx = m[0] - cam.pos[0];
  const float dy = m[1] - cam.pos[1];
  const float dz = m[2] - cam.pos[2];
  const float norm = sqrtf((dx * dx + dz * dz) + dy * dy);
  const bool ok = norm > 0.f;
  const float inv = fmaxf(norm, F(1e-12));
  d[0] = ok ? dx / inv : 0.f;
  d[1] = ok ? dy / inv : 0.f;
  d[2] = ok ? dz / inv : 1.f;
}

// eval_sh(D, d, coef)[channel] + 0.5, before the clamp at 0; coef holds the
// (D + 1)^2 bases x 3 channels of one Gaussian.
template <int D>
__device__ inline float sh_value(const float d[3], const float* coef,
                                 int ch) {
  const auto c = [&](int k) { return coef[3 * k + ch]; };
  float result = F(kC0) * c(0);
  if constexpr (D >= 1) {
    const float x = d[0], y = d[1], z = d[2];
    result = result + F(kC1) * (-y * c(1) + z * c(2) - x * c(3));
    if constexpr (D >= 2) {
      const float xx = x * x, yy = y * y, zz = z * z;
      const float xy = x * y, yz = y * z, xz = x * z;
      result = result + (F(kC2_0) * xy * c(4) + F(kC2_1) * yz * c(5) +
                         F(kC2_2) * (2.f * zz - xx - yy) * c(6) +
                         F(kC2_3) * xz * c(7) + F(kC2_4) * (xx - yy) * c(8));
      if constexpr (D >= 3) {
        result = result +
                 (F(kC3_0) * y * (3.f * xx - yy) * c(9) +
                  F(kC3_1) * xy * z * c(10) +
                  F(kC3_2) * y * (4.f * zz - xx - yy) * c(11) +
                  F(kC3_3) * z * (2.f * zz - 3.f * xx - 3.f * yy) * c(12) +
                  F(kC3_4) * x * (4.f * zz - xx - yy) * c(13) +
                  F(kC3_5) * z * (xx - yy) * c(14) +
                  F(kC3_6) * x * (xx - 3.f * yy) * c(15));
        if constexpr (D >= 4) {
          result =
              result +
              (F(kC4_0) * xy * (xx - yy) * c(16) +
               F(kC4_1) * yz * (3.f * xx - yy) * c(17) +
               F(kC4_2) * xy * (7.f * zz - 1.f) * c(18) +
               F(kC4_3) * yz * (7.f * zz - 3.f) * c(19) +
               F(kC4_4) * (zz * (35.f * zz - 30.f) + 3.f) * c(20) +
               F(kC4_5) * xz * (7.f * zz - 3.f) * c(21) +
               F(kC4_6) * (xx - yy) * (7.f * zz - 1.f) * c(22) +
               F(kC4_7) * xz * (xx - 3.f * yy) * c(23) +
               F(kC4_8) * (xx * (xx - 3.f * yy) - yy * (3.f * xx - yy)) *
                   c(24));
        }
      }
    }
  }
  return result + F(0.5);
}

// d(eval_sh)/d(coefficient k), the same for the three channels.
template <int D>
__device__ inline void sh_weights(const float d[3], float w[Sh<D>::kBases]) {
  w[0] = F(kC0);
  if constexpr (D >= 1) {
    const float x = d[0], y = d[1], z = d[2];
    w[1] = F(kC1) * -y;
    w[2] = F(kC1) * z;
    w[3] = -(F(kC1) * x);
    if constexpr (D >= 2) {
      const float xx = x * x, yy = y * y, zz = z * z;
      const float xy = x * y, yz = y * z, xz = x * z;
      w[4] = F(kC2_0) * xy;
      w[5] = F(kC2_1) * yz;
      w[6] = F(kC2_2) * (2.f * zz - xx - yy);
      w[7] = F(kC2_3) * xz;
      w[8] = F(kC2_4) * (xx - yy);
      if constexpr (D >= 3) {
        w[9] = F(kC3_0) * y * (3.f * xx - yy);
        w[10] = F(kC3_1) * xy * z;
        w[11] = F(kC3_2) * y * (4.f * zz - xx - yy);
        w[12] = F(kC3_3) * z * (2.f * zz - 3.f * xx - 3.f * yy);
        w[13] = F(kC3_4) * x * (4.f * zz - xx - yy);
        w[14] = F(kC3_5) * z * (xx - yy);
        w[15] = F(kC3_6) * x * (xx - 3.f * yy);
        if constexpr (D >= 4) {
          w[16] = F(kC4_0) * xy * (xx - yy);
          w[17] = F(kC4_1) * yz * (3.f * xx - yy);
          w[18] = F(kC4_2) * xy * (7.f * zz - 1.f);
          w[19] = F(kC4_3) * yz * (7.f * zz - 3.f);
          w[20] = F(kC4_4) * (zz * (35.f * zz - 30.f) + 3.f);
          w[21] = F(kC4_5) * xz * (7.f * zz - 3.f);
          w[22] = F(kC4_6) * (xx - yy) * (7.f * zz - 1.f);
          w[23] = F(kC4_7) * xz * (xx - 3.f * yy);
          w[24] = F(kC4_8) * (xx * (xx - 3.f * yy) - yy * (3.f * xx - yy));
        }
      }
    }
  }
}

// One Gaussian's SH coefficients, [dc, rest...] x 3 channels.
template <int D>
__device__ inline void load_coefs(const float* __restrict__ features_dc,
                                  const float* __restrict__ features_rest,
                                  int g, float coef[3 * Sh<D>::kBases]) {
  constexpr int kRest = Sh<D>::kBases - 1;
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) coef[ch] = features_dc[3 * g + ch];
#pragma unroll
  for (int k = 0; k < 3 * kRest; ++k) {
    coef[3 + k] = features_rest[static_cast<long long>(g) * 3 * kRest + k];
  }
}

}  // namespace projection

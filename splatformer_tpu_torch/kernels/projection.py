"""P1, the render's projection over all V views as one fused kernel pair:
the CUDA kernels' wrappers, their autograd function and their plain
PyTorch version.

It replaces no TPU kernel: the JAX package leaves the projection to XLA's
fusion (splatformer_tpu/ops/projection.py, vmapped over the views). In
PyTorch the same chain is ~300 small launches a view, and the host that
launches them leaves the card idle. The kernel sources are
csrc/projection_fwd.cu (one thread per (view, slot)) and
csrc/projection_bwd.cu (one thread per slot, the views summed in
registers), with their shared arithmetic in csrc/projection_common.cuh;
their headers say what bounds them and how their operations follow the
plain version's, bit for bit under -fmad=false.

Inputs: a raw GaussianScene (N slots: means, log-scales, wxyz quats,
opacity logits, features_dc, features_rest at SH degree 0-4, mask) and a
batch of V cameras (c2w (V, 3, 4), intrinsics (V,)). Outputs, in the flat
layout whose column v * n_pad + g is slot g of view v (n_pad = N rounded
up to the packing chunk): the packed entry table (16, V * n_pad) that the
entry gather reads, the ProjectedGaussians that the binning reads (xys and
conics are views of the table's rows) and each slot's tile offset v *
tiles-per-image. Pad slots have radius 0, depth inf and zero rows. The
table is differentiable in the six raw attributes; the backward kernel
takes the cotangent of its rows 0-8.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from splatformer_tpu_torch.kernels import LAUNCHES
from splatformer_tpu_torch.kernels.build import load
from splatformer_tpu_torch.ops.camera import opengl_c2w_to_opencv_w2c
from splatformer_tpu_torch.ops.projection import (ProjectedGaussians,
                                                  activate_gaussians,
                                                  compute_colors,
                                                  project_gaussians)
from splatformer_tpu_torch.ops.raster import CHUNK, PACK_W
from splatformer_tpu_torch.ops.types import (Camera, GaussianScene,
                                             RasterizeConfig)

USED_ROWS = 9        # x, y, conic0-2, opacity, r, g, b
MAX_DEGREE = 4       # the kernels' SH degrees: 0-4
MAX_BWD_VIEWS = 585  # cameras in the backward's 48 KB of shared memory

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
    ctypes.c_longlong
# the C entry points' argument types (csrc/projection_fwd.cu, _bwd.cu):
# the seven scene pointers, c2w and its view stride, the four intrinsics
_INPUTS = [_P] * 8 + [_L] + [_P] * 4
_ARGTYPES = {
    "projection_fwd": _INPUTS + [_I] * 7 + [_F, _F] + [_P] * 6 + [_P],
    "projection_bwd": _INPUTS + [_P] + [_I] * 6 + [_F] + [_P] * 6 + [_P]}


class ProjectedViews(NamedTuple):
    """The projection of V views in the flat layout (module docstring)."""

    packed_t: torch.Tensor     # (PACK_W, V * n_pad) f32
    proj: ProjectedGaussians   # each field (V * n_pad, ...)
    tile_offset: torch.Tensor  # (V * n_pad,) int32


def padded(n: int) -> int:
    """The per-view stride of the flat layout: N rounded up to CHUNK."""
    return ((n + CHUNK - 1) // CHUNK) * CHUNK


def _assemble(packed_t, depths, radii, num_tiles_hit, radii_xy,
              tile_offset) -> ProjectedViews:
    proj = ProjectedGaussians(
        xys=packed_t[0:2].T, depths=depths, radii=radii,
        conics=packed_t[2:5].T, num_tiles_hit=num_tiles_hit,
        radii_xy=radii_xy)
    return ProjectedViews(packed_t=packed_t, proj=proj,
                          tile_offset=tile_offset)


def project_views(scene: GaussianScene, cameras: Camera,
                  config: RasterizeConfig = RasterizeConfig()
                  ) -> ProjectedViews:
    """Activation, projection, SH colours and packing of all V views. CUDA
    tensors launch the forward kernel (and the backward kernel in autograd)
    or raise; CPU tensors take the plain version."""
    dev = scene.means.device
    if dev.type == "cpu":
        return project_views_plain(scene, cameras, config)
    if dev.type != "cuda":
        raise ValueError(f"no projection kernel for device {dev}")
    inputs = _kernel_inputs(scene, cameras)
    params = _Params(scene.sh_degree, cameras.width, cameras.height,
                     config.tile_size, config.clip_thresh,
                     config.alpha_threshold)
    return _assemble(*ProjectViews.apply(*inputs, params))


def project_views_plain(scene: GaussianScene, cameras: Camera,
                        config: RasterizeConfig = RasterizeConfig()
                        ) -> ProjectedViews:
    """The kernels' function in plain PyTorch, on any device: the batched
    projection and colours of ops/projection.py over the leading view axis,
    then the flat layout. Autograd gives its gradient."""
    v, n = cameras.c2w.shape[0], scene.num_points
    n_pad = padded(n)
    ts = config.tile_size
    tiles_img = (((cameras.width + ts - 1) // ts)
                 * ((cameras.height + ts - 1) // ts))
    act = activate_gaussians(scene)
    mask = scene.valid_mask()
    opacities = torch.where(mask, act["opacities"], 0.0)
    proj = project_gaussians(
        act["means"], act["scales"], act["quats"],
        opengl_c2w_to_opencv_w2c(cameras.c2w), cameras.fx, cameras.fy,
        cameras.cx, cameras.cy, cameras.height, cameras.width,
        tile_size=ts, clip_thresh=config.clip_thresh, mask=mask,
        opacities=opacities, alpha_threshold=config.alpha_threshold)
    colors = compute_colors(scene, cameras.c2w[:, :3, 3]).expand(v, n, 3)
    rows = torch.cat([proj.xys, proj.conics,
                      opacities.expand(v, n)[..., None], colors], dim=-1)
    packed_t = F.pad(rows.permute(2, 0, 1),
                     (0, n_pad - n, 0, 0, 0, PACK_W - USED_ROWS))

    def flat(x, value=0.0):
        spec = (0, 0) * (x.ndim - 2) + (0, n_pad - n)
        return F.pad(x, spec, value=value).reshape(v * n_pad,
                                                   *x.shape[2:])

    tile_offset = torch.repeat_interleave(
        torch.arange(v, dtype=torch.int32, device=scene.means.device)
        * tiles_img, n_pad)
    return _assemble(packed_t.reshape(PACK_W, v * n_pad),
                     flat(proj.depths, math.inf), flat(proj.radii),
                     flat(proj.num_tiles_hit), flat(proj.radii_xy),
                     tile_offset)


class _Params(NamedTuple):
    degree: int
    width: int
    height: int
    tile_size: int
    clip_thresh: float
    alpha_threshold: float


def _kernel_inputs(scene: GaussianScene, cameras: Camera) -> tuple:
    """The kernels' tensor inputs, contiguous and checked: means, scales,
    quats, opacities, features_dc, features_rest (None at degree 0), mask
    (None: every slot live), c2w, fx, fy, cx, cy."""
    dev = scene.means.device
    n = scene.num_points
    degree = scene.sh_degree
    if degree > MAX_DEGREE:
        raise ValueError(f"SH degree {degree} above {MAX_DEGREE}")
    shapes = {"means": (n, 3), "scales": (n, 3), "quats": (n, 4),
              "opacities": (n, 1), "features_dc": (n, 3)}
    if degree:
        shapes["features_rest"] = (n, (degree + 1) ** 2 - 1, 3)
    for name, shape in shapes.items():
        x = getattr(scene, name)
        if tuple(x.shape) != shape or x.dtype != torch.float32 \
                or x.device != dev:
            raise ValueError(f"{name} must be {shape} float32 on {dev}, got "
                             f"{tuple(x.shape)} {x.dtype} on {x.device}")
    v = cameras.c2w.shape[0]
    if cameras.c2w.ndim != 3 or cameras.c2w.shape[1:] not in ((3, 4), (4, 4)):
        raise ValueError(f"c2w must be (V, 3, 4) or (V, 4, 4), got "
                         f"{tuple(cameras.c2w.shape)}")
    cams = [cameras.c2w, cameras.fx, cameras.fy, cameras.cx, cameras.cy]
    for x in cams:
        if x.dtype != torch.float32 or x.device != dev:
            raise ValueError(f"cameras must be float32 on {dev}, got "
                             f"{x.dtype} on {x.device}")
    for x in cams[1:]:
        if tuple(x.shape) != (v,):
            raise ValueError(f"intrinsics must be ({v},), got "
                             f"{tuple(x.shape)}")
    mask = scene.mask
    if mask is not None and (mask.dtype != torch.bool
                             or tuple(mask.shape) != (n,)):
        raise ValueError(f"mask must be ({n},) bool")
    rest = scene.features_rest if degree else None
    return tuple(None if x is None else x.contiguous() for x in (
        scene.means, scene.scales, scene.quats, scene.opacities,
        scene.features_dc, rest, mask, *cams))


def _ptr(x: Optional[torch.Tensor]) -> Optional[int]:
    return None if x is None else x.data_ptr()


def _library(name: str) -> ctypes.CDLL:
    lib = load(name)
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
    return lib


class ProjectViews(torch.autograd.Function):
    """The forward kernel, and the backward kernel as its gradient: returns
    (packed_t, depths, radii, num_tiles_hit, radii_xy, tile_offset); the
    gradient flows from packed_t to the six raw attributes. Nothing of
    size V * N is saved: the backward recomputes the forward's
    intermediates from the raw inputs."""

    @staticmethod
    def forward(ctx, means, scales, quats, opacities, features_dc,
                features_rest, mask, c2w, fx, fy, cx, cy, params):
        out = launch_fwd(means, scales, quats, opacities, features_dc,
                         features_rest, mask, c2w, fx, fy, cx, cy, params)
        ctx.save_for_backward(means, scales, quats, opacities, features_dc,
                              features_rest, mask, c2w, fx, fy, cx, cy)
        ctx.params = params
        ctx.mark_non_differentiable(*out[1:])
        return out

    @staticmethod
    def backward(ctx, g_packed, *_):
        grads = launch_bwd(*ctx.saved_tensors, g_packed.contiguous(),
                           ctx.params)
        return (*grads, None, None, None, None, None, None, None)


def launch_fwd(means, scales, quats, opacities, features_dc, features_rest,
               mask, c2w, fx, fy, cx, cy, params: _Params) -> Tuple:
    """Launch the forward kernel on checked, contiguous CUDA tensors;
    returns (packed_t, depths, radii, num_tiles_hit, radii_xy,
    tile_offset)."""
    n, v = means.shape[0], c2w.shape[0]
    n_pad = padded(n)
    dev = means.device
    f32 = dict(dtype=torch.float32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    packed_t = torch.empty((PACK_W, v * n_pad), **f32)
    depths = torch.empty((v * n_pad,), **f32)
    radii = torch.empty((v * n_pad,), **i32)
    num_tiles_hit = torch.empty((v * n_pad,), **i32)
    radii_xy = torch.empty((v * n_pad, 2), **f32)
    tile_offset = torch.empty((v * n_pad,), **i32)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _library("projection_fwd").projection_fwd(
        *(_ptr(x) for x in (means, scales, quats, opacities, features_dc,
                            features_rest, mask, c2w)),
        c2w.stride(0), *(_ptr(x) for x in (fx, fy, cx, cy)),
        n, n_pad, v, params.degree, params.width, params.height,
        params.tile_size, params.clip_thresh, 1.0 / params.alpha_threshold,
        *(_ptr(x) for x in (packed_t, depths, radii, num_tiles_hit,
                            radii_xy, tile_offset)), stream)
    if err != 0:
        raise RuntimeError(f"projection_fwd launch failed: cudaError {err}")
    LAUNCHES["projection_fwd"] += 1
    return packed_t, depths, radii, num_tiles_hit, radii_xy, tile_offset


def launch_bwd(means, scales, quats, opacities, features_dc, features_rest,
               mask, c2w, fx, fy, cx, cy, g_packed: torch.Tensor,
               params: _Params) -> Tuple:
    """Launch the backward kernel; returns the gradients of means, scales,
    quats, opacities, features_dc and features_rest (None at degree 0)."""
    n, v = means.shape[0], c2w.shape[0]
    if v > MAX_BWD_VIEWS:
        raise ValueError(f"{v} views exceed the backward's {MAX_BWD_VIEWS}")
    if g_packed.shape != (PACK_W, v * padded(n)) \
            or g_packed.dtype != torch.float32:
        raise ValueError(f"the cotangent must be ({PACK_W}, {v * padded(n)}) "
                         f"float32, got {tuple(g_packed.shape)}")
    grads = [torch.empty_like(x) for x in (means, scales, quats, opacities,
                                           features_dc)]
    grads.append(None if features_rest is None
                 else torch.empty_like(features_rest))
    stream = torch.cuda.current_stream(means.device).cuda_stream
    err = _library("projection_bwd").projection_bwd(
        *(_ptr(x) for x in (means, scales, quats, opacities, features_dc,
                            features_rest, mask, c2w)),
        c2w.stride(0), *(_ptr(x) for x in (fx, fy, cx, cy, g_packed)),
        n, padded(n), v, params.degree, params.width, params.height,
        params.clip_thresh, *(_ptr(x) for x in grads), stream)
    if err != 0:
        raise RuntimeError(f"projection_bwd launch failed: cudaError {err}")
    LAUNCHES["projection_bwd"] += 1
    return tuple(grads)

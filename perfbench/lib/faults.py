"""Faults planted in the timed path, to show that ``correct`` catches them
(perfbench/tests) and to read the upper limits that they set (control.py
--faults). Each is a function of the runner, called once its program
objects are built and before its warm-up or checked steps."""
from __future__ import annotations

from typing import Callable, Dict

import torch

from perfbench.lib import program


def state_unchanged(d) -> None:
    """The train step returns its state unchanged: the optimizer does not
    step."""
    d.opt.step = lambda: None


def half_batch(d) -> None:
    """Half of the batch left out, the mean taken over the rest: each
    step's loss sees the first half of its views."""
    for b in d.batches:
        v = b.cameras.c2w.shape[0] // 2
        b.cameras = b.cameras.replace(
            c2w=b.cameras.c2w[:v], fx=b.cameras.fx[:v], fy=b.cameras.fy[:v],
            cx=b.cameras.cx[:v], cy=b.cameras.cy[:v])
        b.images = b.images[:v]


def _alter_render(d, shift: float) -> None:
    mod = program.train_step_module
    render = mod.render_images_stats

    def altered(*args, **kwargs):
        rgb, alpha, stats = render(*args, **kwargs)
        return rgb + shift, alpha, stats
    mod.render_images_stats = altered
    d.restore = lambda: setattr(mod, "render_images_stats", render)


def image_altered(d) -> None:
    """An answer altered where it is produced: the render's rgb moved by
    1/255."""
    _alter_render(d, 1.0 / 255.0)


def head_scaled(d) -> None:
    """An answer altered where it is produced: the opacity head's output
    scaled by 1.05."""
    d.model.get_submodule("head_opacities").register_forward_hook(
        lambda m, a, out: out * 1.05)


def _patch_downsampling(d, name: str, wrap: Callable) -> None:
    """Replace ops/downsample.py's ``name`` by ``wrap`` of it, undone by
    ``d.restore``."""
    mod = program.downsample_module
    fn = getattr(mod, name)
    setattr(mod, name, wrap(fn))
    d.restore = lambda: setattr(mod, name, fn)


def fps_pick_moved(d) -> None:
    """A changed FPS pick: the last centroid swapped for its neighbour, the
    next live point in the input's order that is not a centroid."""
    def wrap(fps):
        def moved(coord, mask, m):
            picks = fps(coord, mask, m).clone()
            n = mask.shape[0]
            free = mask.clone()
            free[picks] = False
            after = (torch.arange(n, device=mask.device) - picks[-1] - 1) % n
            picks[-1] = torch.where(free, after, n).argmin()
            return picks
        return moved
    _patch_downsampling(d, "furthest_point_sampling", wrap)


def cluster_mean_moved(d) -> None:
    """A cluster mean moved: the first reduced point's x moved by 1e-4 of
    the scene's extent (its widest axis over the live points)."""
    def wrap(means):
        def moved(coord, feat, mask, assign, m):
            ds_coord, ds_feat, cnt = means(coord, feat, mask, assign, m)
            live = coord[mask]
            extent = (live.max(0).values - live.min(0).values).max()
            ds_coord = ds_coord.clone()
            ds_coord[0, 0] += 1e-4 * extent
            return ds_coord, ds_feat, cnt
        return moved
    _patch_downsampling(d, "_cluster_means", wrap)


FAULTS: Dict[str, Dict[str, Callable]] = {
    "serve": {"head_scaled": head_scaled, "image_altered": image_altered},
    "train": {"state_unchanged": state_unchanged, "half_batch": half_batch,
              "image_altered": image_altered},
}

# faults of input downsampling's own stage, by method
DOWNSAMPLE_FAULTS: Dict[str, Dict[str, Callable]] = {
    "fps": {"fps_pick_moved": fps_pick_moved,
            "cluster_mean_moved": cluster_mean_moved},
    "voxel": {"cluster_mean_moved": cluster_mean_moved},
}


def faults_for(cell: Dict) -> Dict[str, Callable]:
    """The faults a cell can have: its kind's, and, where its configuration
    downsamples the input, those of the downsampling's stage."""
    method = cell["config"]["model"]["additional_info"].get("downsample")
    return {**FAULTS[cell["traffic"]["kind"]],
            **DOWNSAMPLE_FAULTS.get(method, {})}

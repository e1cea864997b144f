"""Faults planted in the timed path, to show that ``correct`` catches them
(perfbench/tests) and to read the upper limits that they set (control.py
--faults). Each is a function of the runner, called once its program
objects are built and before its warm-up or checked steps."""
from __future__ import annotations

from typing import Callable, Dict

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


FAULTS: Dict[str, Dict[str, Callable]] = {
    "serve": {"head_scaled": head_scaled, "image_altered": image_altered},
    "train": {"state_unchanged": state_unchanged, "half_batch": half_batch,
              "image_altered": image_altered},
}

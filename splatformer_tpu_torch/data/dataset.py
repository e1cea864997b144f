"""Scene dataset (port of splatformer_tpu/data/dataset.py; the reference's
SplatfactoDataset, dataset/GS.py:16-399): splatfacto checkpoints and
COLMAP folders -> padded scene batches on a device.

  * test scenes are sharded across processes in contiguous chunks, the
    last process taking the remainder (GS.py:54-68);
  * training scenes follow a seeded permutation per epoch, padded to the
    process count and chunked (GS.py:92-120);
  * each sample draws ``image_per_scene`` views, each from the OOD test
    pool with probability ``sample_ratio_test`` (GS.py:360-382);
  * RGBA images are composited over a random or fixed background, and a
    real-data image keeps its ``masks/`` sibling as a 4th channel
    (GS.py:128-151);
  * Gaussians are padded to a fixed ``pad_to`` with a validity mask;
  * an LRU scene cache (``cache_steps`` / ``cache_num_scenes``).

Everything here is numpy on the host until ``to_scene_batch`` moves one
sample to a device. The caller passes the process index and count.
"""
from __future__ import annotations

import os
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from splatformer_tpu_torch.data import image_io
from splatformer_tpu_torch.data import nerfstudio as ns
from splatformer_tpu_torch.device import resolve_device
from splatformer_tpu_torch.ops.types import Camera, GaussianScene
from splatformer_tpu_torch.training.train_step import SceneBatch


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def read_image(path: str, background: np.ndarray) -> np.ndarray:
    """RGBA -> RGB composited over ``background``; a real-data image (a path
    with "real" in it) with a ``masks/`` sibling keeps the mask as a 4th
    channel (GS.py:128-151)."""
    image = image_io.decode_image(path)
    mask = None
    if "real" in path.lower():
        mask_path = path.replace("images", "masks")
        if os.path.exists(mask_path):
            mask = image_io.decode_image(mask_path)
            if mask.ndim == 3:
                mask = mask[..., 0]
    if image.ndim == 2 or image.shape[2] == 1:
        image = np.repeat(image.reshape(image.shape[:2] + (1,)), 3, axis=-1)
    if image.shape[2] == 4:
        image = (image[:, :, :3] * image[:, :, 3:]
                 + background * (1.0 - image[:, :, 3:]))
    elif mask is not None:
        rgb = image[:, :, :3] * mask[..., None] + background * (1.0 - mask[..., None])
        image = np.concatenate([rgb, mask[..., None]], axis=-1)
    return image


def read_images(paths: Sequence[str], background: np.ndarray
                ) -> List[np.ndarray]:
    """``read_image`` of each path (the JAX package's threaded batch decode
    gives the same values)."""
    return [read_image(p, background) for p in paths]


def corrupt_gaussians(gs: Dict[str, np.ndarray], rng: np.random.Generator,
                      aug: Dict, pad_to: int) -> Dict[str, np.ndarray]:
    """Train-time corruption-resampling augmentation.

    A fresh corruption draw per sample makes (input, target) pairs
    impossible to memorize, forcing the scene-agnostic repair rule — the
    fix for held-out-scene overfitting demonstrated at CI scale in
    tests/test_refinement.py. Operates on the NORMALIZED gs dict (means in
    [0,1]^3, log scales, opacity logits). Two corruption families, modeled
    on real low-elevation-fit artifacts:

      * attribute jitter — mean/scale/quat/opacity noise (mis-converged
        splats);
      * floater injection — scene-colored, enlarged, fairly opaque
        Gaussians scattered with an upward bias (the unconstrained-top
        floaters the OOD protocol exposes,
        the reference's dataset/GS.py:222-238).

    The GT target images are unchanged: the refiner must learn to remove
    exactly these artifacts.
    """
    if rng.uniform() > aug.get("prob", 0.0):
        return gs
    out = {k: v.copy() for k, v in gs.items()}
    n = out["means"].shape[0]

    def jitter(key, sigma):
        if sigma > 0:
            out[key] = out[key] + rng.normal(
                0, sigma, out[key].shape).astype(np.float32)

    jitter("means", aug.get("noise_means", 0.0))
    jitter("scales", aug.get("noise_scales", 0.0))
    jitter("quats", aug.get("noise_quats", 0.0))
    jitter("opacities", aug.get("noise_opacities", 0.0))

    frac = aug.get("floater_frac", 0.0)
    if frac > 0:
        n_f = min(int(n * rng.uniform(0, frac)), pad_to - n)
        if n_f > 0:
            src = rng.integers(0, n, n_f)
            f = {k: out[k][src].copy() for k in out}
            f["means"] = np.stack([
                rng.uniform(0.05, 0.95, n_f),
                rng.uniform(0.05, 0.95, n_f),
                rng.uniform(0.35, 0.98, n_f),  # upward bias
            ], axis=1).astype(np.float32)
            f["scales"] = (f["scales"]
                           + rng.uniform(0.3, aug.get("floater_scale", 1.5),
                                         (n_f, 1))).astype(np.float32)
            f["opacities"] = rng.uniform(
                0.0, 3.0, f["opacities"].shape).astype(np.float32)
            q = rng.normal(size=(n_f, 4)).astype(np.float32)
            f["quats"] = q / (np.linalg.norm(q, axis=1, keepdims=True)
                              + 1e-8)
            for k in out:
                out[k] = np.concatenate([out[k], f[k]], axis=0)
    return out


def pad_gaussians(gs: Dict[str, np.ndarray], pad_to: int
                  ) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
    n = gs["means"].shape[0]
    assert n <= pad_to, (n, pad_to)
    out = {}
    for k, v in gs.items():
        pad = [(0, pad_to - n)] + [(0, 0)] * (v.ndim - 1)
        out[k] = np.pad(v, pad)
    mask = np.zeros(pad_to, bool)
    mask[:n] = True
    return out, mask


class SplatfactoScenes:
    """One instance per (split, dataset folder pair)."""

    def __init__(
        self,
        train_or_test: str,
        nerfstudio_folder: str,
        colmap_folder: str,
        load_pose_src: str = "nerfstudio",
        sample_ratio_test: Optional[float] = 0.7,
        image_per_scene: Optional[int] = 4,
        remove_outlier_ndevs: float = -1.0,
        max_gs_num: int = 100_000,
        pad_to: Optional[int] = None,
        background_color="random",
        cache_steps: int = 1,
        cache_num_scenes: int = 1,
        process_index: int = 0,
        process_count: int = 1,
        split_across_processes: bool = True,
        seed: int = 0,
        augment: Optional[Dict] = None,
    ):
        assert train_or_test in ("train", "test")
        self.augment = dict(augment) if augment else None
        self.train_or_test = train_or_test
        self.image_per_scene = image_per_scene
        self.sample_ratio_test = sample_ratio_test
        self.remove_outlier_ndevs = remove_outlier_ndevs
        self.max_gs_num = max_gs_num
        self.pad_to = pad_to or _round_up(max_gs_num, 1024)
        self.background_color = background_color
        self.load_pose_src = load_pose_src
        self.cache_steps = cache_steps
        self.cache_num_scenes = cache_num_scenes
        self.process_index = process_index
        self.process_count = process_count
        self.split_across_processes = split_across_processes
        self.seed = seed
        self.epoch = 0
        self._cache: List[list] = []

        ns_folders = sorted(
            os.path.join(nerfstudio_folder, d, "splatfacto")
            for d in os.listdir(nerfstudio_folder))
        if colmap_folder.endswith(".txt"):
            with open(colmap_folder) as f:
                cm_folders = [l.strip() for l in f if l.strip()]
        else:
            cm_folders = sorted(os.path.join(colmap_folder, d)
                                for d in os.listdir(colmap_folder))
        assert len(ns_folders) == len(cm_folders), (
            "nerfstudio and colmap folder counts differ")
        self.folders = list(zip(ns_folders, cm_folders))

        if train_or_test == "test":
            # deterministic contiguous chunks per process (GS.py:54-68)
            ids = list(range(len(self.folders)))
            if split_across_processes and process_count > 1:
                chunk = len(ids) // process_count
                if process_index == process_count - 1:
                    ids = ids[process_index * chunk:]
                else:
                    ids = ids[process_index * chunk:(process_index + 1) * chunk]
            self.scene_ids = ids
        else:
            self.scene_ids = list(range(len(self.folders)))

    def __len__(self) -> int:
        return len(self.scene_ids)

    # ------------------------------------------------------------------
    def _train_epoch_ids(self) -> List[int]:
        """Seeded permutation, padded to process_count, chunked
        (GS.py:92-120)."""
        rng = np.random.default_rng(self.seed + self.epoch)
        perm = rng.permutation(len(self.folders))
        if self.split_across_processes and self.process_count > 1:
            pad = self.process_count - len(perm) % self.process_count
            if pad and pad < self.process_count:
                perm = np.concatenate([perm, perm[:pad]])
            chunk = len(perm) // self.process_count
            if self.process_index == self.process_count - 1:
                perm = perm[self.process_index * chunk:]
            else:
                perm = perm[self.process_index * chunk:
                            (self.process_index + 1) * chunk]
        self.epoch += 1
        return [int(i) for i in perm]

    def load_scene(self, idx: int) -> dict:
        ns_dir, cm_dir = self.folders[idx]
        scene = ns.load_scene(ns_dir, cm_dir, self.load_pose_src,
                              self.remove_outlier_ndevs, self.max_gs_num)
        scene["idx"] = idx
        return scene

    def _cached_scene(self, idx: int) -> dict:
        for i, entry in enumerate(self._cache):
            if entry[0]["idx"] == idx:
                entry[1] += 1
                if self.cache_steps > 0 and entry[1] >= self.cache_steps:
                    # remove by position: list.remove would compare entries
                    # with ==, which broadcasts the numpy arrays inside the
                    # scene dicts (and fails across different-size scenes)
                    del self._cache[i]
                return entry[0]
        scene = self.load_scene(idx)
        if self.cache_steps != 1 and len(self._cache) < self.cache_num_scenes:
            self._cache.append([scene, 1])
        return scene

    def _background(self, rng: np.random.Generator) -> np.ndarray:
        if isinstance(self.background_color, str):
            assert self.background_color == "random"
            assert self.train_or_test == "train", \
                "test background cannot be random"
            return rng.uniform(size=3).astype(np.float32)
        return np.asarray(self.background_color, np.float32) / 255.0

    # ------------------------------------------------------------------
    def iter_train(self) -> Iterator[dict]:
        """Yields dicts with padded gs, sampled views, images, background."""
        assert self.train_or_test == "train"
        rng = np.random.default_rng(self.seed * 7919 + self.process_index)
        while True:
            for idx in self._train_epoch_ids():
                scene = self._cached_scene(idx)
                yield self.sample_views(scene, rng)

    def sample_views(self, scene: dict, rng: np.random.Generator) -> dict:
        meta = scene["meta"]
        n_train = len(meta["train_camera_to_worlds"])
        n_test = len(meta["test_camera_to_worlds"])
        v = self.image_per_scene
        sample_test = rng.random(v) < self.sample_ratio_test
        n_s_test = min(int(sample_test.sum()), n_test)
        n_s_train = min(v - n_s_test, n_train)
        background = self._background(rng)
        paths, c2ws = [], []
        if n_s_train > 0:
            ids = rng.permutation(n_train)[:n_s_train]
            paths += [scene["train_imgs_path"][i] for i in ids]
            c2ws.append(meta["train_camera_to_worlds"][ids])
        if n_s_test > 0:
            ids = rng.permutation(n_test)[:n_s_test]
            paths += [scene["test_imgs_path"][i] for i in ids]
            c2ws.append(meta["test_camera_to_worlds"][ids])
        images = read_images(paths, background)
        names = [os.path.basename(p) for p in paths]
        # top up to exactly v views if pools were short (static shapes)
        c2w = np.concatenate(c2ws, axis=0)
        while len(images) < v:
            images.append(images[len(images) % max(len(images), 1)])
            c2w = np.concatenate([c2w, c2w[-1:]], axis=0)
        gs_params = scene["gs_params"]
        if self.augment and self.train_or_test == "train":
            gs_params = corrupt_gaussians(gs_params, rng, self.augment,
                                          self.pad_to)
        gs, mask = pad_gaussians(gs_params, self.pad_to)
        return {
            "gs_params": gs, "gs_mask": mask,
            "images": np.stack(images).astype(np.float32),
            "c2w": c2w[:, :3, :4].astype(np.float32),
            "intrinsics": {k: np.float32(meta[k]) for k in
                           ("fx", "fy", "cx", "cy", "width", "height")},
            "background": background,
            "scene_idx": scene["idx"], "scene_name": scene["scene_name"],
            "images_name": names,
        }

    def iter_test(self) -> Iterator[dict]:
        assert self.train_or_test == "test"
        background = self._background(np.random.default_rng(0))
        for idx in self.scene_ids:
            scene = self.load_scene(idx)
            meta = scene["meta"]
            images = read_images(scene["test_imgs_path"], background)
            gs, mask = pad_gaussians(scene["gs_params"], self.pad_to)
            yield {
                "gs_params": gs, "gs_mask": mask,
                "images": np.stack(images).astype(np.float32),
                "c2w": meta["test_camera_to_worlds"][:, :3, :4].astype(np.float32),
                "intrinsics": {k: np.float32(meta[k]) for k in
                               ("fx", "fy", "cx", "cy", "width", "height")},
                "background": background,
                "scene_idx": scene["idx"], "scene_name": scene["scene_name"],
                "images_name": [os.path.basename(p)
                                for p in scene["test_imgs_path"]],
            }


def prefetch_iterator(it: Iterator, depth: int = 2) -> Iterator:
    """Host-side prefetch thread, the reference DataLoader's num_workers:
    scene loading and PNG decoding overlap the device step. An exception
    in the thread is raised again here."""
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=max(int(depth), 1))
    sentinel = object()
    failure = []

    def worker():
        try:
            for item in it:
                q.put(item)
        except BaseException as e:  # handed to the consumer below
            failure.append(e)
        finally:
            q.put(sentinel)

    threading.Thread(target=worker, daemon=True).start()
    while True:
        item = q.get()
        if item is sentinel:
            if failure:
                raise failure[0]
            return
        yield item


def to_scene_batch(sample: dict, device="cuda") -> SceneBatch:
    """One host sample -> the port's SceneBatch on ``device`` (the JAX
    package's ``to_scene_batch([sample])`` without its device axis)."""
    device = resolve_device(device)

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    gs = {k: t(v) for k, v in sample["gs_params"].items()}
    scene = GaussianScene(
        means=gs["means"], scales=gs["scales"], quats=gs["quats"],
        opacities=gs["opacities"], features_dc=gs["features_dc"],
        features_rest=gs["features_rest"], mask=t(sample["gs_mask"]))
    v = sample["c2w"].shape[0]
    h, w = sample["images"].shape[1:3]

    def intr(k):
        return t(np.full((v,), sample["intrinsics"][k], np.float32))

    cameras = Camera(c2w=t(sample["c2w"]), fx=intr("fx"), fy=intr("fy"),
                     cx=intr("cx"), cy=intr("cy"), width=w, height=h)
    return SceneBatch(scene=scene, cameras=cameras,
                      images=t(sample["images"][..., :3]),
                      background=t(np.asarray(sample["background"])))

"""File/console logging, eval.csv results, image grids and PNG files (port
of splatformer_tpu/utils/logging.py). Single process: the JAX package's
process-0 gates have nothing to gate here.

``save_image`` writes PNG with numpy, ``zlib`` and ``struct`` alone (the
card's machine has no PIL).
"""
from __future__ import annotations

import logging
import os
import struct
import zlib
from typing import Dict, Optional

import numpy as np
import torch

EVAL_CSV_HEADER = "dataset,psnr,ssim,lpips,algo,r,max mem\n"


def get_logger(log_path: Optional[str] = None,
               name: str = "splatformer_tpu_torch") -> logging.Logger:
    """Console logger, and a file logger into ``log_path`` when given (a
    later path replaces an earlier one, so each run logs into its own
    directory)."""
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO)
    logger.propagate = False
    fmt = logging.Formatter("%(asctime)s %(levelname)s %(message)s")
    if not logger.handlers:
        sh = logging.StreamHandler()
        sh.setFormatter(fmt)
        logger.addHandler(sh)
    if log_path:
        path = os.path.abspath(log_path)
        files = [h for h in logger.handlers
                 if isinstance(h, logging.FileHandler)]
        if [h.baseFilename for h in files] != [path]:
            for h in files:
                logger.removeHandler(h)
                h.close()
            os.makedirs(os.path.dirname(path), exist_ok=True)
            fh = logging.FileHandler(path)
            fh.setFormatter(fmt)
            logger.addHandler(fh)
    return logger


def log_result_csv(csv_path: str, test_dataset: str, metrics: Dict[str, float],
                   algo: str = "base", r: float = 0.0,
                   max_mem: float = 0.0) -> None:
    """Append an eval.csv row with the reference's schema
    'dataset,psnr,ssim,lpips,algo,r,max mem'."""
    new = not os.path.exists(csv_path)
    with open(csv_path, "a") as f:
        if new:
            f.write(EVAL_CSV_HEADER)
        lp = metrics.get("lpips", float("nan"))
        f.write(f"{test_dataset},{metrics.get('psnr')},{metrics.get('ssim')},"
                f"{lp},{algo},{r},{max_mem}\n")


def device_peak_memory_mb(device: torch.device) -> float:
    """Peak memory allocated on ``device`` in MB; 0.0 on the CPU."""
    if device.type != "cuda":
        return 0.0
    return torch.cuda.max_memory_allocated(device) / 2 ** 20


def make_grid(imgs, nrow: int = 3, ncols: int = 3) -> np.ndarray:
    """uint8 image grid (reference make_grid, train.py:56-67)."""
    img_h, img_w = imgs[0].shape[:2]
    ch = (imgs[0].shape[2],) if imgs[0].ndim == 3 else ()
    grid = np.zeros((img_h * nrow, img_w * ncols) + ch, dtype=np.uint8)
    for i in range(nrow):
        for j in range(ncols):
            if i * ncols + j >= len(imgs):
                break
            grid[i * img_h:(i + 1) * img_h,
                 j * img_w:(j + 1) * img_w] = imgs[i * ncols + j]
    return grid


# PNG colour type by channel count: grey, grey + alpha, RGB, RGBA
_COLOR_TYPE = {1: 0, 2: 4, 3: 2, 4: 6}


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def save_image(path: str, img_uint8) -> None:
    """Write an (H, W) or (H, W, C in 1-4) uint8 array as an 8-bit PNG
    (every row filter 0)."""
    img = np.asarray(img_uint8)
    if img.dtype != np.uint8:
        raise ValueError(f"save_image wants uint8, got {img.dtype}")
    if img.ndim == 2:
        img = img[:, :, None]
    if img.ndim != 3 or img.shape[2] not in _COLOR_TYPE:
        raise ValueError(f"save_image: shape {img.shape} is not an image")
    h, w, c = img.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           np.ascontiguousarray(img).reshape(h, w * c)],
                          axis=1)
    png = (b"\x89PNG\r\n\x1a\n"
           + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8,
                                         _COLOR_TYPE[c], 0, 0, 0))
           + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
           + _chunk(b"IEND", b""))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(png)

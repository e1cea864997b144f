"""Geometry transforms for scene normalisation (copy of
splatformer_tpu/data/transforms.py), numpy on the host: the n-sigma outlier
mask on Gaussian means and the ratio-preserving MinMaxScaler that maps
means into [0, 1]^3 (one shared scale, the minimum over the axes, then the
scaled cloud centred); the same scaler moves camera positions and shifts
log-scales by log(scale).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def remove_outliers(points: np.ndarray, n_devs: float = 3.0,
                    already_centered: bool = False,
                    take_biggest_std: bool = False,
                    center: Optional[np.ndarray] = None
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (filtered_points, inlier_mask)."""
    if take_biggest_std:
        assert already_centered
    if not already_centered:
        if center is None:
            mean = points.mean(axis=0)
            std = points.std(axis=0, ddof=1)
        else:
            mean = center
            std = np.sqrt(((points - center) ** 2).mean(axis=0))
    else:
        mean = np.zeros(3, points.dtype)
        std = np.sqrt((points ** 2).mean(axis=0))
    if take_biggest_std:
        std = np.full(3, std.max())
    lower = mean - n_devs * std
    upper = mean + n_devs * std
    mask = np.all((points >= lower) & (points <= upper), axis=1)
    return points[mask], mask


class MinMaxScaler:
    """Ratio-preserving min-max scaler to [0, 1]^3 with centering."""

    def __init__(self, feature_range=(0.0, 1.0), preserve_ratio: bool = True,
                 already_centered: bool = False, already_scaled: bool = False):
        assert preserve_ratio
        if already_scaled:
            assert already_centered
        self.feature_range = feature_range
        self.already_centered = already_centered
        self.already_scaled = already_scaled
        self.scale_: Optional[np.ndarray] = None
        self.trans_: Optional[np.ndarray] = None

    def fit_transform(self, x: np.ndarray) -> np.ndarray:
        lo, hi = self.feature_range
        if not self.already_centered and not self.already_scaled:
            data_min = x.min(axis=0)
            data_max = x.max(axis=0)
            data_range = data_max - data_min
            center = (lo + hi) / 2.0
            scale = (hi - lo) / np.maximum(data_range, 1e-20)
            self.scale_ = np.asarray(scale.min(), x.dtype)
            scaled = x * self.scale_
            mid = (scaled.min(axis=0) + scaled.max(axis=0)) / 2.0
            self.trans_ = center - mid
        else:
            assert self.feature_range == (0.0, 1.0)
            self.trans_ = np.full(3, 0.5, x.dtype)
            if not self.already_scaled:
                self.scale_ = np.asarray(0.5 / np.abs(x).max(), x.dtype)
            else:
                self.scale_ = np.asarray(0.5, x.dtype)
            scaled = x * self.scale_
        return scaled + self.trans_

    # alias matching the reference's separate fit/transform usage
    def fit(self, x: np.ndarray) -> "MinMaxScaler":
        self.fit_transform(x)
        return self

    def transform(self, x: np.ndarray) -> np.ndarray:
        return x * self.scale_ + self.trans_

    def inverse_transform(self, x: np.ndarray) -> np.ndarray:
        return (x - self.trans_) / self.scale_

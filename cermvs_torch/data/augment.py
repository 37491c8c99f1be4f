"""Deterministic resize / center-crop with intrinsics bookkeeping, as
``inference()`` uses them. Images are (N, H, W, 3) float32 NHWC numpy arrays;
intrinsics (N, 3, 3)."""

from __future__ import annotations

import cv2
import numpy as np


def _resize_stack(frames: np.ndarray, ht: int, wd: int, interp) -> np.ndarray:
    return np.stack(
        [cv2.resize(f, (wd, ht), interpolation=interp) for f in frames], 0)


def scale_operation(images: np.ndarray, intrinsics: np.ndarray, s: float):
    """Resize by factor s (bilinear) and scale the intrinsics' first two rows."""
    ht1, wd1 = images.shape[1:3]
    ht2, wd2 = int(s * ht1), int(s * wd1)
    intrinsics = intrinsics.copy()
    intrinsics[:, 0] *= s
    intrinsics[:, 1] *= s
    images = _resize_stack(images, ht2, wd2, cv2.INTER_LINEAR)
    return images, intrinsics


def crop_operation(images: np.ndarray, intrinsics: np.ndarray,
                   crop_h: int, crop_w: int):
    """Center crop with the principal point shifted to match."""
    ht1, wd1 = images.shape[1:3]
    x0 = (wd1 - crop_w) // 2
    y0 = (ht1 - crop_h) // 2
    images = images[:, y0 : y0 + crop_h, x0 : x0 + crop_w]
    intrinsics = intrinsics.copy()
    intrinsics[:, 0, 2] -= x0
    intrinsics[:, 1, 2] -= y0
    return images, intrinsics


def pad_to_multiple(images: np.ndarray, intrinsics: np.ndarray, multiple: int):
    """Center-crop H and W DOWN to the nearest multiple of ``multiple`` (the
    encoder stride)."""
    ht, wd = images.shape[1:3]
    ch = (ht // multiple) * multiple
    cw = (wd // multiple) * multiple
    if ch == ht and cw == wd:
        return images, intrinsics
    return crop_operation(images, intrinsics, ch, cw)

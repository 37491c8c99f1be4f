"""Resize and crop with intrinsics bookkeeping: a random log-uniform scale
and random crop for training, a deterministic scale and center crop for
inference. Images are (N, H, W, 3) float32 NHWC numpy arrays; depths
(N, H, W); intrinsics (N, 3, 3)."""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import cv2
import numpy as np

from cermvs_torch.config import configurable


def _resize_stack(frames: np.ndarray, ht: int, wd: int, interp) -> np.ndarray:
    return np.stack(
        [cv2.resize(f, (wd, ht), interpolation=interp) for f in frames], 0)


@configurable("random_scale_and_crop")
def random_scale_and_crop(images: np.ndarray, depths: np.ndarray,
                          intrinsics: np.ndarray,
                          crop_size: Sequence[int] = (1056, 1440),
                          smin: float = -0.15, smax: float = 0.5,
                          rng: Optional[np.random.RandomState] = None
                          ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Scale by 2^U(smin, smax) (images bilinear, depths nearest), crop a
    random ``crop_size`` window, and fix the intrinsics to match."""
    rng = rng or np.random
    s = 2.0 ** rng.uniform(smin, smax)
    ht1, wd1 = images.shape[1:3]
    ht2, wd2 = int(s * ht1), int(s * wd1)

    intrinsics = intrinsics.copy()
    intrinsics[:, 0] *= float(wd2) / wd1
    intrinsics[:, 1] *= float(ht2) / ht1

    ch, cw = crop_size
    x0 = rng.randint(0, wd2 - cw + 1)
    y0 = rng.randint(0, ht2 - ch + 1)
    images = _resize_stack(images, ht2, wd2, cv2.INTER_LINEAR)
    depths = _resize_stack(depths, ht2, wd2, cv2.INTER_NEAREST)
    images = images[:, y0:y0 + ch, x0:x0 + cw]
    depths = depths[:, y0:y0 + ch, x0:x0 + cw]
    intrinsics[:, 0, 2] -= x0
    intrinsics[:, 1, 2] -= y0
    return images, depths, intrinsics


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

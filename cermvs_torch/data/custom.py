"""A dataset of the user's own frames (``Custom``): TUM trajectories.

The directory holds ``images/`` (one extension: jpg, jpeg or png, the first
found in name order), ``cams.txt`` (TUM rows ``t x y z qx qy qz qw``,
camera to world, one per image in name order), which are inverted to world
to camera, and ``intrinsic.txt``, one 3x3 matrix for every frame. A
reference's neighbours are a sliding window of frames around it, shifted
inward at the sequence's ends.

The scene scale is ``400 / min_depth``: with ``min_dist_over_baseline`` a
number, ``min_depth`` is the mean distance between consecutive cameras
times it; with None it is read per view from ``min_depth/<name>.txt``,
which a first pass at rescale 0.5 writes (``inference(write_min_depth=)``,
the three passes of ``demo_custom``).

Items are ``(images (N+1,H,W,3) float32 BGR, poses (N+1,4,4), intrinsics
(N+1,3,3), image_names, scale)``.
"""

from __future__ import annotations

import os
from pathlib import Path

import cv2
import numpy as np

from cermvs_torch.config import configurable
from cermvs_torch.data.loader import Dataset

IMAGE_FORMATS = (".jpg", ".jpeg", ".png")


def quat_to_matrix(q: np.ndarray) -> np.ndarray:
    """Quaternion (x, y, z, w) -> 3x3 rotation matrix, scipy's
    ``Rotation.from_quat(q).as_matrix()`` (q need not be unit)."""
    x, y, z, w = q
    n = x * x + y * y + z * z + w * w
    s = 0.0 if n == 0 else 2.0 / n
    xx, yy, zz = s * x * x, s * y * y, s * z * z
    xy, xz, yz = s * x * y, s * x * z, s * y * z
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    return np.array([
        [1 - yy - zz, xy - wz, xz + wy],
        [xy + wz, 1 - xx - zz, yz - wx],
        [xz - wy, yz + wx, 1 - xx - yy],
    ])


@configurable("Custom")
class Custom(Dataset):
    def __init__(self, dataset_path, num_frames, min_dist_over_baseline=1,
                 cam_format="TUM", subset=None, window_stride=1, **_):
        self.root = Path(dataset_path)
        names, ext = [], None
        for f in sorted(os.listdir(self.root / "images")):
            e = os.path.splitext(f)[-1].lower()
            if e in IMAGE_FORMATS and (ext is None or e == ext):
                ext = e
                names.append(os.path.splitext(f)[0])
        self.ext = ext
        self.data_index = sorted(names)
        n0 = len(self.data_index)
        if subset is not None:
            self.data_index = [self.data_index[x] for x in subset]

        if cam_format != "TUM":
            raise ValueError(f"unsupported cam_format {cam_format!r}")
        rows = np.loadtxt(self.root / "cams.txt", dtype=np.float64)[:, 1:]
        if len(rows) != n0:
            raise ValueError(f"cams.txt has {len(rows)} rows for {n0} "
                             f"images")
        if subset is not None:
            rows = rows[list(subset)]
        self.poses = np.zeros((len(rows), 4, 4))
        centers = []
        for i, r in enumerate(rows):
            c2w = np.eye(4)
            c2w[:3, :3] = quat_to_matrix(r[3:])
            c2w[:3, 3] = r[:3]
            centers.append(r[:3])
            self.poses[i] = np.linalg.inv(c2w)
        self.cam_centers = centers
        intrinsic = np.loadtxt(self.root / "intrinsic.txt", dtype=np.float64)
        self.intrinsics = [intrinsic] * len(rows)

        if min_dist_over_baseline is not None:
            baselines = [np.linalg.norm(np.subtract(centers[i],
                                                    centers[i + 1]))
                         for i in range(len(centers) - 1)]
            self.min_depth = (float(np.mean(baselines))
                              * min_dist_over_baseline)
        else:
            self.min_depth = None  # min_depth/<name>.txt per view

        self.num_frames = num_frames
        self.window_stride = window_stride
        self.offsets = np.arange(
            -num_frames // 2, -num_frames // 2 + num_frames + 1
        ) * window_stride

    def __len__(self):
        return len(self.data_index)

    def __getitem__(self, index):
        ids = self.offsets.copy() + index
        while ids[0] < 0:
            ids += self.window_stride
        while ids[-1] >= len(self.data_index):
            ids -= self.window_stride
        if ids[0] < 0:
            raise ValueError(f"{len(self.data_index)} frames are fewer than "
                             f"the window of {len(self.offsets)}")
        ids = [index] + [int(i) for i in ids if i != index]

        images, poses, intrinsics = [], [], []
        for i in ids:
            path = self.root / "images" / f"{self.data_index[i]}{self.ext}"
            img = cv2.imread(str(path))
            if img is None:
                raise FileNotFoundError(path)
            images.append(img.astype(np.float32))
            poses.append(self.poses[i])
            intrinsics.append(self.intrinsics[i])

        if self.min_depth is None:
            md = np.loadtxt(self.root / "min_depth"
                            / f"{self.data_index[index]}.txt",
                            dtype=np.float64)
            scale = 400.0 / float(md)
        else:
            scale = 400.0 / self.min_depth
        names = [self.data_index[i] for i in ids]
        return (np.stack(images), np.stack(poses).astype(np.float32),
                np.stack(intrinsics).astype(np.float32), names, float(scale))

"""Tanks and Temples test dataset (``TNT``), as the MVSNet-preprocessed set
lays it out.

* the training, intermediate and advanced scenes live under different
  directories: ``training_input/<scan>``,
  ``tankandtemples/intermediate/<scan>`` and
  ``tankandtemples/advanced/<scan>``;
* neighbours from ``pair.txt``, backfilled breadth-first when a view's
  list runs short, and a sliding window around the view when it is empty;
* the scene scale is ``400 / depth_min``, the first value of the reference
  camera's auxiliary row, so that stage 0's hypotheses (inverse depths up
  to 1/400) start at the scene's near plane.

Items are ``(images (N+1,H,W,3) float32 BGR, poses (N+1,4,4), intrinsics
(N+1,3,3), image_names, scale)``.
"""

from __future__ import annotations

from pathlib import Path

import cv2
import numpy as np

from cermvs_torch.config import configurable
from cermvs_torch.data.cams import read_cam_file
from cermvs_torch.data.loader import Dataset
from cermvs_torch.data.pairs import (backfill_neighbors, load_pair,
                                     window_neighbors)

TRAINING_SET = ["Barn", "Truck", "Caterpillar", "Ignatius", "Meetingroom",
                "Church", "Courthouse"]
INTERMEDIATE_SET = ["Family", "Francis", "Horse", "Lighthouse", "M60",
                    "Panther", "Playground", "Train"]
ADVANCED_SET = ["Auditorium", "Ballroom", "Courtroom", "Museum", "Palace",
                "Temple"]


def scene_root(dataset_path, scan) -> Path:
    """The directory of ``scan``: a training scene's, an intermediate one's,
    or else an advanced one's."""
    if scan in TRAINING_SET:
        return Path(dataset_path) / "training_input" / scan
    if scan in INTERMEDIATE_SET:
        return Path(dataset_path) / "tankandtemples" / "intermediate" / scan
    return Path(dataset_path) / "tankandtemples" / "advanced" / scan


@configurable("TNT")
class TNT(Dataset):
    def __init__(self, dataset_path="datasets/TanksAndTemples", scan=None,
                 num_frames=None, subset=None):
        self.scan = scan
        self.root = scene_root(dataset_path, scan)
        self.num_frames = num_frames
        self.pair_list = load_pair(self.root / "pair.txt")
        ids = self.pair_list["id_list"]
        self.index = list(range(len(ids))) if subset is None else list(subset)

    def __len__(self):
        return len(self.index)

    def __getitem__(self, index0):
        index = self.index[index0]
        ref_id = self.pair_list["id_list"][index]
        if self.pair_list[ref_id]["pair"]:
            neighbors = backfill_neighbors(self.pair_list, ref_id,
                                           self.num_frames)
        else:
            neighbors = window_neighbors(self.pair_list["id_list"], index,
                                         self.num_frames)
        names = [f"{ref_id:08d}"] + [f"{x:08d}" for x in neighbors]
        images, poses, intrinsics = [], [], []
        for name in names:
            path = self.root / "images" / f"{name}.jpg"
            img = cv2.imread(str(path))
            if img is None:
                raise FileNotFoundError(path)
            e, k, _ = read_cam_file(self.root / "cams" / f"{name}_cam.txt")
            images.append(img.astype(np.float32))
            poses.append(e)
            intrinsics.append(k)
        _, _, aux = read_cam_file(self.root / "cams" / f"{names[0]}_cam.txt")
        scale = 400.0 / aux[0]
        return (np.stack(images), np.stack(poses).astype(np.float32),
                np.stack(intrinsics).astype(np.float32), names, float(scale))

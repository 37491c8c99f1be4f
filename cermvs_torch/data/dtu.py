"""DTU datasets: ``DTU`` (training) and ``DTUTest``.

* the 85 training scans;
* 7 lighting conditions x 49 views per training scan
  (``light_number`` picks one);
* neighbours from ``Cameras/pair.txt``, or drawn from a pose-angle graph
  with angles in (min_angle, max_angle);
* intrinsics scaled by the image/depth resolution ratio;
* training samples scaled and cropped at random
  (``augment.random_scale_and_crop``);
* the test split uses the fixed lighting ``_3_r5000``, breadth-first
  neighbour backfill and scale 1.

Samples are NHWC float32 (images as cv2 reads them, BGR): train ->
dict(images (N+1,H,W,3), depths (N+1,H,W), poses (N+1,4,4), intrinsics
(N+1,3,3)); test -> (images, poses, intrinsics, image_names, scale).
"""

from __future__ import annotations

import glob
from pathlib import Path

import cv2
import numpy as np

from cermvs_torch.config import configurable
from cermvs_torch.data.augment import random_scale_and_crop
from cermvs_torch.data.cams import read_cam_file
from cermvs_torch.data.loader import Dataset
from cermvs_torch.data.pairs import backfill_neighbors, load_pair
from cermvs_torch.io import read_pfm_fast as read_pfm

TRAINING_SET = [
    113, 14, 124, 111, 89, 45, 61, 104, 63, 22, 73, 39, 16, 42, 57, 8, 120,
    119, 83, 65, 103, 76, 87, 18, 58, 107, 91, 90, 99, 6, 41, 36, 46, 55, 109,
    52, 101, 126, 25, 19, 94, 88, 100, 7, 44, 122, 125, 51, 47, 96, 69, 98,
    30, 68, 121, 127, 105, 93, 53, 102, 64, 72, 27, 123, 128, 2, 116, 108, 20,
    112, 92, 85, 50, 84, 70, 95, 26, 97, 60, 54, 31, 74, 71, 115,
]
VIEWS = 49  # per scan and light


def pose_angles(poses: np.ndarray) -> np.ndarray:
    """Pairwise relative rotation angles in degrees."""
    delta = np.matmul(poses[:, None], np.linalg.inv(poses[None, :]))
    dR = delta[..., :3, :3]
    cos_theta = (np.trace(dR, axis1=-2, axis2=-1) - 1.0) / 2.0
    return np.rad2deg(np.arccos(np.clip(cos_theta, -1.0, 1.0)))


def _pose_graph(poses, min_angle, max_angle):
    thetas = pose_angles(poses)
    graph, ranked = [], []
    for i in range(len(poses)):
        graph.append(np.where((thetas[i] > min_angle)
                              & (thetas[i] < max_angle))[0])
        ranked.append([j for _, j in sorted(
            (thetas[i, j], j) for j in range(len(poses))
            if thetas[i, j] > min_angle)])
    return graph, ranked


def _read_image(path) -> np.ndarray:
    img = cv2.imread(str(path))
    if img is None:
        raise FileNotFoundError(path)
    return img.astype(np.float32)


def _neighbors_from_graph(rng, graph, ranked, ref_id, num_frames):
    if len(graph[ref_id]) < num_frames:
        cands = ranked[ref_id][:num_frames * 2]
    else:
        cands = graph[ref_id]
    return rng.choice(np.asarray(cands), num_frames, replace=False).tolist()


@configurable("DTU")
class DTU(Dataset):
    def __init__(self, dataset_path="datasets/DTU", num_frames=10,
                 light_number=-1, pairs_provided=True, min_angle=3.0,
                 max_angle=30.0, seed=0):
        self.root = Path(dataset_path)
        self.num_frames = num_frames
        self.min_angle = min_angle
        self.max_angle = max_angle
        self.pairs_provided = pairs_provided
        self.rng = np.random.RandomState(seed)

        image_root = self.root / "Rectified"
        depth_root = self.root / "Depths"
        self.scenes = {}
        self.index = []
        self.image_depth_scale = None
        lights = range(7) if light_number == -1 else [light_number]
        for scan_id in TRAINING_SET:
            scene = f"scan{scan_id}"
            for k in lights:
                images = sorted(glob.glob(str(image_root / scene
                                              / f"*_{k}_*.png")))
                depths = sorted(glob.glob(str(depth_root / scene / "*.pfm")))
                if not images or not depths:
                    continue
                if self.image_depth_scale is None:
                    ih = _read_image(images[0]).shape[0]
                    dh = read_pfm(depths[0]).shape[0]
                    self.image_depth_scale = int(ih / dh)
                sid = f"{scene}_{k}"
                self.scenes[sid] = (images, depths)
                self.index += [(sid, i) for i in range(VIEWS)]

        self._load_poses()
        if pairs_provided:
            self.pair_list = load_pair(self.root / "Cameras" / "pair.txt")

    def _load_poses(self):
        cams = sorted(glob.glob(str(self.root / "Cameras" / "*_cam.txt")))
        poses, intr = [], []
        for c in cams:
            e, k, _ = read_cam_file(c)
            k = k.copy()
            k[0] *= self.image_depth_scale
            k[1] *= self.image_depth_scale
            poses.append(e)
            intr.append(k)
        self.poses = np.stack(poses)
        self.intrinsics = np.stack(intr)
        self.pose_graph, self.theta_ranked = _pose_graph(
            self.poses, self.min_angle, self.max_angle)

    def __len__(self):
        return len(self.index)

    def _neighbors(self, ref_id):
        if self.pairs_provided:
            return self.pair_list[ref_id]["pair"][:self.num_frames]
        return _neighbors_from_graph(self.rng, self.pose_graph,
                                     self.theta_ranked, ref_id,
                                     self.num_frames)

    def __getitem__(self, index):
        sid, ref_id = self.index[index]
        image_list, depth_list = self.scenes[sid]
        ids = [ref_id] + list(self._neighbors(ref_id))
        images = np.stack([_read_image(image_list[i]) for i in ids])
        depths = np.stack(
            [read_pfm(depth_list[i]).astype(np.float32) for i in ids])
        poses = self.poses[ids].astype(np.float32)
        intrinsics = self.intrinsics[ids].astype(np.float32)
        images, depths, intrinsics = random_scale_and_crop(
            images, depths, intrinsics, rng=self.rng)
        return {"images": images, "depths": depths, "poses": poses,
                "intrinsics": intrinsics}


@configurable("DTUTest")
class DTUTest(Dataset):
    def __init__(self, dataset_path="datasets/DTU", scan=None,
                 num_frames=None, subset=None, min_angle=4.0, max_angle=30.0,
                 pairs_provided=True, seed=0):
        self.root = Path(dataset_path)
        self.scan = scan
        self.num_frames = num_frames
        self.pairs_provided = pairs_provided
        self.rng = np.random.RandomState(seed)

        self.image_list = sorted(glob.glob(
            str(self.root / "Rectified" / scan / "rect_*_3_r5000.png")))
        poses, intr = [], []
        for i in range(VIEWS):
            e, k, _ = read_cam_file(self.root / "Cameras"
                                    / f"{i:08d}_cam.txt")
            poses.append(e)
            intr.append(k)
        self.poses = np.stack(poses)
        self.intrinsics = np.stack(intr)
        self.pose_graph, self.theta_ranked = _pose_graph(
            self.poses, min_angle, max_angle)
        if pairs_provided:
            self.pair_list = load_pair(self.root / "Cameras" / "pair.txt")
        self.index = (list(range(len(self.image_list))) if subset is None
                      else list(subset))

    def __len__(self):
        return len(self.index)

    def __getitem__(self, index0):
        ref_id = self.index[index0]
        if self.pairs_provided:
            neighbors = backfill_neighbors(self.pair_list, ref_id,
                                           self.num_frames)
        else:
            neighbors = _neighbors_from_graph(
                self.rng, self.pose_graph, self.theta_ranked, ref_id,
                self.num_frames)
        ids = [ref_id] + list(neighbors)
        images = np.stack([_read_image(self.image_list[i]) for i in ids])
        poses = self.poses[ids].astype(np.float32)
        intrinsics = self.intrinsics[ids].astype(np.float32)
        return images, poses, intrinsics, [str(i) for i in ids], 1.0

"""The one generator of every traffic mix: it reads a mix's parameters
(``portbench/traffic/<name>.json``) and makes the cell's inputs from the
seed. Nothing here imports the port.

Scenes:
  * ``arc``: the DTU rig as an arc of cameras on a sphere about the object,
    ``step`` rad apart in azimuth with a small alternating elevation, all
    looking at the origin (neighbouring views mostly lateral, as on the
    rig's arcs); DTU's focal (2892 px at 1600 wide);
  * ``walk``: a forward walk through a room, ``step`` m a frame, swaying
    ``sway`` m sideways with a little yaw, as a Tanks and Temples indoor
    scan (Meetingroom) is shot; its focal (1165 px at 1920 wide).

Frames are smooth random textures (noise an eighth the size, resized), a
bank of them drawn on the device from the seed; each visit takes a run of
the bank at an offset of its own, so consecutive visits see other
images. Training
depths are those of a sphere about the rig's centre.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def rng_of(seed: int, *keys: int) -> np.random.Generator:
    """A numpy generator for ``seed`` and the integer ``keys`` (any size;
    a negative one is taken modulo 2**64)."""
    return np.random.default_rng([int(k) % 2**64 for k in (seed,) + keys])


def torch_generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed) % (2**63))


def look_at(eye, target, up=(0.0, 1.0, 0.0)) -> np.ndarray:
    """World-to-camera pose of a camera at ``eye`` looking at ``target``."""
    eye = np.asarray(eye, np.float64)
    fwd = np.asarray(target, np.float64) - eye
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, np.asarray(up, np.float64))
    right /= np.linalg.norm(right)
    R = np.stack([right, np.cross(fwd, right), fwd])
    P = np.eye(4)
    P[:3, :3] = R
    P[:3, 3] = -R @ eye
    return P


def arc_pose(i: int, n: int = 49, step: float = 0.04, radius: float = 600.0,
             elevation: float = 0.015) -> np.ndarray:
    """Camera ``i`` of the ``n`` on the arc."""
    az = step * (i - (n - 1) / 2)
    el = elevation * (i % 3 - 1)
    eye = radius * np.array([np.sin(az) * np.cos(el), np.sin(el),
                             -np.cos(az) * np.cos(el)])
    return look_at(eye, [0.0, 0.0, 0.0])


def walk_pose(i: int, step: float = 0.1, sway: float = 0.1,
              sway_rate: float = 0.9, bob: float = 0.02,
              yaw_deg: float = 2.0, yaw_rate: float = 0.5) -> np.ndarray:
    """Frame ``i`` of the walk."""
    eye = np.array([sway * np.sin(sway_rate * i), bob * (i % 2), step * i])
    yaw = np.deg2rad(yaw_deg * np.sin(yaw_rate * i))
    return look_at(eye, eye + [np.sin(yaw), 0.0, np.cos(yaw)])


POSES = {"arc": arc_pose, "walk": walk_pose}


def centre(P: np.ndarray) -> np.ndarray:
    return -P[:3, :3].T @ P[:3, 3]


def intrinsics(focal: float, at_width: float, H: int, W: int) -> np.ndarray:
    f = focal * W / at_width
    return np.array([[f, 0.0, W / 2], [0.0, f, H / 2], [0.0, 0.0, 1.0]])


def nearest(candidates: List[int], ref: int, pose, count: int) -> List[int]:
    """The ``count`` candidates nearest ``ref`` by camera centre."""
    c0 = centre(pose(ref))
    d = [np.linalg.norm(centre(pose(j)) - c0) for j in candidates]
    return [candidates[k] for k in np.argsort(d, kind="stable")[:count]]


def texture_bank(seed: int, count: int, H: int, W: int, device,
                 chunk: int = 4) -> torch.Tensor:
    """(count, H, W, 3) fp32 frames in [0, 255] on ``device``: uniform
    noise an eighth the size, resized bicubically and clamped."""
    gen = torch_generator(seed, device)
    out = torch.empty((count, H, W, 3), dtype=torch.float32, device=device)
    for i in range(0, count, chunk):
        n = min(chunk, count - i)
        small = torch.rand((n, 3, max(1, H // 8), max(1, W // 8)),
                           generator=gen, device=device)
        big = F.interpolate(small, size=(H, W), mode="bicubic",
                            align_corners=False)
        out[i:i + n] = (big.clamp(0, 1) * 255.0).permute(0, 2, 3, 1)
    return out


def sphere_depth(P: np.ndarray, K: np.ndarray, H: int, W: int,
                 radius: float, device) -> torch.Tensor:
    """Depth (camera z) of the sphere of ``radius`` about the origin seen
    from pose P, (H, W) fp32 on ``device``; 0 where a ray misses it."""
    P = torch.as_tensor(P, dtype=torch.float64, device=device)
    Kinv = torch.linalg.inv(torch.as_tensor(K, dtype=torch.float64,
                                            device=device))
    v, u = torch.meshgrid(torch.arange(H, dtype=torch.float64, device=device),
                          torch.arange(W, dtype=torch.float64, device=device),
                          indexing="ij")
    d = Kinv @ torch.stack([u.reshape(-1), v.reshape(-1),
                            torch.ones_like(u).reshape(-1)])
    R, t = P[:3, :3], P[:3, 3]
    dw = R.T @ d
    c = -R.T @ t
    a = (dw * dw).sum(0)
    b = 2.0 * (c[:, None] * dw).sum(0)
    cc = float(c @ c) - radius ** 2
    disc = b * b - 4 * a * cc
    s = (-b - disc.clamp(min=0).sqrt()) / (2 * a)
    hit = (disc >= 0) & (s > 0)
    return torch.where(hit, s, torch.zeros_like(s)).reshape(H, W).float()


class ViewTraffic:
    """Reference views with their neighbours, as ``inference()``'s loader
    yields them: ``visit(i)`` is the i-th item, ``(images (N, H, W, 3) fp32
    in [0, 255], poses (N, 4, 4), intrinsics (N, 3, 3), names, scale)``.

    ``pool``: the reference views cycle over ``pool`` cameras of the scene,
    drawn from the seed (the same rig in every scan); ``pool: null``: visit
    i is frame ``start + i`` of the scene, ``start`` drawn from the seed
    (every view new). The neighbours are the ``neighbours`` nearest by
    camera centre among the scene's ``cameras`` (a rig), or among the
    frames within ``window`` of the reference (a walk)."""

    def __init__(self, mix: Dict, config: Dict, seed: int, device):
        self.mix = mix
        self.seed = int(seed)
        self.H, self.W = config["image_hw"]
        self.num_frames = int(config["num_frames"])
        self.pose = lambda i: POSES[mix["scene"]](i, **mix["scene_params"])
        self.K = intrinsics(mix["focal"], mix["focal_at_width"], self.H,
                            self.W)
        rng = rng_of(seed, 0)
        if mix.get("pool"):
            self.refs = [int(r) for r in rng.choice(
                mix["cameras"], mix["pool"], replace=False)]
        else:
            self.start = int(rng.integers(0, mix["start_range"]))
        self.bank = texture_bank(seed, mix["bank"], self.H, self.W,
                                 device).cpu().numpy()
        self._ids: Dict[int, List[int]] = {}

    def ids(self, i: int) -> List[int]:
        """Frame indices of visit i: the reference, then its neighbours."""
        ref = (self.refs[i % len(self.refs)] if self.mix.get("pool")
               else self.start + i)
        if ref not in self._ids:
            if self.mix.get("pool"):
                cands = [j for j in range(self.mix["cameras"]) if j != ref]
            else:
                w = self.mix["window"]
                cands = [j for j in range(ref - w, ref + w + 1) if j != ref]
            self._ids[ref] = [ref] + nearest(cands, ref, self.pose,
                                             self.num_frames)
        return self._ids[ref]

    def visit(self, i: int) -> Tuple:
        """The i-th item; its frames are a run of the bank at an offset
        drawn for the visit (a view of the bank, not a copy, so the loader
        costs the pipeline nothing)."""
        ids = self.ids(i)
        start = int(rng_of(self.seed, 1, i).integers(
            0, len(self.bank) - len(ids) + 1))
        images = self.bank[start:start + len(ids)]
        poses = np.stack([self.pose(j) for j in ids]).astype(np.float32)
        intr = np.tile(self.K, (len(ids), 1, 1)).astype(np.float32)
        return images, poses, intr, [f"v{i:06d}"], self.mix.get("scale", 1.0)


class BatchTraffic:
    """Training batches as the loader gives them: ``batch(i)`` is a dict of
    images (B, N, h, w, 3) fp32 in [0, 255], depths (B, N, h, w), poses
    (B, N, 4, 4) and intrinsics (B, N, 3, 3), numpy. Each sample: a
    reference camera of the scene, its ``neighbours`` nearest, the frames
    scaled by ``2^U(smin, smax)`` and cropped to ``crop`` at a random
    offset (intrinsics to match, as the training augmentation does),
    textures from the bank, the true depths of a sphere about the rig's
    centre, of radius ``sphere_radius[b]`` for sample b (so the samples of
    a batch differ in depth).

    The pool holds ``plans[kind]`` batches stepped through each
    construction ("twopass", "onepass" or "exact"): the construction of
    the key that a rectified training run's plan cache gives the batch,
    where the pool is stepped in its order from an empty cache (the first
    cached plan that covers the batch's plan, else its own plan widened; a
    one-pass key covers two-pass plans, so a two-pass batch may step
    one-pass). Candidate geometries (reference camera, scale, crop) are
    drawn one after another from ``geometry_seed`` and each is kept while
    its construction has room: the pool's sizes and order are the mix's
    own, the same for every seed, since the widths of its plans set the
    work of a step. The seed draws the textures (and the weights)."""

    def __init__(self, mix: Dict, config: Dict, seed: int, device):
        self.mix = mix
        self.seed = int(seed)
        self.device = device
        self.batch_size = int(config["batch_size"])
        self.num_frames = int(config["num_frames"])
        self.H, self.W = config["image_hw"]
        self.crop = tuple(config["crop_hw"])
        # the feature stride the planner plans at (HR encoders: 4)
        self.stride = 4 if config["model"]["encoder_type"] == "HR" else 8
        self.pose = lambda i: POSES[mix["scene"]](i, **mix["scene_params"])
        self.bank = texture_bank(seed, mix["bank"], *self.crop,
                                 device).cpu().numpy()
        self.slots, self.kinds = self._draw_pool()

    def _geometry(self, j: int, b: int):
        """Candidate j's sample b: its frame ids and intrinsics."""
        rng = rng_of(self.mix["geometry_seed"], 2, j, b)
        cams = self.mix["cameras"]
        ref = int(rng.integers(0, cams))
        ids = [ref] + nearest([i for i in range(cams) if i != ref], ref,
                              self.pose, self.num_frames)
        s = 2.0 ** rng.uniform(self.mix["smin"], self.mix["smax"])
        ht, wd = int(s * self.H), int(s * self.W)
        ch, cw = self.crop
        x0 = int(rng.integers(0, wd - cw + 1))
        y0 = int(rng.integers(0, ht - ch + 1))
        K = intrinsics(self.mix["focal"], self.mix["focal_at_width"],
                       self.H, self.W)
        K[0] *= wd / self.W
        K[1] *= ht / self.H
        K[0, 2] -= x0
        K[1, 2] -= y0
        return ids, K

    def plan_of(self, j: int):
        """The reference planner's plan of candidate j's batch."""
        from portbench.reference.route import plan_batch

        parts = [self._geometry(j, b) for b in range(self.batch_size)]
        return plan_batch({
            "poses": np.stack([np.stack([self.pose(i) for i in ids])
                               for ids, _ in parts]),
            "intrinsics": np.stack([np.tile(K, (len(ids), 1, 1))
                                    for ids, K in parts]),
            "images": np.zeros((self.batch_size, 1) + self.crop + (1,),
                               np.uint8)}, self.stride)

    def _draw_pool(self, most: int = 10000):
        from portbench.reference.rectify import PlanCache, widen_plan

        notches = PlanCache().notches
        room = dict(self.mix["plans"])
        keys, slots, kinds = [], [], []
        for j in range(most):
            if not any(room.values()):
                return slots, kinds
            plan = self.plan_of(j)
            key = (None if not plan.ok else
                   next((q for q in keys if q.covers(plan)), None)
                   or widen_plan(plan, notches))
            kind = ("exact" if key is None else
                    "twopass" if key.twopass else "onepass")
            if room.get(kind, 0) > 0:
                room[kind] -= 1
                slots.append(j)
                kinds.append(kind)
                if key is not None and all(q is not key for q in keys):
                    keys.append(key)
        raise ValueError(f"no pool of {self.mix['plans']} in {most} draws")

    def sample(self, i: int, b: int):
        j = self.slots[i]
        ids, K = self._geometry(j, b)
        ch, cw = self.crop
        frames = rng_of(self.seed, 4, j, b).choice(len(self.bank), len(ids),
                                                   replace=False)
        poses = np.stack([self.pose(k) for k in ids])
        radius = self.mix["sphere_radius"][b % len(self.mix["sphere_radius"])]
        depths = torch.stack([sphere_depth(P, K, ch, cw, radius, self.device)
                              for P in poses])
        return (self.bank[np.sort(frames)], depths.cpu().numpy(),
                poses.astype(np.float32),
                np.tile(K, (len(ids), 1, 1)).astype(np.float32))

    def batch(self, i: int) -> Dict[str, np.ndarray]:
        parts = [self.sample(i, b) for b in range(self.batch_size)]
        return {k: np.stack([p[n] for p in parts])
                for n, k in enumerate(("images", "depths", "poses",
                                       "intrinsics"))}


MIXES = {"views": ViewTraffic, "batches": BatchTraffic}


def make(mix: Dict, config: Dict, seed: int, device):
    """The traffic of mix ``mix`` for configuration ``config``."""
    return MIXES[mix["kind"]](mix, config, seed, device)

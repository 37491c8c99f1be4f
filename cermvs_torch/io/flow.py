"""Optical-flow and KITTI disparity I/O: Middlebury ``.flo`` files and
KITTI's 16-bit PNGs (flow: ``(u, v) * 64 + 2^15`` and a valid channel;
disparity: ``disp * 256``). Off the MVS path; the files are byte for byte
the JAX package's.
"""

from __future__ import annotations

from os.path import splitext

import cv2
import numpy as np

TAG_FLOAT = 202021.25


def read_flo(path) -> np.ndarray:
    """A ``.flo`` file as (H, W, 2) float32."""
    with open(path, "rb") as f:
        magic = np.fromfile(f, np.float32, count=1)
        if magic.size == 0 or magic[0] != TAG_FLOAT:
            raise ValueError(f"{path}: invalid .flo magic")
        w = int(np.fromfile(f, np.int32, count=1)[0])
        h = int(np.fromfile(f, np.int32, count=1)[0])
        data = np.fromfile(f, np.float32, count=2 * w * h)
    return data.reshape(h, w, 2)


def write_flo(path, flow: np.ndarray) -> None:
    if flow.ndim != 3 or flow.shape[2] != 2:
        raise ValueError("flow must be (H, W, 2)")
    h, w = flow.shape[:2]
    with open(path, "wb") as f:
        np.array([TAG_FLOAT], np.float32).tofile(f)
        np.array([w], np.int32).tofile(f)
        np.array([h], np.int32).tofile(f)
        flow.astype(np.float32).tofile(f)


def read_flow_kitti(path):
    """A KITTI flow PNG as ((H, W, 2) flow, (H, W) valid), float32."""
    raw = cv2.imread(str(path), cv2.IMREAD_ANYDEPTH | cv2.IMREAD_COLOR)
    raw = raw[:, :, ::-1].astype(np.float32)
    flow, valid = raw[:, :, :2], raw[:, :, 2]
    flow = (flow - 2**15) / 64.0
    return flow, valid


def write_flow_kitti(path, flow: np.ndarray) -> None:
    uv = 64.0 * flow + 2**15
    valid = np.ones((*flow.shape[:2], 1))
    uv = np.concatenate([uv, valid], axis=-1).astype(np.uint16)
    cv2.imwrite(str(path), uv[..., ::-1])


def read_disp_kitti(path):
    """A KITTI disparity PNG as ((H, W, 2) flow ``(-disp, 0)``, (H, W)
    valid where the disparity is positive)."""
    disp = cv2.imread(str(path), cv2.IMREAD_ANYDEPTH) / 256.0
    valid = disp > 0.0
    flow = np.stack([-disp, np.zeros_like(disp)], -1)
    return flow, valid


def read_gen(path):
    """A file read by its extension: images with cv2, ``.bin``/``.raw``
    with ``np.load``, ``.flo``, and ``.pfm`` (a colour map's first two
    channels); ``[]`` for any other."""
    from cermvs_torch.io import read_pfm_fast

    ext = splitext(str(path))[-1].lower()
    if ext in (".png", ".jpeg", ".ppm", ".jpg"):
        return cv2.imread(str(path))
    if ext in (".bin", ".raw"):
        return np.load(path)
    if ext == ".flo":
        return read_flo(path)
    if ext == ".pfm":
        f = read_pfm_fast(path).astype(np.float32)
        return f if f.ndim == 2 else f[:, :, :-1]
    return []

"""Binary PLY point clouds (the port's own copy; files are byte-identical to
the JAX package's).

The fused cloud's format: vertices with float32 x/y/z and uint8
red/green/blue, written as binary little-endian PLY.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

_VERTEX_DTYPE = np.dtype(
    [
        ("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
        ("red", "u1"), ("green", "u1"), ("blue", "u1"),
    ]
)


def write_ply(path, xyz: np.ndarray, rgb: np.ndarray) -> None:
    """Write an (N,3) float32 xyz + (N,3) uint8 rgb point cloud."""
    xyz = np.asarray(xyz, dtype=np.float32)
    rgb = np.asarray(rgb, dtype=np.uint8)
    if xyz.shape != rgb.shape or xyz.ndim != 2 or xyz.shape[1] != 3:
        raise ValueError(f"bad point cloud shapes {xyz.shape} / {rgb.shape}")
    n = xyz.shape[0]
    verts = np.empty(n, dtype=_VERTEX_DTYPE)
    verts["x"], verts["y"], verts["z"] = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    verts["red"], verts["green"], verts["blue"] = rgb[:, 0], rgb[:, 1], rgb[:, 2]

    header = "\n".join(
        [
            "ply",
            "format binary_little_endian 1.0",
            f"element vertex {n}",
            "property float x",
            "property float y",
            "property float z",
            "property uchar red",
            "property uchar green",
            "property uchar blue",
            "end_header",
        ]
    )
    with open(Path(path), "wb") as f:
        f.write(header.encode("ascii") + b"\n")
        verts.tofile(f)


def read_ply(path):
    """Read back a PLY written by :func:`write_ply` (tests / tooling)."""
    with open(path, "rb") as f:
        header = []
        while True:
            line = f.readline().decode("ascii").strip()
            header.append(line)
            if line == "end_header":
                break
        n = next(int(l.split()[-1]) for l in header if l.startswith("element vertex"))
        verts = np.fromfile(f, dtype=_VERTEX_DTYPE, count=n)
    xyz = np.stack([verts["x"], verts["y"], verts["z"]], -1)
    rgb = np.stack([verts["red"], verts["green"], verts["blue"]], -1)
    return xyz, rgb

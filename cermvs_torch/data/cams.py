"""MVSNet camera files: a 4x4 world-to-camera extrinsic, a 3x3 intrinsic and
an optional auxiliary row:

    extrinsic
    <4x4 world-to-camera>
    (blank)
    intrinsic
    <3x3 K>
    (blank)
    <depth_min [interval [num_depth [depth_max]]]>   # line 11
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Tuple

import numpy as np


def read_cam_file(path) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
    with open(path) as f:
        lines = f.readlines()
    extrinsic = np.array(
        [[float(v) for v in lines[r].split()] for r in range(1, 5)],
        np.float64)
    intrinsic = np.array(
        [[float(v) for v in lines[r].split()] for r in range(7, 10)],
        np.float64)
    aux = None
    if len(lines) > 11 and lines[11].strip():
        aux = np.array([float(v) for v in lines[11].split()], np.float64)
    return extrinsic, intrinsic, aux


def write_cam_file(path, extrinsic, intrinsic, aux=None) -> None:
    """The inverse of :func:`read_cam_file`."""
    rows = ["extrinsic"]
    rows += [" ".join(f"{v:.10g}" for v in r) for r in np.asarray(extrinsic)]
    rows += ["", "intrinsic"]
    rows += [" ".join(f"{v:.10g}" for v in r) for r in np.asarray(intrinsic)]
    rows += ["", "" if aux is None else " ".join(f"{v:.10g}" for v in aux)]
    Path(path).write_text("\n".join(rows) + "\n")

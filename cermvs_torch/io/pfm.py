"""PFM depth-map I/O (the port's own copy; files are byte-identical to the
JAX package's).

PFM is the interchange format between the inference, multires and fusion
stages: 'Pf' greyscale / 'PF' color header, a "width height" line, a negative
scale for little-endian data, rows stored bottom-up (hence the flipud).
"""

from __future__ import annotations

import re
import sys
from pathlib import Path

import numpy as np


def read_pfm(path) -> np.ndarray:
    with open(path, "rb") as f:
        header = f.readline().rstrip()
        if header == b"PF":
            color = True
        elif header == b"Pf":
            color = False
        else:
            raise ValueError(f"{path}: not a PFM file")

        dim_line = f.readline()
        m = re.match(rb"^(\d+)\s(\d+)\s*$", dim_line)
        if not m:
            raise ValueError(f"{path}: malformed PFM header")
        width, height = map(int, m.groups())

        scale = float(f.readline().rstrip())
        endian = "<" if scale < 0 else ">"

        data = np.fromfile(f, endian + "f")
    shape = (height, width, 3) if color else (height, width)
    return np.flipud(data.reshape(shape)).copy()


def write_pfm(path, image: np.ndarray, scale: float = 1.0) -> None:
    path = Path(path)
    if image.dtype != np.float32:
        raise ValueError("PFM image dtype must be float32")
    if image.ndim == 3 and image.shape[2] == 3:
        color = True
    elif image.ndim == 2 or (image.ndim == 3 and image.shape[2] == 1):
        color = False
    else:
        raise ValueError("image must be HxW, HxWx1 or HxWx3")

    image = np.flipud(image)
    if image.dtype.byteorder == "<" or (
        image.dtype.byteorder == "=" and sys.byteorder == "little"
    ):
        scale = -scale

    with open(path, "wb") as f:
        f.write(b"PF\n" if color else b"Pf\n")
        f.write(b"%d %d\n" % (image.shape[1], image.shape[0]))
        f.write(b"%f\n" % scale)
        image.tofile(f)

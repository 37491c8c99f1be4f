"""Multi-resolution depth-map merge (the JAX package's, on the host).

For each view, read the ``_scale1`` and ``_scale2`` passes, upsample the
low-res map to the high-res size, keep the high-res value where the two
agree within ``th`` relative (``|d1 - d2| < th * d1``), else fall back to
low-res; write the merged map as ``{name}{suffix1}{suffix2}_th{th}.pfm``
plus an optional visualization PNG. Host numpy and cv2: the stage reads
and writes files and does little arithmetic, so it has no device path.
"""

from __future__ import annotations

import os
from pathlib import Path

import cv2
import numpy as np

from cermvs_torch.config import configurable
from cermvs_torch.io.pfm import read_pfm, write_pfm


@configurable("multires")
def multires(output_folder, suffix1="", suffix2="", th=0.02, down_sample=1,
             visualize=False):
    output_folder = Path(output_folder)
    depths_dir = output_folder / "depths"
    names = sorted(
        n.split("_scale1")[0] for n in os.listdir(depths_dir) if "_scale1" in n)

    for name in names:
        im1 = read_pfm(depths_dir / f"{name}_scale1{suffix1}.pfm")
        im2 = read_pfm(depths_dir / f"{name}_scale2{suffix2}.pfm")
        im1 = cv2.resize(im1, im2.shape[::-1])
        mask = np.abs(im1 - im2) < th * im1
        im = np.where(mask, im2, im1).astype(np.float32)
        if down_sample != 1:
            im = cv2.resize(im, tuple(np.array(im.shape[::-1]) // down_sample))
        write_pfm(depths_dir / f"{name}{suffix1}{suffix2}_th{th}.pfm", im)

        if visualize:
            d = np.where(im > 0, 1.0 / np.where(im > 0, im, 1), 0)
            med = np.median(d[d > 0]) if (d > 0).any() else 1.0
            d = np.clip(d, 0, 5 * med)
            vis = (255 * d / max(d.max(), 1e-9)).astype(np.uint8)
            cv2.imwrite(str(depths_dir / f"{name}.png"),
                        cv2.applyColorMap(vis, cv2.COLORMAP_VIRIDIS))

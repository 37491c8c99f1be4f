"""Depth-map inference (one device, one reference view per forward).

``InferenceRunner`` owns the model and picks the cost-volume construction
per scene; ``inference()`` runs every reference view of a loader and writes
``depths/{ref}_scale{rescale}_nf{num_frames}.pfm`` (plus optional per-view
min-depth files).

Construction routing:
  * "exact": the gather construction (``ops/corr.py``);
  * "rectified": the rectified construction (``ops/corr_rectified.py``) when
    the host planner accepts the scene and its warped features fit
    ``rect_memory_budget``, else exact with a printed notice;
  * "auto": the same decision, silently.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from cermvs_torch.config import configurable
from cermvs_torch.data.augment import (crop_operation, pad_to_multiple,
                                       scale_operation)
from cermvs_torch.io.pfm import write_pfm
from cermvs_torch.models.raft import RAFT
from cermvs_torch.ops.corr_rectified import make_rectified_volume_fn
from cermvs_torch.ops.rectify import RectPlan, plan_rectification


class InferenceRunner:
    """Test-mode RAFT on one device with per-scene construction routing.

    ``model``: a port ``RAFT`` (its weights are used as they are); otherwise
    one is built from ``model_kwargs`` and, if given, loaded with the JAX
    parameter tree ``params`` (numpy leaves).
    """

    def __init__(self, model: Optional[RAFT] = None, params=None,
                 construction: str = "auto",
                 rect_lambda_max: float = 0.00375,
                 rect_memory_budget: float = 6e9, device="cuda",
                 **model_kwargs):
        if construction not in ("auto", "exact", "rectified"):
            raise ValueError(f"unknown construction {construction!r}")
        self.device = torch.device(device)
        if model is None:
            model = RAFT(test_mode=True, device=self.device, **model_kwargs)
        if params is not None:
            from cermvs_torch.utils.weights import load_jax_params

            load_jax_params(model, params)
        self.model = model.to(self.device).eval()
        self.model.test_mode = True
        self.construction = construction
        self.rect_lambda_max = rect_lambda_max
        # device-memory cap for the rectified path's warped feature rows
        # (shared across cascade stages): ~2*V*h_r*(w_r+ws_r)*C bytes
        self.rect_memory_budget = rect_memory_budget
        self._volumes: Dict[RectPlan, object] = {}
        self._warned_fallback = False
        self.last_path = "exact"

    def plan_for(self, poses, intrinsics, scale, img_shape) -> RectPlan:
        """Host-side rectification plan on the scaled, feature-stride
        geometry (not ok when the exact path must be used)."""
        f = self.model.stride_factor
        poses = np.asarray(poses, np.float64).copy()
        poses[..., :3, 3] *= float(scale)  # RAFT scales translations
        intr = np.asarray(intrinsics, np.float64).copy()
        intr[..., :2, :] /= f
        plan = plan_rectification(poses, intr, img_shape[0] // f,
                                  img_shape[1] // f,
                                  lambda_max=self.rect_lambda_max)
        if plan.ok:
            V = poses.shape[0] - 1
            rect_bytes = (2 * V * plan.h_r * (plan.w_r + plan.ws_r)
                          * self.model.dim_fmap)
            if rect_bytes > self.rect_memory_budget:
                plan = RectPlan(0, 0, 0, 0, False,
                                f"rect features ~{rect_bytes / 1e9:.1f} GB "
                                f"exceed budget")
        if (not plan.ok and self.construction == "rectified"
                and not self._warned_fallback):
            print(f"[inference] rectified construction unavailable "
                  f"({plan.reason}); using exact path")
            self._warned_fallback = True
        return plan

    @staticmethod
    def neighbor_order(poses) -> np.ndarray:
        """[0, neighbours sorted by ascending baseline to the reference]."""
        po = np.asarray(poses, np.float64)
        rel = po[1:] @ np.linalg.inv(po[0])
        centers = -np.einsum("vji,vj->vi", rel[:, :3, :3], rel[:, :3, 3])
        return np.concatenate(
            [[0], 1 + np.argsort(np.linalg.norm(centers, axis=-1),
                                 kind="stable")])

    def submit(self, images, poses, intrinsics, scale) -> torch.Tensor:
        """images (N, H, W, 3) in [0, 255] -> disparity (1, h, w) on device.

        Images cross to the device in bf16, as the model's encoders compute
        in bf16 regardless."""
        images = np.asarray(images, np.float32)
        poses = np.asarray(poses, np.float32)
        intrinsics = np.asarray(intrinsics, np.float32)
        vol_fn = None
        self.last_path = "exact"
        if self.construction != "exact":
            # neighbour order by baseline: the view aggregation is
            # permutation-invariant, and a canonical order keeps per-view
            # plans comparable across reference views
            order = self.neighbor_order(poses)
            images, poses, intrinsics = (images[order], poses[order],
                                         intrinsics[order])
            plan = self.plan_for(poses, intrinsics, scale, images.shape[1:3])
            if plan.ok:
                if plan not in self._volumes:
                    self._volumes[plan] = make_rectified_volume_fn(plan)
                vol_fn = self._volumes[plan]
                self.last_path = "rectified"
        dev = self.device
        im = torch.from_numpy(images).to(torch.bfloat16).to(dev)[None]
        po = torch.from_numpy(poses).to(dev)[None]
        k = torch.from_numpy(intrinsics).to(dev)[None]
        s = torch.tensor([float(scale)], dtype=torch.float32, device=dev)
        with torch.no_grad():
            return self.model(im, po, k, s, volume_fn=vol_fn)

    @staticmethod
    def finalize(disp: torch.Tensor) -> np.ndarray:
        """Disparity (1, h, w) -> depth map (h, w) float32 on the host."""
        d = disp[0].float().cpu().numpy()
        return np.where(d == 0, 0, 1.0 / np.where(d == 0, 1, d)).astype(
            np.float32)

    def __call__(self, images, poses, intrinsics, scale) -> np.ndarray:
        """images (N,H,W,3) float32 [0,255] -> depth map (h, w) float32."""
        return self.finalize(self.submit(images, poses, intrinsics, scale))


@configurable("inference")
def inference(test_loader, ckpt=None, output_folder="results",
              rescale: float = 1, crop=None, do_report: bool = False,
              write_min_depth: Optional[str] = None, params=None,
              model=None, model_kwargs: Optional[dict] = None,
              view_batch: int = 1, construction: str = "auto",
              device="cuda"):
    """Run depth inference for every reference view of ``test_loader``.

    ``test_loader`` yields ``(images, poses, intrinsics, image_names,
    scale)`` items and has ``.dataset.num_frames``. Weights come from
    ``model`` (a port RAFT), ``params`` (a JAX parameter tree) or ``ckpt``
    (a reference ``.pth``, with or without a ``module.`` prefix).
    """
    if view_batch != 1:
        raise NotImplementedError("the port runs one reference view per "
                                  "forward (view_batch=1)")
    if model is None and params is None:
        if ckpt is None:
            raise ValueError("need model, params or a ckpt path")
        if not str(ckpt).endswith(".pth"):
            raise NotImplementedError(
                f"{ckpt}: the port loads reference .pth checkpoints only")
        from cermvs_torch.utils.weights import load_reference_checkpoint

        model = load_reference_checkpoint(
            ckpt, RAFT(test_mode=True, device=device, **(model_kwargs or {})))
    runner = InferenceRunner(model=model, params=params,
                             construction=construction, device=device,
                             **({} if model is not None
                                else (model_kwargs or {})))

    output_folder = Path(output_folder)
    (output_folder / "depths").mkdir(exist_ok=True, parents=True)
    num_frames = test_loader.dataset.num_frames
    factor = runner.model.stride_factor

    for images, poses, intrinsics, image_names, scale in test_loader:
        tic = time.perf_counter()
        images, intrinsics = scale_operation(images, intrinsics, rescale)
        if crop is not None:
            images, intrinsics = crop_operation(images, intrinsics, *crop)
        images, intrinsics = pad_to_multiple(images, intrinsics, factor)
        depth = runner(images, poses, intrinsics, scale)
        name = image_names[0]
        if do_report:
            peak = (torch.cuda.max_memory_allocated(runner.device) / 2**20
                    if runner.device.type == "cuda" else 0.0)
            print(f"per view time: {time.perf_counter() - tic:.3f}s  "
                  f"peak device memory: {peak:.0f} MB ({name}, "
                  f"{runner.last_path})")
        write_pfm(output_folder / "depths"
                  / f"{name}_scale{rescale}_nf{num_frames}.pfm", depth)
        if write_min_depth is not None:
            md_dir = Path(write_min_depth)
            md_dir.mkdir(exist_ok=True, parents=True)
            valid = depth[depth > 0]
            min_depth = (float(np.quantile(valid, 0.1) / 2) if valid.size
                         else 0.0)
            (md_dir / f"{name}.txt").write_text(f"{min_depth}\n")

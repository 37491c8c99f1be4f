"""Sequence loss over the cascade's iterates with the disparity-to-depth
curriculum.

  * every prediction is upsampled bilinearly (align corners) to the ground
    truth's size;
  * iterate i of T weighs ``gamma^(T-1-i)``;
  * ``i_loss = gw * depth_L1 (clamped at the threshold) / 3.6e5
    + (1 - gw) * disp_L1``;
  * a masked mean plus 0.01 times the unmasked mean;
  * metrics on the final iterate: mean depth error and the <3/<10/<25
    fractions over valid pixels.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from cermvs_torch.config import configurable
from cermvs_torch.ops.sampling import resize_bilinear_align_corners


@configurable("sequence_loss")
def sequence_loss(disp_est: torch.Tensor, disp_gt: torch.Tensor,
                  gradual_weight, depthloss_threshold: float = 100.0,
                  gamma: float = 0.9, depth_cut: float = 1e-3
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """disp_est: (T, B, h, w) predictions; disp_gt: (B, H, W), zeros mark
    invalid pixels. Returns (scalar loss, metrics of the final iterate)."""
    T = disp_est.shape[0]
    H, W = disp_gt.shape[-2:]
    est = resize_bilinear_align_corners(disp_est.float(), H, W)
    disp_gt = disp_gt.float()
    gw = float(gradual_weight)

    valid = (disp_gt > 0.0).float()
    loss_disp = (est - disp_gt).abs()
    loss_depth = (1.0 / est.clamp(min=depth_cut)
                  - 1.0 / disp_gt.clamp(min=depth_cut)).abs()
    loss_depth = loss_depth.clamp(max=depthloss_threshold) / 3.6e5
    i_loss = gw * loss_depth + (1.0 - gw) * loss_disp

    weights = gamma ** torch.arange(T - 1, -1, -1, dtype=torch.float32,
                                    device=est.device)
    masked = (i_loss * valid).mean(dim=(1, 2, 3))
    unmasked = i_loss.mean(dim=(1, 2, 3))
    total = (weights * (masked + 0.01 * unmasked)).sum()

    with torch.no_grad():
        gt_safe = torch.where(valid > 0, disp_gt, torch.ones_like(disp_gt))
        epe = (1.0 / est[-1].clamp(min=depth_cut) - 1.0 / gt_safe).abs()
        denom = valid.sum().clamp(min=1.0)

        def vmean(x):
            return (x * valid).sum() / denom

        metrics = {
            "mean_depth_error": vmean(epe),
            "less3": vmean((epe < 3).float()),
            "less10": vmean((epe < 10).float()),
            "less25": vmean((epe < 25).float()),
        }
    return total, metrics

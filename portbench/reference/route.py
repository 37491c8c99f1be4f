"""The reference's own routing: which volume construction a reference view
or a training batch takes, worked out again from the poses with the frozen
planner (``rectify.py``), by the port's rules for one view a forward
(construction "auto") and for a rectified training batch."""

from __future__ import annotations

import numpy as np

from portbench.reference.corr_rectified import (MixedVolume,
                                                RectifiedVolume)
from portbench.reference.rectify import (PlanCache, RectPlan,
                                         plan_rectification,
                                         plan_rectification_partial,
                                         plan_union)

LAMBDA_MAX = 0.00375     # the planner's rate gate
MEMORY_BUDGET = 6e9      # bytes the warped feature rows may take


def neighbor_order(poses) -> np.ndarray:
    """[0, neighbours sorted by ascending baseline to the reference]."""
    po = np.asarray(poses, np.float64)
    rel = po[1:] @ np.linalg.inv(po[0])
    centers = -np.einsum("vji,vj->vi", rel[:, :3, :3], rel[:, :3, 3])
    return np.concatenate(
        [[0], 1 + np.argsort(np.linalg.norm(centers, axis=-1),
                             kind="stable")])


def _feature_geometry(poses, intrinsics, scale, img_hw, stride):
    poses = np.asarray(poses, np.float64).copy()
    poses[..., :3, 3] *= float(scale)
    intr = np.asarray(intrinsics, np.float64).copy()
    intr[..., :2, :] /= stride
    return poses, intr, img_hw[0] // stride, img_hw[1] // stride


def rect_bytes(plan: RectPlan, n_views: int, channels: int) -> int:
    return 2 * n_views * plan.h_r * (plan.w_r + plan.ws_r) * channels


def route_view(poses, intrinsics, scale, img_hw, stride: int,
               channels: int):
    """One reference view under construction "auto": ``(order, kind,
    key)`` with the neighbours' order (by baseline), the route
    ("rectified", "mixed" or "exact") and its key (a RectPlan, ``(plan,
    rect_views)`` or None)."""
    order = neighbor_order(poses)
    poses = np.asarray(poses)[order]
    intrinsics = np.asarray(intrinsics)[order]
    p, intr, h, w = _feature_geometry(poses, intrinsics, scale, img_hw,
                                      stride)
    V = p.shape[0] - 1
    plan = plan_rectification(p, intr, h, w, lambda_max=LAMBDA_MAX)
    if plan.ok and rect_bytes(plan, V, channels) <= MEMORY_BUDGET:
        return order, "rectified", plan
    pplan, rect_views = plan_rectification_partial(p, intr, h, w,
                                                   lambda_max=LAMBDA_MAX)
    if (not pplan.ok or not rect_views or len(rect_views) == V
            or rect_bytes(pplan, len(rect_views), channels) > MEMORY_BUDGET):
        return order, "exact", None
    return order, "mixed", (pplan, tuple(rect_views))


def volume_of(kind: str, key):
    """The construction of a route: None for exact."""
    if kind == "rectified":
        return RectifiedVolume(key)
    if kind == "mixed":
        return MixedVolume(*key)
    return None


def plan_batch(batch, stride: int) -> RectPlan:
    """The rectification plan of a training batch: each sample's plan at
    feature stride, merged by ``plan_union``."""
    poses = np.asarray(batch["poses"], np.float64)
    intr = np.asarray(batch["intrinsics"], np.float64).copy()
    intr[..., :2, :] /= stride
    H, W = np.asarray(batch["images"]).shape[2:4]
    return plan_union(plan_rectification(poses[b], intr[b], H // stride,
                                         W // stride)
                      for b in range(poses.shape[0]))


class BatchRouter:
    """Training batches' constructions, keyed through one ``PlanCache`` in
    the order the batches come, as a rectified training run keys them."""

    def __init__(self, stride: int):
        self.stride = stride
        self.cache = PlanCache()

    def key(self, batch):
        plan = plan_batch(batch, self.stride)
        return self.cache.key_for(plan) if plan.ok else None

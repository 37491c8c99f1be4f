"""View-sharded inference: the neighbour views split over the ranks of a
mesh's ``view`` axis.

Each rank encodes the reference frame and its own share of the neighbour
frames, and for every cascade stage builds the partial view-sum volume of
its views through the exact, rectified or mixed construction. One
``all_reduce(SUM)`` per stage, divided by V, gives every rank the view-mean
volume (the lookup is linear and its index is the same for every view), and
the GRU iterations then run replicated with no further communication. With
an aggregation other than the mean (max, std) the per-view volumes stay on
their rank and every iteration aggregates the looked-up features across the
ranks: the moments by SUM, the max by MAX.

Where this differs from the JAX package's ``parallel/infer.py`` on purpose
(ROADMAP North star): ``shard_map`` traces one program for every shard, so
JAX pads the views to a multiple of the shards, lays out the mixed
construction's rectified and exact slots alike on every shard and widens
every view's epiband window to the plan's scene-wide bounds. Ranks here
run their own code: each takes its share of the rectified views and of the
exact views with no padding, and builds each view in its own window. The
sum over the views is the same up to fp32 order; in a world of one it is
the unsharded forward's, bit for bit.

``view_scan`` (the JAX package's view grouping, not ported by decision) is
accepted and changes nothing.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.distributed as dist

from cermvs_torch.ops.corr import ExactVolume
from cermvs_torch.ops.corr_rectified import MixedVolume, RectifiedVolume
from cermvs_torch.ops.rectify import RectPlan, subplan
from cermvs_torch.parallel.mesh import (AXES, check_mesh, rank, view_group,
                                        world_size)


def shard_views(n_views: int, n_ranks: int, rect_views=None):
    """Each rank's neighbours (positions 0..V-1, ascending): the rectified
    views, then the exact ones, dealt round robin, so every rank holds
    ``V // n`` or one more and its share of each construction. No view is
    padded or repeated. ``rect_views``: the rectified neighbours, or None
    when one construction builds them all."""
    rect = list(rect_views) if rect_views is not None else []
    order = rect + [v for v in range(n_views) if v not in rect]
    return [sorted(order[r::n_ranks]) for r in range(n_ranks)]


class ViewShardedVolume:
    """One rank's share of a view-sharded construction over the ``n_views``
    neighbours, for RAFT's ``volume_fn`` (test mode).

    ``plan`` None: the exact construction; a plan with ``rect_views`` None:
    the rectified one; with ``rect_views`` (the plan's per-view entries in
    their order): the mixed one. The rank builds its views
    (:func:`shard_views`) through the exact, rectified or mixed
    construction of that share, each rectified view with its own entries
    of the plan (:func:`rectify.subplan`).

    RAFT calls :meth:`local_frames` before its encoders, so the rank
    encodes the reference and its own views alone; :meth:`build` sums the
    share's volumes, all-reduces the sum over ``group`` and divides by V;
    :meth:`aggregate` does the per-iteration aggregation where the model's
    volumes stay per view. The frame index is made on the device at the
    first call and kept, so a CUDA graph can capture a later one."""

    def __init__(self, n_views: int, group, plan: Optional[RectPlan] = None,
                 rect_views=None):
        if plan is not None and not plan.ok:
            plan = None
        if plan is None:
            rect_views = None
        n = world_size(group)
        if n_views < n:
            raise ValueError(f"{n_views} neighbours cannot be shared by "
                             f"{n} view ranks: each needs one at least")
        self.n_views = n_views
        self.group = group
        rect = (list(range(n_views)) if plan is not None and rect_views is None
                else list(rect_views or ()))
        self.views = shard_views(n_views, n, rect_views)[rank(group)]
        local_rect = [k for k, v in enumerate(self.views) if v in rect]
        if not local_rect:
            self.inner = ExactVolume()
        else:
            entries = [rect.index(self.views[k]) for k in local_rect]
            local_plan = subplan(plan, entries)
            if len(local_rect) == len(self.views):
                self.inner = RectifiedVolume(local_plan)
            else:
                self.inner = MixedVolume(local_plan, local_rect)
        self._frames: Dict[torch.device, torch.Tensor] = {}

    def frame_index(self, device) -> torch.Tensor:
        """[0, 1 + each of this rank's views] on ``device``."""
        device = torch.device(device)
        if device not in self._frames:
            self._frames[device] = torch.tensor(
                [0] + [1 + v for v in self.views], device=device)
        return self._frames[device]

    def local_frames(self, images, poses, intrinsics):
        idx = self.frame_index(images.device)
        return (images.index_select(1, idx), poses.index_select(1, idx),
                intrinsics.index_select(1, idx))

    def prepare(self, fmaps, poses, intrinsics, ii, jj, feature_dtype):
        return self.inner.prepare(fmaps, poses, intrinsics, ii, jj,
                                  feature_dtype)

    def build(self, ctx, origin, n_hyp, incre, hyp_chunk=16,
              mean_over_views=False, zero_slab=False):
        if not mean_over_views:
            return self.inner.build(ctx, origin, n_hyp, incre, hyp_chunk,
                                    False, zero_slab)
        vol = self.inner.build(ctx, origin, n_hyp, incre, hyp_chunk, True,
                               zero_slab, view_sum=True).contiguous()
        dist.all_reduce(vol, group=self.group)
        return vol / self.n_views

    def aggregate(self, corr_frames: torch.Tensor, aggregation
                  ) -> torch.Tensor:
        """The looked-up features (B, V_local, h, w, K) aggregated over
        every rank's views: the mean and the std's moments by SUM, the max
        by MAX (the JAX package's psum and pmax)."""
        parts = []
        mean = None
        if "mean" in aggregation or "std" in aggregation:
            mean = corr_frames.sum(1)
            dist.all_reduce(mean, group=self.group)
            mean = mean / self.n_views
        if "mean" in aggregation:
            parts.append(mean)
        if "max" in aggregation:
            top = corr_frames.amax(1)
            dist.all_reduce(top, op=dist.ReduceOp.MAX, group=self.group)
            parts.append(top)
        if "std" in aggregation:
            d2 = ((corr_frames - mean[:, None]) ** 2).sum(1)
            dist.all_reduce(d2, group=self.group)
            parts.append(torch.sqrt(d2 / self.n_views))
        return torch.cat(parts, dim=-1)


def view_sharded_forward(model, images, poses, intrinsics, scale, mesh,
                         plan: Optional[RectPlan] = None, rect_views=None,
                         view_scan: bool = False) -> torch.Tensor:
    """The test-mode forward with the neighbours sharded over the ``view``
    axis of ``mesh``: (B, h, w) scaled disparities, as ``model(images,
    poses, intrinsics, scale)`` returns, on every rank of the axis.

    ``plan``: an accepted RectPlan selects the rectified construction
    (B == 1, as unsharded); with ``rect_views``, a proper subset of the
    neighbours that the plan's per-view entries follow, the mixed one.
    ``view_scan`` is accepted and changes nothing."""
    del view_scan
    if plan is not None and plan.ok and images.shape[0] != 1:
        raise ValueError("the rectified view-sharded forward takes B == 1")
    check_mesh(mesh, (AXES,), "the view-sharded forward's mesh")
    volume = ViewShardedVolume(images.shape[1] - 1, view_group(mesh), plan,
                               rect_views)
    with torch.no_grad():
        return model(images, poses, intrinsics, scale, volume_fn=volume)

"""Rectified epipolar cost-volume construction (the inference fast path).

After warping each (ref, src) feature pair into a common rotated frame
(``ops/rectify.py``), every hypothesis sample of rect pixel (y, x) lies on
row y of the rect-src image at column ``x + s_max - base - k * sigma``, so
per view the volume is the epiband resample (``ops/epiband.py``) of the
row correlations, back-warped to the reference grid.

Numerics: the feature warps and the volume back-warp make this an
approximation of the exact volume (``ops/corr.py``); it is exact under pure
lateral motion, where the warps degenerate to integer shifts. The host
planner (``rectify.plan_rectification``) decides per scene whether it can
be used.

Volume interface (shared with ``corr.ExactVolume``): :meth:`prepare` does
the stage-independent work once per forward — the rect geometry and the
warped (ref, src) feature rows of every view — and :meth:`build` makes one
cascade stage's volume from that context. :class:`MixedVolume` combines the
two constructions for scenes where only some neighbours can be rectified.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from portbench.reference import rectify
from portbench.reference.corr import ExactVolume
from portbench.reference.extractor import cast
from portbench.reference.kernels import epiband
from portbench.reference.rectify import RectPlan


def remat(fn, *args):
    """``fn(*args)``; where autograd records, recomputed in the backward
    pass instead of keeping its transients (one view's warps or volume at
    a time), which changes no value."""
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False)
    return fn(*args)


def column_shift(col0: int, device) -> torch.Tensor:
    """The homography ``[[1, 0, col0], [0, 1, 0], [0, 0, 1]]`` (float32)
    that starts a src band at column ``col0``, made on the device: no host
    copy, so a CUDA graph can capture it (``shift[0, 2] = x`` would copy
    ``x`` from the host)."""
    shift = torch.eye(3, dtype=torch.float32, device=device)
    shift[0, 2].fill_(float(col0))
    return shift


def rect_features(fmaps, poses, intrinsics, ii, jj, plan: RectPlan,
                  feature_dtype):
    """Stage-independent rectification work: ``(geo, warped)`` with
    ``warped[v] = (fr_rect, fs_rect)`` in ``feature_dtype``; view v's src
    band keeps only its own ``view_s_max`` columns."""
    B, N, h, w, C = fmaps.shape
    V = int(jj.shape[0])
    geo = rectify.rect_geometry(poses, intrinsics, ii, jj, h, w, plan,
                                need_grids=not plan.twopass)
    f = fmaps.float() / 8.0
    f_ref = cast(f[0, 0], feature_dtype)
    f_src = cast(f[0, jj], feature_dtype)  # (V, h, w, C)

    def warp_view(v):
        _, _, s_max_v = plan.view_params(v)
        col0 = plan.s_max - s_max_v  # src band: columns [col0, ws_r)
        if plan.twopass:
            shift = column_shift(col0, fmaps.device)
            fr_rect = rectify.warp_image_twopass(
                f_ref, geo["H_ref_inv"][v], plan.h_r, plan.w_r)
            fs_rect = rectify.warp_image_twopass(
                f_src[v], geo["H_src_inv"][v] @ shift, plan.h_r,
                plan.ws_r - col0)
        else:
            rrx, rry = geo["ref_ref_xy"]
            rsx, rsy = geo["ref_src_xy"]
            fr_rect = rectify.warp_image(f_ref, rrx[v], rry[v])
            fs_rect = rectify.warp_image(f_src[v], rsx[v, :, col0:],
                                         rsy[v, :, col0:])
        return (cast(fr_rect, feature_dtype).contiguous(),
                cast(fs_rect, feature_dtype).contiguous())

    warped = [remat(warp_view, v) for v in range(V)]
    return geo, warped


def build_corr_volume_rectified(fmaps, poses, intrinsics, ii, jj, origin,
                                n_hyp: int, incre: float, plan: RectPlan,
                                mean_over_views: bool = False,
                                gather_dtype=None,
                                zero_slab: bool = False, rect_ctx=None,
                                view_sum: bool = False):
    """(1, 1, h, w, D) when ``mean_over_views`` else (1, V, h, w, D), fp32;
    with ``view_sum`` the sum over the views in place of their mean.

    ``zero_slab``: the origin is statically ``(n_hyp//2)*incre`` (stage 0),
    so base == 0 and the origin warp is skipped. ``rect_ctx``: a context
    from :func:`rect_features`, shared across cascade stages.
    """
    B, N, h, w, C = fmaps.shape
    V = int(jj.shape[0])
    assert B == 1, "one sample; batches: build_corr_volume_rectified_batched"
    feature_dtype = gather_dtype or fmaps.dtype
    if rect_ctx is None:
        rect_ctx = rect_features(fmaps, poses, intrinsics, ii, jj, plan,
                                 feature_dtype)
    geo, warped = rect_ctx
    org = origin[0, 0][..., None]  # (h, w, 1)

    def one_view(v):
        _, _, s_max_v = plan.view_params(v)
        fr_rect, fs_rect = warped[v]
        if zero_slab:
            base = None
        else:
            rrx, rry = geo["ref_ref_xy"]
            origin_rect = rectify.warp_image(org, rrx[v], rry[v],
                                             mode="clamp")[..., 0]
            base = (geo["rate"][v] * (origin_rect - (n_hyp // 2) * incre))
        sigma = (geo["rate"][v] * incre).contiguous()
        vol_rect = epiband(fr_rect[None], fs_rect[None],
                           None if base is None else base[None],
                           sigma[None], n_hyp, s_max_v)[0]
        # back-warp in the feature dtype, accumulate in fp32
        if plan.twopass:
            return rectify.warp_image_twopass(
                cast(vol_rect, feature_dtype), geo["H_fwd"][v], h, w)
        fwx, fwy = geo["fwd_xy"]
        return rectify.warp_image(cast(vol_rect, feature_dtype), fwx[v], fwy[v])

    if mean_over_views:
        vol = remat(one_view, 0)
        for v in range(1, V):
            vol = vol + remat(one_view, v)
        return (vol if view_sum else vol / V)[None, None]
    return torch.stack([remat(one_view, v) for v in range(V)])[None]


def build_corr_volume_rectified_batched(
        fmaps, poses, intrinsics, ii, jj, origin, n_hyp: int, incre: float,
        plan: RectPlan, mean_over_views: bool = False, gather_dtype=None,
        zero_slab: bool = False, rect_ctxs=None,
        view_sum: bool = False):
    """Batch-B construction: the B == 1 builder per sample, concatenated
    (B == 1 returns its volume as it is). ``plan`` must cover every sample
    (``rectify.plan_union`` of the samples' plans); ``rect_ctxs`` holds one
    :func:`rect_features` context per sample."""
    B = fmaps.shape[0]
    vols = [build_corr_volume_rectified(
        fmaps[b:b + 1], poses[b:b + 1], intrinsics[b:b + 1], ii, jj,
        origin[b:b + 1], n_hyp, incre, plan, mean_over_views=mean_over_views,
        gather_dtype=gather_dtype, zero_slab=zero_slab,
        rect_ctx=rect_ctxs[b] if rect_ctxs else None, view_sum=view_sum)
        for b in range(B)]
    return vols[0] if B == 1 else torch.cat(vols, 0)


class RectifiedVolume:
    """Rectified construction for one :class:`RectPlan`. A batch of B > 1
    samples needs a plan that covers each of them (``rectify.plan_union``);
    :meth:`prepare` builds one context per sample."""

    def __init__(self, plan: RectPlan):
        if not plan.ok:
            raise ValueError(f"plan not usable: {plan.reason}")
        self.plan = plan
        
    def prepare(self, fmaps, poses, intrinsics, ii, jj, feature_dtype):
        feature_dtype = feature_dtype or fmaps.dtype
        ctxs = [rect_features(fmaps[b:b + 1], poses[b:b + 1],
                              intrinsics[b:b + 1], ii, jj, self.plan,
                              feature_dtype)
                for b in range(fmaps.shape[0])]
        return (fmaps, poses, intrinsics, ii, jj, feature_dtype, ctxs)

    def build(self, ctx, origin, n_hyp, incre, hyp_chunk=16,
              mean_over_views=False, zero_slab=False, view_sum=False):
        del hyp_chunk  # memory is bounded by the per-view loop
        fmaps, poses, intrinsics, ii, jj, fd, ctxs = ctx
        return build_corr_volume_rectified_batched(
            fmaps, poses, intrinsics, ii, jj, origin, n_hyp, incre,
            self.plan, mean_over_views=mean_over_views, gather_dtype=fd,
            zero_slab=zero_slab, rect_ctxs=ctxs,
            view_sum=view_sum)


class MixedVolume:
    """The mixed construction: rectified volume slices for the neighbours in
    ``rect_views``, exact gathers for the rest.

    ``plan`` and ``rect_views`` come from
    :func:`rectify.plan_rectification_partial` (the plan's per-view entries
    follow ``rect_views``). With ``mean_over_views`` the two means combine
    as ``(vol_r * |rect| + vol_e * |exact|) / V`` (the numerator alone with
    ``view_sum``); otherwise the per-view volumes come back in the original
    jj order."""

    def __init__(self, plan: RectPlan, rect_views):
        self.rect_views = tuple(int(v) for v in rect_views)
        self.rect = RectifiedVolume(plan)
        self.exact = ExactVolume()
        self._indices = {}

    def view_indices(self, n_views: int, device):
        """The rectified and the exact views' positions in jj, as index
        tensors on ``device``, and the exact views as a list. Made once per
        (view count, device), at the first :meth:`prepare`: a later one,
        which a CUDA graph may capture, copies nothing from the host."""
        key = (n_views, torch.device(device))
        if key not in self._indices:
            ev = [v for v in range(n_views) if v not in self.rect_views]
            if not ev:
                raise ValueError("all views rectifiable: use "
                                 "make_rectified_volume_fn")
            self._indices[key] = (torch.tensor(self.rect_views, device=device),
                                  torch.tensor(ev, device=device), ev)
        return self._indices[key]

    def prepare(self, fmaps, poses, intrinsics, ii, jj, feature_dtype):
        rv_t, ev_t, ev = self.view_indices(int(jj.shape[0]), jj.device)
        ctx_r = self.rect.prepare(fmaps, poses, intrinsics,
                                  ii[:len(self.rect_views)], jj[rv_t],
                                  feature_dtype)
        ctx_e = self.exact.prepare(fmaps, poses, intrinsics, ii[:len(ev)],
                                   jj[ev_t], feature_dtype)
        return ctx_r, ctx_e, ev

    def build(self, ctx, origin, n_hyp, incre, hyp_chunk=16,
              mean_over_views=False, zero_slab=False, view_sum=False):
        ctx_r, ctx_e, ev = ctx
        rv = self.rect_views
        vol_r = self.rect.build(ctx_r, origin, n_hyp, incre, hyp_chunk,
                                mean_over_views, zero_slab)
        vol_e = self.exact.build(ctx_e, origin, n_hyp, incre, hyp_chunk,
                                 mean_over_views)
        V = len(rv) + len(ev)
        if mean_over_views:
            vol = vol_r * len(rv) + vol_e * len(ev)
            return vol if view_sum else vol / V
        parts = [None] * V
        for k, v in enumerate(rv):
            parts[v] = vol_r[:, k]
        for k, v in enumerate(ev):
            parts[v] = vol_e[:, k]
        return torch.stack(parts, 1)



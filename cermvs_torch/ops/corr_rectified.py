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
cascade stage's volume from that context.
"""

from __future__ import annotations

import torch

from cermvs_torch.ops import rectify
from cermvs_torch.ops.epiband import epiband, epiband_reference
from cermvs_torch.ops.rectify import RectPlan


def _resample_rows_oracle(fr_rect, fs_rect, base, sigma, n_hyp, s_max):
    """One view's rect volume via a materialized G: fr_rect (h_r, w_r, C),
    fs_rect (h_r, ws_r, C), base/sigma (h_r, w_r) -> (h_r, w_r, D) fp32."""
    return epiband_reference(fr_rect[None], fs_rect[None], base[None],
                             sigma[None], n_hyp, s_max)[0]


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
    f_ref = f[0, 0].to(feature_dtype)
    f_src = f[0, jj].to(feature_dtype)  # (V, h, w, C)

    warped = []
    for v in range(V):
        _, _, s_max_v = plan.view_params(v)
        col0 = plan.s_max - s_max_v  # src band: columns [col0, ws_r)
        if plan.twopass:
            shift = torch.tensor(
                [[1.0, 0.0, float(col0)], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]],
                dtype=torch.float32, device=fmaps.device)
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
        warped.append((fr_rect.to(feature_dtype).contiguous(),
                       fs_rect.to(feature_dtype).contiguous()))
    return geo, warped


def build_corr_volume_rectified(fmaps, poses, intrinsics, ii, jj, origin,
                                n_hyp: int, incre: float, plan: RectPlan,
                                mean_over_views: bool = False,
                                gather_dtype=None, impl: str = "kernel",
                                zero_slab: bool = False, rect_ctx=None):
    """(1, 1, h, w, D) when ``mean_over_views`` else (1, V, h, w, D), fp32.

    ``impl="kernel"``: the epiband wrapper (the CUDA kernel on CUDA tensors,
    its plain version on CPU tensors); ``impl="oracle"``: the plain version.
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
        if impl == "kernel":
            vol_rect = epiband(fr_rect[None], fs_rect[None],
                               None if base is None else base[None],
                               sigma[None], n_hyp, s_max_v)[0]
        elif impl == "oracle":
            if base is None:
                base = torch.zeros_like(sigma)
            vol_rect = _resample_rows_oracle(fr_rect, fs_rect, base, sigma,
                                             n_hyp, s_max_v)
        else:
            raise ValueError(f"unknown impl {impl!r} (kernel/oracle)")
        # back-warp in the feature dtype, accumulate in fp32
        if plan.twopass:
            return rectify.warp_image_twopass(
                vol_rect.to(feature_dtype), geo["H_fwd"][v], h, w)
        fwx, fwy = geo["fwd_xy"]
        return rectify.warp_image(vol_rect.to(feature_dtype), fwx[v], fwy[v])

    if mean_over_views:
        vol = one_view(0)
        for v in range(1, V):
            vol = vol + one_view(v)
        return (vol / V)[None, None]
    return torch.stack([one_view(v) for v in range(V)])[None]


def build_corr_volume_rectified_batched(
        fmaps, poses, intrinsics, ii, jj, origin, n_hyp: int, incre: float,
        plan: RectPlan, mean_over_views: bool = False, gather_dtype=None,
        impl: str = "kernel", zero_slab: bool = False, rect_ctxs=None):
    """Batch-B construction: the B == 1 builder per sample, concatenated
    (B == 1 returns its volume as it is). ``plan`` must cover every sample
    (``rectify.plan_union`` of the samples' plans); ``rect_ctxs`` holds one
    :func:`rect_features` context per sample."""
    B = fmaps.shape[0]
    vols = [build_corr_volume_rectified(
        fmaps[b:b + 1], poses[b:b + 1], intrinsics[b:b + 1], ii, jj,
        origin[b:b + 1], n_hyp, incre, plan, mean_over_views=mean_over_views,
        gather_dtype=gather_dtype, impl=impl, zero_slab=zero_slab,
        rect_ctx=rect_ctxs[b] if rect_ctxs else None) for b in range(B)]
    return vols[0] if B == 1 else torch.cat(vols, 0)


class RectifiedVolume:
    """Rectified construction for one :class:`RectPlan`. A batch of B > 1
    samples needs a plan that covers each of them (``rectify.plan_union``);
    :meth:`prepare` builds one context per sample."""

    def __init__(self, plan: RectPlan, impl: str = "kernel"):
        if not plan.ok:
            raise ValueError(f"plan not usable: {plan.reason}")
        self.plan = plan
        self.impl = impl

    def prepare(self, fmaps, poses, intrinsics, ii, jj, feature_dtype):
        feature_dtype = feature_dtype or fmaps.dtype
        ctxs = [rect_features(fmaps[b:b + 1], poses[b:b + 1],
                              intrinsics[b:b + 1], ii, jj, self.plan,
                              feature_dtype)
                for b in range(fmaps.shape[0])]
        return (fmaps, poses, intrinsics, ii, jj, feature_dtype, ctxs)

    def build(self, ctx, origin, n_hyp, incre, hyp_chunk=16,
              mean_over_views=False, zero_slab=False):
        del hyp_chunk  # memory is bounded by the per-view loop
        fmaps, poses, intrinsics, ii, jj, fd, ctxs = ctx
        return build_corr_volume_rectified_batched(
            fmaps, poses, intrinsics, ii, jj, origin, n_hyp, incre,
            self.plan, mean_over_views=mean_over_views, gather_dtype=fd,
            impl=self.impl, zero_slab=zero_slab, rect_ctxs=ctxs)


def make_rectified_volume_fn(plan: RectPlan, impl: str = "kernel"):
    """The rectified construction RAFT takes as ``volume_fn``."""
    return RectifiedVolume(plan, impl)

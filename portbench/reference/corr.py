"""Epipolar cost volume: exact construction, depth pyramid, multi-level lookup.

This is the exact construction, the one the rectified path falls back to:

  * hypothesis slab ``disps = (arange(D) - D//2) * incre + origin``,
  * stage-0 "shift" rule clamping the origin up to ``D//2 * incre``,
  * feature scaling by 1/8 per map,
  * sample coordinates clamped to +-1e4,
  * bilinear quad-corner gathers with per-corner zero padding, gathered in
    ``gather_dtype`` and accumulated in fp32,
  * lookup index ``max((zinv - origin)/incre + D//2, 0)``.

Memory: views and hypothesis chunks are looped, each chunk's gathered
transients (the gather, its fp32 copy and the products) held under
``GATHER_BUDGET_BYTES`` by shrinking the chunk below ``hyp_chunk`` where
they would not fit; under autograd each chunk is recomputed in the backward
pass instead of keeping them (the JAX package's exact construction
rematerializes each view, ``jax.checkpoint``, for the same reason). Neither
changes a value: hypotheses are independent.

Layout is hypothesis-minor: the volume is (B, V, H, W, D). With mean
aggregation the view average is folded into the volume (``mean_over_views``):
the lookup is linear in the volume and its index depends only on the shared
reference disparity, so lookups of the averaged volume equal the average of
per-view lookups.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from portbench.reference.extractor import cast
from portbench.reference.geometry import (apply_projection,
                                          relative_projection)


# the bytes one gathered chunk may take: a bf16 gather, its fp32 copy and
# the fp32 products, 10 bytes per gathered element
GATHER_BUDGET_BYTES = 4 << 30
GATHER_BYTES_PER_ELEMENT = 10


class CorrPyramid(NamedTuple):
    """Correlation pyramid + slab parameters for one cascade stage."""

    levels: List[torch.Tensor]  # each (B, V, H, W, D / 2^i), fp32; level 0
    #                             alone for the fused lookup
    origin: torch.Tensor        # (B, 1, H, W) per-pixel slab origin
    incre: float                # hypothesis spacing (inverse-depth units)
    n_hyp: int                  # D at level 0
    num_levels: int = 3


def slab_origin(disp: torch.Tensor, n_hyp: int, incre: float, shift: bool):
    """Per-pixel origin of the hypothesis slab; disp: (B, 1, H, W).

    Stage 0 (``shift=True``) clamps the origin up to ``D//2 * incre`` so the
    slab starts at inverse depth 0; later stages center it on the estimate.
    """
    if shift:
        return torch.clamp(disp, min=n_hyp // 2 * incre)
    return disp


def _corner_quads(f_src: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, (H+2)*(W+2), 4C) zero-padded corner-quad rows:
    row ``(y+1)*(W+2) + (x+1)`` holds ``[f[y,x], f[y,x+1], f[y+1,x],
    f[y+1,x+1]]``."""
    B, H, W, C = f_src.shape
    Wp = W + 2
    f_pad = torch.nn.functional.pad(f_src, (0, 0, 1, 1, 1, 1))
    flat = f_pad.reshape(B, (H + 2) * Wp, C)
    return torch.cat([flat, flat.roll(-1, 1), flat.roll(-Wp, 1),
                      flat.roll(-(Wp + 1), 1)], dim=-1)


def _gather_corr_chunk(f_ref, f_quads, coords, H, W):
    """Correlation for one hypothesis chunk of one view.

    f_ref: (B, Hr, Wr, C) reference features (already scaled); f_quads:
    (B, (H+2)*(W+2), 4C) source corner quads; coords: (B, K, Hr, Wr, 2)
    sample coords in the source view (H, W are the SOURCE dims).
    Returns (B, K, Hr, Wr) fp32.
    """
    x, y = coords[..., 0], coords[..., 1]
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    ix = x0.to(torch.int64)
    iy = y0.to(torch.int64)
    B, K, Hr, Wr = x.shape
    C = f_ref.shape[-1]
    # for ix in [-1, W-1] / iy in [-1, H-1] the padded quad holds the true
    # corners; farther out every corner is masked, so the clip is harmless
    idx = iy.add(1).clamp(0, H) * (W + 2) + ix.add(1).clamp(0, W)
    f32 = torch.float32
    in_x0 = ((ix >= 0) & (ix <= W - 1)).to(f32)
    in_x1 = ((ix + 1 >= 0) & (ix + 1 <= W - 1)).to(f32)
    in_y0 = ((iy >= 0) & (iy <= H - 1)).to(f32)
    in_y1 = ((iy + 1 >= 0) & (iy + 1 <= H - 1)).to(f32)

    g = torch.gather(f_quads, 1, idx.reshape(B, K * Hr * Wr, 1).expand(
        -1, -1, 4 * C))
    # products of gather-dtype values are exact in fp32; sums are fp32
    g = g.reshape(B, K, Hr * Wr, 4, C).float()
    fr = f_ref.reshape(B, 1, Hr * Wr, 1, C).float()
    dots = (g * fr).sum(-1).reshape(B, K, Hr, Wr, 4)
    return (dots[..., 0] * ((1 - fx) * (1 - fy) * in_x0 * in_y0)
            + dots[..., 1] * (fx * (1 - fy) * in_x1 * in_y0)
            + dots[..., 2] * ((1 - fx) * fy * in_x0 * in_y1)
            + dots[..., 3] * (fx * fy * in_x1 * in_y1))


def build_corr_volume_from(f_ref, f_src, Pij, origin, n_hyp: int,
                           incre: float, hyp_chunk: int = 16,
                           mean_over_views: bool = False,
                           gather_dtype=None,
                           view_sum: bool = False) -> torch.Tensor:
    """Volume from per-pair features.

    f_ref/f_src: (B, V, H, W, C) already scaled by 1/8; Pij: (B, V, 4, 4);
    origin: (B, 1, H, W). Views and hypothesis chunks are looped so the
    gathered transients stay at one view x ``hyp_chunk`` hypotheses, fewer
    where those would exceed GATHER_BUDGET_BYTES; with autograd recording,
    each chunk is recomputed in the backward pass.
    Returns (B, V, H, W, D), or (B, 1, H, W, D) with ``mean_over_views``:
    the mean over the views, or their sum with ``view_sum`` (a view-sharded
    rank's share, which the ranks sum before dividing).
    """
    B, V, H, W, C = f_ref.shape
    Hs, Ws = f_src.shape[2:4]
    gd = gather_dtype or f_src.dtype
    per_hyp = B * H * W * 4 * C * GATHER_BYTES_PER_ELEMENT
    hyp_chunk = max(1, min(hyp_chunk, GATHER_BUDGET_BYTES // per_hyp))
    n_chunks = max(1, math.ceil(n_hyp / hyp_chunk))
    recompute = torch.is_grad_enabled() and (f_ref.requires_grad
                                             or f_src.requires_grad)
    offsets = ((torch.arange(n_hyp, device=origin.device) - n_hyp // 2)
               .to(torch.float32) * incre)

    def view_volume(v):
        quads = _corner_quads(cast(f_src[:, v], gd))
        fr = cast(f_ref[:, v], gd)
        chunks = []
        for c in range(n_chunks):
            offs = offsets[c * hyp_chunk:(c + 1) * hyp_chunk]
            disps = origin[:, :, None] + offs[None, None, :, None, None]
            coords = apply_projection(Pij[:, v:v + 1], disps)[:, 0]
            if recompute:
                chunks.append(checkpoint(
                    _gather_corr_chunk, fr, quads, coords, Hs, Ws,
                    use_reentrant=False, preserve_rng_state=False))
            else:
                chunks.append(_gather_corr_chunk(fr, quads, coords, Hs, Ws))
        return torch.cat(chunks, dim=1).permute(0, 2, 3, 1)  # (B, H, W, D)

    if mean_over_views:
        vol = view_volume(0)
        for v in range(1, V):
            vol = vol + view_volume(v)
        return (vol if view_sum else vol / V)[:, None]
    return torch.stack([view_volume(v) for v in range(V)], dim=1)


class ExactVolume:
    """The exact construction behind the volume interface RAFT uses:
    :meth:`prepare` once per forward (stage-independent work), then
    :meth:`build` once per cascade stage."""

    def prepare(self, fmaps, poses, intrinsics, ii, jj, feature_dtype):
        f = fmaps.float() / 8.0
        return (f[:, ii], f[:, jj],
                relative_projection(poses, intrinsics, ii, jj), feature_dtype)

    def build(self, ctx, origin, n_hyp, incre, hyp_chunk=16,
              mean_over_views=False, zero_slab=False, view_sum=False):
        del zero_slab  # the gather construction gains nothing from it
        f_ref, f_src, Pij, gd = ctx
        return build_corr_volume_from(f_ref, f_src, Pij, origin, n_hyp, incre,
                                      hyp_chunk, mean_over_views, gd,
                                      view_sum)


def build_pyramid(corr: torch.Tensor, num_levels: int = 3) -> List[torch.Tensor]:
    """Avg-pool pyramid along the hypothesis (last) axis."""
    levels = [corr]
    for _ in range(num_levels - 1):
        D = corr.shape[-1]
        corr = corr.reshape(corr.shape[:-1] + (D // 2, 2)).mean(-1)
        levels.append(corr)
    return levels


def lookup(pyramid: CorrPyramid, zinv: torch.Tensor, radius: int = 5
           ) -> torch.Tensor:
    """Sample 2r+1 taps per pyramid level around the current estimate
    (the banded lookup). zinv: (B, V, H, W) current reference disparity per
    view. Returns (B, V, H, W, num_levels*(2r+1)), level-major,
    tap-minor."""
    x0 = torch.clamp((zinv - pyramid.origin) / pyramid.incre
                     + pyramid.n_hyp // 2, min=0.0)
    return _lookup_banded(pyramid.levels, x0, radius)


def _lookup_banded(levels, x0: torch.Tensor, radius: int) -> torch.Tensor:
    """Banded lookup: at level l every tap k sits at ``x0/2^l + k``, so all
    taps share the fraction ``f = frac(x0/2^l)`` and read the band
    ``pool_l[c0 - r .. c0 + r + 1]`` with ``c0 = floor(x0/2^l)``; cells
    outside [0, D_l-1] read zero."""
    K = 2 * radius + 1
    outs = []
    for lvl, corr in enumerate(levels):
        D_l = corr.shape[-1]
        q = x0 / (2.0 ** lvl)
        c0 = torch.floor(q)
        f = (q - c0)[..., None]
        cells = (c0.to(torch.int64)[..., None] - radius
                 + torch.arange(K + 1, device=corr.device))
        inside = (cells >= 0) & (cells <= D_l - 1)
        band = torch.gather(corr.expand(cells.shape[:-1] + (D_l,)), -1,
                            cells.clamp(0, D_l - 1))
        s = band * inside.to(corr.dtype)
        outs.append((1.0 - f) * s[..., :-1] + f * s[..., 1:])
    return torch.cat(outs, dim=-1)


def build_corr_pyramid(vol_fn, ctx, disp, n_hyp, incre, shift: bool,
                       num_levels: int = 3, hyp_chunk: int = 16,
                       mean_over_views: bool = False,
                       zero_slab: bool = False) -> CorrPyramid:
    """One cascade stage's volume and pyramid. ``vol_fn`` is an
    :class:`ExactVolume` or a rectified volume and ``ctx`` its prepared
    context; disp: (B, 1, H, W) detached current estimate. ``zero_slab``
    tells ``vol_fn`` the origin is statically ``(n_hyp//2)*incre``."""
    origin = slab_origin(disp, n_hyp, incre, shift)
    corr = vol_fn.build(ctx, origin, n_hyp, incre, hyp_chunk=hyp_chunk,
                         mean_over_views=mean_over_views,
                         zero_slab=zero_slab and shift)
    return CorrPyramid(levels=build_pyramid(corr, num_levels), origin=origin,
                       incre=incre, n_hyp=n_hyp, num_levels=num_levels)

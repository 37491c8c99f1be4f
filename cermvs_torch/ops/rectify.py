"""Pairwise stereo rectification for the rectified cost-volume construction.

Rectifying each (reference, source) pair by pure camera ROTATIONS makes every
epipolar sample land on the SAME image row, at a position LINEAR in inverse
depth:

    rect-src x  =  rect-ref x  -  fx_r * B * g(q) * lambda
    rect-src y  =  rect-ref y

with ``B`` the baseline length and ``g(q)`` a smooth per-pixel factor. The
volume is then, per (view, row), one row-correlation ``G = F_ref_row @
F_src_row^T`` resampled along the row (``ops/epiband.py``).

Geometry. For a pair (i=ref, j=src) with world-to-camera poses ``P_i, P_j``:
``[R|t] = P_j P_i^{-1}`` and ``C = -R^T t`` the src center in ref-cam
coordinates. The rectifying rotation has rows ``r1 = C/||C||``,
``r2 = normalize(z x r1)``, ``r3 = r1 x r2``; the src side uses
``R_rect_j = R_rect_i R^T``. Both rect cameras share the reference focals,
with per-view principal offsets that center the warped reference image.

Two halves:
  * a host planner in numpy (float64): :func:`plan_rectification` decides
    whether a scene can use the rectified path and with which grid sizes
    (:class:`RectPlan`);
  * in-graph geometry and warps as torch ops in float32:
    :func:`rect_geometry`, :func:`warp_image` (quad bilinear),
    :func:`warp_image_twopass` (two 1-D hat-matrix resamples).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

# ---------------------------------------------------------------------------
# Host planner (numpy, float64)
# ---------------------------------------------------------------------------


def _np_rect_rotations(R, t):
    """(V,3,3), (V,3) relative poses -> (R_rect_i, R_rect_j, baseline)."""
    C = -np.einsum("...ji,...j->...i", R, t)
    baseline = np.linalg.norm(C, axis=-1)
    r1 = C / (baseline[..., None] + 1e-12)
    z = np.zeros_like(r1)
    z[..., 2] = 1.0
    r2 = np.cross(z, r1)
    r2 = r2 / (np.linalg.norm(r2, axis=-1, keepdims=True) + 1e-12)
    r3 = np.cross(r1, r2)
    R_rect_i = np.stack([r1, r2, r3], axis=-2)
    R_rect_j = np.einsum("...ik,...jk->...ij", R_rect_i, R)
    return R_rect_i, R_rect_j, baseline


def _np_relative_pose(poses):
    """[R|t] of P_v @ P_0^{-1} for v = 1..N-1. poses: (N, 4, 4)."""
    Pi, Pj = poses[:1], poses[1:]
    Ri, ti = Pi[..., :3, :3], Pi[..., :3, 3]
    Rj, tj = Pj[..., :3, :3], Pj[..., :3, 3]
    R = np.einsum("...ik,...jk->...ij", Rj, Ri)
    t = tj - np.einsum("...ij,...j->...i", R, ti)
    return R, t


def _np_K(fx, fy, cx, cy):
    return np.array([[fx, 0.0, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]])


def _np_K_inv(fx, fy, cx, cy):
    return _np_K(1.0 / fx, 1.0 / fy, -cx / fx, -cy / fy)


@dataclass(frozen=True)
class RectPlan:
    """Static rectification parameters for one scene: grid sizes, disparity
    bands and rate bounds. ``ok=False`` means the exact path must be used."""

    h_r: int          # rect grid rows (shared ref/src)
    w_r: int          # rect-ref grid cols
    s_max: int        # max disparity covered (px); src band extends left
    s_neg: int        # negative-disparity margin (px)
    ok: bool = True
    reason: str = ""
    # scene-wide bounds on the disparity rate fx_r*B*g (px per unit inverse
    # depth)
    rate_lo: float = 0.0
    rate_hi: float = 0.0
    # per-view rate bounds and disparity bands (leading index = view position)
    view_rates: Tuple[Tuple[float, float], ...] = ()
    view_s_max: Tuple[int, ...] = ()
    # every (view, warp) passed the two-pass eligibility gate
    twopass: bool = False

    @property
    def ws_r(self) -> int:
        return self.w_r + self.s_max + self.s_neg

    def view_params(self, v: int) -> Tuple[float, float, int]:
        """(rate_lo, rate_hi, s_max) for view ``v`` (scene-wide fallback)."""
        if self.view_rates:
            lo, hi = self.view_rates[v]
            return lo, hi, self.view_s_max[v]
        return self.rate_lo, self.rate_hi, self.s_max


def _round_up(v: float, m: int) -> int:
    return int(math.ceil(v / m)) * m


def _snap_rates(rate_lo: float, rate_hi: float) -> Tuple[float, float]:
    """Pad a rate interval 2% and snap it outward to a log-1.15 grid."""
    margin = 0.02 * (rate_hi - rate_lo) + 1e-6
    lo, hi = max(rate_lo - margin, 1e-6), rate_hi + margin
    step = math.log(1.15)
    lo = math.exp(math.floor(math.log(lo) / step) * step)
    hi = math.exp(math.ceil(math.log(hi) / step) * step)
    return float(lo), float(hi)


def _twopass_ok(Hi: np.ndarray, out_h: int, out_w: int, in_h: int,
                in_w: int, tilt_max: float = 3.0) -> bool:
    """Host-side eligibility of ONE warp for :func:`warp_image_twopass`.

    Over the sampled domain (output grid with a 25% margin, input rows within
    hat range of the vertical map): the vertical solve's denominator is
    bounded away from 0, the homography denominator keeps the sign of the
    legitimate branch, and the horizontal drift per input row stays under
    ``tilt_max`` pixels.
    """
    Hi = np.asarray(Hi, np.float64)
    scale = max(abs(Hi[1, 1]), 1e-12)
    pc = np.linalg.inv(Hi) @ np.array([(in_w - 1) / 2, (in_h - 1) / 2, 1.0])
    if abs(pc[2]) < 1e-9:
        return False
    den_c = (Hi[2, 0] * pc[0] + Hi[2, 1] * pc[1]) / pc[2] + Hi[2, 2]
    if abs(den_c) < 1e-3:
        return False
    sgn = np.sign(den_c)
    xs = np.linspace(-0.25 * out_w, 1.25 * out_w, 41)
    ys = np.linspace(-0.25 * out_h, 1.25 * out_h, 41)
    Yg, Xg = np.meshgrid(ys, xs, indexing="ij")
    den = Hi[2, 0] * Xg + Hi[2, 1] * Yg + Hi[2, 2]
    dsafe = np.where(np.abs(den) < 1e-12, 1e-12, den)
    k = (Hi[1, 0] * Xg + Hi[1, 1] * Yg + Hi[1, 2]) / dsafe
    kmask = (k > -2.0) & (k < in_h + 1.0)
    if not kmask.any():
        return True  # nothing ever sampled: all-zero output either way
    ms = []
    for dy in (-1.5, 0.0, 1.5):
        yp = np.clip(k + dy, -2.0, in_h + 1.0)
        den1 = Hi[1, 1] - yp * Hi[2, 1]
        d1safe = np.where(np.abs(den1) < 1e-12, 1e-12, den1)
        ystar = (yp * (Hi[2, 0] * Xg + Hi[2, 2])
                 - (Hi[1, 0] * Xg + Hi[1, 2])) / d1safe
        den2 = Hi[2, 0] * Xg + Hi[2, 1] * ystar + Hi[2, 2]
        d2safe = np.where(np.abs(den2) < 1e-12, 1e-12, den2)
        m = (Hi[0, 0] * Xg + Hi[0, 1] * ystar + Hi[0, 2]) / d2safe
        in_range = np.isfinite(m) & (np.abs(m) < in_w + 2.0)
        live = kmask & in_range
        bad = live & ((den2 * sgn <= 0) | (np.abs(den1) < 0.2 * scale))
        if bad.any():
            return False
        ms.append((m, live))
    both = ms[0][1] & ms[2][1]
    if both.any():
        drift = np.abs(ms[2][0][both] - ms[0][0][both]) / 3.0
        if drift.max() > tilt_max:
            return False
    return True


def _reject(reason: str) -> RectPlan:
    return RectPlan(0, 0, 0, 0, False, reason)


def plan_rectification(poses: np.ndarray, intrinsics: np.ndarray, h: int,
                       w: int, lambda_max: float = 0.00375, s_neg: int = 16,
                       min_baseline_sin: float = 0.25, pad: int = 8,
                       max_width_factor: float = 2.5) -> RectPlan:
    """Whether, and with which grid sizes, a scene can use the rectified path.

    poses: (N, 4, 4) or (1, N, 4, 4) world-to-camera; intrinsics: matching
    (..., N, 3, 3) at the FEATURE stride; (h, w): feature-grid size.
    ``lambda_max``: largest inverse depth any hypothesis slab may reach.
    Grid sizes are rounded (``w_r`` to 128, ``h_r`` to 32, ``s_max`` to 64).
    """
    poses = np.asarray(poses, np.float64)
    intrinsics = np.asarray(intrinsics, np.float64)
    if poses.ndim == 4:
        if poses.shape[0] != 1:
            return _reject("rectified path requires B==1")
        poses, intrinsics = poses[0], intrinsics[0]
    N = poses.shape[0]
    R, t = _np_relative_pose(poses)

    C = -np.einsum("...ji,...j->...i", R, t)
    r1 = C / (np.linalg.norm(C, axis=-1, keepdims=True) + 1e-12)
    sin = np.sqrt(np.clip(r1[..., 0] ** 2 + r1[..., 1] ** 2, 0.0, 1.0))
    if np.any(sin < min_baseline_sin):
        return _reject(f"near-forward baseline (min sin={sin.min():.3f})")

    R_ri, R_rj, bl = _np_rect_rotations(R, t)
    if np.any(bl < 1e-6):
        return _reject("zero baseline pair")

    Ki = intrinsics[0]
    fx_r, fy_r = Ki[0, 0], Ki[1, 1]
    Ki_inv = np.linalg.inv(Ki)
    corners = np.array(
        [[0, 0, 1], [w - 1, 0, 1], [0, h - 1, 1], [w - 1, h - 1, 1]],
        np.float64)

    w_need, h_need, s_need = 0.0, 0.0, 0.0
    rate_lo, rate_hi = np.inf, 0.0
    v_lo, v_hi, v_s = [], [], []
    for v in range(N - 1):
        A = _np_K(fx_r, fy_r, 0.0, 0.0) @ R_ri[v] @ Ki_inv
        q = corners @ A.T
        if np.any(q[:, 2] <= 1e-6):
            return _reject(f"rect horizon crosses ref image (view {v})")
        q = q[:, :2] / q[:, 2:3]
        w_need = max(w_need, q[:, 0].max() - q[:, 0].min())
        h_need = max(h_need, q[:, 1].max() - q[:, 1].min())
        # g over the warped ref image, sampled on a coarse interior grid
        gy, gx = np.meshgrid(np.linspace(0, h - 1, 8),
                             np.linspace(0, w - 1, 8), indexing="ij")
        rays = np.stack([gx, gy, np.ones_like(gx)], -1) @ Ki_inv.T
        g = rays @ R_ri[v][2]
        if np.any(g <= 0.05):
            return _reject(f"rect ray grazes principal plane (view {v})")
        s_need = max(s_need, fx_r * bl[v] * g.max() * lambda_max)
        rate_lo = min(rate_lo, fx_r * bl[v] * g.min())
        rate_hi = max(rate_hi, fx_r * bl[v] * g.max())
        v_lo.append(fx_r * bl[v] * g.min())
        v_hi.append(fx_r * bl[v] * g.max())
        v_s.append(fx_r * bl[v] * g.max() * lambda_max)

    w_r = _round_up(w_need + 2 * pad, 128)
    h_r = _round_up(h_need + 2 * pad, 32)
    s_max = _round_up(s_need + pad, 64)
    if w_r + s_max + s_neg > max_width_factor * (w + s_need + 2 * pad) + 256:
        return _reject(f"rect grid blow-up (w_r={w_r}, s_max={s_max})")
    lo, hi = _snap_rates(rate_lo, rate_hi)
    view_rates = tuple(_snap_rates(a, b) for a, b in zip(v_lo, v_hi))
    view_s_max = tuple(min(_round_up(s + pad, 64), s_max) for s in v_s)

    ws_r = w_r + s_max + int(s_neg)
    H_ref_inv, H_src_inv, H_fwd = host_rect_homographies(
        poses, intrinsics, h, w, h_r, w_r, s_max)
    twopass = True
    for v in range(N - 1):
        twopass = (twopass
                   and _twopass_ok(H_ref_inv[v], h_r, w_r, h, w)
                   and _twopass_ok(H_src_inv[v], h_r, ws_r, h, w)
                   and _twopass_ok(H_fwd[v], h, w, h_r, w_r))
        if not twopass:
            break
    return RectPlan(h_r, w_r, s_max, int(s_neg), True, "",
                    rate_lo=float(lo), rate_hi=float(hi),
                    view_rates=view_rates, view_s_max=view_s_max,
                    twopass=twopass)


def host_rect_homographies(poses, intrinsics, h: int, w: int, h_r: int,
                           w_r: int, s_max: int):
    """numpy mirror of :func:`rect_geometry`'s three homographies:
    ``(H_ref_inv, H_src_inv, H_fwd)``, each (V, 3, 3) float64."""
    poses = np.asarray(poses, np.float64)
    intrinsics = np.asarray(intrinsics, np.float64)
    if poses.ndim == 4:
        poses, intrinsics = poses[0], intrinsics[0]
    N = poses.shape[0]
    R, t = _np_relative_pose(poses)
    R_ri, R_rj, _ = _np_rect_rotations(R, t)
    Ki = intrinsics[0]
    fx_r, fy_r = Ki[0, 0], Ki[1, 1]
    Ki_inv = np.linalg.inv(Ki)
    corners = np.array(
        [[0, 0, 1], [w - 1, 0, 1], [0, h - 1, 1], [w - 1, h - 1, 1]],
        np.float64)
    H_ref_inv = np.zeros((N - 1, 3, 3))
    H_src_inv = np.zeros((N - 1, 3, 3))
    H_fwd = np.zeros((N - 1, 3, 3))
    for v in range(N - 1):
        A = _np_K(fx_r, fy_r, 0.0, 0.0) @ R_ri[v] @ Ki_inv
        q = corners @ A.T
        q = q[:, :2] / q[:, 2:3]
        ox = -q[:, 0].min() + (w_r - 1 - (q[:, 0].max() - q[:, 0].min())) / 2
        oy = -q[:, 1].min() + (h_r - 1 - (q[:, 1].max() - q[:, 1].min())) / 2
        Kj = intrinsics[1 + v]
        H_ref_inv[v] = Ki @ R_ri[v].T @ _np_K_inv(fx_r, fy_r, ox, oy)
        H_src_inv[v] = Kj @ R_rj[v].T @ _np_K_inv(fx_r, fy_r, ox + s_max, oy)
        H_fwd[v] = _np_K(fx_r, fy_r, ox, oy) @ R_ri[v] @ Ki_inv
    return H_ref_inv, H_src_inv, H_fwd


# ---------------------------------------------------------------------------
# In-graph geometry (torch, float32)
# ---------------------------------------------------------------------------


def _K(fx, fy, cx, cy):
    """Broadcast scalars/tensors -> (..., 3, 3) intrinsic matrices."""
    fx, fy, cx, cy = torch.broadcast_tensors(fx, fy, cx, cy)
    z = torch.zeros_like(fx)
    o = torch.ones_like(fx)
    return torch.stack([torch.stack([fx, z, cx], -1),
                        torch.stack([z, fy, cy], -1),
                        torch.stack([z, z, o], -1)], -2)


def _K_inv(fx, fy, cx, cy):
    return _K(1.0 / fx, 1.0 / fy, -cx / fx, -cy / fy)


def _rect_rotations(R, t):
    """torch twin of the host rotations: (V,3,3), (V,3) -> rotations, bl."""
    C = -torch.einsum("...ji,...j->...i", R, t)
    baseline = torch.linalg.vector_norm(C, dim=-1)
    r1 = C / (baseline[..., None] + 1e-12)
    z = torch.zeros_like(r1)
    z[..., 2] = 1.0
    r2 = torch.linalg.cross(z, r1)
    r2 = r2 / (torch.linalg.vector_norm(r2, dim=-1, keepdim=True) + 1e-12)
    r3 = torch.linalg.cross(r1, r2)
    R_rect_i = torch.stack([r1, r2, r3], dim=-2)
    R_rect_j = torch.einsum("...ik,...jk->...ij", R_rect_i, R)
    return R_rect_i, R_rect_j, baseline


def homography_grid(H: torch.Tensor, out_h: int, out_w: int,
                    clamp: float = 1e4):
    """Apply 3x3 homographies (..., 3, 3) to the pixel grid of an
    (out_h, out_w) image -> (qx, qy), each (..., out_h, out_w),
    perspective-divided and clamped."""
    dev = H.device
    gy = torch.arange(out_h, dtype=torch.float32, device=dev)[:, None]
    gx = torch.arange(out_w, dtype=torch.float32, device=dev)[None, :]
    shape = H.shape[:-2] + (1, 1)

    def comp(i):
        return (H[..., i, 0].reshape(shape) * gx
                + H[..., i, 1].reshape(shape) * gy
                + H[..., i, 2].reshape(shape))

    qx, qy, wz = comp(0), comp(1), comp(2)
    wz = torch.where(wz.abs() < 1e-9, torch.full_like(wz, 1e-9), wz)
    return (qx / wz).clamp(-clamp, clamp), (qy / wz).clamp(-clamp, clamp)


def rect_geometry(poses, intrinsics, ii, jj, h: int, w: int, plan: RectPlan,
                  need_grids: bool = True):
    """Per-view rectification maps, float32.

    poses: (1, N, 4, 4); intrinsics: (1, N, 3, 3) at feature stride. Returns a
    dict (leading axis V; coordinate maps are (x, y) pairs of (V, ., .)):
      ref_src_xy  original-src coords per rect-src cell (V, h_r, ws_r)
      ref_ref_xy  original-ref coords per rect-ref cell (V, h_r, w_r)
      fwd_xy      rect-ref coords of each ref pixel (V, h, w)
      rate        (V, h_r, w_r) disparity per unit inverse depth
      H_src_inv, H_ref_inv, H_fwd: the homographies behind the three maps.
    ``need_grids=False`` (two-pass warps) skips ``ref_src_xy`` and ``fwd_xy``.
    """
    assert poses.shape[0] == 1, "rectified path supports batch size 1"
    poses = poses.float()
    intrinsics = intrinsics.float()
    Pi, Pj = poses[0, ii], poses[0, jj]
    Ri, ti = Pi[..., :3, :3], Pi[..., :3, 3]
    Rj, tj = Pj[..., :3, :3], Pj[..., :3, 3]
    R = torch.einsum("...ik,...jk->...ij", Rj, Ri)
    t = tj - torch.einsum("...ij,...j->...i", R, ti)
    R_ri, R_rj, bl = _rect_rotations(R, t)

    Ki = intrinsics[0, 0]
    Kj = intrinsics[0, jj]
    fx_r, fy_r = Ki[0, 0], Ki[1, 1]
    zero = torch.zeros((), dtype=torch.float32, device=poses.device)

    corners = torch.tensor(
        [[0.0, 0.0, 1.0], [w - 1.0, 0.0, 1.0],
         [0.0, h - 1.0, 1.0], [w - 1.0, h - 1.0, 1.0]],
        dtype=torch.float32, device=poses.device)
    Kr0 = _K(fx_r, fy_r, zero, zero)
    Ki_inv = _K_inv(Ki[0, 0], Ki[1, 1], Ki[0, 2], Ki[1, 2])
    A = torch.einsum("ij,vjk,kl->vil", Kr0, R_ri, Ki_inv)
    qc = torch.einsum("vij,cj->vci", A, corners)
    qc = qc[..., :2] / qc[..., 2:3]
    qx_min, qx_max = qc[..., 0].amin(1), qc[..., 0].amax(1)
    qy_min, qy_max = qc[..., 1].amin(1), qc[..., 1].amax(1)
    ox = -qx_min + (plan.w_r - 1 - (qx_max - qx_min)) / 2
    oy = -qy_min + (plan.h_r - 1 - (qy_max - qy_min)) / 2

    Koff = _K(fx_r, fy_r, ox, oy)
    Koff_inv = _K_inv(fx_r, fy_r, ox, oy)
    Ksrc_inv = _K_inv(fx_r, fy_r, ox + float(plan.s_max), oy)

    H_src_inv = torch.einsum("vij,vkj,vkl->vil", Kj, R_rj, Ksrc_inv)
    H_ref_inv = torch.einsum("ij,vkj,vkl->vil",
                             _K(Ki[0, 0], Ki[1, 1], Ki[0, 2], Ki[1, 2]),
                             R_ri, Koff_inv)
    H_fwd = torch.einsum("vij,vjk,kl->vil", Koff, R_ri, Ki_inv)

    gy = torch.arange(plan.h_r, dtype=torch.float32, device=poses.device)
    gx = torch.arange(plan.w_r, dtype=torch.float32, device=poses.device)
    a = R_ri[:, 0, 2][:, None, None]
    b = R_ri[:, 1, 2][:, None, None]
    cc = R_ri[:, 2, 2][:, None, None]
    g = (a * (gx[None, None, :] - ox[:, None, None]) / fx_r
         + b * (gy[None, :, None] - oy[:, None, None]) / fy_r + cc)
    rate = fx_r * bl[:, None, None] * g

    return {
        "ref_src_xy": (homography_grid(H_src_inv, plan.h_r, plan.ws_r)
                       if need_grids else None),
        "ref_ref_xy": homography_grid(H_ref_inv, plan.h_r, plan.w_r),
        "fwd_xy": homography_grid(H_fwd, h, w) if need_grids else None,
        "rate": rate,
        "H_src_inv": H_src_inv,
        "H_ref_inv": H_ref_inv,
        "H_fwd": H_fwd,
    }


# ---------------------------------------------------------------------------
# Warps
# ---------------------------------------------------------------------------


def warp_image(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
               mode: str = "zero") -> torch.Tensor:
    """Inverse-warp ``img`` (H, W, C) at pixel positions x/y (...,) -> (..., C)
    fp32.

    mode="zero": out-of-image corner taps contribute zero (feature warps).
    mode="clamp": positions are clamped to the image (edge-extend; per-pixel
    parameter maps like the slab origin). Taps are read in ``img.dtype``;
    lerp weights are fp32.
    """
    H, W = img.shape[:2]
    C = img.shape[2] if img.dim() == 3 else 1
    img = img.reshape(H, W, C)
    if mode == "clamp":
        x = x.clamp(0.0, W - 1.0)
        y = y.clamp(0.0, H - 1.0)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    ix0 = x0.to(torch.int64)
    iy0 = y0.to(torch.int64)
    flat = img.reshape(H * W, C)

    def tap(iy, ix, wgt):
        inside = ((ix >= 0) & (ix <= W - 1) & (iy >= 0) & (iy <= H - 1))
        idx = iy.clamp(0, H - 1) * W + ix.clamp(0, W - 1)
        v = flat[idx.reshape(-1)].reshape(idx.shape + (C,)).float()
        return v * (wgt * inside.to(torch.float32))[..., None]

    return (tap(iy0, ix0, (1 - fx) * (1 - fy))
            + tap(iy0, ix0 + 1, fx * (1 - fy))
            + tap(iy0 + 1, ix0, (1 - fx) * fy)
            + tap(iy0 + 1, ix0 + 1, fx * fy))


def _twopass_maps(Hi: torch.Tensor, h_s: int, out_w: int) -> torch.Tensor:
    """Horizontal-pass sample positions ``m(y', x)``: the input column where
    output column x's warp curve crosses input row y' (``Hi`` maps output
    pixels to input pixels). Rows where the solve has a pole are pushed out
    of range so their hat weights vanish."""
    Hi = Hi.float()
    dev = Hi.device
    yp = torch.arange(h_s, dtype=torch.float32, device=dev)[:, None]
    x = torch.arange(out_w, dtype=torch.float32, device=dev)[None, :]
    den1 = Hi[1, 1] - yp * Hi[2, 1]
    safe1 = torch.where(den1.abs() < 1e-6, torch.full_like(den1, 1e-6), den1)
    ystar = (yp * (Hi[2, 0] * x + Hi[2, 2]) - (Hi[1, 0] * x + Hi[1, 2])) / safe1
    den2 = Hi[2, 0] * x + Hi[2, 1] * ystar + Hi[2, 2]
    safe2 = torch.where(den2.abs() < 1e-6, torch.full_like(den2, 1e-6), den2)
    m = (Hi[0, 0] * x + Hi[0, 1] * ystar + Hi[0, 2]) / safe2
    bad = (den1.abs() < 1e-6) | (den2.abs() < 1e-6)
    return torch.where(bad, torch.full_like(m, -1e4), m.clamp(-1e4, 1e4))


def warp_image_twopass(img: torch.Tensor, H_inv: torch.Tensor, out_h: int,
                       out_w: int, mode: str = "zero",
                       hat_budget: int = 384 * 1024 * 1024) -> torch.Tensor:
    """Inverse-warp ``img`` (h_s, w_s, C) through homography ``H_inv`` as two
    1-D hat-matrix resamples (matrix products) -> (out_h, out_w, C) fp32.

      pass 1 (horizontal): ``tmp[y', x, :] = img[y', :, :]^T @ hat(s - m)``
        with ``m(y', x)`` from :func:`_twopass_maps`;
      pass 2 (vertical):   ``out[y, x, :] = hat(y' - k)^T @ tmp[:, x, :]``
        with ``k(x, y)`` the direct vertical map.

    Equals direct bilinear exactly for separable warps; for general
    homographies the two samples sit on the warp curve at integer input rows
    (eligibility is decided host-side, ``RectPlan.twopass``). bf16 inputs
    multiply in bf16 with fp32 accumulation (``tmp`` is rounded to bf16, as
    in the JAX package); fp32 inputs multiply in full fp32. Hat tensors above
    ``hat_budget`` bytes are built in row / column chunks.
    """
    h_s, w_s, C = img.shape
    dev = img.device
    k = homography_grid(H_inv, out_h, out_w)[1]            # (out_h, out_w)
    m = _twopass_maps(H_inv, h_s, out_w)
    if mode == "clamp":
        m = torch.where(m.abs() > 9e3, torch.full_like(m, -1e4),
                        m.clamp(0.0, w_s - 1.0))
        k = k.clamp(0.0, h_s - 1.0)
    cdtype = img.dtype if img.dtype == torch.bfloat16 else torch.float32
    bpe = 2 if cdtype == torch.bfloat16 else 4
    row_chunk = h_s if h_s * w_s * out_w * bpe <= hat_budget else 32
    col_chunk = out_w if out_w * h_s * out_h * bpe <= hat_budget else 64
    imgc = img.to(cdtype)

    tmp = torch.empty((h_s, out_w, C), dtype=cdtype, device=dev)
    s = torch.arange(w_s, dtype=torch.float32, device=dev)[None, :, None]
    for r0 in range(0, h_s, row_chunk):
        m_c = m[r0:r0 + row_chunk]                         # (r, out_w)
        S = torch.clamp(1.0 - (s - m_c[:, None, :]).abs(), min=0.0)
        # (r, C, w_s) @ (r, w_s, out_w) -> (r, C, out_w), fp32 accumulate
        t = torch.bmm(imgc[r0:r0 + row_chunk].transpose(1, 2), S.to(cdtype))
        tmp[r0:r0 + row_chunk] = t.transpose(1, 2).to(cdtype)

    out = torch.empty((out_h, out_w, C), dtype=torch.float32, device=dev)
    tmpT = tmp.permute(1, 2, 0)                            # (out_w, C, h_s)
    yy = torch.arange(h_s, dtype=torch.float32, device=dev)[None, :, None]
    kT = k.t()                                             # (out_w, out_h)
    for c0 in range(0, out_w, col_chunk):
        k_c = kT[c0:c0 + col_chunk]
        T = torch.clamp(1.0 - (yy - k_c[:, None, :]).abs(), min=0.0)
        # (cc, C, h_s) @ (cc, h_s, out_h) in fp32: bf16 operands are exact in
        # fp32, so this is the fp32-accumulated product of the bf16 values
        o = torch.bmm(tmpT[c0:c0 + col_chunk].float(),
                      T.to(cdtype).float())                # (cc, C, out_h)
        out[:, c0:c0 + col_chunk] = o.permute(2, 0, 1)
    return out

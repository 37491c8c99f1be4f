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
    :func:`warp_image_twopass` (two 1-D hat resamples).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from cermvs_torch.ops.hatwarp import hat_resample_rows

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

    def covers(self, other: "RectPlan") -> bool:
        """True iff a construction for ``self`` is sound for a batch whose
        own plan is ``other``: grids, rate intervals and disparity bands at
        least as large. ``twopass`` is not monotone: ``other``'s two-pass
        gate sampled a 25% margin around its own grids, so a two-pass plan
        may serve it only while its grids stay inside that margin (the rule
        :func:`plan_union` applies)."""
        if not (self.ok and other.ok):
            return False
        if len(self.view_s_max) != len(other.view_s_max):
            return False
        if not (self.h_r >= other.h_r and self.w_r >= other.w_r
                and self.s_max >= other.s_max and self.s_neg >= other.s_neg
                and self.rate_lo <= other.rate_lo + 1e-12
                and self.rate_hi >= other.rate_hi - 1e-12):
            return False
        if bool(self.view_rates) != bool(other.view_rates):
            return False
        for (slo, shi), (olo, ohi), ss, os_ in zip(
                self.view_rates, other.view_rates,
                self.view_s_max, other.view_s_max):
            if not (slo <= olo + 1e-12 and shi >= ohi - 1e-12 and ss >= os_):
                return False
        if self.twopass:
            if not other.twopass:
                return False
            if (self.h_r > 1.25 * other.h_r or self.w_r > 1.25 * other.w_r
                    or self.s_max > other.s_max + 0.25 * other.ws_r):
                return False
        return True


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


def plan_union(plans) -> RectPlan:
    """Smallest plan covering every plan in ``plans`` (one training batch:
    per-sample geometry differs, one plan serves the batch). The plans must
    share the view count; a plan that is not ok is returned as it is."""
    plans = list(plans)
    for p in plans:
        if not p.ok:
            return p
    nv = {len(p.view_s_max) for p in plans}
    if len(nv) > 1:
        return _reject("view-count mismatch in union")
    V = nv.pop() if all(p.view_rates for p in plans) else 0
    view_rates = tuple(
        (min(p.view_rates[v][0] for p in plans),
         max(p.view_rates[v][1] for p in plans))
        for v in range(V))
    s_max = max(p.s_max for p in plans)
    return RectPlan(
        max(p.h_r for p in plans), max(p.w_r for p in plans),
        s_max, max(p.s_neg for p in plans), True, "",
        rate_lo=min(p.rate_lo for p in plans),
        rate_hi=max(p.rate_hi for p in plans),
        view_rates=view_rates,
        view_s_max=tuple(min(max(p.view_s_max[v] for p in plans), s_max)
                         for v in range(V)),
        # each plan's gate sampled a 25% margin around its own grids
        twopass=all(
            p.twopass
            and max(q.h_r for q in plans) <= 1.25 * p.h_r
            and max(q.w_r for q in plans) <= 1.25 * p.w_r
            and s_max <= p.s_max + 0.25 * p.ws_r
            for p in plans))


def widen_plan(plan: RectPlan, notches: int = 2) -> RectPlan:
    """Widen a plan's rate intervals outward by ``notches`` steps of the
    log-1.15 snap grid, staying on the grid, so one plan covers the nearby
    plans of a long run of batches."""
    if not plan.ok:
        return plan
    f = 1.15 ** notches

    def out(lo, hi):
        return _snap_rates(lo / f, hi * f)

    lo, hi = out(plan.rate_lo, plan.rate_hi)
    return RectPlan(
        plan.h_r, plan.w_r, plan.s_max, plan.s_neg, True, "",
        rate_lo=lo, rate_hi=hi,
        view_rates=tuple(out(a, b) for a, b in plan.view_rates),
        view_s_max=plan.view_s_max, twopass=plan.twopass)


class PlanCache:
    """Bounds the number of distinct plans (and constructions kept for
    them) over a run: :meth:`key_for` returns a cached plan that covers the
    batch's plan, else registers and returns the widened plan.
    Deterministic in the stream of plans."""

    def __init__(self, notches: int = 2):
        self.notches = notches
        self._plans: list = []

    def key_for(self, plan: RectPlan) -> RectPlan:
        for q in self._plans:
            if q.covers(plan):
                return q
        wide = widen_plan(plan, self.notches)
        self._plans.append(wide)
        return wide

    def __len__(self) -> int:
        return len(self._plans)


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
                       out_w: int, mode: str = "zero") -> torch.Tensor:
    """Inverse-warp ``img`` (h_s, w_s, C) through homography ``H_inv`` as two
    1-D hat resamples (``ops/hatwarp.hat_resample_rows``) -> (out_h, out_w,
    C) fp32.

      pass 1 (horizontal): ``tmp[y', x, :] = sum_s hat(s - m(y', x)) img[y', s, :]``
        with ``m(y', x)`` from :func:`_twopass_maps`;
      pass 2 (vertical):   ``out[y, x, :] = sum_y' hat(y' - k(x, y)) tmp[y', x, :]``
        with ``k(x, y)`` the direct vertical map.

    Equals direct bilinear exactly for separable warps; for general
    homographies the two samples sit on the warp curve at integer input rows
    (eligibility is decided host-side, ``RectPlan.twopass``). A bf16 image
    resamples with bf16 hat weights and fp32 sums, and ``tmp`` is rounded to
    bf16 between the passes, as in the JAX package; an fp32 image stays
    fp32. The position maps get no gradient; the image's flows through the
    transposed resamples.
    """
    h_s, w_s, C = img.shape
    k = homography_grid(H_inv, out_h, out_w)[1]            # (out_h, out_w)
    m = _twopass_maps(H_inv, h_s, out_w)
    if mode == "clamp":
        m = torch.where(m.abs() > 9e3, torch.full_like(m, -1e4),
                        m.clamp(0.0, w_s - 1.0))
        k = k.clamp(0.0, h_s - 1.0)
    cdtype = img.dtype if img.dtype == torch.bfloat16 else torch.float32
    tmp = hat_resample_rows(img.to(cdtype).contiguous(),
                            m.detach().contiguous()).to(cdtype)
    out = hat_resample_rows(tmp.transpose(0, 1).contiguous(),
                            k.detach().t().contiguous())  # (out_w, out_h, C)
    return out.transpose(0, 1)

"""Projective geometry on tensors.

Conventions (the same as the JAX package):
  * poses are world-to-camera 4x4 matrices,
  * ``disps`` are inverse depths ("disparities"),
  * a pixel of view i with inverse depth d is the homogeneous vector
    ``[x, y, 1, d]``; the relative projection is
    ``Pij = K_j @ P_j @ P_i^{-1} @ K_i^{-1}``.
Intrinsic and rigid-pose inverses are analytic.
"""

from __future__ import annotations

import torch


def coords_grid(d: torch.Tensor) -> torch.Tensor:
    """Homogeneous pixel grid ``[x, y, 1, d]``: (..., H, W) -> (..., H, W, 4)."""
    ht, wd = d.shape[-2], d.shape[-1]
    y = torch.arange(ht, dtype=d.dtype, device=d.device)[:, None].expand(ht, wd)
    x = torch.arange(wd, dtype=d.dtype, device=d.device)[None, :].expand(ht, wd)
    return torch.stack([x.expand(d.shape), y.expand(d.shape),
                        torch.ones_like(d), d], dim=-1)


def embed_intrinsics(intrinsics: torch.Tensor) -> torch.Tensor:
    """3x3 intrinsics -> 4x4 with K[3,3] = 1."""
    K = intrinsics.new_zeros(intrinsics.shape[:-2] + (4, 4))
    K[..., :3, :3] = intrinsics
    K[..., 3, 3] = 1.0
    return K


def inv_intrinsics(intrinsics: torch.Tensor) -> torch.Tensor:
    """Analytic inverse of the embedded 4x4 intrinsics of a pinhole
    K = [[fx, s, cx], [0, fy, cy], [0, 0, 1]]."""
    fx = intrinsics[..., 0, 0]
    fy = intrinsics[..., 1, 1]
    cx = intrinsics[..., 0, 2]
    cy = intrinsics[..., 1, 2]
    s = intrinsics[..., 0, 1]
    zeros = torch.zeros_like(fx)
    ones = torch.ones_like(fx)
    ifx = 1.0 / fx
    ify = 1.0 / fy
    row0 = torch.stack([ifx, -s * ifx * ify, (s * cy - cx * fy) * ifx * ify,
                        zeros], -1)
    row1 = torch.stack([zeros, ify, -cy * ify, zeros], -1)
    row2 = torch.stack([zeros, zeros, ones, zeros], -1)
    row3 = torch.stack([zeros, zeros, zeros, ones], -1)
    return torch.stack([row0, row1, row2, row3], -2)


def inv_pose(pose: torch.Tensor) -> torch.Tensor:
    """Analytic inverse of a rigid 4x4 [R|t; 0 1] transform."""
    R = pose[..., :3, :3]
    t = pose[..., :3, 3:4]
    Rt = R.transpose(-1, -2)
    top = torch.cat([Rt, -Rt @ t], dim=-1)
    # [0, 0, 0, 1] filled on the device (no host copy), so a CUDA graph can
    # capture it
    bottom = pose.new_zeros(pose.shape[:-2] + (1, 4))
    bottom[..., 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def relative_projection(poses: torch.Tensor, intrinsics: torch.Tensor,
                        ii: torch.Tensor, jj: torch.Tensor) -> torch.Tensor:
    """Pij = K_j P_j P_i^{-1} K_i^{-1} for each (i, j) pair.

    poses: (B, N, 4, 4); intrinsics: (B, N, 3, 3); ii/jj: (V,) index tensors.
    Returns (B, V, 4, 4).
    """
    K = embed_intrinsics(intrinsics)
    Kinv = inv_intrinsics(intrinsics)
    Pinv = inv_pose(poses)
    Ki = Kinv[:, ii]
    Kj = K[:, jj]
    Pi_inv = Pinv[:, ii]
    Pj = poses[:, jj]
    return Kj @ Pj @ Pi_inv @ Ki


def _project(Pij: torch.Tensor, disps: torch.Tensor) -> torch.Tensor:
    """(B, V, 4, 4) x homogeneous grid of (B, V, ..., H, W) -> (..., 4)."""
    x0 = coords_grid(disps)
    B, V = Pij.shape[:2]
    flat = x0.reshape(B, V, -1, 4)
    x1 = flat @ Pij.transpose(-1, -2)
    return x1.reshape(x0.shape)


def apply_projection(Pij: torch.Tensor, disps: torch.Tensor,
                     clamp: float = 1e4) -> torch.Tensor:
    """Pij: (B, V, 4, 4); disps: (B, V or 1, ..., H, W) -> (B, V, ..., H, W, 2)
    sample coordinates, clamped to +-clamp."""
    V = Pij.shape[1]
    if disps.shape[1] == 1 and V > 1:
        disps = disps.expand((disps.shape[0], V) + disps.shape[2:])
    x1 = _project(Pij, disps)
    xy = x1[..., :2] / x1[..., 2:3]
    return xy.clamp(-clamp, clamp)



"""Linear and bilinear sampling on tensors.

Semantics of ``F.grid_sample(align_corners=True, padding_mode='zeros')``:
coordinates are in pixel units and each out-of-range tap contributes zero.
"""

from __future__ import annotations

import torch


def interp1d(values: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Linear interpolation along the last axis with zero padding.

    values: (..., D); x: (..., K) fractional positions. Each of the two taps
    is zeroed separately when it falls outside ``[0, D-1]``. Returns (..., K).
    """
    D = values.shape[-1]
    x0 = torch.floor(x)
    f = (x - x0).to(values.dtype)
    i0 = x0.to(torch.int64)
    i1 = i0 + 1
    v0 = torch.gather(values, -1, i0.clamp(0, D - 1))
    v1 = torch.gather(values, -1, i1.clamp(0, D - 1))
    valid0 = ((i0 >= 0) & (i0 <= D - 1)).to(values.dtype)
    valid1 = ((i1 >= 0) & (i1 <= D - 1)).to(values.dtype)
    return (1.0 - f) * v0 * valid0 + f * v1 * valid1


def bilinear_sample(img: torch.Tensor, coords: torch.Tensor,
                    with_mask: bool = False):
    """Sample ``img`` (H, W, C) at pixel coords (..., 2) -> (..., C).

    Zero padding outside the image. With ``with_mask`` also returns the float
    mask of samples strictly inside the image in normalized coordinates.
    """
    H, W, C = img.shape
    x, y = coords[..., 0], coords[..., 1]
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0).to(img.dtype)
    fy = (y - y0).to(img.dtype)
    ix0 = x0.to(torch.int64)
    iy0 = y0.to(torch.int64)
    flat = img.reshape(H * W, C)

    def tap(iy, ix, w):
        inside = (ix >= 0) & (ix <= W - 1) & (iy >= 0) & (iy <= H - 1)
        idx = iy.clamp(0, H - 1) * W + ix.clamp(0, W - 1)
        v = flat[idx.reshape(-1)].reshape(idx.shape + (C,))
        return v * (w * inside.to(img.dtype))[..., None]

    out = (tap(iy0, ix0, (1 - fx) * (1 - fy))
           + tap(iy0, ix0 + 1, fx * (1 - fy))
           + tap(iy0 + 1, ix0, (1 - fx) * fy)
           + tap(iy0 + 1, ix0 + 1, fx * fy))
    if with_mask:
        gx = 2 * x / (W - 1) - 1
        gy = 2 * y / (H - 1) - 1
        mask = ((gx > -1) & (gx < 1) & (gy > -1) & (gy < 1)).to(img.dtype)
        return out, mask
    return out


def _interp_matrix(n_out: int, n_in: int, dtype, device) -> torch.Tensor:
    if n_in == 1:
        return torch.ones((n_out, 1), dtype=dtype, device=device)
    if n_out == 1:
        m = torch.zeros((1, n_in), dtype=dtype, device=device)
        m[0, 0] = 1.0
        return m
    pos = (torch.arange(n_out, dtype=torch.float32, device=device)
           * (n_in - 1) / (n_out - 1))
    i0 = torch.floor(pos).to(torch.int64).clamp(0, n_in - 2)
    f = pos - i0.to(torch.float32)
    m = torch.zeros((n_out, n_in), dtype=torch.float32, device=device)
    rows = torch.arange(n_out, device=device)
    m.index_put_((rows, i0), 1.0 - f, accumulate=True)
    m.index_put_((rows, i0 + 1), f, accumulate=True)
    return m.to(dtype)


def resize_bilinear_align_corners(img: torch.Tensor, out_h: int, out_w: int):
    """Bilinear resize with align_corners=True as two 1-D interpolation
    matrix products. img: (..., H, W) -> (..., out_h, out_w)."""
    H, W = img.shape[-2], img.shape[-1]
    A = _interp_matrix(out_h, H, img.dtype, img.device)
    Bm = _interp_matrix(out_w, W, img.dtype, img.device)
    out = torch.einsum("oh,...hw->...ow", A, img)
    return torch.einsum("pw,...hw->...hp", Bm, out)

"""Linear and bilinear sampling on tensors.

Semantics of ``F.grid_sample(align_corners=True, padding_mode='zeros')``:
coordinates are in pixel units and each out-of-range tap contributes zero.
"""

from __future__ import annotations

import torch


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

"""Plain versions of the port's hand-written kernels, as the reference
computes them: the rectified volume's row resample (epiband) and the 1-D
hat resample of the two-pass warps, in fp32 and differentiable by autograd.
"""

from __future__ import annotations

import torch

HAT_BUDGET = 384 * 1024 * 1024  # bytes of one hat-matrix chunk


def epiband(fr, fs, base, sigma, n_hyp: int, s_max: int):
    """fr (V, h_r, w_r, C), fs (V, h_r, ws, C), base and sigma (V, h_r, w_r)
    -> (V, h_r, w_r, n_hyp) fp32: per view the row correlations ``G = fr
    fs^T`` interpolated at ``x + s_max - base - k * sigma``; taps outside
    [0, ws - 1] read zero."""
    V, h_r, w_r, _ = fr.shape
    ws = fs.shape[2]
    x = torch.arange(w_r, dtype=torch.float32, device=fr.device)
    k = torch.arange(n_hyp, dtype=torch.float32, device=fr.device)
    outs = []
    for v in range(V):
        G = torch.einsum("hxc,hsc->hxs", fr[v].float(), fs[v].float())
        b = (torch.zeros((h_r, w_r), dtype=torch.float32, device=fr.device)
             if base is None else base[v])
        idx = (x + float(s_max))[None, :, None] - (
            b[..., None] + sigma[v][..., None] * k)
        x0 = torch.floor(idx)
        f = idx - x0
        i0 = x0.clamp(-2, ws + 1).to(torch.int64)
        i1 = i0 + 1
        g0 = torch.gather(G, -1, i0.clamp(0, ws - 1))
        g1 = torch.gather(G, -1, i1.clamp(0, ws - 1))
        valid0 = ((i0 >= 0) & (i0 <= ws - 1)).float()
        valid1 = ((i1 >= 0) & (i1 <= ws - 1)).float()
        outs.append((1.0 - f) * g0 * valid0 + f * g1 * valid1)
    return torch.stack(outs)


def _hats(pos, S: int, dtype):
    """(r, S, O) hat matrices ``hat(s - pos[r, o])``, rounded to ``dtype``
    and widened back to fp32."""
    s = torch.arange(S, dtype=torch.float32, device=pos.device)[None, :, None]
    w = torch.clamp(1.0 - (s - pos[:, None, :]).abs(), min=0.0)
    return w.to(dtype).float()


def hat_resample_rows(img, pos):
    """(R, S, C) x (R, O) -> (R, O, C) fp32: ``out[r] = hat(r)^T @ img[r]``
    as fp32 matrix products over row chunks; ``pos`` takes no gradient."""
    R, S, C = img.shape
    O = pos.shape[1]
    pos = pos.detach()
    rc = max(1, min(R, HAT_BUDGET // max(1, S * O * 4)))
    return torch.cat([
        torch.bmm(_hats(pos[r0:r0 + rc], S, img.dtype).transpose(1, 2),
                  img[r0:r0 + rc].float())
        for r0 in range(0, R, rc)], 0)

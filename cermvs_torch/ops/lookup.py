"""Fused multi-level correlation lookup: the CUDA kernels' wrappers and their
plain PyTorch versions.

``lookup_fused(corr0, x0, radius, num_levels)`` with ``corr0`` (..., D) the
level-0 volume and ``x0`` (...) the clamped fractional index returns
(..., num_levels*(2*radius+1)) fp32, level-major and tap-minor: the taps of
the avg-pooled pyramid (``corr.build_pyramid`` + ``corr.lookup``) read
straight from level 0, with pooling folded into the taps. At level l the
pooled cells are ``pool_l[i] = mean(corr0[i*2^l : (i+1)*2^l])`` for
``i < D >> l``, and tap k is

    (1 - f) * pool_l[c0 + k - r] + f * pool_l[c0 + k - r + 1],
    c0 = floor(x0 / 2^l),  f = x0 / 2^l - c0,

cells outside ``[0, D >> l)`` reading zero. It is differentiable in
``corr0``: the gradient applies the same weights, and ``x0`` gets none (the
JAX package's custom VJP gives it zero; the caller detaches it anyway).
Autograd saves only ``x0`` and the volume's shape.

``lookup_fused_v2`` computes the same taps, forward only, from inclusive
prefix sums along D (D <= 128): a pooled cell is a difference of two prefix
sums, which loses low bits to cancellation (~1e-4 relative).

On CUDA tensors the wrappers launch the hand-written kernels
(``cermvs_torch/csrc/lookup.cu``: ``lookup_forward``, ``lookup_backward``,
``lookup_v2_forward``); on CPU tensors they run the plain versions. There
is no fallback from one to the other. Inputs are taken as contiguous fp32
(``.contiguous()`` copies a strided volume, such as a permuted view, once
per call).
"""

from __future__ import annotations

import ctypes

import torch

from cermvs_torch.ops import cudalib

_p, _i, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
LIB = cudalib.KernelLibrary("lookup", {
    "lookup_forward": [_p, _p, _p, _ll, _i, _i, _i, _p],
    "lookup_backward": [_p, _p, _p, _ll, _i, _i, _i, _p],
    "lookup_v2_forward": [_p, _p, _p, _ll, _i, _i, _i, _p],
})
KERNELS = ("lookup_fused_fwd", "lookup_fused_bwd", "lookup_fused_v2")
V2_MAX_D = 128


def _level(x0, lvl: int, radius: int):
    """Level ``lvl``'s band: the fraction f (..., 1), the K+1 pooled cells
    ``c0 - r .. c0 + r + 1`` (..., K+1) and whether each is inside."""
    q = x0 / float(1 << lvl)
    c0 = torch.floor(q)
    f = (q - c0)[..., None]
    cells = (c0[..., None] - radius
             + torch.arange(2 * radius + 2, dtype=torch.float32,
                            device=x0.device))
    return f, cells


def _gather_cells(values, cells, n: int):
    """``values[..., cells]`` with cells outside [0, n) reading zero; cells
    are float so a huge index never reaches the integer cast."""
    inside = (cells >= 0) & (cells < n)
    idx = torch.where(inside, cells, torch.zeros_like(cells)).to(torch.int64)
    return torch.gather(values, -1, idx) * inside.to(values.dtype)


def lookup_fused_reference(corr0, x0, radius: int = 5, num_levels: int = 3):
    """Plain forward: pool each level from level 0, then read each level's
    band of K+1 pooled cells and lerp."""
    corr0, x0 = corr0.float(), x0.float()
    D = corr0.shape[-1]
    outs = []
    for lvl in range(num_levels):
        n, Dl = 1 << lvl, D >> lvl
        pool = corr0[..., :Dl * n].reshape(corr0.shape[:-1] + (Dl, n)).sum(-1)
        pool = pool * (1.0 / n)
        f, cells = _level(x0, lvl, radius)
        s = _gather_cells(pool, cells, Dl)
        outs.append((1.0 - f) * s[..., :-1] + f * s[..., 1:])
    return torch.cat(outs, dim=-1)


def lookup_fused_backward_reference(g, x0, D: int, radius: int = 5,
                                    num_levels: int = 3):
    """Plain gradient: each level's band of K+1 pooled cells receives
    ``(1 - f) * g[k]`` from the tap reading it first and ``f * g[k - 1]``
    from the tap reading it second, scaled by 1 / 2^l and spread over the
    cell's 2^l level-0 cells."""
    g, x0 = g.float(), x0.float()
    K = 2 * radius + 1
    dcorr = torch.zeros(x0.shape + (D,), dtype=torch.float32, device=g.device)
    for lvl in range(num_levels):
        n, Dl = 1 << lvl, D >> lvl
        f, cells = _level(x0, lvl, radius)
        gl = g[..., lvl * K:(lvl + 1) * K]
        coef = torch.zeros(x0.shape + (K + 1,), dtype=torch.float32,
                           device=g.device)
        coef[..., :K] += gl * ((1.0 - f) * (1.0 / n))
        coef[..., 1:] += gl * (f * (1.0 / n))
        inside = (cells >= 0) & (cells < Dl)
        # cells outside [0, D_l) land in a spare slot that is dropped
        idx = torch.where(inside, cells, torch.full_like(cells, Dl))
        dpool = torch.zeros(x0.shape + (Dl + 1,), dtype=torch.float32,
                            device=g.device)
        dpool.scatter_add_(-1, idx.to(torch.int64),
                           coef * inside.to(torch.float32))
        dcorr[..., :Dl * n] += dpool[..., :Dl].repeat_interleave(n, dim=-1)
    return dcorr


def lookup_fused_v2_reference(corr0, x0, radius: int = 5,
                              num_levels: int = 3):
    """Plain prefix-sum forward: ``P = [0, cumsum(corr0)]`` and pooled cell
    i of level l is ``(P[(i+1)*2^l] - P[i*2^l]) / 2^l``."""
    corr0, x0 = corr0.float(), x0.float()
    D = corr0.shape[-1]
    P = torch.cat([torch.zeros_like(corr0[..., :1]),
                   torch.cumsum(corr0, dim=-1)], dim=-1)
    outs = []
    for lvl in range(num_levels):
        n, Dl = 1 << lvl, D >> lvl
        f, cells = _level(x0, lvl, radius)
        inside = (cells >= 0) & (cells < Dl)
        lo = torch.where(inside, cells, torch.zeros_like(cells)).to(
            torch.int64) * n
        pool = (torch.gather(P, -1, lo + n) - torch.gather(P, -1, lo)) * (
            1.0 / n) * inside.to(torch.float32)
        outs.append((1.0 - f) * pool[..., :-1] + f * pool[..., 1:])
    return torch.cat(outs, dim=-1)


def _check(corr0, x0, radius, num_levels):
    if tuple(x0.shape) != tuple(corr0.shape[:-1]):
        raise ValueError(f"x0 {tuple(x0.shape)} does not match the volume "
                         f"{tuple(corr0.shape)}")
    if corr0.device != x0.device:
        raise ValueError("corr0 and x0 must be on one device")
    if radius < 0 or num_levels < 1 or (corr0.shape[-1] >> (num_levels - 1)) < 1:
        raise ValueError(f"bad radius {radius} / num_levels {num_levels} for "
                         f"D={corr0.shape[-1]}")
    if corr0.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {corr0.device}")


def _flat(t, width):
    return t.float().contiguous().reshape(-1, width)


def _launch(fn, name, src, x0, width_out, D, radius, num_levels):
    """One kernel launch over the flattened pixels; returns (M, width_out)."""
    M = x0.numel()
    out = torch.empty((M, width_out), dtype=torch.float32, device=src.device)
    with torch.cuda.device(src.device):
        LIB.call(fn, src.data_ptr(), x0.data_ptr(), out.data_ptr(), M, D,
                 radius, num_levels, cudalib.stream_of(src))
    cudalib.count_launch(name)
    return out


def lookup_fused_backward(g, x0, D: int, radius: int = 5,
                          num_levels: int = 3):
    """``dcorr`` (..., D) fp32 for ``g`` (..., num_levels*(2r+1)): the
    kernel on CUDA tensors, the plain version on CPU tensors."""
    T = num_levels * (2 * radius + 1)
    if tuple(g.shape) != tuple(x0.shape) + (T,) or g.device != x0.device:
        raise ValueError(f"g {tuple(g.shape)} does not match x0 "
                         f"{tuple(x0.shape)} and {T} taps")
    if g.is_cuda:
        x0c = x0.float().contiguous()
        out = _launch("lookup_backward", "lookup_fused_bwd", _flat(g, T), x0c,
                      D, D, radius, num_levels)
        return out.reshape(tuple(x0.shape) + (D,))
    if g.device.type != "cpu":
        raise ValueError(f"unsupported device {g.device}")
    return lookup_fused_backward_reference(g, x0, D, radius, num_levels)


class _LookupFused(torch.autograd.Function):
    @staticmethod
    def forward(ctx, corr0, x0, radius, num_levels):
        ctx.save_for_backward(x0)
        ctx.D, ctx.radius, ctx.num_levels = corr0.shape[-1], radius, num_levels
        if not corr0.is_cuda:
            return lookup_fused_reference(corr0, x0, radius, num_levels)
        D = corr0.shape[-1]
        T = num_levels * (2 * radius + 1)
        out = _launch("lookup_forward", "lookup_fused_fwd", _flat(corr0, D),
                      x0.float().contiguous(), T, D, radius, num_levels)
        return out.reshape(tuple(x0.shape) + (T,))

    @staticmethod
    def backward(ctx, g):
        (x0,) = ctx.saved_tensors
        dcorr = lookup_fused_backward(g, x0, ctx.D, ctx.radius,
                                      ctx.num_levels)
        return dcorr, None, None, None


def lookup_fused(corr0: torch.Tensor, x0: torch.Tensor, radius: int = 5,
                 num_levels: int = 3) -> torch.Tensor:
    """(..., D) x (...) -> (..., num_levels*(2r+1)) fp32; see the module
    docstring."""
    _check(corr0, x0, radius, num_levels)
    return _LookupFused.apply(corr0, x0.detach(), radius, num_levels)


def lookup_fused_v2(corr0: torch.Tensor, x0: torch.Tensor, radius: int = 5,
                    num_levels: int = 3) -> torch.Tensor:
    """The prefix-sum forward (D <= 128, no gradient): the kernel on CUDA
    tensors, the plain version on CPU tensors."""
    _check(corr0, x0, radius, num_levels)
    D = corr0.shape[-1]
    if D > V2_MAX_D:
        raise ValueError(f"lookup_fused_v2 takes D <= {V2_MAX_D}, got {D}")
    if not corr0.is_cuda:
        return lookup_fused_v2_reference(corr0, x0, radius, num_levels)
    T = num_levels * (2 * radius + 1)
    out = _launch("lookup_v2_forward", "lookup_fused_v2", _flat(corr0, D),
                  x0.detach().float().contiguous(), T, D, radius, num_levels)
    return out.reshape(tuple(x0.shape) + (T,))

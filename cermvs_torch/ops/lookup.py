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
``lookup_v2_forward``); :func:`lookup_launch_geometry` (the forward and the
prefix-sum variant) and :func:`backward_launch_geometry` (the gradient) set
the tile of pixels each block stages in shared memory. On CPU tensors they
run the plain versions. There is no fallback from one to the other. Inputs
are taken as contiguous fp32 (``.contiguous()`` copies a strided volume,
such as a permuted view, once per call). :func:`work` is each kernel's
(bytes, FLOPs) for given indices; while a FLOP count is open
(``utils/flops.py``) the wrappers add its FLOPs and hide their plain
versions' work from the counter.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from cermvs_torch.ops import cudalib
from cermvs_torch.utils import flops

_p, _i, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
LIB = cudalib.KernelLibrary("lookup", {
    "lookup_forward": [_p, _p, _p, _ll, _i, _i, _i, _i, _i, _i, _p],
    "lookup_backward": [_p, _p, _p, _ll, _i, _i, _i, _i, _i, _i, _i, _p],
    "lookup_v2_forward": [_p, _p, _p, _ll, _i, _i, _i, _i, _i, _i, _p],
})
KERNELS = ("lookup_fused_fwd", "lookup_fused_bwd", "lookup_fused_v2")
V2_MAX_D = 128
TILE_PIXELS = 64  # pixels per block: ~8 taps (forward) or 4 cell groups
# (gradient, D = 64) a thread
SMEM_LIMIT = 232_448  # dynamic shared memory a block may use (bytes)


@dataclass(frozen=True)
class LookupGeometry:
    """The forward or prefix-sum kernel's launch: ``grid`` tiles of
    ``pixels`` pixels, 16-byte row copies where ``vec == 4`` and
    ``smem_bytes`` of dynamic shared memory. The launcher runs as many
    blocks as stay resident on the card (at most ``grid``), each looping
    over tiles, the next tile's copy in flight while it computes one."""
    pixels: int
    vec: int
    smem_bytes: int
    grid: int


def _round16(n: int) -> int:
    return -(-n // 16) * 16


def forward_smem_bytes(P: int, D: int, radius: int, num_levels: int) -> int:
    """Shared bytes of a block of the forward (``fwd_layout`` in
    ``csrc/lookup.cu``), each region at a multiple of 16 bytes: a 4-byte
    record per tap, two buffers of a tile's P rows and x0, and per (pixel,
    level) 8 bytes and a band of 2r + 2 pooled cells."""
    L, J = num_levels, 2 * radius + 2
    T = L * (J - 1)
    rows = _round16(4 * T)
    xs = _round16(rows + 2 * 4 * P * D)
    pix = _round16(xs + 2 * 4 * P)
    band = _round16(pix + 8 * P * L)
    return _round16(band + 4 * P * L * J)


@functools.lru_cache(maxsize=256)
def lookup_launch_geometry(M: int, D: int, radius: int, num_levels: int,
                           align: int = 16) -> LookupGeometry:
    """Launch parameters of ``lookup_forward`` and ``lookup_v2_forward``
    (which turns each staged row into its prefix sums in place, in the same
    shared memory) for M pixels of D cells at an address that is a multiple
    of ``align`` bytes: ``TILE_PIXELS`` pixels
    per block, fewer where their rows and bands would not fit a block's
    shared memory; 16-byte copies where D % 4 == 0 and the alignment
    allow. Raises only where one pixel does not fit."""
    per_pixel = forward_smem_bytes(1, D, radius, num_levels)
    if per_pixel > SMEM_LIMIT:
        raise ValueError(
            f"lookup_forward stages a pixel's {D} cells, its bands and "
            f"{num_levels * (2 * radius + 1)} tap records in shared memory: "
            f"{per_pixel} bytes exceed a block's {SMEM_LIMIT}")
    P = TILE_PIXELS
    while forward_smem_bytes(P, D, radius, num_levels) > SMEM_LIMIT:
        P -= 1
    vec = 4 if D % 4 == 0 and align % 16 == 0 else 1
    return LookupGeometry(pixels=P, vec=vec,
                          smem_bytes=forward_smem_bytes(P, D, radius,
                                                        num_levels),
                          grid=-(-M // P))


@dataclass(frozen=True)
class BackwardGeometry:
    """The gradient kernel's launch: ``grid`` tiles of ``pixels`` pixels,
    16-byte copies of the tap gradients where ``vec == 4``, ``cells``
    consecutive cells a thread (4: one 16-byte store each) and
    ``smem_bytes`` of dynamic shared memory; persistent blocks as for the
    forward."""
    pixels: int
    vec: int
    cells: int
    smem_bytes: int
    grid: int


def backward_smem_bytes(P: int, radius: int, num_levels: int) -> int:
    """Shared bytes of a block of the gradient (``bwd_layout`` in
    ``csrc/lookup.cu``), each region at a multiple of 16 bytes: two buffers
    of a tile's P rows of T tap gradients and its x0, and per (pixel,
    level) a 16-byte record."""
    T = num_levels * (2 * radius + 1)
    xs = _round16(2 * 4 * P * T)
    rec = _round16(xs + 2 * 4 * P)
    return _round16(rec + 16 * P * num_levels)


@functools.lru_cache(maxsize=256)
def backward_launch_geometry(M: int, D: int, radius: int, num_levels: int,
                             g_align: int = 16,
                             out_align: int = 16) -> BackwardGeometry:
    """Launch parameters of ``lookup_backward`` for M pixels, ``g`` and
    ``dcorr`` at addresses that are multiples of ``g_align`` and
    ``out_align`` bytes: ``TILE_PIXELS`` pixels per block, fewer where
    their taps would not fit; 16-byte copies where ``g`` is aligned and
    every tile's span starts aligned (P * T % 4 == 0); 4 cells a thread
    where D % 4 == 0 and ``dcorr`` is aligned. Raises only where one pixel
    does not fit."""
    T = num_levels * (2 * radius + 1)
    per_pixel = backward_smem_bytes(1, radius, num_levels)
    if per_pixel > SMEM_LIMIT:
        raise ValueError(
            f"lookup_backward stages a pixel's {T} tap gradients and "
            f"{num_levels} records in shared memory: {per_pixel} bytes "
            f"exceed a block's {SMEM_LIMIT}")
    P = TILE_PIXELS
    while backward_smem_bytes(P, radius, num_levels) > SMEM_LIMIT:
        P -= 1
    vec = 4 if g_align % 16 == 0 and P * T % 4 == 0 else 1
    cells = 4 if D % 4 == 0 and out_align % 16 == 0 else 1
    return BackwardGeometry(pixels=P, vec=vec, cells=cells,
                            smem_bytes=backward_smem_bytes(P, radius,
                                                           num_levels),
                            grid=-(-M // P))


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


def work(x0, D: int, radius: int = 5, num_levels: int = 3):
    """``{kernel: (bytes, flops)}`` of the fused lookup (forward and
    prefix-sum variant) and of its gradient for the indices ``x0`` over
    volumes of D cells. Bytes: the level-0 cells some in-range tap reaches
    and x0, read once; the taps written (forward) or read (gradient) once;
    the gradient's D cells per pixel written once. Operations (fp32): per
    (tap, in-range pooled cell) 2^l adds and a scale, and a 3-operation
    lerp per tap (forward); 2 * 2^l per (tap, in-range pooled cell)
    (gradient). The cells are counted from the data (device syncs)."""
    M, K = x0.numel(), 2 * radius + 1
    T = num_levels * K
    x = x0.reshape(-1).float()
    j = torch.arange(D, device=x.device)[None]
    reached = torch.zeros(M, D, dtype=torch.bool, device=x.device)
    fwd_ops, bwd_ops = 3 * M * T, 0
    for lvl in range(num_levels):
        n, Dl = 1 << lvl, D >> lvl
        c0 = torch.floor(x / n)[:, None]
        cells = c0 - radius + torch.arange(K + 1, device=x.device)
        inside = (cells >= 0) & (cells < Dl)
        pairs = int(inside[:, :-1].sum() + inside[:, 1:].sum())
        fwd_ops += pairs * (n + 1)
        bwd_ops += pairs * 2 * n
        jl = j >> lvl
        reached |= (jl >= c0 - radius) & (jl <= c0 + radius + 1) & (jl < Dl)
    taps = M * T * 4
    fwd = (int(reached.sum()) * 4 + M * 4 + taps, fwd_ops)
    return {"lookup_fused_fwd": fwd, "lookup_fused_v2": fwd,
            "lookup_fused_bwd": (taps + M * 4 + M * D * 4, bwd_ops)}


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


def _launch_forward(corr, x0, radius, num_levels, out=None, prefix=False):
    """Launch ``lookup_forward`` (``lookup_v2_forward`` where ``prefix``) on
    the flattened volume ``corr`` (M, D) and ``x0`` (M,), contiguous fp32,
    into ``out`` (M, T) fp32, a new tensor unless given; the kernel writes
    every element."""
    M, D = corr.shape
    T = num_levels * (2 * radius + 1)
    geo = lookup_launch_geometry(M, D, radius, num_levels,
                                 cudalib.pointer_alignment(corr))
    if out is None:
        out = torch.empty((M, T), dtype=torch.float32, device=corr.device)
    fn, name = (("lookup_v2_forward", "lookup_fused_v2") if prefix else
                ("lookup_forward", "lookup_fused_fwd"))
    with cudalib.on_device(corr):
        LIB.call(fn, corr.data_ptr(), x0.data_ptr(), out.data_ptr(), M, D,
                 radius, num_levels, geo.pixels, int(geo.vec == 4),
                 geo.smem_bytes, cudalib.stream_of(corr))
    cudalib.count_launch(name)
    return out


def _launch_backward(g, x0, D, radius, num_levels, out=None):
    """Launch ``lookup_backward`` on the flattened tap gradients ``g`` (M,
    T) and ``x0`` (M,), contiguous fp32, into ``out`` (M, D) fp32, a new
    tensor unless given; the kernel writes every element."""
    M = g.shape[0]
    if out is None:
        out = torch.empty((M, D), dtype=torch.float32, device=g.device)
    geo = backward_launch_geometry(M, D, radius, num_levels,
                                   cudalib.pointer_alignment(g),
                                   cudalib.pointer_alignment(out))
    with cudalib.on_device(g):
        LIB.call("lookup_backward", g.data_ptr(), x0.data_ptr(),
                 out.data_ptr(), M, D, radius, num_levels, geo.pixels,
                 int(geo.vec == 4), geo.cells, geo.smem_bytes,
                 cudalib.stream_of(g))
    cudalib.count_launch("lookup_fused_bwd")
    return out


def lookup_fused_backward(g, x0, D: int, radius: int = 5,
                          num_levels: int = 3):
    """``dcorr`` (..., D) fp32 for ``g`` (..., num_levels*(2r+1)): the
    kernel on CUDA tensors, the plain version on CPU tensors."""
    T = num_levels * (2 * radius + 1)
    if tuple(g.shape) != tuple(x0.shape) + (T,) or g.device != x0.device:
        raise ValueError(f"g {tuple(g.shape)} does not match x0 "
                         f"{tuple(x0.shape)} and {T} taps")
    if flops.counting():
        return flops.counted(("lookup_fused_bwd",),
                             lambda: work(x0, D, radius, num_levels),
                             _backward, g, x0, D, radius, num_levels)
    return _backward(g, x0, D, radius, num_levels)


def _backward(g, x0, D, radius, num_levels):
    T = num_levels * (2 * radius + 1)
    if g.is_cuda:
        out = _launch_backward(_flat(g, T),
                               x0.float().contiguous().reshape(-1), D,
                               radius, num_levels)
        return out.reshape(tuple(x0.shape) + (D,))
    if g.device.type != "cpu":
        raise ValueError(f"unsupported device {g.device}")
    return lookup_fused_backward_reference(g, x0, D, radius, num_levels)


def _forward(corr0, x0, radius, num_levels):
    if not corr0.is_cuda:
        return lookup_fused_reference(corr0, x0, radius, num_levels)
    D = corr0.shape[-1]
    out = _launch_forward(_flat(corr0, D), x0.float().contiguous(),
                          radius, num_levels)
    return out.reshape(tuple(x0.shape) + (out.shape[-1],))


class _LookupFused(torch.autograd.Function):
    @staticmethod
    def forward(ctx, corr0, x0, radius, num_levels):
        ctx.save_for_backward(x0)
        ctx.D, ctx.radius, ctx.num_levels = corr0.shape[-1], radius, num_levels
        if flops.counting():
            return flops.counted(
                ("lookup_fused_fwd",),
                lambda: work(x0, corr0.shape[-1], radius, num_levels),
                _forward, corr0, x0, radius, num_levels)
        return _forward(corr0, x0, radius, num_levels)

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
    if flops.counting():
        return flops.counted(("lookup_fused_v2",),
                             lambda: work(x0, D, radius, num_levels),
                             _forward_v2, corr0, x0, radius, num_levels)
    return _forward_v2(corr0, x0, radius, num_levels)


def _forward_v2(corr0, x0, radius, num_levels):
    if not corr0.is_cuda:
        return lookup_fused_v2_reference(corr0, x0, radius, num_levels)
    out = _launch_forward(_flat(corr0, corr0.shape[-1]),
                          x0.detach().float().contiguous().reshape(-1),
                          radius, num_levels, prefix=True)
    return out.reshape(tuple(x0.shape) + (out.shape[-1],))

"""Bilinear inverse warp at per-output positions ("quad warp"): the CUDA
kernels' wrappers and their plain PyTorch versions. The one-pass rectified
construction (``rectify.warp_image``) warps its features, its volumes and
the slab origin with it.

``quad_warp(img, x, y, mode)`` with ``img`` (H, W, C) bf16 or fp32 and
positions ``x``, ``y`` (...) fp32 returns (..., C) fp32:

    out[p, :] = sum_k w_k(p) * img[y_k(p), x_k(p), :]

over the four corners k of (floor(x), floor(y)), each read in the image's
dtype and weighted by its fp32 lerp weight, masked to zero where the corner
falls off the image (``mode="zero"``), or after clamping the positions to
the image (``mode="clamp"``). It is differentiable in ``img`` through the
transpose ``dimg[s, :] = sum_{p,k: corner k of p is s} w_k(p) * dout[p, :]``,
summed in fp32 and rounded once to the image's dtype; the positions get no
gradient (they come from poses and intrinsics), and the wrapper refuses
positions that require one.

On CUDA tensors the wrapper launches the hand-written kernels
(``cermvs_torch/csrc/quadwarp.cu``: ``quad_warp_forward``,
``quad_warp_backward``): the forward is bit for bit the plain version on
the card; the transpose accumulates a tile's footprint in shared memory and
adds it to a zeroed fp32 buffer with global atomics, so two launches agree
to fp32 reordering, not bit for bit. :func:`launch_geometry` sets the
forward's channel vector, block and grid, :func:`backward_launch_geometry`
the transpose's reduction width, shared memory and grid. On CPU tensors the
wrapper runs the plain version, :func:`warp_image_reference` (four gathers
and fp32 products, differentiated by autograd); there is no fallback from
one to the other. :func:`warp_image_backward_reference` (fp32
``index_add_``) is the plain transpose the kernel is held against, and
:func:`work` each kernel's bytes.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from cermvs_torch.ops import cudalib

_p, _i = ctypes.c_void_p, ctypes.c_int
LIB = cudalib.KernelLibrary("quadwarp", {
    "quad_warp_forward": [_p] * 4 + [_i] * 10 + [_p],
    "quad_warp_backward": [_p] * 4 + [_i] * 8 + [_p, _p],
})
KERNELS = ("quad_warp_fwd", "quad_warp_bwd")
MODES = ("zero", "clamp")
THREADS = 256  # the block size of both kernels
TILE = 8       # the transpose's tile: TILE x TILE positions a block
MAX_GRID_Y = 65535
# the transpose's shared memory for a tile's footprint: 13312 fp32, a box of
# 208 pixels of 64 channels (an 8 x 8 tile of a map whose scale is ~1 covers
# at most 13 x 13 at any rotation); four blocks fit an H100 SM with the
# tile's corners beside it
BWD_SMEM_BYTES = 53248


@dataclass(frozen=True)
class Geometry:
    """The forward kernel's launch: ``vec`` channels per thread, a block of
    ``block = (groups, positions)`` threads and ``grid = (tiles,)``."""
    vec: int
    block: tuple
    grid: tuple


@functools.lru_cache(maxsize=256)
def launch_geometry(P: int, C: int, dtype, align: int = 16) -> Geometry:
    """Launch parameters of ``quad_warp_forward`` for P positions into an
    image of C channels of ``dtype`` whose address is a multiple of
    ``align`` bytes: the widest channel vector (16 bytes at most) that
    divides C and the alignment; the threads of one position across its
    vectors (at most a block); as many positions per block as fit in
    ``THREADS``."""
    esize = 2 if dtype == torch.bfloat16 else 4
    vec = next(v for v in (8, 4, 2, 1) if v == 1 or (
        v * esize <= 16 and C % v == 0 and align % (v * esize) == 0))
    groups = min(C // vec, THREADS)
    positions = max(1, THREADS // groups)
    return Geometry(vec=vec, block=(groups, positions),
                    grid=(-(-P // positions),))


@dataclass(frozen=True)
class BackwardGeometry:
    """The transpose's launch: 16-byte reductions (``vec4``) or scalar
    ones, ``smem_bytes`` of dynamic shared memory for a tile's box, and
    ``grid = (column tiles, row tiles)`` of TILE x TILE positions over the
    positions' (rows, cols) view."""
    vec4: bool
    smem_bytes: int
    grid: tuple


@functools.lru_cache(maxsize=256)
def backward_launch_geometry(R: int, Q: int, C: int) -> BackwardGeometry:
    """Launch parameters of ``quad_warp_backward`` for positions viewed as
    (R, Q) and C channels: 16-byte reductions where C % 4 == 0 (the wrapper
    allocates dimg, so its rows are aligned); raises where the row tiles
    exceed the grid's second dimension."""
    row_tiles = -(-R // TILE)
    if row_tiles > MAX_GRID_Y:
        raise ValueError(f"quad_warp_backward takes at most "
                         f"{MAX_GRID_Y * TILE} position rows, got {R}")
    return BackwardGeometry(vec4=C % 4 == 0, smem_bytes=BWD_SMEM_BYTES,
                            grid=(-(-Q // TILE), row_tiles))


def _corners(img_hw, x, y, mode):
    """The four corners of each position: ``[(flat index, weight, inside)]``
    in the kernels' order, the weights masked by ``inside``."""
    H, W = img_hw
    if mode == "clamp":
        x = x.clamp(0.0, W - 1.0)
        y = y.clamp(0.0, H - 1.0)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    ix0 = x0.to(torch.int64)
    iy0 = y0.to(torch.int64)
    out = []
    for iy, ix, wgt in ((iy0, ix0, (1 - fx) * (1 - fy)),
                        (iy0, ix0 + 1, fx * (1 - fy)),
                        (iy0 + 1, ix0, (1 - fx) * fy),
                        (iy0 + 1, ix0 + 1, fx * fy)):
        inside = ((ix >= 0) & (ix <= W - 1) & (iy >= 0) & (iy <= H - 1))
        idx = iy.clamp(0, H - 1) * W + ix.clamp(0, W - 1)
        out.append((idx, wgt * inside.to(torch.float32), inside))
    return out


def warp_image_reference(img, x, y, mode: str = "zero"):
    """Plain forward: four gathers of ``img`` (H, W, C), each widened to
    fp32 and times its masked weight, summed as ((t00 + t01) + t10) + t11.
    Differentiable in ``img`` (and in the positions) by autograd."""
    H, W, C = img.shape
    flat = img.reshape(H * W, C)
    taps = [flat[idx.reshape(-1)].reshape(idx.shape + (C,)).float()
            * wgt[..., None]
            for idx, wgt, _ in _corners((H, W), x, y, mode)]
    return ((taps[0] + taps[1]) + taps[2]) + taps[3]


def warp_image_backward_reference(dout, x, y, shape, dtype,
                                  mode: str = "zero"):
    """Plain transpose: ``dimg`` of ``shape`` (H, W, C) as fp32
    ``index_add_`` of each in-image corner's ``weight * dout``, rounded once
    to ``dtype``."""
    H, W, C = shape
    dimg = torch.zeros((H * W, C), dtype=torch.float32, device=dout.device)
    g = dout.reshape(-1, C).float()
    for idx, wgt, inside in _corners((H, W), x, y, mode):
        keep = inside.reshape(-1)
        dimg.index_add_(0, idx.reshape(-1)[keep],
                        g[keep] * wgt.reshape(-1)[keep][:, None])
    return dimg.reshape(H, W, C).to(dtype)


def reached_pixels(x, y, hw, mode: str = "zero") -> int:
    """The number of image pixels of ``hw`` (H, W) that the positions'
    in-image corners reach: all the forward reads of the image."""
    idx = torch.cat([idx.reshape(-1)[inside.reshape(-1)]
                     for idx, _, inside in _corners(hw, x, y, mode)])
    return int(torch.unique(idx).numel())


def work(P: int, H: int, W: int, C: int, dtype, pixels=None):
    """``{kernel: bytes}`` that each kernel must move: the image's
    ``pixels`` (all H * W where None; :func:`reached_pixels` gives the
    forward's), x and y read once and out written once; dout, x and y read
    once and dimg written whole, in the image's dtype."""
    esize = 2 if dtype == torch.bfloat16 else 4
    img, pos, out = H * W * C * esize, 2 * P * 4, P * C * 4
    read = img if pixels is None else pixels * C * esize
    return {"quad_warp_fwd": read + pos + out,
            "quad_warp_bwd": out + pos + img}


def _check(img, x, y, mode, counter=None):
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if img.dim() != 3 or x.shape != y.shape:
        raise ValueError(f"expected img (H,W,C) and x, y of one shape, got "
                         f"{tuple(img.shape)}, {tuple(x.shape)} and "
                         f"{tuple(y.shape)}")
    if img.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"img must be float32 or bfloat16, got {img.dtype}")
    if x.dtype != torch.float32 or y.dtype != torch.float32:
        raise TypeError(f"x and y must be float32, got {x.dtype} and "
                        f"{y.dtype}")
    if not img.device == x.device == y.device:
        raise ValueError("img, x and y must be on one device")
    if img.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {img.device}")
    for name, t in (("img", img), ("x", x), ("y", y)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.requires_grad or y.requires_grad:
        raise ValueError("x and y get no gradient: pass them detached")
    if img.numel() == 0 or img.numel() >= 2 ** 31:
        raise ValueError(f"img {tuple(img.shape)} must be non-empty with "
                         f"fewer than 2^31 elements")
    if counter is not None and not (
            img.is_cuda and counter.dtype == torch.int32
            and counter.numel() == 2 and counter.device == img.device
            and counter.is_contiguous()):
        raise ValueError("counter must be two contiguous int32 on img's "
                         "CUDA device (it counts the kernel's blocks)")


def _launch_forward(img, x, y, clamp: bool):
    """Launch ``quad_warp_forward`` into a new (..., C) fp32 tensor."""
    H, W, C = img.shape
    P = x.numel()
    geo = launch_geometry(P, C, img.dtype, cudalib.pointer_alignment(img))
    out = torch.empty(tuple(x.shape) + (C,), dtype=torch.float32,
                      device=img.device)
    with cudalib.on_device(img):
        LIB.call("quad_warp_forward", img.data_ptr(), x.data_ptr(),
                 y.data_ptr(), out.data_ptr(), P, H, W, C,
                 int(img.dtype == torch.bfloat16), int(clamp), geo.vec,
                 *geo.block, geo.grid[0], cudalib.stream_of(img))
    cudalib.count_launch("quad_warp_fwd")
    return out


def _launch_backward(dout, x, y, shape, dtype, clamp: bool, counter=None):
    """Launch ``quad_warp_backward`` into a zeroed fp32 buffer (no host
    copy, no sync: a CUDA graph captures it) and round it to ``dtype``."""
    H, W, C = shape
    Q = x.shape[-1] if x.dim() else 1  # the positions as (rows, cols)
    R = x.numel() // Q if Q else 0
    geo = backward_launch_geometry(R, Q, C)
    dimg = torch.zeros((H, W, C), dtype=torch.float32, device=dout.device)
    with cudalib.on_device(dout):
        LIB.call("quad_warp_backward", dout.data_ptr(), x.data_ptr(),
                 y.data_ptr(), dimg.data_ptr(), R, Q, H, W, C, int(clamp),
                 int(geo.vec4), geo.smem_bytes,
                 None if counter is None else counter.data_ptr(),
                 cudalib.stream_of(dout))
    cudalib.count_launch("quad_warp_bwd")
    return dimg.to(dtype)


class _QuadWarp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, img, x, y, clamp, counter):
        ctx.save_for_backward(x, y)
        ctx.shape, ctx.img_dtype = tuple(img.shape), img.dtype
        ctx.clamp, ctx.counter = clamp, counter
        return _launch_forward(img, x, y, clamp)

    @staticmethod
    def backward(ctx, dout):
        x, y = ctx.saved_tensors
        dimg = _launch_backward(dout.float().contiguous(), x, y, ctx.shape,
                                ctx.img_dtype, ctx.clamp, ctx.counter)
        return dimg, None, None, None, None


def quad_warp(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
              mode: str = "zero", counter=None) -> torch.Tensor:
    """(H, W, C) at positions (...) -> (..., C) fp32 bilinear warp; see the
    module docstring. ``counter``, two int32 zeros on the card (kernel
    only), adds at the transpose's launch the blocks with a corner on the
    image and, of those, the blocks whose footprint did not fit shared
    memory."""
    _check(img, x, y, mode, counter)
    if not img.is_cuda:
        return warp_image_reference(img, x, y, mode)
    return _QuadWarp.apply(img, x, y, mode == "clamp", counter)

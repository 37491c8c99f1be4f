"""1-D hat resample along rows: the CUDA kernels' wrappers and their plain
PyTorch versions. Each pass of the two-pass warp
(``rectify.warp_image_twopass``) is one such resample.

``hat_resample_rows(img, pos)`` with ``img`` (R, S, C) bf16 or fp32 and
``pos`` (R, O) fp32 returns (R, O, C) fp32:

    out[r, o, :] = sum_s hat(s - pos[r, o]) * img[r, s, :],  hat(d) = max(0, 1 - |d|)

so out-of-range positions get zero weight. It is differentiable in ``img``
through the transposed resample ``dimg[r, s, :] = sum_o hat(s - pos[r, o])
* dout[r, o, :]``, returned in ``img``'s dtype; ``pos`` gets no gradient.
Numerics follow the JAX package's kernel: for a bf16 image the hat weights
(and, in the backward, ``dout``) are rounded to bf16, and every product and
sum is fp32.

On CUDA tensors the wrappers launch the hand-written kernels
(``cermvs_torch/csrc/hatwarp.cu``: ``hat_rows_forward``,
``hat_rows_backward``), which read each output's two non-zero taps; autograd
saves only ``pos``. :func:`launch_geometry` sets the forward kernel's
channel vector, block and grid, :func:`backward_launch_geometry` the
transpose's rows per block, channel vector and shared memory (the
transpose gathers per row: it writes each element of ``dimg`` once, in the
image's dtype, with no atomics). On CPU tensors they run the plain
versions, the hat-matrix products built in row chunks of at most
``HAT_BUDGET`` bytes. There is no fallback from one to the other.
:func:`work` is each kernel's (bytes, FLOPs) for given inputs; while a FLOP
count is open (``utils/flops.py``) the wrappers add its FLOPs and hide their
plain versions' products from the counter.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from cermvs_torch.ops import cudalib
from cermvs_torch.utils import flops

_p, _i = ctypes.c_void_p, ctypes.c_int
LIB = cudalib.KernelLibrary("hatwarp", {
    "hat_rows_forward": [_p, _p, _p] + [_i] * 9 + [_p],
    "hat_rows_backward": [_p, _p, _p] + [_i] * 10 + [_p],
})
KERNELS = ("hat_rows_fwd", "hat_rows_bwd")
HAT_BUDGET = 384 * 1024 * 1024  # bytes of one hat-matrix chunk (plain)
THREADS = 256  # the block size of both kernels
MAX_GRID_Y = 65535
SMEM_LIMIT = 232_448  # dynamic shared memory a block may use (bytes)
# blocks the transpose aims for: four of 256 threads on each of an H100's
# 132 SMs keep enough dout loads in flight
BWD_TARGET_BLOCKS = 4 * 132


@dataclass(frozen=True)
class Geometry:
    """The forward kernel's launch: ``vec`` channels per thread, a block of
    ``block = (groups, positions)`` threads and a ``grid = (R, tiles)``."""
    vec: int
    block: tuple
    grid: tuple


@functools.lru_cache(maxsize=256)
def launch_geometry(R: int, S: int, O: int, C: int, dtype,
                    align: int = 16) -> Geometry:
    """Launch parameters of ``hat_rows_forward`` for img (R, S, C) of
    ``dtype`` whose address is a multiple of ``align`` bytes, pos (R, O):
    the widest channel vector (16 bytes at most) that divides C and the
    alignment; the threads of one position across its vectors (at most a
    block); as many positions per block as fit in ``THREADS``; one grid row
    per image row."""
    esize = 2 if dtype == torch.bfloat16 else 4
    vec = next(v for v in (8, 4, 2, 1) if v == 1 or (
        v * esize <= 16 and C % v == 0 and align % (v * esize) == 0))
    groups = min(C // vec, THREADS)
    positions = max(1, THREADS // groups)
    tiles = -(-O // positions)
    if tiles > MAX_GRID_Y or S * C >= 2 ** 31 or O * C >= 2 ** 31:
        raise ValueError(f"hat_rows_forward takes S*C and O*C below 2^31 and "
                         f"O <= {MAX_GRID_Y * positions}, got S={S} O={O} "
                         f"C={C}")
    return Geometry(vec=vec, block=(groups, positions), grid=(R, tiles))


@dataclass(frozen=True)
class BackwardGeometry:
    """The transpose's launch: ``rows`` image rows per block of ``THREADS``
    threads (``THREADS // rows`` each), ``vec`` channels per thread,
    ``groups`` threads per column, ``smem_bytes`` of dynamic shared memory
    and a ``grid = (row blocks, splits)``: block (x, j) writes the j-th of
    ``splits`` column ranges of its rows (each ranks its whole rows)."""
    rows: int
    vec: int
    groups: int
    smem_bytes: int
    grid: tuple


def backward_row_bytes(S: int, O: int) -> int:
    """Shared bytes of one row of the transpose (``bwd_row_bytes`` in
    ``csrc/hatwarp.cu``): per output its position and a record (offset and
    two weights, 16 bytes in all), per bin its end and first output."""
    return -(-(16 * O + 8 * (S + 1)) // 16) * 16


@functools.lru_cache(maxsize=256)
def backward_launch_geometry(R: int, S: int, O: int, C: int, dtype,
                             align: int = 16) -> BackwardGeometry:
    """Launch parameters of ``hat_rows_backward`` for dout (R, O, C) fp32
    and dimg (R, S, C) of ``dtype``, both at addresses that are multiples of
    ``align`` bytes: the widest fp32 channel vector (16 bytes at most) that
    divides C and the alignment; a row's threads, a whole number of warps,
    as few as its columns' vectors need (so rows of a small image share a
    block); the threads of one column across its vectors. Raises where one
    row's positions, records and bins do not fit a block's shared memory
    (16 O + 8 (S + 1) bytes: O = S = 8192 fit) or a row's offsets do not fit
    32 bits."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"unsupported image dtype {dtype}")
    row_bytes = backward_row_bytes(S, O)
    if row_bytes > SMEM_LIMIT:
        raise ValueError(
            f"hat_rows_backward keeps a row's positions, records and bins in "
            f"shared memory: 16*O + 8*(S+1) = {row_bytes} bytes exceed a "
            f"block's {SMEM_LIMIT} (O={O}, S={S})")
    if S * C >= 2 ** 31 or O * C >= 2 ** 31:
        raise ValueError(f"hat_rows_backward takes S*C and O*C below 2^31, "
                         f"got S={S} O={O} C={C}")
    vec = next(v for v in (4, 2, 1) if v == 1 or (
        C % v == 0 and align % (v * 4) == 0))
    work = S * (C // vec)  # a row's (column, vector) items
    threads = 32
    while threads < THREADS and threads < work:
        threads *= 2
    rows = THREADS // threads
    while rows > 1 and (rows > R or rows * row_bytes > SMEM_LIMIT):
        rows //= 2
    threads = THREADS // rows
    groups = max(1, min(C // vec, threads))
    row_blocks = max(1, -(-R // rows))
    # split the columns where the rows alone leave the card short of
    # blocks, keeping two passes of columns in each range
    passes = -(-S // (threads // groups))
    splits = max(1, min(round(BWD_TARGET_BLOCKS / row_blocks), passes // 2,
                        MAX_GRID_Y))
    return BackwardGeometry(rows=rows, vec=vec, groups=groups,
                            smem_bytes=rows * row_bytes,
                            grid=(row_blocks, splits))


def _hats(pos, S: int, dtype):
    """(r, S, O) hat matrices ``hat(s - pos[r, o])``, rounded to ``dtype``
    and widened back to fp32 (bf16 values are exact in fp32)."""
    s = torch.arange(S, dtype=torch.float32, device=pos.device)[None, :, None]
    w = torch.clamp(1.0 - (s - pos[:, None, :]).abs(), min=0.0)
    return w.to(dtype).float()


def _row_chunk(R: int, S: int, O: int, hat_budget=None) -> int:
    budget = HAT_BUDGET if hat_budget is None else hat_budget
    return max(1, min(R, budget // max(1, S * O * 4)))


def hat_resample_rows_reference(img, pos, hat_budget=None):
    """Plain forward: ``out[r] = hat(r)^T @ img[r]`` as fp32 matrix products
    over row chunks."""
    R, S, C = img.shape
    out = torch.empty((R, pos.shape[1], C), dtype=torch.float32,
                      device=img.device)
    rc = _row_chunk(R, S, pos.shape[1], hat_budget)
    for r0 in range(0, R, rc):
        hat = _hats(pos[r0:r0 + rc], S, img.dtype)       # (r, S, O)
        out[r0:r0 + rc] = torch.bmm(hat.transpose(1, 2),
                                    img[r0:r0 + rc].float())
    return out


def hat_resample_rows_backward_reference(dout, pos, S: int, img_dtype,
                                         hat_budget=None):
    """Plain transpose: ``dimg[r] = hat(r) @ dout[r]`` with ``dout`` rounded
    to ``img_dtype`` first, fp32 products, returned in ``img_dtype``."""
    R, O, C = dout.shape
    dimg = torch.empty((R, S, C), dtype=torch.float32, device=dout.device)
    g = dout.to(img_dtype).float()
    rc = _row_chunk(R, S, O, hat_budget)
    for r0 in range(0, R, rc):
        hat = _hats(pos[r0:r0 + rc], S, img_dtype)       # (r, S, O)
        dimg[r0:r0 + rc] = torch.bmm(hat, g[r0:r0 + rc])
    return dimg.to(img_dtype)


def work(pos, S: int, C: int, dtype):
    """``{kernel: (bytes, flops)}`` of the resample and its transpose for
    an image (R, S, C) of ``dtype`` resampled at ``pos`` (R, O): the image,
    pos and dout read once, out or dimg written once, over 2 * C FLOPs per
    in-range tap (fp32 products). The taps are counted from the data (one
    device sync)."""
    fl = torch.floor(pos)
    taps = int(((fl >= 0) & (fl <= S - 1)).sum()
               + ((fl >= -1) & (fl <= S - 2)).sum())
    img = pos.shape[0] * S * C * (2 if dtype == torch.bfloat16 else 4)
    out = pos.numel() * C * 4
    nflops = 2 * C * taps
    return {"hat_rows_fwd": (img + pos.numel() * 4 + out, nflops),
            "hat_rows_bwd": (out + pos.numel() * 4 + img, nflops)}


def _check(img, pos):
    if img.dim() != 3 or pos.dim() != 2 or pos.shape[0] != img.shape[0]:
        raise ValueError(f"expected img (R,S,C) and pos (R,O), got "
                         f"{tuple(img.shape)} and {tuple(pos.shape)}")
    if img.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"img must be float32 or bfloat16, got {img.dtype}")
    if pos.dtype != torch.float32:
        raise TypeError(f"pos must be float32, got {pos.dtype}")
    if img.device != pos.device:
        raise ValueError("img and pos must be on one device")
    for name, t in (("img", img), ("pos", pos)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if max(img.shape + pos.shape) >= 2 ** 31:
        raise ValueError("every dimension must fit a 32-bit int")


def _dtype_code(dtype) -> int:
    return 1 if dtype == torch.bfloat16 else 0


def _launch_forward(img, pos, out=None):
    """Launch ``hat_rows_forward`` into ``out`` (R, O, C) fp32, a new
    tensor unless given."""
    R, S, C = img.shape
    O = pos.shape[1]
    geo = launch_geometry(R, S, O, C, img.dtype,
                          cudalib.pointer_alignment(img))
    if out is None:
        out = torch.empty((R, O, C), dtype=torch.float32, device=img.device)
    with cudalib.on_device(img):
        LIB.call("hat_rows_forward", img.data_ptr(), pos.data_ptr(),
                 out.data_ptr(), R, S, O, C, _dtype_code(img.dtype), geo.vec,
                 *geo.block, geo.grid[1], cudalib.stream_of(img))
    cudalib.count_launch("hat_rows_fwd")
    return out


def _launch_backward(dout, pos, S, img_dtype, out=None):
    """Launch ``hat_rows_backward`` into ``out`` (R, S, C) of ``img_dtype``,
    a new tensor unless given; the kernel writes every element."""
    R, O, C = dout.shape
    if out is None:
        out = torch.empty((R, S, C), dtype=img_dtype, device=dout.device)
    geo = backward_launch_geometry(
        R, S, O, C, img_dtype,
        min(cudalib.pointer_alignment(dout), cudalib.pointer_alignment(out)))
    with cudalib.on_device(dout):
        LIB.call("hat_rows_backward", dout.data_ptr(), pos.data_ptr(),
                 out.data_ptr(), R, S, O, C, _dtype_code(img_dtype), geo.vec,
                 geo.rows, geo.groups, geo.grid[1], geo.smem_bytes,
                 cudalib.stream_of(dout))
    cudalib.count_launch("hat_rows_bwd")
    return out


def hat_rows_backward(dout, pos, S: int, img_dtype, out=None):
    """``dimg`` (R, S, C) in ``img_dtype`` for ``dout`` (R, O, C): the kernel
    on CUDA tensors, the plain version on CPU tensors; written into ``out``
    (contiguous, (R, S, C), ``img_dtype``, on dout's device) when given."""
    if dout.dim() != 3 or tuple(dout.shape[:2]) != tuple(pos.shape):
        raise ValueError(f"dout {tuple(dout.shape)} does not match pos "
                         f"{tuple(pos.shape)}")
    if dout.device != pos.device or pos.dtype != torch.float32:
        raise ValueError("dout and float32 pos must be on one device")
    if img_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"unsupported image dtype {img_dtype}")
    R, O, C = dout.shape
    if out is not None and (tuple(out.shape) != (R, S, C)
                            or out.dtype != img_dtype
                            or out.device != dout.device
                            or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous {(R, S, C)} "
                         f"{img_dtype} tensor on {dout.device}")
    dout = dout.float().contiguous()
    if flops.counting():
        return flops.counted(("hat_rows_bwd",),
                             lambda: work(pos, S, C, img_dtype),
                             _backward, dout, pos, S, img_dtype, out)
    return _backward(dout, pos, S, img_dtype, out)


def _backward(dout, pos, S, img_dtype, out):
    if dout.is_cuda:
        return _launch_backward(dout, pos.contiguous(), S, img_dtype, out)
    if dout.device.type != "cpu":
        raise ValueError(f"unsupported device {dout.device}")
    dimg = hat_resample_rows_backward_reference(dout, pos, S, img_dtype)
    return dimg if out is None else out.copy_(dimg)


def _forward(img, pos):
    if flops.counting():
        return flops.counted(("hat_rows_fwd",),
                             lambda: work(pos, img.shape[1], img.shape[2],
                                          img.dtype),
                             _run_forward, img, pos)
    return _run_forward(img, pos)


def _run_forward(img, pos):
    if img.is_cuda:
        return _launch_forward(img, pos)
    if img.device.type != "cpu":
        raise ValueError(f"unsupported device {img.device}")
    return hat_resample_rows_reference(img, pos)


class _HatRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, img, pos):
        ctx.save_for_backward(pos)
        ctx.S, ctx.img_dtype = img.shape[1], img.dtype
        return _forward(img, pos)

    @staticmethod
    def backward(ctx, dout):
        (pos,) = ctx.saved_tensors
        # pos: no gradient (zero in the JAX package's VJP)
        return hat_rows_backward(dout, pos, ctx.S, ctx.img_dtype), None


def hat_resample_rows(img: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """(R, S, C) x (R, O) -> (R, O, C) fp32 row resample; see the module
    docstring."""
    _check(img, pos)
    if not (img.requires_grad and torch.is_grad_enabled()):
        return _forward(img, pos)  # no graph to record: skip autograd's cost
    return _HatRows.apply(img, pos.detach())

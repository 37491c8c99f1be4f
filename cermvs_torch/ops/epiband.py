"""Rectified epipolar band resample: the CUDA kernels' wrappers and their
plain PyTorch versions.

``epiband(fr, fs, base, sigma, n_hyp, s_max)`` -> (V, h_r, w_r, n_hyp) fp32:

    out[v, y, x, k] = interp1d(G[v, y, x, :], x + s_max - base - k * sigma)
    G[v, y, x, s]   = <fr[v, y, x, :], fs[v, y, s, :]>

with each interpolation tap zeroed outside ``[0, ws - 1]``. ``fr``
(V, h_r, w_r, C) and ``fs`` (V, h_r, ws, C) are bf16 or fp32; ``base`` and
``sigma`` (V, h_r, w_r) fp32; ``base=None`` means base == 0 (stage 0).

It is differentiable in ``fr`` and ``fs``: the backward returns ``dfr`` and
``dfs`` in the features' dtype (:func:`epiband_backward_reference` says
what they are) and no gradient for ``base`` and ``sigma``, as the JAX
package's custom VJP gives them zero (not autograd's gradient of the plain
version, which is non-zero).

On CUDA tensors the wrappers launch the hand-written kernels
(``cermvs_torch/csrc/epiband.cu``: ``epiband_forward``,
``epiband_backward_dfr``, ``epiband_backward_dfs``), built with ``nvcc`` at
first use (``ops/cudalib.py``); on CPU tensors they run the plain versions.
There is no fallback from one to the other. :func:`launch_geometry` sets the
forward kernel's tile, hypotheses per block, chunk, copy width, shared
memory and grid,
:func:`dfs_launch_geometry` the dfs kernel's column window, shared memory and
grid, :func:`dfr_launch_geometry` the dfr kernel's pixel tile, channel layout,
shared memory and grid. :func:`work` is each kernel's (bytes, FLOPs) for
given inputs; while a FLOP count is open (``utils/flops.py``) the wrappers
add its FLOPs and hide their plain versions' products from the counter.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from cermvs_torch.ops import cudalib
from cermvs_torch.utils import flops

_p, _i = ctypes.c_void_p, ctypes.c_int
LIB = cudalib.KernelLibrary("epiband", {
    "epiband_forward": [_p, _p, _p, _p, _p] + [_i] * 11 + [_p],
    "epiband_backward_dfr": [_p, _p, _p, _p, _p] + [_i] * 11 + [_p],
    "epiband_backward_dfs": [_p, _p, _p, _p, _p] + [_i] * 10 + [_p],
})
KERNELS = ("epiband_fwd", "epiband_bwd_dfr", "epiband_bwd_dfs")
THREADS = 256        # the forward kernel's block size
MAX_OUT = 16         # forward: outputs a thread keeps in registers
CHUNK = 128          # bf16 forward: source columns per staged chunk
REACH_WORDS = 64     # bf16 forward: 32-chunk words of its reached-chunk bitmap
FP32_TILE = 64       # fp32 forward: rect pixels per block
FP32_CHUNK = 64      # fp32 forward: source columns per staged chunk
MAX_GRID_YZ = 65535
DFS_WARPS = 8        # dfs: warps per block, 32 source columns each
DFS_CHUNK = 32       # dfs: pixels whose dG rows a block stages at once
DFR_WARPS = 8        # dfr: warps per block, two pixels at a time each
DFR_TILE = 32        # dfr: rect pixels per block
SMEM_LIMIT = 232_448  # dynamic shared memory a block may use (bytes)


@dataclass(frozen=True)
class Geometry:
    """The forward kernel's launch: ``tile`` rect pixels and ``hyps``
    hypotheses per block of ``THREADS``, ``chunk`` source columns per staged
    chunk (the kernel's compile-time ``kChunk``), ``vec`` channels per copy,
    ``smem_bytes`` of dynamic shared memory and ``grid = (tiles * groups,
    h_r, V)``, ``groups = ceil(D / hyps)``. The launcher takes tile, vec and
    smem_bytes, and forms hyps as :func:`hyp_group` does."""
    tile: int
    hyps: int
    chunk: int
    vec: int
    smem_bytes: int
    grid: tuple


def hyp_group(tile: int, D: int) -> int:
    """Hypotheses per block: all D where the tile's outputs fit the
    threads' registers (tile * D <= THREADS * MAX_OUT), else the fewest
    equal groups that do (the kernel's ``hyp_group``)."""
    groups = -(-tile * D // (THREADS * MAX_OUT))
    return -(-D // groups)


@functools.lru_cache(maxsize=256)
def launch_geometry(V: int, h_r: int, w_r: int, ws: int, C: int, D: int,
                    dtype, align: int = 16) -> Geometry:
    """Launch parameters of ``epiband_forward`` for fr (V, h_r, w_r, C) and
    fs (V, h_r, ws, C) of ``dtype`` whose addresses are multiples of
    ``align`` bytes, and D hypotheses. bf16: the widest tile of 64, 32 or
    16 pixels whose outputs fit the threads' registers (tile * D <=
    THREADS * MAX_OUT), all D hypotheses a block, chunks of CHUNK columns,
    a bitmap of REACH_WORDS words. fp32: tiles of FP32_TILE pixels, the
    hypotheses in :func:`hyp_group`'s groups (any D), chunks of FP32_CHUNK
    columns, a bitmap of one bit per chunk of the row (any ws). Both: the
    widest copy (16 bytes at most) that divides C and the alignment, and
    the bytes of the kernel's shared-memory layout (``Smem`` in
    ``csrc/epiband.cu``, whose launcher refuses any other count)."""
    if max(h_r, V) > MAX_GRID_YZ:
        raise ValueError(f"epiband takes h_r and V up to {MAX_GRID_YZ}, got "
                         f"{h_r} and {V}")
    esize = 2 if dtype == torch.bfloat16 else 4
    if esize == 2:
        fits = [t for t in (64, 32, 16) if t * D <= THREADS * MAX_OUT]
        if not fits or ws > 32 * REACH_WORDS * CHUNK:
            raise ValueError(f"the bf16 epiband kernel takes D <= "
                             f"{THREADS * MAX_OUT // 16} and ws <= "
                             f"{32 * REACH_WORDS * CHUNK}, got D={D} ws={ws}")
        tile, chunk, words = fits[0], CHUNK, REACH_WORDS
    else:
        tile, chunk = FP32_TILE, FP32_CHUNK
        words = -(-(-(-ws // chunk)) // 32)
    hyps = hyp_group(tile, D)
    vec = next(v for v in (8, 4, 2)
               if C % v == 0 and align % (v * esize) == 0 and v * esize <= 16)
    lds = -(-C // 16) * 16 + 8              # elements per staged row
    smem = ((tile + 2 * chunk) * lds * esize  # fr tile, two source chunks
            # the fp32 G tile, then the output tile (rows of hyps | 1)
            + tile * max(chunk + 8, hyps | 1) * 4
            + 2 * tile * 4 + words * 4)     # base, sigma, bitmap
    if smem > SMEM_LIMIT:
        raise ValueError(f"the epiband forward's bitmap for ws={ws} leaves no "
                         f"room in a block's shared memory")
    return Geometry(tile=tile, hyps=hyps, chunk=chunk, vec=vec,
                    smem_bytes=smem,
                    grid=(-(-w_r // tile) * -(-D // hyps), h_r, V))


@dataclass(frozen=True)
class DfsGeometry:
    """The dfs kernel's launch: a block of ``DFS_WARPS`` warps per window of
    ``window`` source columns (32 a warp), rect row and view, ``grid =
    (windows, h_r, V)``, and ``smem_bytes`` of dynamic shared memory. The
    launcher takes window and smem_bytes."""
    window: int
    smem_bytes: int
    grid: tuple


@functools.lru_cache(maxsize=256)
def dfs_launch_geometry(V: int, h_r: int, ws: int, C: int, D: int,
                        dtype) -> DfsGeometry:
    """Launch parameters of ``epiband_backward_dfs`` for a gradient (V, h_r,
    ws, C) of ``dtype`` from D hypotheses: the fewest windows of at most
    ``32 * DFS_WARPS`` columns that cover the row, made even (a multiple of
    32 columns each), and the bytes of the kernel's shared-memory layout
    (``DfsSmem`` in ``csrc/epiband.cu``, whose launcher refuses any other
    count): a chunk's D tap records a pixel, its dG rows (fp32,
    over the window) and fr rows (padded to 16 bytes), the column groups'
    masks of them, the candidate pixels."""
    if max(h_r, V) > MAX_GRID_YZ:
        raise ValueError(f"epiband takes h_r and V up to {MAX_GRID_YZ}, got "
                         f"{h_r} and {V}")
    n = -(-ws // (32 * DFS_WARPS))
    window = -(-ws // (32 * n)) * 32
    esize = 2 if dtype == torch.bfloat16 else 4
    fr_row = -(-C * esize // 16) * 16
    # tap records; two buffers of dG rows, fr rows, masks; candidates
    smem = (DFS_CHUNK * D * 16
            + 2 * (DFS_CHUNK * window * 4 + DFS_CHUNK * fr_row + DFS_WARPS * 4)
            + 2 * DFS_WARPS * 32 * 5 * 4 + 2 * DFS_WARPS * 4)
    if smem > SMEM_LIMIT:
        raise ValueError(f"the dfs kernel's tap records for D={D} leave no "
                         f"room in a block's shared memory")
    return DfsGeometry(window=window, smem_bytes=smem,
                       grid=(-(-ws // window), h_r, V))


@dataclass(frozen=True)
class DfrGeometry:
    """The dfr kernel's launch: a block of ``DFR_WARPS`` warps per ``tile``
    (``DFR_TILE``) rect pixels of a row and view, ``grid = (tiles, h_r,
    V)``; ``vec`` 4 where each lane's four channels are one vector, else 2
    (the channel pairs at 2i and 32 + 2i); ``smem_bytes`` of dynamic shared
    memory. The launcher takes tile, vec and smem_bytes."""
    tile: int
    vec: int
    smem_bytes: int
    grid: tuple


@functools.lru_cache(maxsize=256)
def dfr_launch_geometry(V: int, h_r: int, w_r: int, ws: int, C: int, D: int,
                        dtype, align: int = 16) -> DfrGeometry:
    """Launch parameters of ``epiband_backward_dfr`` for a gradient (V, h_r,
    w_r, C) of ``dtype`` from D hypotheses over source rows of ws columns,
    with fs and the gradient at addresses that are multiples of ``align``
    bytes: tiles of ``DFR_TILE`` pixels; 4-channel vectors where C % 4 == 0
    and the alignment allows them; and the bytes of the kernel's
    shared-memory layout (``DfrSmem`` in ``csrc/epiband.cu``, whose launcher
    refuses any other count): per warp, one pixel's D tap records (16 bytes
    each) and two pixels' lists of up to 2 D column records (8 bytes
    each)."""
    if max(h_r, V) > MAX_GRID_YZ:
        raise ValueError(f"epiband takes h_r and V up to {MAX_GRID_YZ}, got "
                         f"{h_r} and {V}")
    if C % 2 or not 0 < C <= 64 or ws * C >= 2 ** 31:
        raise ValueError(f"the dfr kernel takes an even C <= 64 and ws * C "
                         f"< 2^31, got C={C} ws={ws}")
    esize = 2 if dtype == torch.bfloat16 else 4
    vec = 4 if C % 4 == 0 and align % (4 * esize) == 0 else 2
    smem = DFR_WARPS * (D * 16 + 2 * 2 * D * 8)
    if smem > SMEM_LIMIT:
        raise ValueError(f"the dfr kernel's records for D={D} leave no room "
                         f"in a block's shared memory")
    return DfrGeometry(tile=DFR_TILE, vec=vec, smem_bytes=smem,
                       grid=(-(-w_r // DFR_TILE), h_r, V))


def epiband_reference(fr, fs, base, sigma, n_hyp: int, s_max: int):
    """Plain PyTorch version: materialize G per view in fp32 and interpolate
    (the arithmetic of ``corr_rectified._resample_rows_oracle``)."""
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
        # clamped only to keep the integer cast finite: -2 and ws + 1 are
        # outside the band for both taps, as every farther position is
        i0 = x0.clamp(-2, ws + 1).to(torch.int64)
        i1 = i0 + 1
        g0 = torch.gather(G, -1, i0.clamp(0, ws - 1))
        g1 = torch.gather(G, -1, i1.clamp(0, ws - 1))
        valid0 = ((i0 >= 0) & (i0 <= ws - 1)).float()
        valid1 = ((i1 >= 0) & (i1 <= ws - 1)).float()
        outs.append((1.0 - f) * g0 * valid0 + f * g1 * valid1)
    return torch.stack(outs)


def work(fr, fs, base, sigma, n_hyp: int, s_max: int):
    """``{kernel: (bytes, flops)}`` of the forward and the two backward
    kernels for these inputs: what the inputs need, not the most they
    could. Bytes: the fr rows of pixels with an in-band tap, the fs columns
    that some in-band tap of the row reaches, base and sigma, each read
    once; the fp32 volume (forward) or dout (backward) once; the gradient
    written once. FLOPs: 2 * C per in-band tap, plus 4 per output in the
    forward (the lerp). The taps are counted from the data (one device
    sync)."""
    V, h_r, w_r, C = fr.shape
    ws = fs.shape[2]
    x = torch.arange(w_r, dtype=torch.float32, device=fr.device)
    k = torch.arange(n_hyp, dtype=torch.float32, device=fr.device)
    b = 0.0 if base is None else base[..., None]
    pos = (x + float(s_max))[None, None, :, None] - (b + sigma[..., None] * k)
    fl = torch.floor(pos)
    ok0 = (fl >= 0) & (fl <= ws - 1)
    ok1 = (fl >= -1) & (fl <= ws - 2)
    reached = torch.zeros(V * h_r, ws + 1, dtype=torch.uint8,
                          device=fr.device)
    for tap, ok in ((fl, ok0), (fl + 1, ok1)):
        col = torch.where(ok, tap, float(ws)).to(torch.int64)
        reached.scatter_(1, col.reshape(V * h_r, -1), 1)
    cols = int(reached[:, :ws].sum())
    pixels = int((ok0 | ok1).any(-1).sum())
    taps = int(ok0.sum() + ok1.sum())
    e = fr.element_size()
    params = sigma.numel() * 4 + (0 if base is None else base.numel() * 4)
    vol = V * h_r * w_r * n_hyp * 4
    return {
        "epiband_fwd": ((pixels + cols) * C * e + params + vol,
                        2 * C * taps + 4 * V * h_r * w_r * n_hyp),
        "epiband_bwd_dfr": (cols * C * e + params + vol + fr.numel() * e,
                            2 * C * taps),
        "epiband_bwd_dfs": (pixels * C * e + params + vol + fs.numel() * e,
                            2 * C * taps),
    }


def _check(fr, fs, base, sigma, n_hyp, s_max):
    if fr.dim() != 4 or fs.dim() != 4 or sigma.dim() != 3:
        raise ValueError("expected fr (V,h_r,w_r,C), fs (V,h_r,ws,C), "
                         "sigma (V,h_r,w_r)")
    V, h_r, w_r, C = fr.shape
    if fs.shape[0] != V or fs.shape[1] != h_r or fs.shape[3] != C:
        raise ValueError(f"fs shape {tuple(fs.shape)} does not match fr "
                         f"{tuple(fr.shape)}")
    if tuple(sigma.shape) != (V, h_r, w_r) or (
            base is not None and tuple(base.shape) != (V, h_r, w_r)):
        raise ValueError("base/sigma must be (V, h_r, w_r)")
    if fr.dtype != fs.dtype or fr.dtype not in (torch.float32,
                                                torch.bfloat16):
        raise TypeError(f"features must both be float32 or bfloat16, got "
                        f"{fr.dtype}/{fs.dtype}")
    if sigma.dtype != torch.float32 or (base is not None
                                        and base.dtype != torch.float32):
        raise TypeError("base/sigma must be float32")
    tensors = [fr, fs, sigma] + ([] if base is None else [base])
    if len({t.device for t in tensors}) != 1:
        raise ValueError("fr, fs, base and sigma must be on one device")
    if n_hyp < 1 or s_max < 0:
        raise ValueError(f"bad n_hyp={n_hyp} / s_max={s_max}")
    for name, t in (("fr", fr), ("fs", fs), ("sigma", sigma), ("base", base)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_kernel_args(fr, fs, base, sigma):
    """What the CUDA kernels add to :func:`_check`: an even C <= 64 (rows
    copied and read as channel pairs at least, the gradients' lanes one
    pair each), so fr and fs must start on a 2-element boundary
    (base/sigma on 4 bytes)."""
    C = fr.shape[-1]
    if C % 2 or C > 64:
        raise ValueError(f"kernel takes an even channel count <= 64, got {C}")
    for name, t, align in (("fr", fr, 2 * fr.element_size()),
                           ("fs", fs, 2 * fs.element_size()),
                           ("sigma", sigma, 4), ("base", base, 4)):
        if t is not None and t.data_ptr() % align:
            raise ValueError(f"{name} must start on a {align}-byte boundary "
                             f"(storage offset {t.storage_offset()})")


def _dtype_code(t) -> int:
    return 1 if t.dtype == torch.bfloat16 else 0


def _launch(fr, fs, base, sigma, n_hyp, s_max, out=None):
    """Launch ``epiband_forward`` into ``out`` (V, h_r, w_r, n_hyp) fp32, a
    new tensor unless given."""
    V, h_r, w_r, C = fr.shape
    ws = fs.shape[2]
    _check_kernel_args(fr, fs, base, sigma)
    geo = launch_geometry(V, h_r, w_r, ws, C, n_hyp, fr.dtype,
                          min(cudalib.pointer_alignment(fr),
                              cudalib.pointer_alignment(fs)))
    if out is None:
        out = torch.empty((V, h_r, w_r, n_hyp), dtype=torch.float32,
                          device=fr.device)
    with cudalib.on_device(fr):
        LIB.call("epiband_forward", fr.data_ptr(), fs.data_ptr(),
                 None if base is None else base.data_ptr(), sigma.data_ptr(),
                 out.data_ptr(), V, h_r, w_r, ws, C, n_hyp, int(s_max),
                 _dtype_code(fr), geo.tile, geo.vec, geo.smem_bytes,
                 cudalib.stream_of(fr))
    cudalib.count_launch("epiband_fwd")
    return out


def epiband_backward_reference(fr, fs, base, sigma, dout, s_max: int):
    """Plain PyTorch version of the backward: with the forward's tap
    positions, ``dG[v,y,x,s] = sum_k dout[v,y,x,k] * (weight of tap s)``
    over the in-band taps, then ``dfr = dG @ fs`` and ``dfs = dG^T @ fr``,
    returned in the features' dtype. Sums and products are fp32; with bf16
    features ``dout``, each tap's ``weight * dout`` and ``dG`` are rounded
    to bf16 first, where the JAX package's backward kernels round them."""
    V, h_r, w_r, _ = fr.shape
    ws = fs.shape[2]
    D = dout.shape[-1]
    dev = fr.device

    def rd(t):
        return t.to(fr.dtype).float()

    x = torch.arange(w_r, dtype=torch.float32, device=dev)
    k = torch.arange(D, dtype=torch.float32, device=dev)
    dfr, dfs = [], []
    for v in range(V):
        b = (torch.zeros((h_r, w_r), dtype=torch.float32, device=dev)
             if base is None else base[v])
        idx = (x + float(s_max))[None, :, None] - (
            b[..., None] + sigma[v][..., None] * k)
        x0 = torch.floor(idx)
        f = idx - x0
        # a NaN position (base or sigma) has no in-band tap
        i0 = x0.nan_to_num(-2.0).clamp(-2, ws + 1).to(torch.int64)
        i1 = i0 + 1
        g = rd(dout[v].float())
        w0 = torch.where((i0 >= 0) & (i0 <= ws - 1), rd((1.0 - f) * g), 0.0)
        w1 = torch.where((i1 >= 0) & (i1 <= ws - 1), rd(f * g), 0.0)
        dG = torch.zeros((h_r, w_r, ws), dtype=torch.float32, device=dev)
        dG.scatter_add_(-1, i0.clamp(0, ws - 1), w0)
        dG.scatter_add_(-1, i1.clamp(0, ws - 1), w1)
        dG = rd(dG)
        dfr.append(torch.einsum("hxs,hsc->hxc", dG, fs[v].float()))
        dfs.append(torch.einsum("hxs,hxc->hsc", dG, fr[v].float()))
    return (torch.stack(dfr).to(fr.dtype), torch.stack(dfs).to(fs.dtype))


def backward_dfr(fr, fs, base, sigma, dout, s_max: int, out=None):
    """Launch ``epiband_backward_dfr`` on checked CUDA tensors into ``out``
    (V, h_r, w_r, C) in the features' dtype, a new tensor unless given: the
    kernel writes every element."""
    V, h_r, w_r, C = fr.shape
    ws, D = fs.shape[2], dout.shape[-1]
    _check_kernel_args(fr, fs, base, sigma)
    if out is None:
        out = torch.empty((V, h_r, w_r, C), dtype=fr.dtype, device=fr.device)
    elif (out.shape != fr.shape or out.dtype != fr.dtype
          or out.device != fr.device or not out.is_contiguous()):
        raise ValueError("out must be contiguous, shaped and typed as fr, "
                         "on its device")
    geo = dfr_launch_geometry(V, h_r, w_r, ws, C, D, fr.dtype,
                              min(cudalib.pointer_alignment(fs),
                                  cudalib.pointer_alignment(out)))
    with cudalib.on_device(fr):
        LIB.call("epiband_backward_dfr", fs.data_ptr(),
                 None if base is None else base.data_ptr(), sigma.data_ptr(),
                 dout.data_ptr(), out.data_ptr(), V, h_r, w_r, ws, C, D,
                 int(s_max), _dtype_code(fr), geo.tile, geo.vec,
                 geo.smem_bytes, cudalib.stream_of(fr))
    cudalib.count_launch("epiband_bwd_dfr")
    return out


def backward_dfs(fr, fs, base, sigma, dout, s_max: int, out=None):
    """Launch ``epiband_backward_dfs`` on checked CUDA tensors into ``out``
    (V, h_r, ws, C) in the features' dtype, a new tensor unless given: the
    kernel writes every element."""
    V, h_r, w_r, C = fr.shape
    ws, D = fs.shape[2], dout.shape[-1]
    _check_kernel_args(fr, fs, base, sigma)
    geo = dfs_launch_geometry(V, h_r, ws, C, D, fr.dtype)
    if out is None:
        out = torch.empty((V, h_r, ws, C), dtype=fs.dtype, device=fr.device)
    with cudalib.on_device(fr):
        LIB.call("epiband_backward_dfs", fr.data_ptr(),
                 None if base is None else base.data_ptr(), sigma.data_ptr(),
                 dout.data_ptr(), out.data_ptr(), V, h_r, w_r, ws, C, D,
                 int(s_max), _dtype_code(fr), geo.window, geo.smem_bytes,
                 cudalib.stream_of(fr))
    cudalib.count_launch("epiband_bwd_dfs")
    return out


def epiband_backward(fr, fs, base, sigma, dout, s_max: int):
    """``(dfr, dfs)`` for the output gradient ``dout`` (V, h_r, w_r, D)
    fp32: the kernels on CUDA tensors, :func:`epiband_backward_reference`
    on CPU tensors."""
    _check(fr, fs, base, sigma, dout.shape[-1], s_max)
    if (dout.dtype != torch.float32 or dout.device != fr.device
            or tuple(dout.shape[:3]) != tuple(fr.shape[:3])):
        raise ValueError(f"dout must be float32 (V, h_r, w_r, D) on "
                         f"{fr.device}, got {dout.dtype} "
                         f"{tuple(dout.shape)} on {dout.device}")
    dout = dout.contiguous()
    if flops.counting():
        return flops.counted(
            ("epiband_bwd_dfr", "epiband_bwd_dfs"),
            lambda: work(fr, fs, base, sigma, dout.shape[-1], s_max),
            _backward, fr, fs, base, sigma, dout, s_max)
    return _backward(fr, fs, base, sigma, dout, s_max)


def _backward(fr, fs, base, sigma, dout, s_max):
    if fr.is_cuda:
        return (backward_dfr(fr, fs, base, sigma, dout, s_max),
                backward_dfs(fr, fs, base, sigma, dout, s_max))
    if fr.device.type != "cpu":
        raise ValueError(f"unsupported device {fr.device}")
    return epiband_backward_reference(fr, fs, base, sigma, dout, s_max)


def _forward(fr, fs, base, sigma, n_hyp, s_max):
    if flops.counting():
        return flops.counted(
            ("epiband_fwd",),
            lambda: work(fr, fs, base, sigma, n_hyp, s_max),
            _run_forward, fr, fs, base, sigma, n_hyp, s_max)
    return _run_forward(fr, fs, base, sigma, n_hyp, s_max)


def _run_forward(fr, fs, base, sigma, n_hyp, s_max):
    if fr.is_cuda:
        return _launch(fr, fs, base, sigma, n_hyp, s_max)
    if fr.device.type != "cpu":
        raise ValueError(f"unsupported device {fr.device}")
    return epiband_reference(fr, fs, base, sigma, n_hyp, s_max)


class _Epiband(torch.autograd.Function):
    @staticmethod
    def forward(ctx, fr, fs, base, sigma, n_hyp, s_max):
        ctx.save_for_backward(fr, fs, base, sigma)
        ctx.s_max = s_max
        return _forward(fr, fs, base, sigma, n_hyp, s_max)

    @staticmethod
    def backward(ctx, dout):
        fr, fs, base, sigma = ctx.saved_tensors
        dfr, dfs = epiband_backward(fr, fs, base, sigma, dout.float(),
                                    ctx.s_max)
        # base and sigma: no gradient (zero in the JAX package's VJP)
        return dfr, dfs, None, None, None, None


def epiband(fr, fs, base, sigma, n_hyp: int, s_max: int) -> torch.Tensor:
    """(V, h_r, w_r, n_hyp) fp32 rect-grid cost volume; see the module
    docstring. CUDA tensors launch the kernel, CPU tensors run
    :func:`epiband_reference`."""
    _check(fr, fs, base, sigma, n_hyp, s_max)
    if not (torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (fr, fs, base, sigma))):
        # no graph to record: skip autograd's cost
        return _forward(fr, fs, base, sigma, int(n_hyp), int(s_max))
    return _Epiband.apply(fr, fs, base, sigma, int(n_hyp), int(s_max))

"""Rectified epipolar band resample: the CUDA kernel's wrapper and its plain
PyTorch version.

``epiband(fr, fs, base, sigma, n_hyp, s_max)`` -> (V, h_r, w_r, n_hyp) fp32:

    out[v, y, x, k] = interp1d(G[v, y, x, :], x + s_max - base - k * sigma)
    G[v, y, x, s]   = <fr[v, y, x, :], fs[v, y, s, :]>

with each interpolation tap zeroed outside ``[0, ws - 1]``. ``fr``
(V, h_r, w_r, C) and ``fs`` (V, h_r, ws, C) are bf16 or fp32; ``base`` and
``sigma`` (V, h_r, w_r) fp32; ``base=None`` means base == 0 (stage 0).

On CUDA tensors the wrapper launches the hand-written kernel
(``cermvs_torch/csrc/epiband.cu``), built with ``nvcc`` at first use into
``build/`` at the repository root; on CPU tensors it runs
:func:`epiband_reference`. There is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "epiband.cu"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

launches = 0  # kernel launches since the last reset (reset_launches)

_lib = None
_lib_lock = threading.Lock()


def reset_launches() -> None:
    global launches
    launches = 0


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME)")
    return found


def build(verbose: bool = False) -> Path:
    """Compile ``csrc/epiband.cu`` into ``build/`` (named by the source's
    hash, so an edited source rebuilds) and return the library path."""
    digest = hashlib.sha256(_SRC.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"libepiband_{digest}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS] + (["-Xptxas", "-v"] if verbose else []) + [
        "-o", str(tmp), str(_SRC)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    if verbose:
        print(res.stdout + res.stderr, flush=True)
    os.replace(tmp, lib)
    return lib


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.epiband_forward.argtypes = [p, p, p, p, p, i, i, i, i, i, i,
                                            i, i, p]
            lib.epiband_forward.restype = i
            lib.epiband_error_string.argtypes = [i]
            lib.epiband_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


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
    """What the CUDA kernel adds to :func:`_check`: one channel pair per
    lane (an even C <= 64), and fr/fs rows read as 2-element vectors, so
    both must start on a 2-element boundary (base/sigma on 4 bytes)."""
    C = fr.shape[-1]
    if C % 2 or C > 64:
        raise ValueError(f"kernel takes an even channel count <= 64, got {C}")
    for name, t, align in (("fr", fr, 2 * fr.element_size()),
                           ("fs", fs, 2 * fs.element_size()),
                           ("sigma", sigma, 4), ("base", base, 4)):
        if t is not None and t.data_ptr() % align:
            raise ValueError(f"{name} must start on a {align}-byte boundary "
                             f"(storage offset {t.storage_offset()})")


def _launch(fr, fs, base, sigma, n_hyp, s_max):
    global launches
    V, h_r, w_r, C = fr.shape
    _check_kernel_args(fr, fs, base, sigma)
    lib = _load()
    out = torch.empty((V, h_r, w_r, n_hyp), dtype=torch.float32,
                      device=fr.device)
    with torch.cuda.device(fr.device):
        stream = torch.cuda.current_stream(fr.device).cuda_stream
        err = lib.epiband_forward(
            fr.data_ptr(), fs.data_ptr(),
            None if base is None else base.data_ptr(), sigma.data_ptr(),
            out.data_ptr(), V, h_r, w_r, fs.shape[2], C, n_hyp, int(s_max),
            1 if fr.dtype == torch.bfloat16 else 0, stream)
    if err != 0:
        raise RuntimeError("epiband kernel launch failed: "
                           + lib.epiband_error_string(err).decode())
    launches += 1
    return out


class _Epiband(torch.autograd.Function):
    @staticmethod
    def forward(ctx, fr, fs, base, sigma, n_hyp, s_max):
        if fr.is_cuda:
            return _launch(fr, fs, base, sigma, n_hyp, s_max)
        if fr.device.type != "cpu":
            raise ValueError(f"unsupported device {fr.device}")
        return epiband_reference(fr, fs, base, sigma, n_hyp, s_max)

    @staticmethod
    def backward(ctx, dout):
        raise NotImplementedError("epiband backward: Queue 2 item 2")


def epiband(fr, fs, base, sigma, n_hyp: int, s_max: int) -> torch.Tensor:
    """(V, h_r, w_r, n_hyp) fp32 rect-grid cost volume; see the module
    docstring. CUDA tensors launch the kernel, CPU tensors run
    :func:`epiband_reference`."""
    _check(fr, fs, base, sigma, n_hyp, s_max)
    return _Epiband.apply(fr, fs, base, sigma, int(n_hyp), int(s_max))

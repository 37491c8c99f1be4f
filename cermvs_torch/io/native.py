"""The port's host data runtime, ``cermvs_torch/csrc/dataio.cpp``, through
ctypes: the PFM codec and the multithreaded resize and crop that
``random_scale_and_crop`` applies to every training batch.

The source is compiled with ``g++`` at first use into ``build/`` at the
repository root, with the flags of the JAX package's data runtime
(:data:`CXXFLAGS`, :data:`LDFLAGS`): they decide the bits, since under
``-march=native`` GCC contracts the bilinear blends into fused multiply-adds,
and the port's training batches must be the JAX package's. The library is
named by a hash of the source, the flags and the CPU that ``-march=native``
means on this host, so an edited source, or a checkout copied to another
host, builds anew. A failed build or load raises with the compiler's
message: there is no fallback (cv2's resize gives other arrays).

:func:`scale_and_crop_reference` is a plain numpy version of
:func:`scale_and_crop` (the same float32 formula, half-pixel centres), for
tests and the smoke run to hold the library against.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent.parent / "csrc" / "dataio.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build"
CXX = "g++"
CXXFLAGS = ["-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall"]
LDFLAGS = ["-shared", "-lpthread"]

_lib = None
_lock = threading.Lock()


def _native_arch() -> str:
    """What ``-march=native`` selects on this host, as g++ reports it."""
    res = subprocess.run([CXX, "-march=native", "-Q", "--help=target"],
                         capture_output=True, text=True, check=True)
    return " ".join(line.split()[-1] for line in res.stdout.splitlines()
                    if line.strip().startswith(("-march=", "-mtune=")))


def build() -> Path:
    """Compile the source into ``build/`` unless that build exists; return
    the library's path. Raises RuntimeError with g++'s message if the
    build fails."""
    digest = hashlib.sha256(SRC.read_bytes() + " ".join(
        [CXX, *CXXFLAGS, *LDFLAGS, _native_arch()]).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"libdataio_{digest}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    res = subprocess.run([CXX, *CXXFLAGS, str(SRC), "-o", str(tmp),
                          *LDFLAGS], capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"{CXX} {SRC.name} failed ({res.returncode}):\n"
                           f"{res.stderr}")
    os.replace(tmp, lib)
    return lib


def load() -> ctypes.CDLL:
    """The library, built and bound at the first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            f32p = ctypes.POINTER(ctypes.c_float)
            i32p = ctypes.POINTER(ctypes.c_int)
            c_int = ctypes.c_int
            lib.pfm_read_header.argtypes = [ctypes.c_char_p, i32p, i32p,
                                            i32p, f32p]
            lib.pfm_read_header.restype = c_int
            lib.pfm_read_data.argtypes = [ctypes.c_char_p, f32p]
            lib.pfm_read_data.restype = c_int
            lib.pfm_write.argtypes = [ctypes.c_char_p, f32p, c_int, c_int]
            lib.pfm_write.restype = c_int
            for fn in (lib.resize_bilinear, lib.resize_nearest):
                fn.argtypes = [f32p, c_int, c_int, c_int, f32p, c_int, c_int]
                fn.restype = None
            lib.scale_and_crop.argtypes = [f32p] + [c_int] * 11 + [f32p]
            lib.scale_and_crop.restype = None
            _lib = lib
    return _lib


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def read_pfm(path) -> np.ndarray:
    """A PFM file as float32, (H, W) or (H, W, 3), rows top-down."""
    lib = load()
    w, h, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    s = ctypes.c_float()
    name = str(path).encode()
    rc = lib.pfm_read_header(name, ctypes.byref(w), ctypes.byref(h),
                             ctypes.byref(c), ctypes.byref(s))
    if rc != 0:
        raise IOError(f"pfm_read_header({path}) -> {rc}")
    shape = (h.value, w.value) if c.value == 1 else (h.value, w.value, 3)
    out = np.empty(shape, np.float32)
    rc = lib.pfm_read_data(name, _fptr(out))
    if rc != 0:
        raise IOError(f"pfm_read_data({path}) -> {rc}")
    return out


def write_pfm(path, image: np.ndarray) -> None:
    """An (H, W) float32 image as a greyscale PFM in the host's byte order."""
    if image.dtype != np.float32 or image.ndim != 2:
        raise ValueError("native write_pfm: HxW float32 only")
    image = np.ascontiguousarray(image)
    rc = load().pfm_write(str(path).encode(), _fptr(image), image.shape[1],
                          image.shape[0])
    if rc != 0:
        raise IOError(f"pfm_write({path}) -> {rc}")


def resize(img: np.ndarray, oh: int, ow: int, nearest: bool = False
           ) -> np.ndarray:
    """(H, W) or (H, W, C) float32 resized to (oh, ow): bilinear with
    half-pixel centres (cv2's convention), or nearest (source index
    ``floor(i * scale)``)."""
    lib = load()
    img = np.ascontiguousarray(img, np.float32)
    h, w = img.shape[:2]
    c = img.shape[2] if img.ndim == 3 else 1
    out = np.empty((oh, ow) + img.shape[2:], np.float32)
    fn = lib.resize_nearest if nearest else lib.resize_bilinear
    fn(_fptr(img), h, w, c, _fptr(out), oh, ow)
    return out


def scale_and_crop(frames: np.ndarray, rh: int, rw: int, y0: int, x0: int,
                   ch: int, cw: int, nearest: bool) -> np.ndarray:
    """frames (n, h, w[, c]) resized to (rh, rw), then the window of
    (ch, cw) at (y0, x0) cut out."""
    frames = np.ascontiguousarray(frames, np.float32)
    n, h, w = frames.shape[:3]
    c = frames.shape[3] if frames.ndim == 4 else 1
    if not (0 <= y0 and y0 + ch <= rh and 0 <= x0 and x0 + cw <= rw):
        raise ValueError(f"crop ({ch}, {cw}) at ({y0}, {x0}) leaves the "
                         f"resized ({rh}, {rw}) frame")
    out = np.empty((n, ch, cw) + frames.shape[3:], np.float32)
    load().scale_and_crop(_fptr(frames), n, h, w, c, rh, rw, y0, x0, ch, cw,
                          int(nearest), _fptr(out))
    return out


def scale_and_crop_reference(frames: np.ndarray, rh: int, rw: int, y0: int,
                             x0: int, ch: int, cw: int, nearest: bool
                             ) -> np.ndarray:
    """:func:`scale_and_crop` in numpy, float32 throughout. Nearest is
    equal bit for bit. Bilinear differs where the compiled library fused a
    multiply and an add: a source coordinate then moves by up to one float32
    ulp of the frame's size, so an output by up to
    :func:`bilinear_tolerance`."""
    frames = np.asarray(frames, np.float32)
    n, h, w = frames.shape[:3]
    f32 = np.float32
    sy, sx = f32(h) / f32(rh), f32(w) / f32(rw)
    oy = np.arange(y0, y0 + ch).astype(f32)
    ox = np.arange(x0, x0 + cw).astype(f32)
    if nearest:
        iy = np.minimum((oy * sy).astype(np.int64), h - 1)
        ix = np.minimum((ox * sx).astype(np.int64), w - 1)
        return np.ascontiguousarray(frames[:, iy][:, :, ix])

    def taps(o, s, size):
        f = (o + f32(0.5)) * s - f32(0.5)
        i0 = np.floor(f).astype(np.int64)
        wgt = f - i0.astype(f32)
        return (np.clip(i0, 0, size - 1), np.clip(i0 + 1, 0, size - 1), wgt)

    y0c, y1c, wy = taps(oy, sy, h)
    x0c, x1c, wx = taps(ox, sx, w)
    extra = (1,) * (frames.ndim - 3)
    wx = wx.reshape((1, 1, cw) + extra)
    wy = wy.reshape((1, ch, 1) + extra)
    r0, r1 = frames[:, y0c], frames[:, y1c]
    a = r0[:, :, x0c] * (f32(1) - wx) + r0[:, :, x1c] * wx
    b = r1[:, :, x0c] * (f32(1) - wx) + r1[:, :, x1c] * wx
    return (a * (f32(1) - wy) + b * wy).astype(f32)


def bilinear_tolerance(frames: np.ndarray) -> float:
    """The largest difference :func:`scale_and_crop_reference` may show
    against the library in bilinear mode: a coordinate off by one ulp of
    the frame's larger side (2^-23 of its next power of two) moves a
    weight that far, times the spread of the values, plus four ulps of the
    largest value for the blends' own rounding."""
    frames = np.asarray(frames, np.float32)
    side = 2.0 ** np.ceil(np.log2(max(frames.shape[1:3])))
    spread = float(frames.max() - frames.min())
    top = float(np.abs(frames).max())
    return float(side * 2.0 ** -23 * spread + 4 * 2.0 ** -24 * top)

"""Build, load and count the port's hand-written CUDA kernels.

Each source under ``cermvs_torch/csrc`` exports a plain C interface. It is
compiled with ``nvcc -gencode arch=compute_90a,code=sm_90a`` at first use
into ``build/`` at the repository root (named by the source's hash, so an
edited source rebuilds) and loaded with ctypes. :func:`build_all` starts one
``nvcc`` per source, all at once.

``launches`` counts kernel launches by kernel name since the last
:func:`reset_launches`; a wrapper adds one where it launches its kernel and
nowhere else. A CUDA graph's capture runs the wrappers without running the
kernels: :func:`captured_launches` takes its counts out, and whoever
replays the graph adds them back per replay (:func:`add_launches`).
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Sequence

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

launches: Dict[str, int] = {}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def count_launch(name: str) -> None:
    launches[name] = launches.get(name, 0) + 1


def add_launches(counts: Dict[str, int]) -> None:
    """Count the launches of ``counts`` (a replay of a captured graph)."""
    for name, n in counts.items():
        launches[name] = launches.get(name, 0) + n


@contextlib.contextmanager
def captured_launches():
    """Around a CUDA graph's capture: yields a dict that holds, after the
    block, the launches the wrappers counted in it, and takes them out of
    :data:`launches` (a captured kernel runs only when its graph is
    replayed)."""
    before = dict(launches)
    seen: Dict[str, int] = {}
    try:
        yield seen
    finally:
        for name, n in launches.items():
            if n != before.get(name, 0):
                seen[name] = n - before.get(name, 0)
                launches[name] = before.get(name, 0)


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME)")
    return found


class KernelLibrary:
    """One CUDA source: ``functions`` maps each exported C function to its
    ctypes argument types (all return an int, a ``cudaError_t``); the
    source also exports ``<name>_error_string(int)``."""

    def __init__(self, name: str, functions: Dict[str, Sequence]):
        self.name = name
        self.src = CSRC / f"{name}.cu"
        self.functions = functions
        self._lib = None
        self._fns: Dict[str, object] = {}
        self._lock = threading.Lock()

    def build(self, verbose: bool = False) -> Path:
        """Compile the source into ``build/`` unless that build exists;
        return the library path. ``verbose`` prints ptxas' register and
        shared-memory report."""
        digest = hashlib.sha256(self.src.read_bytes() + " ".join(
            NVCC_FLAGS).encode()).hexdigest()[:16]
        lib = BUILD_DIR / f"lib{self.name}_{digest}.so"
        if lib.exists():
            return lib
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS] + (["-Xptxas", "-v"] if verbose else [])
        res = subprocess.run(cmd + ["-o", str(tmp), str(self.src)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc {self.src.name} failed "
                               f"({res.returncode}):\n{res.stderr}")
        if verbose:
            print(res.stdout + res.stderr, flush=True)
        os.replace(tmp, lib)
        return lib

    def load(self):
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(str(self.build()))
                for fn, argtypes in self.functions.items():
                    getattr(lib, fn).argtypes = list(argtypes)
                    getattr(lib, fn).restype = ctypes.c_int
                err = getattr(lib, f"{self.name}_error_string")
                err.argtypes = [ctypes.c_int]
                err.restype = ctypes.c_char_p
                self._lib = lib
        return self._lib

    def call(self, fn: str, *args) -> None:
        """Launch through ``fn`` and raise if the launch was refused."""
        f = self._fns.get(fn)
        if f is None:
            f = self._fns.setdefault(fn, getattr(self.load(), fn))
        err = f(*args)
        if err != 0:
            msg = getattr(self.load(), f"{self.name}_error_string")(err)
            raise RuntimeError(f"{fn} launch failed: {msg.decode()}")


def build_all(libraries: List[KernelLibrary], verbose: bool = False):
    """Build every library at once (one nvcc each); returns their paths."""
    with ThreadPoolExecutor(len(libraries)) as pool:
        return list(pool.map(lambda lib: lib.build(verbose), libraries))


def pointer_alignment(t) -> int:
    """The largest power of two, up to 16 bytes, that divides ``t``'s
    address: the widest vector load its rows allow."""
    ptr = t.data_ptr()
    return 16 if ptr % 16 == 0 else ptr & -ptr


def stream_of(t) -> int:
    """The address of ``t``'s device's current stream, for a launch."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)


def on_device(t):
    """A context in which ``t``'s device is the current one: nothing to do
    when it already is (a device switch costs the host more than the
    launch)."""
    index = t.device.index
    if index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(index)

#!/usr/bin/env python3
"""What bounds the port's lookup gradient kernel, on one CUDA card.

    python3 benchmarks/port_lookup_probe.py

Run from the root of a checkout, on a machine with a CUDA card and
``nvcc``. It compiles text-edited copies of ``cermvs_torch/csrc/lookup.cu``
into ``build/`` and times ``lookup_backward`` from each at the training
batch's volumes (chip_smoke's ``training_stage0`` and ``training_stage1``),
with the L2 flushed before each launch and in device time (a CUDA graph of
launches):

  * ``as_built``: the source as it is;
  * ``no_arithmetic``: the gradient's tap loop taken out (every output
    written as 0): the copies, the records and the stores alone;
  * ``no_copy``: the tap gradients not copied into shared memory (x0 still
    is): the arithmetic and the stores without the read of g.

Then the host's microseconds per call of each lookup wrapper and of the
pieces of the gradient's (calls queued without a sync between them). One
line per measurement; the card's name and power limit first.
"""

import ctypes
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
SHAPES = ("training_stage0", "training_stage1")


def variants(src):
    """{name: source} of the edited copies; each edit must apply."""
    loop = "for (int lvl = 0; lvl < L; ++lvl, gl += K) {"
    out = {"as_built": src,
           "no_arithmetic": src.replace(
               loop, loop.replace("lvl < L;", "lvl < 0;")),
           "no_copy": src.replace("pixels(tile), T);", "pixels(tile), 0);")
                         .replace("pixels(next), T);", "pixels(next), 0);")}
    for name, text in out.items():
        if name != "as_built" and text == src:
            raise RuntimeError(f"the {name} edit no longer applies")
    return out


def build(cudalib, name, text):
    path = cudalib.BUILD_DIR / f"probe_lookup_{name}.cu"
    cudalib.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path.write_text(text)
    lib = path.with_suffix(".so")
    subprocess.run([cudalib._nvcc(), *cudalib.NVCC_FLAGS, "-o", str(lib),
                    str(path)], check=True)
    handle = ctypes.CDLL(str(lib))
    _p, _i, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    handle.lookup_backward.argtypes = [_p, _p, _p, _ll] + [_i] * 7 + [_p]
    return handle


def host_us(torch, fn, calls=400):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("port_lookup_probe: no CUDA card")
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    from cermvs_torch.ops import cudalib
    from cermvs_torch.ops import lookup as lk

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    src = (REPO / "cermvs_torch" / "csrc" / "lookup.cu").read_text()
    libs = {name: build(cudalib, name, text)
            for name, text in variants(src).items()}
    rng = np.random.RandomState(7)
    for shape_name in SHAPES:
        shape = cs.LOOKUP_SHAPES[shape_name]
        corr, x0, g = cs.lookup_case(torch, rng, shape)
        D, M = shape[-1], x0.numel()
        g2, x02 = g.reshape(M, -1), x0.reshape(M)
        out = torch.empty(M, D, device="cuda")
        geo = lk.backward_launch_geometry(M, D, 5, 3)
        bound = cs.lookup_bounds(torch, x0, D)["lookup_fused_bwd"][0]
        for name, lib in libs.items():
            def launch(lib=lib):
                err = lib.lookup_backward(
                    g2.data_ptr(), x02.data_ptr(), out.data_ptr(), M, D, 5, 3,
                    geo.pixels, int(geo.vec == 4), geo.cells, geo.smem_bytes,
                    cudalib.stream_of(g))  # the capturing stream in a graph
                if err:
                    raise RuntimeError(f"{name}: launch failed ({err})")
            cold = cs.cuda_ms_cold(torch, launch, 20)
            device = cs.cuda_ms_graph(torch, launch)
            print(f"{shape_name} {shape} lookup_backward {name}: L2 flushed "
                  f"{cold:.4f} ms, device {device:.4f} ms, bound "
                  f"{bound:.4f} ms (device / bound {device / bound:.2f})",
                  flush=True)
        x0c = x0.float().contiguous().reshape(-1)
        pieces = {
            "lookup_fused": lambda: lk.lookup_fused(corr, x0),
            "lookup_fused_v2": lambda: lk.lookup_fused_v2(corr, x0),
            "lookup_fused_backward": lambda: lk.lookup_fused_backward(
                g, x0, D),
            "_launch_backward": lambda: lk._launch_backward(
                g2, x0c, D, 5, 3, out=out),
            "flatten g and x0": lambda: (lk._flat(g, g.shape[-1]),
                                         x0.float().contiguous().reshape(-1)),
            "torch.empty of dcorr": lambda: torch.empty(
                (M, D), dtype=torch.float32, device="cuda"),
        }
        for name, fn in pieces.items():
            print(f"{shape_name} host per call, {name}: "
                  f"{host_us(torch, fn):.2f} us", flush=True)


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""What bounds the port's fp32 epiband forward (the 3xTF32 G tile), on one
CUDA card.

    python3 benchmarks/port_epiband_probe.py

Run from the root of a checkout, on a machine with a CUDA card and
``nvcc``. It compiles text-edited copies of ``cermvs_torch/csrc/epiband.cu``
into ``build/`` (one nvcc each, all at once) and times ``epiband_forward``
from each with fp32 features at chip_smoke's phase-2 stage shapes (the
inference plan's widest view, 512 x 512 pixels against 1104 columns, C =
64; stage 0: D = 64, base == 0; stage 1: D = 44, the main path's bases),
in device time (a CUDA graph of launches), beside the byte bound:

  * ``as_built``: the source as it is;
  * ``cvt_split``: the TF32 rounding by ``cvt.rna.tf32.f32`` instead of the
    integer operations (the same values);
  * ``no_split``: every operand passed to mma.sync unsplit (hi = lo = v):
    the split's cost;
  * ``one_pass``: only the A_hi B_hi product (a single TF32 pass): the two
    small products' cost;
  * ``no_g_product``: no G tile formed: the staging, positions, weighted
    terms and stores alone;
  * ``no_terms``: no weighted G terms added: the G tiles and the rest.

Only ``as_built`` and ``cvt_split`` compute the forward; the others time
parts of it. One line per measurement; the card's name and power limit
first.
"""

import ctypes
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
SMALL = ("for (int i = 0; i < 4; ++i) mma1688(d[i], al, bh[i][0], bh[i][1]);",
         "for (int i = 0; i < 4; ++i) mma1688(d[i], ah, bl[i][0], bl[i][1]);")
RNA = "  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;"
SPLIT = ("  hi = rna_tf32(v);\n"
         "  lo = rna_tf32(__fsub_rn(v, __uint_as_float(hi)));")
G = "    af.g(sB + buf * buf_elems, sG, mt, ksteps, L.lds, L.gs);"
TERMS = ("    const unsigned active = __ballot_sync(0xffffffffu, c_lo <= c && "
         "c <= c_hi);")


def variants(src):
    """{name: source} of the edited copies; each edit must apply."""
    cvt = ('  unsigned r;\n  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : '
           '"f"(v));\n  return r;')
    out = {"as_built": src,
           "cvt_split": src.replace(RNA, cvt),
           "no_split": src.replace(SPLIT, "  hi = lo = __float_as_uint(v);"),
           "one_pass": src.replace(SMALL[0], "").replace(SMALL[1], ""),
           "no_g_product": src.replace(G, ""),
           "no_terms": src.replace(TERMS, "    const unsigned active = 0u;")}
    for name, text in out.items():
        if name != "as_built" and text == src:
            raise RuntimeError(f"the {name} edit no longer applies")
    return out


def build(cudalib, name, text):
    path = cudalib.BUILD_DIR / f"probe_epiband_{name}.cu"
    path.write_text(text)
    lib = path.with_suffix(".so")
    subprocess.run([cudalib._nvcc(), *cudalib.NVCC_FLAGS, "-o", str(lib),
                    str(path)], check=True)
    handle = ctypes.CDLL(str(lib))
    _p, _i = ctypes.c_void_p, ctypes.c_int
    handle.epiband_forward.argtypes = [_p] * 5 + [_i] * 11 + [_p]
    return handle


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("port_epiband_probe: no CUDA card")
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    from cermvs_torch.ops import cudalib
    from cermvs_torch.ops import epiband as eb

    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    cudalib.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = (REPO / "cermvs_torch" / "csrc" / "epiband.cu").read_text()
    edited = variants(src)
    with ThreadPoolExecutor(len(edited)) as pool:
        libs = dict(zip(edited, pool.map(lambda kv: build(cudalib, *kv),
                                         edited.items())))
    h_r, w_r, ws, s_max, C = 512, 512, 1104, 576, 64
    sigmas = {"stage0": (4.263, 5.637), "stage1": (0.853, 1.127)}
    rng = np.random.RandomState(11)
    for stage, D, kind in (("stage0", 64, None), ("stage1", 44, "main")):
        fr, fs, base, sigma = cs.epiband_case(
            torch, rng, h_r, w_r, ws, C, D, kind, sigmas[stage],
            torch.float32, (64, 5.0))
        out = torch.empty((1, h_r, w_r, D), device="cuda")
        geo = eb.launch_geometry(1, h_r, w_r, ws, C, D, torch.float32)
        bound = cs.epiband_bounds(torch, fr, fs, base, sigma, D,
                                  s_max)["epiband_fwd"][0]
        ref = eb.epiband_reference(fr, fs, base, sigma, D, s_max)
        for name, lib in libs.items():
            def launch(lib=lib):
                err = lib.epiband_forward(
                    fr.data_ptr(), fs.data_ptr(),
                    None if base is None else base.data_ptr(),
                    sigma.data_ptr(), out.data_ptr(), 1, h_r, w_r, ws, C, D,
                    s_max, 0, geo.tile, geo.vec, geo.smem_bytes,
                    cudalib.stream_of(fr))  # the capturing stream in a graph
                if err:
                    raise RuntimeError(f"{name}: launch failed ({err})")
            device = cs.cuda_ms_graph(torch, launch)
            launch()
            torch.cuda.synchronize()
            err = float((out - ref).abs().max())
            print(f"{stage} D={D} fp32 epiband_forward {name}: device "
                  f"{device:.4f} ms, bound {bound:.4f} ms (device / bound "
                  f"{device / bound:.2f}), max|out - plain| {err:.3e}",
                  flush=True)


if __name__ == "__main__":
    main()

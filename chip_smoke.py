#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``cermvs_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA card and ``nvcc``.
Phases (any failure raises, so the exit code is non-zero):

  1. build the kernels from ``cermvs_torch/csrc`` (``epiband.cu``,
     ``hatwarp.cu``, ``lookup.cu``), one nvcc each, all at once;
  2. hold the epiband forward kernel against its plain PyTorch version on
     the card at the DTU slice's shapes (stage 0: D=64, base == 0; stage 1:
     D=44 with bases inside and outside the band and with the main path's
     bases; narrow and wide sigma; fp32 and bf16), and at the bf16
     kernel's edges (a stage-1 tile band wider than one chunk, tap pairs
     straddling a chunk edge, bases of +-1e5 and NaN, a ragged w_r, C = 44
     and 16); time both stages on the main path's bases, back to back
     (``ms``) and in device time (``device_ms``, a CUDA graph of launches),
     beside the earlier design's back-to-back time;
  3. hold the fused lookup kernels (forward, gradient, prefix-sum) against
     their plain versions at phase 4's (1,1,288,400,D), the demo's
     (1,1,300,400,D) and (1,1,600,800,D) and the training batch's
     (2,1,264,360,D) volumes, D = 64 and 44, with their times (the L2
     flushed before each launch, and back to back; the forward also in
     device time, beside the earlier design's time), plain times and
     bounds;
  4. drive the port's depth inference (``InferenceRunner``) at full DTU width
     — 1152x1600 images, 11 views, cascade (64,64,8)/(44,320,8), HR encoders,
     bf16, random weights from a seed — through the rectified construction
     (epiband and hat kernels) and through the exact one (one warm-up, three
     timed forwards each), and check the result: finite (288, 400)
     disparities, the launch counts, and rectified-vs-exact, kernel-vs-plain
     and fused-vs-banded lookup agreement on a small lateral-motion scene,
     where rectification is lossless;
  5. run ``inference()`` on a two-item in-memory loader and check the PFM
     names;
  6. the demo contract: write a synthetic DTU test scan (11 imaged views of
     1200x1600, 49 cameras on an arc) and random weights; plan it at
     rescale 1 and 2 as inference does and hold the epiband forward and hat
     kernels against their plain versions at those plans (the widest band
     and the largest grid; every hat pass, C = 64, 44 and 3; fp32 and
     bf16), timing them at rescale 2, both ways, with ``grid_sample``
     timed both ways beside the hat kernel; then
     run the port's CLIs with ``inference_DTU.gin`` and
     ``RAFT.lookup_impl="pallas"``: inference at rescale 1 and 2, multires,
     fusion at rescale 2 with view_batch 8; check the construction, the
     launches per forward and every file;
  7. fuse the scan's true depth maps (a sphere) at 1152x1600 and check that
     every fused point lies on the sphere;
  8. write a synthetic DTU training tree (one scan, one light, 1200x1600
     PNGs and PFM depths, 49 cameras on an arc), plan its first training
     batch, and hold the epiband backward kernels and the hat-resample
     kernels against their plain versions at that plan's shapes (fp32 and
     bf16; the hat also at C = 44 and 3), with their times, bounds and, for
     the hat kernels, the time of one ``grid_sample`` call (forward) and of
     one ``grid_sampler_2d_backward`` call (transpose), each kernel and
     call also in device time; the epiband dfr and dfs kernels also in
     device time at both stages; all beside the earlier designs'
     back-to-back times;
  9. train through ``train()`` with ``train_DTU.gin``'s bindings (rectified,
     batch 2, nf10, crop 1056x1440) for four steps, time the last three, and
     check the two-pass plan, finite loss and gradients, the kernels'
     launch counts, and that the checkpoint restores its step;
 10. train two steps the same way with the fused lookup, check its launches
     (16 forward and 16 backward a step), and hold one step's loss from
     fixed weights on phase 8's batch against the banded lookup's.

Prints the card's name and power limit, a ``{"kernels": [...]}`` line, and
last ``{"ok": true, "device": {...}}``. Needs no network and one card.
``--profile`` adds a torch.profiler breakdown of one forward per
construction, of one rescale-2 demo forward and of one train step (device
time per RAFT.forward range, top kernels, busy share; for the step also a
line with its device-busy time, the dfr, dfs and hat_rows_bwd kernels'
rows and its count of elementwise launches; for the demo forward a line
with the lookup_fused_fwd row).
"""

import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
T_START = time.perf_counter()
H, W = 1152, 1600          # DTU images, cropped to the encoder stride
NUM_FRAMES = 10            # neighbours; 11 views in all
PEAK_BYTES_S = 3.35e12     # H100 SXM HBM3
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # dense, non-TF32 fp32
DTU_HW = (1200, 1600)      # DTU training images and depths
TRAIN_STEPS = 3            # train.num_steps: 4 steps, the first a warm-up
PALLAS_STEPS = 2           # train.num_steps of the fused-lookup run: 3 steps
DEMO_VIEWS = 11            # imaged views of the synthetic DTU test scan
SPHERE_R = 200.0           # its surface: a sphere about the origin (mm)
TRUE_HW = (1152, 1600)     # true depth maps: the 1200x1600 images' crop
TRUE_TOL_MM = 0.05         # fused true depths: largest distance to the sphere
C_FEAT = 64                # the shipped model's feature channels
STAGES = ((64, 0.0025 / 64), (44, 0.0025 / 320))  # (hypotheses, increment)
LOOKUP_SHAPES = {          # (B, V, h, w, D) of the fused lookup
    "inference_stage0": (1, 1, 288, 400, 64),     # phase 4's 1152x1600
    "inference_stage1": (1, 1, 288, 400, 44),
    "demo_rescale1_stage0": (1, 1, 300, 400, 64),  # the demo's 1200x1600
    "demo_rescale1_stage1": (1, 1, 300, 400, 44),
    "demo_rescale2_stage0": (1, 1, 600, 800, 64),  # and its 2400x3200
    "demo_rescale2_stage1": (1, 1, 600, 800, 44),
    "training_stage0": (2, 1, 264, 360, 64),
    "training_stage1": (2, 1, 264, 360, 44)}
LOOKUPS = ("lookup_fused_fwd", "lookup_fused_bwd", "lookup_fused_v2")
TRAIN_KERNELS = ("epiband_bwd_dfr", "epiband_bwd_dfs", "hat_rows_fwd",
                 "hat_rows_bwd")  # held against plain at the training plan
KERNELS = ("epiband_fwd",) + TRAIN_KERNELS + LOOKUPS
_EB, _HW = "cermvs_torch/csrc/epiband.cu", "cermvs_torch/csrc/hatwarp.cu"
_LK = "cermvs_torch/csrc/lookup.cu"
SOURCES = {  # kernel: (source, the TPU kernel's entry it replaces)
    "epiband_fwd": (_EB, "cermvs_tpu/ops/pallas/epiband.py:529"),
    "epiband_bwd_dfr": (_EB, "cermvs_tpu/ops/pallas/epiband.py:919"),
    "epiband_bwd_dfs": (_EB, "cermvs_tpu/ops/pallas/epiband.py:919"),
    "hat_rows_fwd": (_HW, "cermvs_tpu/ops/pallas/hatwarp.py:119"),
    "hat_rows_bwd": (_HW, "cermvs_tpu/ops/pallas/hatwarp.py:155"),
    "lookup_fused_fwd": (_LK, "cermvs_tpu/ops/pallas/lookup.py:104"),
    "lookup_fused_bwd": (_LK, "cermvs_tpu/ops/pallas/lookup.py:138"),
    "lookup_fused_v2": (_LK, "cermvs_tpu/ops/pallas/lookup_v2.py:99"),
}
NO_LIBRARY = "none: no single PyTorch call computes the pooled 33-tap lookup"
# The earlier designs' times of the kernels redesigned since (ms per launch,
# bf16, back-to-back CUDA events; PERF.md's kernel table, NVIDIA H100 80GB
# HBM3 at 700 W): the warp-per-pixel epiband forward, the thread-per-element
# hat forward, the epiband dfs that scattered with global atomics, the
# warp-per-pixel epiband dfr, the hat transpose that scattered with global
# atomics into a zeroed fp32 buffer (its memset and cast included) and the
# thread-per-tap lookup forward (fp32, L2 flushed before each launch).
# Printed in the phases' text beside this run's times; never part of the
# kernels line, which holds only this run's.
EARLIER_MS = {"epiband_fwd": {"stage0": 1.537, "stage1": 1.079,
                              "demo_rescale2": 5.125},
              "hat_rows_fwd": {"feature_warp": 0.115,
                               "volume_back_warp": 0.082,
                               "demo_rescale2": 0.480},
              "epiband_bwd_dfs": {"stage0": 4.860, "stage1": 1.829},
              "epiband_bwd_dfr": {"stage0": 1.2165, "stage1": 0.9670},
              "hat_rows_bwd": {"feature_warp": 0.134,
                               "volume_back_warp": 0.128},
              "lookup_fused_fwd": {"inference_stage0": 0.101,
                                   "demo_rescale2_stage0": 0.175,
                                   "training_stage0": 0.074}}
HAT_TIMED = ("feature_warp", "volume_back_warp")  # phase 8's timed hat shapes


def dtu_ring_poses(n):
    """World-to-camera poses of a DTU-like rig: cameras on a sphere of
    radius ~600 mm looking at the object at the origin (mostly lateral
    pairwise baselines of 20-100 mm)."""
    poses = np.zeros((n, 4, 4), np.float32)
    for i in range(n):
        ang = 0.06 * ((i + 1) // 2) * (1 if i % 2 else -1)
        elev = 0.04 * (i % 3 - 1)
        eye = 600.0 * np.array(
            [np.sin(ang), np.sin(elev), -np.cos(ang) * np.cos(elev)])
        fwd = -eye / np.linalg.norm(eye)
        right = np.cross(fwd, [0.0, 1.0, 0.0])
        right /= np.linalg.norm(right)
        down = np.cross(fwd, right)
        R = np.stack([right, down, fwd]).astype(np.float32)
        poses[i, :3, :3] = R
        poses[i, :3, 3] = -R @ eye.astype(np.float32)
        poses[i, 3, 3] = 1.0
    return poses


def dtu_scene(h, w, n, seed=0):
    rng = np.random.RandomState(seed)
    images = (rng.rand(n, h, w, 3) * 255).astype(np.float32)
    f = 2892.0 * w / 1600
    K = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]], np.float32)
    return images, dtu_ring_poses(n), np.tile(K, (n, 1, 1))


def lateral_scene(h, w, n, seed=0):
    rng = np.random.RandomState(seed)
    images = (rng.rand(n, h, w, 3) * 255).astype(np.float32)
    K = np.array([[80.0, 0, w / 2], [0, 80.0, h / 2], [0, 0, 1]], np.float32)
    poses = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    for i in range(n):
        poses[i, 0, 3] = -(0.6 * ((i + 1) // 2) * (1 if i % 2 else -1))
    return images, poses, np.tile(K, (n, 1, 1))


def dtu_arc_poses(n=49, step=0.04, radius=600.0):
    """World-to-camera poses of n cameras on an arc of a sphere of
    ``radius`` mm, ``step`` rad apart in azimuth with a small alternating
    elevation, all looking at the object at the origin. Neighbouring views
    are then mostly lateral, as on the DTU rig's arcs; pairs of one column
    of the real rig (vertical baselines) would fail the two-pass gate."""
    poses = []
    for i in range(n):
        az = step * (i - (n - 1) / 2)
        el = 0.015 * (i % 3 - 1)
        eye = radius * np.array([np.sin(az) * np.cos(el), np.sin(el),
                                 -np.cos(az) * np.cos(el)])
        fwd = -eye / np.linalg.norm(eye)
        right = np.cross(fwd, [0.0, 1.0, 0.0])
        right /= np.linalg.norm(right)
        R = np.stack([right, np.cross(fwd, right), fwd])
        P = np.eye(4)
        P[:3, :3] = R
        P[:3, 3] = -R @ eye
        poses.append(P)
    return np.stack(poses)


def write_cameras(root, h, w, n, num_frames):
    """``Cameras/``: the 49 camera files of :func:`dtu_arc_poses` with the
    DTU focal (2892 px at 1600 wide) for h x w images, and ``pair.txt``
    listing, for each of the first ``n`` views, its ``num_frames`` nearest
    among them. Returns n."""
    from cermvs_torch.data.cams import write_cam_file

    (Path(root) / "Cameras").mkdir(parents=True, exist_ok=True)
    poses = dtu_arc_poses()
    f = 2892.0 * w / 1600
    K = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]])
    for i, P in enumerate(poses):
        write_cam_file(Path(root) / "Cameras" / f"{i:08d}_cam.txt", P, K,
                       aux=[425.0, 2.5])
    centers = np.stack([-P[:3, :3].T @ P[:3, 3] for P in poses[:n]])
    dist = np.linalg.norm(centers[:, None] - centers[None], axis=-1)
    lines = [f"{n}\n"]
    for i in range(n):
        near = [int(j) for j in np.argsort(dist[i], kind="stable")
                if j != i][:num_frames]
        lines += [f"{i}\n", f"{len(near)} " + " ".join(
            f"{j} {100.0 - r:.1f}" for r, j in enumerate(near)) + "\n"]
    (Path(root) / "Cameras" / "pair.txt").write_text("".join(lines))
    return n


def write_dtu_tree(root, h, w, num_frames, scan="scan113", light=0, seed=0):
    """A DTU training tree for one scan and one light: ``Rectified/`` PNGs
    and ``Depths/`` PFMs of h x w (image/depth ratio 1), 49 cameras from
    :func:`dtu_arc_poses` with the DTU focal (2892 px at 1600 wide), and a
    ``pair.txt`` listing each view's ``num_frames`` nearest views. The 49
    views share 11 textures (hard links): the dataset indexes 49 views per
    scan, a step reads 2 x 11 of them, and what they show does not change
    the work."""
    import cv2

    from cermvs_torch.io.pfm import write_pfm

    root = Path(root)
    for d in (f"Rectified/{scan}", f"Depths/{scan}"):
        (root / d).mkdir(parents=True, exist_ok=True)
    n = write_cameras(root, h, w, 49, num_frames)
    rng = np.random.RandomState(seed)
    yy, xx = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w),
                         indexing="ij")
    depth = (600.0 + 40.0 * np.sin(3 * xx) * np.cos(2 * yy)).astype(
        np.float32)
    textures = []
    for t in range(num_frames + 1):
        img = (rng.rand(h, w, 3) * 255).astype(np.uint8)
        textures.append(root / f"texture_{t}.png")
        cv2.imwrite(str(textures[-1]), img, [cv2.IMWRITE_PNG_COMPRESSION, 1])
    write_pfm(root / "depth.pfm", depth)
    for i in range(n):
        os.link(textures[i % len(textures)],
                root / "Rectified" / scan / f"rect_{i + 1:03d}_{light}_r5000.png")
        os.link(root / "depth.pfm",
                root / "Depths" / scan / f"depth_map_{i:04d}.pfm")


def check_launches(got, expect, what):
    """Fail unless the kernels launched as often as ``expect`` says."""
    if any(got.get(k, 0) != v for k, v in expect.items()):
        raise RuntimeError(f"{what}: launches {got} != {expect}")


def cuda_ms(fn, reps):
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def cuda_ms_graph(torch, fn, reps=10, replays=5):
    """Device time of one call: ``reps`` calls captured in a CUDA graph,
    replayed ``replays`` times between CUDA events. Unlike
    :func:`cuda_ms` it leaves out the host's work per call (the wrappers'
    checks and ctypes launch), which back to back bounds a kernel shorter
    than that. The kernels line's ``ms`` is :func:`cuda_ms`, as for every
    kernel; this is its ``device_ms``."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up off the capture
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (reps * replays)
    del graph
    return ms


def cuda_ms_both(torch, fn, reps=50):
    """(back-to-back ms, device ms) of one call: :func:`cuda_ms` and
    :func:`cuda_ms_graph`."""
    return cuda_ms(fn, reps), cuda_ms_graph(torch, fn)


def earlier(name, shape):
    """``, earlier design X ms`` for the kernel's recorded time at shape
    (back to back; the lookup forward's with the L2 flushed)."""
    ms = EARLIER_MS.get(name, {}).get(shape)
    how = "L2 flushed" if name == "lookup_fused_fwd" else "back to back"
    return "" if ms is None else f", earlier design {ms} ms {how}"


def ratio_text(kernel, library):
    """The kernel's speed-up over the library call in each measure."""
    return (f"library/kernel {library[0] / kernel[0]:.2f}x back to back, "
            f"{library[1] / kernel[1]:.2f}x device")


def main_path_base(rng, sigma, d0, d1, ratio):
    """Stage-1 bases as the main path forms them (``corr_rectified``:
    base = rate * (origin - (d1 // 2) * incre1), so base = sigma1 *
    (ratio * k0 - d1 // 2) with ratio = incre0 / incre1) from a smooth
    stage-0 estimate k0 that sweeps the stage-0 hypotheses [0, d0 - 1]
    across the image, with half a hypothesis of jitter."""
    _, h_r, w_r = sigma.shape
    yy, xx = np.meshgrid(np.linspace(0, 1, h_r), np.linspace(0, 1, w_r),
                         indexing="ij")
    k0 = (d0 - 1) * (0.5 + 0.25 * np.sin(2 * np.pi * xx)
                     + 0.25 * np.cos(2 * np.pi * yy))
    k0 = np.clip(k0 + rng.uniform(-0.5, 0.5, sigma.shape), 0, d0 - 1)
    return (sigma * (ratio * k0 - d1 // 2)).astype(np.float32)


def epiband_case(torch, rng, h_r, w_r, ws, C, D, base_kind, sig, dtype,
                 stage0=None, s_max=None):
    """Inputs of one epiband call. base_kind None: base == 0 (stage 0);
    "band": bases inside and outside the band, so slabs fall partly or
    wholly off either end of the source row; "main": the main path's
    stage-1 bases (``main_path_base``, stage0 = (d0, ratio)); "straddle":
    hypothesis 3 of every pixel at column 128 m - 0.75 (m >= 1, ``s_max``
    given), so its tap pair straddles two of the bf16 kernel's 128-column
    chunks; "far": "band" bases with a third of two rows at +1e5 and -1e5
    and every fifth pixel of a third row NaN. The features are drawn on the
    card (seeded from ``rng``): the host's generator takes seconds at the
    demo's widths."""
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(int(rng.randint(2**31)))
    fr = torch.randn((1, h_r, w_r, C), generator=gen, device=dev)
    fs = torch.randn((1, h_r, ws, C), generator=gen, device=dev)
    sigma = rng.uniform(sig[0], sig[1], (1, h_r, w_r)).astype(np.float32)
    base = None
    if base_kind in ("band", "far"):
        base = rng.uniform(-(ws - w_r) / 2, ws, (1, h_r, w_r))
    elif base_kind == "main":
        base = main_path_base(rng, sigma, stage0[0], D, stage0[1])
    elif base_kind == "straddle":
        edge = 128.0 * rng.randint(1, ws // 128, (1, h_r, w_r)) - 0.75
        base = np.arange(w_r) + s_max - 3 * sigma - edge
    if base_kind == "far":
        base[0, 0, ::3] = 1e5
        base[0, 1, ::3] = -1e5
        base[0, 2, ::5] = np.nan
    if base is not None:
        base = torch.from_numpy(base.astype(np.float32)).to(dev)
    return (fr.to(dev, dtype).contiguous(), fs.to(dev, dtype).contiguous(),
            base, torch.from_numpy(sigma).to(dev))


def epiband_bounds(torch, fr, fs, base, sigma, D, s_max):
    """Least time for the work of these inputs, for the forward and the two
    backward kernels: the bytes each must move over the memory rate,
    against its flops over the peak rate of the inputs' type. Bytes count
    what these inputs need: the fr rows of pixels with an in-band tap, the
    fs columns that some in-band tap of the row reaches, base and sigma,
    each read once; the fp32 volume (forward) or dout (backward) once; the
    gradient written once. Flops: 2*C per in-band tap, plus 4 per output
    in the forward (the lerp). Returns {name: (bound_ms, bound_by)}."""
    V, h_r, w_r, C = fr.shape
    ws = fs.shape[2]
    x = torch.arange(w_r, dtype=torch.float32, device=fr.device)
    k = torch.arange(D, dtype=torch.float32, device=fr.device)
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
    vol = V * h_r * w_r * D * 4
    peak = PEAK_FLOPS[str(fr.dtype).split(".")[-1]]
    work = {  # name: (bytes, flops)
        "epiband_fwd": ((pixels + cols) * C * e + params + vol,
                        2 * C * taps + 4 * V * h_r * w_r * D),
        "epiband_bwd_dfr": (cols * C * e + params + vol + fr.numel() * e,
                            2 * C * taps),
        "epiband_bwd_dfs": (pixels * C * e + params + vol + fs.numel() * e,
                            2 * C * taps),
    }
    return {name: bound_of(nbytes, flops, peak)
            for name, (nbytes, flops) in work.items()}


def bound_of(nbytes, flops, peak):
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / peak * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def hat_bounds(torch, img, pos):
    """Least time of the hat resample and its transpose for these inputs:
    img, pos and dout read once, out or dimg written once, over 2*C flops
    per in-range tap (fp32 products)."""
    R, S, C = img.shape
    fl = torch.floor(pos)
    taps = int(((fl >= 0) & (fl <= S - 1)).sum()
               + ((fl >= -1) & (fl <= S - 2)).sum())
    e = img.element_size()
    out = pos.numel() * C * 4
    flops = 2 * C * taps
    return {"hat_rows_fwd": bound_of(img.numel() * e + pos.numel() * 4 + out,
                                     flops, PEAK_FLOPS["float32"]),
            "hat_rows_bwd": bound_of(out + pos.numel() * 4 + img.numel() * e,
                                     flops, PEAK_FLOPS["float32"])}


def hat_case(torch, rng, R, S, O, C, dtype):
    """Row resample inputs of a two-pass warp: positions sweep the source
    row (slope S/O) with sub-pixel jitter, a few rows fully outside. The
    image is drawn on the card, as in :func:`epiband_case`."""
    gen = torch.Generator(device="cuda").manual_seed(int(rng.randint(2**31)))
    img = torch.randn((R, S, C), generator=gen, device="cuda")
    o = np.arange(O)[None] * (S + 8) / O - 4.0
    pos = (o + rng.uniform(-0.5, 0.5, (R, O))).astype(np.float32)
    pos[: max(1, R // 50)] = -1e4  # rows the warp maps off the image
    return (img.to("cuda", dtype).contiguous(),
            torch.from_numpy(pos).to("cuda"))


def grid_sample_rows(torch, img, pos):
    """The same row resample as one ``grid_sample`` call (bilinear, zero
    padding, align_corners=True) on the image as (R, C, 1, S) fp32: the
    yardstick the port never calls. Returns the call, its inputs made."""
    F = torch.nn.functional
    R, S, C = img.shape
    x = img.float().permute(0, 2, 1)[:, :, None, :].contiguous()
    g = torch.zeros((R, 1, pos.shape[1], 2), device=img.device)
    g[..., 0] = (pos * (2.0 / (S - 1)) - 1.0)[:, None, :]
    return lambda: F.grid_sample(x, g, mode="bilinear", padding_mode="zeros",
                                 align_corners=True)


def grid_sample_rows_backward(torch, img, pos, dout):
    """The transposed row resample as one call: ``grid_sampler_2d_backward``
    (bilinear, zero padding, align_corners=True) for the input gradient of
    the same (R, C, 1, S) fp32 layout and grid, ``dout`` as (R, C, 1, O)
    (the card's implementation forms the grid gradient too). Returns a call
    that gives dimg as (R, S, C)."""
    R, S, C = img.shape
    x = img.float().permute(0, 2, 1)[:, :, None, :].contiguous()
    g = torch.zeros((R, 1, pos.shape[1], 2), device=img.device)
    g[..., 0] = (pos * (2.0 / (S - 1)) - 1.0)[:, None, :]
    go = dout.permute(0, 2, 1)[:, :, None, :].contiguous()
    bwd = torch.ops.aten.grid_sampler_2d_backward
    return lambda: bwd(go, x, g, 0, 0, True, [True, False])[0][:, :, 0] \
        .permute(0, 2, 1)


def profile_call(torch, fn, prefix="raft."):
    """One call of ``fn`` under torch.profiler: device time per named range
    (``prefix``), the top kernels by self device time, the port's own
    kernels (by their names in ``csrc/``), the launches and device time of
    elementwise kernels (names holding "elementwise"), and the device-busy
    share of the wall time."""
    from torch.profiler import ProfilerActivity, profile

    def dev(e, own=False):
        name = "self_device_time_total" if own else "device_time_total"
        old = "self_cuda_time_total" if own else "cuda_time_total"
        return getattr(e, name, None) or getattr(e, old, 0.0)

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = prof.key_averages()
    spans = {e.key: dev(e) / 1e3 for e in rows if e.key.startswith(prefix)}
    # device-side rows only (kernels, copies): operator rows repeat their
    # kernels' time
    kernels = [e for e in rows if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.key.startswith(prefix)]
    busy = sum(dev(e, own=True) for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: dev(e, own=True), reverse=True)[:15]
    ours = [e for e in kernels if any(
        k in e.key for k in ("epiband", "hat_rows", "lookup_"))]
    elementwise = [e for e in kernels if "elementwise" in e.key]
    return {"wall_ms": wall * 1e3, "device_busy_ms": busy,
            "elementwise_launches": sum(e.count for e in elementwise),
            "elementwise_ms": sum(dev(e, own=True)
                                  for e in elementwise) / 1e3,
            "busy_share": busy / (wall * 1e3), "spans_ms": spans,
            "top_self_device_ms": [[e.key[:90], e.count,
                                    dev(e, own=True) / 1e3] for e in top],
            "port_kernels_ms": [[e.key[:90], e.count,
                                 dev(e, own=True) / 1e3] for e in ours]}


def configure_training(tree):
    """``train_DTU.gin``'s bindings, the synthetic tree and one light."""
    from cermvs_torch import config as pcfg

    pcfg.clear_config()
    pcfg.parse_config_file(str(REPO / "configs" / "train_DTU.gin"))
    pcfg.bind_parameter("DTU.dataset_path", str(tree))
    pcfg.bind_parameter("DTU.light_number", 0)
    pcfg.bind_parameter("train.num_steps", TRAIN_STEPS)


def plan_training_batch(torch, tree):
    """Write the DTU tree and plan the first batch of a training loader as
    ``train()`` plans each batch (without workers, so it is the seed's)."""
    from cermvs_torch import data
    from cermvs_torch.ops.rectify import PlanCache
    from cermvs_torch.training.train import plan_batch

    t0 = time.perf_counter()
    write_dtu_tree(tree, *DTU_HW, NUM_FRAMES)
    configure_training(tree)
    loader = data.get_train_data_loader(batch_size=2, num_workers=0)
    batch = next(iter(loader))
    plan = PlanCache().key_for(plan_batch(batch, 4))
    print(f"phase 8: DTU tree {DTU_HW} written and first batch "
          f"{batch['images'].shape} planned in "
          f"{time.perf_counter() - t0:.1f} s: h_r={plan.h_r} w_r={plan.w_r} "
          f"s_max={plan.s_max} ws_r={plan.ws_r} twopass={plan.twopass} "
          f"view_s_max={plan.view_s_max}", flush=True)
    if not (plan.ok and plan.twopass):
        raise RuntimeError(f"training batch not planned two-pass: {plan}")
    return plan, batch


def phase_training_kernels(torch, plan, batch):
    """The backward and hat kernels against their plain versions at the
    training plan's shapes (widest view; stage 0 with base == 0, stage 1 on
    the main path's bases; a feature-warp and a volume back-warp pass),
    fp32 and bf16, and their times in bf16, the main path's type."""
    from cermvs_torch.ops import epiband as eb
    from cermvs_torch.ops import hatwarp as hw

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.RandomState(5)
    rates = np.asarray(plan.view_rates)
    vmax = int(np.argmax(plan.view_s_max))
    s_v = plan.view_s_max[vmax]
    ws_v = plan.ws_r - (plan.s_max - s_v)
    C, ((d0, inc0), (d1, inc1)) = C_FEAT, STAGES
    errs = {k: 0.0 for k in TRAIN_KERNELS}
    rows = {k: {"stages": {}} for k in TRAIN_KERNELS[:2]}
    rows.update({k: {"shapes": {}} for k in TRAIN_KERNELS[2:]})
    for dtype, rtol, atol in ((torch.float32, 1e-4, 1e-3),
                              (torch.bfloat16, 1e-2, 1e-2)):
        for stage, D, base_kind, sig in (
                ("stage0", d0, None, tuple(rates[vmax] * inc0)),
                ("stage1", d1, "main", tuple(rates[vmax] * inc1))):
            fr, fs, base, sigma = epiband_case(
                torch, rng, plan.h_r, plan.w_r, ws_v, C, D, base_kind, sig,
                dtype, (d0, inc0 / inc1))
            dout = torch.from_numpy(rng.randn(1, plan.h_r, plan.w_r, D)
                                    .astype(np.float32)).cuda()
            args = (fr, fs, base, sigma, dout, s_v)
            got = (eb.backward_dfr(*args), eb.backward_dfs(*args))
            torch.cuda.synchronize()
            ref = eb.epiband_backward_reference(*args)
            for name, a, b in zip(TRAIN_KERNELS[:2], got, ref):
                err = float((a.float() - b.float()).abs().max())
                errs[name] = max(errs[name], err)
                # bf16: the plain version's roundings, so few elements differ
                differ = float((a != b).float().mean())
                ok = bool(torch.allclose(a.float(), b.float(), rtol=rtol,
                                         atol=atol)) and (
                    dtype != torch.bfloat16 or differ < 0.01)
                print(f"phase 8: {name} {stage} D={D} {str(dtype)[6:]}: "
                      f"max|kernel-plain|={err:.3e} (|plain|max "
                      f"{float(b.abs().max()):.2f}), share differing "
                      f"{differ:.4f}, ok={ok}", flush=True)
                if not ok:
                    raise RuntimeError(f"{name} disagrees with its plain "
                                       f"version ({stage}, {dtype})")
            if dtype != torch.bfloat16:
                continue
            bounds = epiband_bounds(torch, fr, fs, base, sigma, D, s_v)
            plain = cuda_ms(lambda: eb.epiband_backward_reference(*args), 3)
            for name, fn in (("epiband_bwd_dfr", eb.backward_dfr),
                             ("epiband_bwd_dfs", eb.backward_dfs)):
                ms = cuda_ms(lambda: fn(*args), 20)
                rows[name]["stages"][stage] = dict(
                    D=D, shape=[1, plan.h_r, plan.w_r, ws_v, C], ms=ms,
                    plain_ms=plain, bound_ms=bounds[name][0],
                    bound_by=bounds[name][1])
                device = cuda_ms_graph(torch, lambda: fn(*args))
                rows[name]["stages"][stage]["device_ms"] = device
                print(f"phase 8: {name} {stage} timing: kernel {ms:.4f} "
                      f"ms (device {device:.4f}){earlier(name, stage)}, "
                      f"plain (both gradients) {plain:.3f} ms, bound "
                      f"{bounds[name][0]:.4f} ms ({bounds[name][1]})",
                      flush=True)

    h, w = (s // 4 for s in batch["images"].shape[2:4])
    shapes = {"feature_warp": (h, w, ws_v, C),      # src warp, pass 1
              "volume_back_warp": (plan.h_r, plan.w_r, w, d0),  # pass 1
              # stage 1's volume (44 channels) and an image's three
              "feature_warp_c44": (h, w, ws_v, d1),
              "feature_warp_c3": (h, w, ws_v, 3)}
    for dtype in (torch.float32, torch.bfloat16):
        for shape_name, (R, S, O, Cc) in shapes.items():
            img, pos = hat_case(torch, rng, R, S, O, Cc, dtype)
            dout = torch.from_numpy(rng.randn(R, O, Cc).astype(np.float32)
                                    ).cuda()
            out = hw.hat_resample_rows(img, pos)
            dimg = hw.hat_rows_backward(dout, pos, S, dtype)
            torch.cuda.synchronize()
            checks = (
                ("hat_rows_fwd", out, hw.hat_resample_rows_reference(img, pos),
                 1e-5),
                ("hat_rows_bwd", dimg, hw.hat_resample_rows_backward_reference(
                    dout, pos, S, dtype), 1e-5 if dtype == torch.float32
                 else 1e-2))
            for name, a, b, tol in checks:
                err = float((a.float() - b.float()).abs().max())
                errs[name] = max(errs[name], err)
                ok = bool(torch.allclose(a.float(), b.float(), rtol=tol,
                                         atol=tol))
                print(f"phase 8: {name} {shape_name} {(R, S, O, Cc)} "
                      f"{str(dtype)[6:]}: max|kernel-plain|={err:.3e} ok={ok}",
                      flush=True)
                if not ok:
                    raise RuntimeError(f"{name} disagrees with its plain "
                                       f"version ({shape_name}, {dtype})")
            if dtype != torch.bfloat16 or shape_name not in HAT_TIMED:
                continue
            bounds = hat_bounds(torch, img, pos)
            lib = grid_sample_rows(torch, img, pos)
            lib_bwd = grid_sample_rows_backward(torch, img, pos, dout)
            lib_err = {
                "hat_rows_fwd": float((lib()[:, :, 0].permute(0, 2, 1) - out)
                                      .abs().max()),
                "hat_rows_bwd": float((lib_bwd() - dimg.float()).abs().max())}
            # each kernel and its library call back to back and in device
            # time (a CUDA graph): back to back, the host's work per call
            # may bound a launch this short
            both = {
                "hat_rows_fwd": (cuda_ms_both(
                    torch, lambda: hw.hat_resample_rows(img, pos)),
                    cuda_ms_both(torch, lib)),
                "hat_rows_bwd": (cuda_ms_both(
                    torch, lambda: hw.hat_rows_backward(dout, pos, S, dtype)),
                    cuda_ms_both(torch, lib_bwd))}
            plain_ms = {
                "hat_rows_fwd": cuda_ms(
                    lambda: hw.hat_resample_rows_reference(img, pos), 3),
                "hat_rows_bwd": cuda_ms(
                    lambda: hw.hat_resample_rows_backward_reference(
                        dout, pos, S, dtype), 3)}
            for name, (kern, lib_t) in both.items():
                ms, plain, lib_ms = kern[0], plain_ms[name], lib_t[0]
                rows[name]["shapes"][shape_name] = dict(
                    shape=[R, S, O, Cc], ms=ms, plain_ms=plain,
                    library_ms=lib_ms, bound_ms=bounds[name][0],
                    bound_by=bounds[name][1], device_ms=kern[1],
                    library_device_ms=lib_t[1])
                extra = (f" (device {kern[1]:.4f})"
                         f"{earlier(name, shape_name)}")
                lib_extra = (f" (device {lib_t[1]:.4f}; "
                             f"{ratio_text(kern, lib_t)})")
                print(f"phase 8: {name} {shape_name} timing: kernel "
                      f"{ms:.4f} ms{extra}, plain {plain:.3f} ms, library "
                      f"{lib_ms:.4f} ms{lib_extra} (grid_sample |diff| "
                      f"{lib_err[name]:.2e}), bound "
                      f"{bounds[name][0]:.4f} ms ({bounds[name][1]})",
                      flush=True)
    # the report's row: stage 0 and the feature warp, the largest launches
    for name in TRAIN_KERNELS:
        main = (rows[name]["stages"]["stage0"] if "stages" in rows[name]
                else rows[name]["shapes"]["feature_warp"])
        rows[name].update(max_abs_err=errs[name], ms=main["ms"],
                          plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
                          bound_by=main["bound_by"],
                          library_ms=main.get("library_ms"))
        for key in ("device_ms", "library_device_ms"):
            if key in main:
                rows[name][key] = main[key]
    return rows


def phase_train(torch, tree, plan5, batch5):
    """``train()`` through ``train_DTU.gin`` (rectified, batch 2, nf10,
    crop 1056x1440) for TRAIN_STEPS + 1 steps on the synthetic tree; times
    the steps after the first and checks the path, the values, the launch
    counts and the checkpoint."""
    from cermvs_torch.models.raft import RAFT
    from cermvs_torch.ops import cudalib
    from cermvs_torch.training.checkpoint import CheckpointManager
    from cermvs_torch.training.step import init_state
    from cermvs_torch.training.train import train

    configure_training(tree)
    torch.backends.cudnn.allow_tf32 = True  # the bf16 model's own setting
    records = []

    def on_step(state, metrics, plan):
        torch.cuda.synchronize()
        records.append((time.perf_counter(), metrics, plan))
        print(f"phase 9: step {state.step}: loss {metrics['loss']:.5f} "
              f"grad_norm {metrics['grad_norm']:.4f} plan "
              f"{None if plan is None else (plan.h_r, plan.w_r, plan.ws_r)}",
              flush=True)

    ckpt = Path(tree) / "checkpoints"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cudalib.reset_launches()
    t0 = time.perf_counter()
    state = train(name="chip_smoke", checkpoint_dir=str(ckpt),
                  run_dir=str(Path(tree) / "runs"), resume=False, log_every=1,
                  on_step=on_step, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: cudalib.launches.get(k, 0) for k in KERNELS}
    peak = torch.cuda.max_memory_allocated()
    steps = len(records)
    B, V, S = 2, NUM_FRAMES, len(state.model.cascade)
    per_step = {"epiband_fwd": B * V * S, "epiband_bwd_dfr": B * V * S,
                "epiband_bwd_dfs": B * V * S,
                # two passes per feature warp (2 per view) and per stage's
                # volume back-warp, forward and transposed
                "hat_rows_fwd": B * V * (2 + S) * 2,
                "hat_rows_bwd": B * V * (2 + S) * 2,
                # the banded lookup of the materialized pyramid
                "lookup_fused_fwd": 0, "lookup_fused_bwd": 0,
                "lookup_fused_v2": 0}
    expect = {k: steps * v for k, v in per_step.items()}
    s_per_step = [b[0] - a[0] for a, b in zip(records, records[1:])]
    print(f"phase 9: {steps} steps in {wall:.1f} s, s/step after the first "
          f"{[round(t, 4) for t in s_per_step]}, peak "
          f"{peak / 2**30:.2f} GiB, launches {launches} (expected {expect})",
          flush=True)
    if steps != TRAIN_STEPS + 1 or state.step != steps:
        raise RuntimeError(f"{steps} steps taken, state at {state.step}")
    for _, m, plan in records:
        if plan is None or not plan.twopass:
            raise RuntimeError("a step did not take the rectified two-pass "
                               "construction")
        if not (np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"])
                and m["grad_norm"] > 0):
            raise RuntimeError(f"bad step metrics {m}")
    if not all(bool(torch.isfinite(p).all())
               for p in state.model.parameters()):
        raise RuntimeError("non-finite weights after training")
    if launches != expect:
        raise RuntimeError(f"launches {launches} != {expect}")
    mgr = CheckpointManager(ckpt / "chip_smoke")
    fresh = init_state(RAFT(device="cuda"), TRAIN_STEPS)
    restored = mgr.restore(fresh)
    if mgr.all_steps() != [1, steps] or restored.step != steps:
        raise RuntimeError(f"checkpoints {mgr.all_steps()}, restored step "
                           f"{restored.step}")
    same = all(torch.equal(a, b) for a, b in zip(
        state.model.state_dict().values(),
        restored.model.state_dict().values()))
    print(f"phase 9: checkpoints at steps {mgr.all_steps()}, restore resumes "
          f"step {restored.step}, weights equal {same}", flush=True)
    if not same:
        raise RuntimeError("restored weights differ")
    if "--profile" in sys.argv:
        from cermvs_torch.ops.corr_rectified import RectifiedVolume
        from cermvs_torch.training.step import batch_to_device, train_step

        batch = batch_to_device(batch5, "cuda")
        vol = RectifiedVolume(plan5)
        prof = profile_call(torch, lambda: train_step(state, batch, 0.5,
                                                      volume_fn=vol))
        grads = {g: [row for row in prof["port_kernels_ms"] if g in row[0]]
                 for g in ("dfr", "dfs", "hat_rows_bwd")}
        print(f"phase 9: profile of one train step: device busy "
              f"{prof['device_busy_ms']:.1f} ms of {prof['wall_ms']:.1f} ms "
              f"wall; dfr row {grads['dfr']}; dfs row {grads['dfs']}; "
              f"hat_rows_bwd row {grads['hat_rows_bwd']}; elementwise "
              f"launches {prof['elementwise_launches']} "
              f"({prof['elementwise_ms']:.2f} ms)", flush=True)
        print(json.dumps({"profile_train_step": prof}), flush=True)
    plans = {(p.h_r, p.w_r, p.ws_r, p.view_s_max) for _, _, p in records}
    return {"launches": launches, "s_per_step": s_per_step,
            "peak_bytes": peak, "steps": steps,
            "plan": [list(p[:3]) + [list(p[3])] for p in sorted(plans)]}


def cuda_ms_cold(torch, fn, reps):
    """Mean time of one call with the L2 cache flushed before it, as the
    main path finds the volume (the GRU's convolutions run between two
    lookups): CUDA events around each call."""
    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    fn()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for start, end in events:
        flush.zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in events) / reps


def lookup_case(torch, rng, shape):
    """A fp32 volume, its clamped indices (zero, inside and past D, as the
    main path's clamp max(index, 0) gives them) and a tap gradient; the
    volume and the gradient are drawn on the card, as in
    :func:`epiband_case`."""
    D = shape[-1]
    gen = torch.Generator(device="cuda").manual_seed(int(rng.randint(2**31)))
    corr = torch.randn(shape, generator=gen, device="cuda")
    x0 = np.maximum(rng.rand(*shape[:-1]).astype(np.float32) * (D + 16) - 4,
                    0)
    g = torch.randn((*shape[:-1], 33), generator=gen, device="cuda")
    return corr, torch.from_numpy(x0).cuda(), g


def lookup_bounds(torch, x0, D, radius=5, levels=3):
    """Least time of the fused lookup (forward and prefix-sum variant) and
    of its gradient for these indices. Bytes: the level-0 cells some
    in-range tap reaches and x0, read once; the taps written (forward) or
    read (gradient) once; the gradient's D cells per pixel written once.
    Operations (fp32): per (tap, in-range pooled cell) 2^l adds and a scale,
    and a 3-operation lerp per tap (forward); 2 * 2^l per (tap, in-range
    pooled cell) (gradient). Returns {name: (bound_ms, bound_by)}."""
    M, K = x0.numel(), 2 * radius + 1
    T = levels * K
    x = x0.reshape(-1).float()
    j = torch.arange(D, device=x.device)[None]
    reached = torch.zeros(M, D, dtype=torch.bool, device=x.device)
    fwd_ops, bwd_ops = 3 * M * T, 0
    for lvl in range(levels):
        n, Dl = 1 << lvl, D >> lvl
        c0 = torch.floor(x / n)[:, None]
        cells = c0 - radius + torch.arange(K + 1, device=x.device)
        inside = (cells >= 0) & (cells < Dl)
        pairs = int(inside[:, :-1].sum() + inside[:, 1:].sum())
        fwd_ops += pairs * (n + 1)
        bwd_ops += pairs * 2 * n
        jl = j >> lvl
        reached |= (jl >= c0 - radius) & (jl <= c0 + radius + 1) & (jl < Dl)
    peak = PEAK_FLOPS["float32"]
    taps = M * T * 4
    fwd = bound_of(int(reached.sum()) * 4 + M * 4 + taps, fwd_ops, peak)
    return {"lookup_fused_fwd": fwd, "lookup_fused_v2": fwd,
            "lookup_fused_bwd": bound_of(taps + M * 4 + M * D * 4, bwd_ops,
                                         peak)}


def phase_lookup_kernels(torch):
    """The fused lookup kernels against their plain versions on the card at
    the main path's shapes (inference at scale 1 and the training batch,
    stage 0 and stage 1), with their times (L2 flushed before each launch,
    and back to back), plain times and bounds."""
    from cermvs_torch.ops import lookup as lk

    rng = np.random.RandomState(7)
    rows = {k: {"shapes": {}} for k in LOOKUPS}
    errs = {k: 0.0 for k in LOOKUPS}
    for shape_name, shape in LOOKUP_SHAPES.items():
        corr, x0, g = lookup_case(torch, rng, shape)
        D = shape[-1]
        got = {"lookup_fused_fwd": lk.lookup_fused(corr, x0),
               "lookup_fused_bwd": lk.lookup_fused_backward(g, x0, D),
               "lookup_fused_v2": lk.lookup_fused_v2(corr, x0)}
        torch.cuda.synchronize()
        plain = {"lookup_fused_fwd": lambda: lk.lookup_fused_reference(
                     corr, x0),
                 "lookup_fused_bwd": lambda: lk.lookup_fused_backward_reference(
                     g, x0, D),
                 "lookup_fused_v2": lambda: lk.lookup_fused_v2_reference(
                     corr, x0)}
        # fp32 pooling and lerps in another order; the prefix-sum kernel
        # against its plain version (both prefix sums, another scan order)
        # and against the pooled taps at the JAX package's 2e-3
        checks = [(name, "plain", got[name], plain[name](), 1e-4 if name ==
                   "lookup_fused_v2" else 1e-5) for name in LOOKUPS]
        checks.append(("lookup_fused_v2", "pooled taps",
                       got["lookup_fused_v2"], checks[0][3], 2e-3))
        for name, against, a, b, tol in checks:
            err = float((a - b).abs().max())
            if against == "plain":
                errs[name] = max(errs[name], err)
            ok = bool(torch.allclose(a, b, rtol=tol, atol=tol))
            print(f"phase 3: {name} {shape_name} {shape}: max|kernel - "
                  f"{against}|={err:.3e} (|{against}|max "
                  f"{float(b.abs().max()):.2f}, tol {tol:g}) ok={ok}",
                  flush=True)
            if not ok:
                raise RuntimeError(f"{name} disagrees with its plain version "
                                   f"({shape_name})")
        bounds = lookup_bounds(torch, x0, D)
        kernel = {"lookup_fused_fwd": lambda: lk.lookup_fused(corr, x0),
                  "lookup_fused_bwd": lambda: lk.lookup_fused_backward(
                      g, x0, D),
                  "lookup_fused_v2": lambda: lk.lookup_fused_v2(corr, x0)}
        for name in LOOKUPS:
            ms = cuda_ms_cold(torch, kernel[name], 20)
            warm = cuda_ms(kernel[name], 50)
            plain_ms = cuda_ms(plain[name], 3)
            rows[name]["shapes"][shape_name] = dict(
                shape=list(shape), ms=ms, warm_ms=warm, plain_ms=plain_ms,
                bound_ms=bounds[name][0], bound_by=bounds[name][1])
            extra = ""
            if name == "lookup_fused_fwd":  # and in device time (warm L2)
                device = cuda_ms_graph(torch, kernel[name])
                rows[name]["shapes"][shape_name]["device_ms"] = device
                extra = f", device {device:.4f}"
            print(f"phase 3: {name} {shape_name} timing: kernel {ms:.4f} ms "
                  f"(L2 flushed{earlier(name, shape_name)}; back to back "
                  f"{warm:.4f}{extra}), plain {plain_ms:.3f} ms, bound "
                  f"{bounds[name][0]:.4f} ms ({bounds[name][1]}), library "
                  f"{NO_LIBRARY}", flush=True)
    for name in LOOKUPS:
        main = rows[name]["shapes"]["training_stage0" if name ==
                                    "lookup_fused_bwd" else
                                    "inference_stage0"]
        rows[name].update(max_abs_err=errs[name], ms=main["ms"],
                          plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
                          bound_by=main["bound_by"], library_ms=None,
                          library=NO_LIBRARY)
        if "device_ms" in main:
            rows[name]["device_ms"] = main["device_ms"]
    return rows


def sphere_depth(P, K, h, w):
    """Depth (camera z) of the sphere of radius SPHERE_R about the origin
    seen from world-to-camera pose P with intrinsics K, (h, w) fp32; 0
    where a ray misses it."""
    u, v = np.meshgrid(np.arange(w, dtype=np.float64),
                       np.arange(h, dtype=np.float64))
    d = np.linalg.inv(K) @ np.stack([u.ravel(), v.ravel(), np.ones(u.size)])
    c = np.asarray(P, np.float64)[:3, 3]  # the centre in camera coordinates
    a = (d * d).sum(0)
    b = c @ d
    disc = b * b - a * (c @ c - SPHERE_R ** 2)
    s = (b - np.sqrt(np.maximum(disc, 0.0))) / a
    return np.where(disc > 0, s, 0.0).reshape(h, w).astype(np.float32)


def write_dtu_test_scan(root, h, w, scan="scan3", n=DEMO_VIEWS, seed=0):
    """A DTU test scan as ``DTUTest`` reads it: ``Rectified/<scan>/
    rect_{i:03d}_3_r5000.png`` (h x w, random texture) for the first ``n``
    cameras of :func:`write_cameras`, each listing the other n - 1 in
    ``pair.txt``."""
    import cv2

    root = Path(root)
    (root / "Rectified" / scan).mkdir(parents=True, exist_ok=True)
    write_cameras(root, h, w, n, n - 1)
    rng = np.random.RandomState(seed)
    for i in range(n):
        cv2.imwrite(
            str(root / "Rectified" / scan / f"rect_{i + 1:03d}_3_r5000.png"),
            (rng.rand(h, w, 3) * 255).astype(np.uint8),
            [cv2.IMWRITE_PNG_COMPRESSION, 1])


def run_cli(main_fn, bindings):
    """A port CLI with ``-g inference_DTU`` and ``bindings`` as ``-p``."""
    from cermvs_torch import config as pcfg

    pcfg.clear_config()
    argv = ["-g", "inference_DTU"]
    for b in bindings:
        argv += ["-p", b]
    return main_fn(argv)


def demo_plans(runner, root):
    """The rectification plans of the demo's inference at rescale 1 and 2,
    formed as ``inference()`` forms them (scale, crop to the stride,
    neighbour order, ``plan_for``) for every reference view of the test
    scan. Per rescale: the feature size and the distinct plans of the
    widest band and of the largest rectified grid. Fails unless every plan
    is two-pass and phase 3 held the lookups at these feature sizes."""
    from cermvs_torch.data import get_test_data_loader
    from cermvs_torch.data.augment import pad_to_multiple, scale_operation

    loader = get_test_data_loader("DTUTest", dataset_path=str(root / "DTU"),
                                  scan="scan3", num_frames=NUM_FRAMES,
                                  num_workers=0)
    plans, hw = {1: [], 2: []}, {}
    for images, poses, intr, _, scale in loader:
        order = runner.neighbor_order(poses)
        for rescale in plans:
            im, k = scale_operation(images, intr, rescale)
            im, k = pad_to_multiple(im, k, runner.model.stride_factor)
            plan = runner.plan_for(poses[order], k[order], scale,
                                   im.shape[1:3])
            if not (plan.ok and plan.twopass):
                raise RuntimeError(f"demo view not planned two-pass at "
                                   f"rescale {rescale}: {plan}")
            plans[rescale].append(plan)
            hw[rescale] = tuple(s // runner.model.stride_factor
                                for s in im.shape[1:3])
    picked = {}
    for rescale, found in plans.items():
        for s, (D, _) in enumerate(STAGES):
            want = LOOKUP_SHAPES[f"demo_rescale{rescale}_stage{s}"]
            if want != (1, 1, *hw[rescale], D):
                raise RuntimeError(f"the demo's lookup at rescale {rescale} "
                                   f"is {hw[rescale]}, phase 3 held {want}")
        picked[rescale] = (hw[rescale], sorted(
            {max(found, key=lambda p: (p.ws_r, p.h_r * p.w_r)),
             max(found, key=lambda p: (p.h_r * p.w_r, p.ws_r))},
            key=lambda p: p.ws_r, reverse=True))
    return picked


def hold_rect_kernels(torch, plan, h, w, label, timed=False):
    """epiband_fwd and hat_rows_fwd against their plain versions at one
    inference plan's widest view, (h, w) features: epiband stage 0 (base ==
    0) and stage 1 (the main path's bases); both passes of the reference
    and source feature warps and of each stage's volume back-warp; fp32
    and bf16, at phase 2's and phase 8's tolerances. Returns each kernel's
    largest error and, with ``timed``, its bf16 times at stage 0 (epiband)
    and the source warp's first pass (hat), with plain times and bounds."""
    from cermvs_torch.ops import epiband as eb
    from cermvs_torch.ops import hatwarp as hwp

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.RandomState(11)
    vmax = int(np.argmax(plan.view_s_max))
    s_v = plan.view_s_max[vmax]
    ws = plan.ws_r - (plan.s_max - s_v)
    rate = np.asarray(plan.view_rates)[vmax]
    (d0, inc0), (d1, inc1) = STAGES
    errs = {"epiband_fwd": 0.0, "hat_rows_fwd": 0.0}
    rows = {"epiband_fwd": {}, "hat_rows_fwd": {}}
    shape = f"h_r={plan.h_r} w_r={plan.w_r} ws={ws} s_max={s_v}"
    for dtype, rtol, atol in ((torch.float32, 1e-4, 1e-3),
                              (torch.bfloat16, 1e-3, 1e-2)):
        for stage, D, base_kind, inc in (("stage0", d0, None, inc0),
                                         ("stage1", d1, "main", inc1)):
            fr, fs, base, sigma = epiband_case(
                torch, rng, plan.h_r, plan.w_r, ws, C_FEAT, D, base_kind,
                tuple(rate * inc), dtype, (d0, inc0 / inc1))
            args = (fr, fs, base, sigma, D, s_v)
            out = eb.epiband(*args)
            torch.cuda.synchronize()
            ref = eb.epiband_reference(*args)
            err = float((out - ref).abs().max())
            errs["epiband_fwd"] = max(errs["epiband_fwd"], err)
            ok = bool(torch.allclose(out, ref, rtol=rtol, atol=atol))
            print(f"phase 6: epiband_fwd {label} {shape} {stage} D={D} "
                  f"{str(dtype)[6:]}: max|kernel-plain|={err:.3e} (|plain|max "
                  f"{float(ref.abs().max()):.2f}) ok={ok}", flush=True)
            if not ok:
                raise RuntimeError(f"epiband_fwd disagrees with its plain "
                                   f"version ({label}, {stage}, {dtype})")
            del out, ref
            if timed and dtype == torch.bfloat16 and stage == "stage0":
                bound, by = epiband_bounds(torch, fr, fs, base, sigma, D,
                                           s_v)["epiband_fwd"]
                ms, device_ms = cuda_ms_both(torch,
                                             lambda: eb.epiband(*args), 20)
                rows["epiband_fwd"] = dict(
                    shape=[1, plan.h_r, plan.w_r, ws, C_FEAT], D=D, ms=ms,
                    device_ms=device_ms,
                    plain_ms=cuda_ms(lambda: eb.epiband_reference(*args), 3),
                    bound_ms=bound, bound_by=by)
        # (R, S, O, C) of each hat pass: the warps of the (h, w) features to
        # the (h_r, w_r) and (h_r, ws) rect grids, then each stage's
        # (h_r, w_r, D) volume back to (h, w)
        passes = {"ref_warp_pass1": (h, w, plan.w_r, C_FEAT),
                  "ref_warp_pass2": (plan.w_r, h, plan.h_r, C_FEAT),
                  "src_warp_pass1": (h, w, ws, C_FEAT),
                  "src_warp_pass2": (ws, h, plan.h_r, C_FEAT)}
        for s, (D, _) in enumerate(STAGES):
            passes[f"back_warp_stage{s}_pass1"] = (plan.h_r, plan.w_r, w, D)
            passes[f"back_warp_stage{s}_pass2"] = (w, plan.h_r, h, D)
        # three channels (an image's) at the source warp's first pass
        passes["src_warp_pass1_c3"] = (h, w, ws, 3)
        for name, (R, S, O, C) in passes.items():
            img, pos = hat_case(torch, rng, R, S, O, C, dtype)
            out = hwp.hat_resample_rows(img, pos)
            torch.cuda.synchronize()
            ref = hwp.hat_resample_rows_reference(img, pos)
            err = float((out - ref).abs().max())
            errs["hat_rows_fwd"] = max(errs["hat_rows_fwd"], err)
            ok = bool(torch.allclose(out, ref, rtol=1e-5, atol=1e-5))
            print(f"phase 6: hat_rows_fwd {label} {name} {(R, S, O, C)} "
                  f"{str(dtype)[6:]}: max|kernel-plain|={err:.3e} ok={ok}",
                  flush=True)
            if not ok:
                raise RuntimeError(f"hat_rows_fwd disagrees with its plain "
                                   f"version ({label}, {name}, {dtype})")
            if timed and dtype == torch.bfloat16 and name == "src_warp_pass1":
                bound, by = hat_bounds(torch, img, pos)["hat_rows_fwd"]
                lib = grid_sample_rows(torch, img, pos)
                ms, device_ms = cuda_ms_both(
                    torch, lambda: hwp.hat_resample_rows(img, pos))
                lib_ms, lib_device_ms = cuda_ms_both(torch, lib)
                rows["hat_rows_fwd"] = dict(
                    shape=[R, S, O, C], ms=ms, device_ms=device_ms,
                    plain_ms=cuda_ms(
                        lambda: hwp.hat_resample_rows_reference(img, pos), 3),
                    library_ms=lib_ms, library_device_ms=lib_device_ms,
                    library_diff=float((lib()[:, :, 0].permute(0, 2, 1) - out)
                                       .abs().max()),
                    bound_ms=bound, bound_by=by)
                del lib
    for name, row in rows.items():
        if row:
            lib = ("" if "library_ms" not in row else
                   f", library {row['library_ms']:.4f} ms (device "
                   f"{row['library_device_ms']:.4f}; " + ratio_text(
                       (row["ms"], row["device_ms"]),
                       (row["library_ms"], row["library_device_ms"]))
                   + f"; grid_sample |diff| {row['library_diff']:.2e})")
            print(f"phase 6: {name} {label} timing: kernel {row['ms']:.4f} "
                  f"ms (device {row['device_ms']:.4f})"
                  f"{earlier(name, 'demo_rescale2')}, plain "
                  f"{row['plain_ms']:.3f} ms{lib}, bound "
                  f"{row['bound_ms']:.4f} ms ({row['bound_by']})", flush=True)
    return errs, rows


def phase_demo(torch, root):
    """The demo contract through the port's CLIs with inference_DTU.gin and
    the fused lookup (``RAFT.lookup_impl="pallas"``) on a synthetic DTU
    test scan: first epiband_fwd and hat_rows_fwd held against their plain
    versions at the plans the scan gets at rescale 1 and 2, then inference
    at rescale 1 and 2 over every imaged view, the multires merge, fusion at
    rescale 2 with view_batch 8. Per scale: s/view, construction, peak
    device memory, launches per forward (checked); the files (checked);
    fusion's seconds and points."""
    from cermvs_torch import config as pcfg
    from cermvs_torch import fusion as fusion_cli
    from cermvs_torch import inference as inference_cli
    from cermvs_torch import multires as multires_cli
    from cermvs_torch.io.pfm import read_pfm
    from cermvs_torch.io.ply import read_ply
    from cermvs_torch.models.raft import RAFT
    from cermvs_torch.ops import cudalib
    from cermvs_torch.pipeline.inference import InferenceRunner
    from cermvs_torch.training.checkpoint import save_params

    os.chdir(REPO)  # the CLIs read configs/
    t0 = time.perf_counter()
    write_dtu_test_scan(root / "DTU", *DTU_HW)
    common = [f'DTUTest.dataset_path = "{root / "DTU"}"',
              'DTUTest.scan = "scan3"', 'RAFT.lookup_impl = "pallas"']
    pcfg.clear_config()
    pcfg.parse_config(common)
    model = RAFT(test_mode=True, generator=torch.Generator().manual_seed(0))
    ckpt = root / "pretrained" / "train_DTU"
    save_params(ckpt, model)
    n_stages = len(model.cascade)
    n_iters = sum(s[2] for s in model.cascade)
    print(f"phase 6: DTU test scan ({DEMO_VIEWS} views of {DTU_HW}) and "
          f"random weights written in {time.perf_counter() - t0:.1f} s",
          flush=True)
    t0 = time.perf_counter()
    plans = demo_plans(InferenceRunner(
        model=model, device=next(model.parameters()).device), root)
    del model
    errs, kernel_rows = {}, {}
    for rescale, (hw, picked) in plans.items():
        for i, plan in enumerate(picked):
            e, r = hold_rect_kernels(torch, plan, *hw, f"rescale{rescale}",
                                     timed=(rescale, i) == (2, 0))
            for name in e:
                errs[name] = max(errs.get(name, 0.0), e[name])
                kernel_rows.update({name: r[name]} if r[name] else {})
    torch.cuda.empty_cache()
    print(f"phase 6: epiband_fwd and hat_rows_fwd held at the demo's plans "
          f"in {time.perf_counter() - t0:.1f} s: max|kernel-plain| {errs}",
          flush=True)
    out = root / "results" / "scan3"
    scales, demo_launches = {}, {k: 0 for k in KERNELS}
    for rescale in (1, 2):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        cudalib.reset_launches()
        t0 = time.perf_counter()
        records = run_cli(inference_cli.main, common + [
            f'inference.ckpt = "{ckpt}"', f'inference.output_folder = "{out}"',
            f"inference.rescale = {rescale}", "inference.do_report = True"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: cudalib.launches.get(k, 0) for k in KERNELS}
        peak = torch.cuda.max_memory_allocated()
        n = len(records)
        paths = sorted({r[2] for r in records})
        s_view = [r[1] for r in records]
        print(f"phase 6: rescale {rescale}: {n} views in {wall:.1f} s, s/view "
              f"{[round(t, 4) for t in s_view]}, construction {paths}, peak "
              f"{peak / 2**30:.2f} GiB, launches {launches}", flush=True)
        per_forward = {"lookup_fused_fwd": n_iters, "lookup_fused_bwd": 0,
                       "lookup_fused_v2": 0}
        if paths == ["rectified"]:
            V = NUM_FRAMES
            per_forward.update(epiband_fwd=n_stages * V,
                               hat_rows_fwd=(2 + n_stages) * 2 * V)
        check_launches(launches, {k: n * v for k, v in per_forward.items()},
                       f"demo inference at rescale {rescale}")
        for name, _, _ in records:
            f = out / "depths" / f"{name}_scale{rescale}_nf{NUM_FRAMES}.pfm"
            if not f.is_file():
                raise RuntimeError(f"missing {f}")
        for k, v in launches.items():
            demo_launches[k] += v
        scales[rescale] = {"views": n, "s_per_view": s_view,
                           "construction": paths, "peak_bytes": peak,
                           "wall_s": wall}
    if "--profile" in sys.argv:
        profile_demo_forward(torch, common, ckpt, rescale=2)
    t0 = time.perf_counter()
    run_cli(multires_cli.main, [f'multires.output_folder = "{out}"',
                                "multires.visualize = True"])
    merged = sorted((out / "depths").glob("*_nf10_nf10_th0.02.pfm"))
    maps = [read_pfm(f) for f in merged]
    print(f"phase 6: multires wrote {len(merged)} merged maps "
          f"{sorted({m.shape for m in maps})} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if len(merged) != DEMO_VIEWS or not all(np.isfinite(m).all()
                                            for m in maps):
        raise RuntimeError(f"merged maps: {[f.name for f in merged]}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ply = run_cli(fusion_cli.main, common + [f'fusion.output_folder = "{out}"'])
    torch.cuda.synchronize()
    fusion_s = time.perf_counter() - t0
    xyz, _ = read_ply(ply)
    fusion_peak = torch.cuda.max_memory_allocated()
    # random weights: the views' depths disagree, so the cloud is expected
    # to be empty; phase 7 times fusion with point emission
    note = "" if len(xyz) else (" (expected of random weights: no two "
                                "views agree; the time has no point "
                                "emission, phase 7 has)")
    print(f"phase 6: fusion (rescale 2, view_batch 8) in {fusion_s:.2f} s: "
          f"{len(xyz)} points{note}, peak {fusion_peak / 2**30:.2f} GiB",
          flush=True)
    if not (Path(ply) == out / "result.ply" and Path(ply).is_file()
            and np.isfinite(xyz).all()):
        raise RuntimeError(f"bad fused cloud {ply}")
    return {"scales": scales, "launches": demo_launches,
            "fusion_s": fusion_s, "fusion_points": len(xyz),
            "fusion_peak_bytes": fusion_peak, "kernel_errs": errs,
            "kernel_rows_rescale2": kernel_rows}


def profile_demo_forward(torch, bindings, ckpt, rescale):
    """torch.profiler breakdown of one warm forward of the demo's first
    view at ``rescale``, as ``inference()`` prepares it."""
    from cermvs_torch import config as pcfg
    from cermvs_torch.data import get_test_data_loader
    from cermvs_torch.data.augment import pad_to_multiple, scale_operation
    from cermvs_torch.models.raft import RAFT
    from cermvs_torch.pipeline.inference import InferenceRunner
    from cermvs_torch.training.checkpoint import load_params

    pcfg.clear_config()
    pcfg.parse_config(bindings)
    model = RAFT(test_mode=True)
    model.load_state_dict(load_params(ckpt))
    runner = InferenceRunner(model=model,
                             device=next(model.parameters()).device)
    images, poses, intr, _, scale = get_test_data_loader(
        "DTUTest", num_frames=NUM_FRAMES, num_workers=0).dataset[0]
    images, intr = scale_operation(images, intr, rescale)
    images, intr = pad_to_multiple(images, intr, model.stride_factor)
    runner(images, poses, intr, scale)  # warm-up
    prof = profile_call(torch, lambda: runner.submit(images, poses, intr,
                                                     scale))
    print(f"phase 6: profile of one rescale-{rescale} forward: device busy "
          f"{prof['device_busy_ms']:.1f} ms of {prof['wall_ms']:.1f} ms "
          f"wall; lookup_fused_fwd row "
          f"{[r for r in prof['port_kernels_ms'] if 'lookup_fwd' in r[0]]}",
          flush=True)
    print(json.dumps({f"profile_demo_rescale{rescale}": prof}), flush=True)


def phase_true_fusion(torch, root):
    """Fusion on known geometry: the test scan's true depth maps (the sphere
    at TRUE_HW, the centre row crop of its DTU_HW images) fused with
    view_batch 8; every fused point must lie within TRUE_TOL_MM of the
    sphere."""
    from cermvs_torch import config as pcfg
    from cermvs_torch.data import get_test_data_loader
    from cermvs_torch.io.pfm import write_pfm
    from cermvs_torch.io.ply import read_ply
    from cermvs_torch.pipeline.fusion import fusion

    poses = dtu_arc_poses()
    h, w = TRUE_HW
    f = 2892.0 * w / 1600
    # align_image_to_depth crops the image rows to the depth grid
    img_h = DTU_HW[0]
    K = np.array([[f, 0, w / 2], [0, f, img_h / 2 - (img_h - h + 1) // 2],
                  [0, 0, 1]])
    out = root / "true"
    (out / "depths").mkdir(parents=True)
    for i in range(DEMO_VIEWS):
        write_pfm(out / "depths" / f"{i}_true.pfm", sphere_depth(poses[i], K,
                                                                 h, w))
    pcfg.clear_config()
    loader = get_test_data_loader("DTUTest", dataset_path=str(root / "DTU"),
                                  scan="scan3", num_frames=NUM_FRAMES)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ply = fusion(loader, out, suffix="_true", rescale=1, view_batch=8)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    xyz, _ = read_ply(ply)
    err = np.abs(np.linalg.norm(xyz.astype(np.float64), axis=1) - SPHERE_R)
    share = len(xyz) / (DEMO_VIEWS * h * w)
    print(f"phase 7: fusion of the true depths {TRUE_HW} x {DEMO_VIEWS} views "
          f"in {secs:.2f} s: {len(xyz)} points ({share:.3f} of the pixels), "
          f"distance to the sphere max {err.max():.4f} mm, median "
          f"{np.median(err):.4f} mm (limit {TRUE_TOL_MM} mm)", flush=True)
    if share < 0.1 or err.max() > TRUE_TOL_MM:
        raise RuntimeError("the fused cloud is not on the true surface")
    return {"seconds": secs, "points": len(xyz), "share": share,
            "max_err_mm": float(err.max()),
            "median_err_mm": float(np.median(err))}


def phase_train_pallas(torch, tree, plan5, batch5):
    """``train()`` with train_DTU.gin and ``RAFT.lookup_impl="pallas"`` for
    PALLAS_STEPS + 1 steps (16 forward and 16 backward lookup launches a
    step, the other kernels as the banded run), then one train step on
    phase 8's batch from one set of weights, banded against fused."""
    from cermvs_torch import config as pcfg
    from cermvs_torch.models.raft import RAFT
    from cermvs_torch.ops import cudalib
    from cermvs_torch.ops.corr_rectified import RectifiedVolume
    from cermvs_torch.training.step import (batch_to_device, init_state,
                                            train_step)
    from cermvs_torch.training.train import train

    configure_training(tree)
    pcfg.bind_parameter("RAFT.lookup_impl", "pallas")
    pcfg.bind_parameter("train.num_steps", PALLAS_STEPS)
    records = []

    def on_step(state, metrics, plan):
        torch.cuda.synchronize()
        records.append((time.perf_counter(), metrics))
        print(f"phase 10: step {state.step}: loss {metrics['loss']:.5f} "
              f"grad_norm {metrics['grad_norm']:.4f}", flush=True)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cudalib.reset_launches()
    t0 = time.perf_counter()
    state = train(name="chip_smoke_pallas",
                  checkpoint_dir=str(Path(tree) / "checkpoints"),
                  run_dir=str(Path(tree) / "runs"), resume=False,
                  log_every=1, on_step=on_step, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: cudalib.launches.get(k, 0) for k in KERNELS}
    peak = torch.cuda.max_memory_allocated()
    steps = len(records)
    s_per_step = [b[0] - a[0] for a, b in zip(records, records[1:])]
    records = [m for _, m in records]
    B, V, S = 2, NUM_FRAMES, len(state.model.cascade)
    n_iters = sum(s[2] for s in state.model.cascade)
    per_step = {"epiband_fwd": B * V * S, "epiband_bwd_dfr": B * V * S,
                "epiband_bwd_dfs": B * V * S,
                "hat_rows_fwd": B * V * (2 + S) * 2,
                "hat_rows_bwd": B * V * (2 + S) * 2,
                "lookup_fused_fwd": n_iters, "lookup_fused_bwd": n_iters,
                "lookup_fused_v2": 0}
    print(f"phase 10: {steps} fused-lookup steps in {wall:.1f} s, s/step "
          f"after the first {[round(t, 4) for t in s_per_step]}, peak "
          f"{peak / 2**30:.2f} GiB, launches {launches}", flush=True)
    if steps != PALLAS_STEPS + 1 or not all(
            np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"])
            and m["grad_norm"] > 0 for m in records):
        raise RuntimeError(f"bad fused-lookup steps {records}")
    check_launches(launches, {k: steps * v for k, v in per_step.items()},
                   "fused-lookup training")
    del state
    batch = batch_to_device(batch5, "cuda")
    first = {}
    for impl in ("banded", "pallas"):
        model = RAFT(generator=torch.Generator().manual_seed(1234),
                     lookup_impl=impl, device="cuda")
        first[impl] = train_step(init_state(model, 1000), batch, 0.0,
                                 volume_fn=RectifiedVolume(plan5))
        del model
    rel = {k: abs(first["pallas"][k] - first["banded"][k])
           / abs(first["banded"][k]) for k in ("loss", "grad_norm")}
    print(f"phase 10: first step on one batch and weights: banded loss "
          f"{first['banded']['loss']:.6f} grad_norm "
          f"{first['banded']['grad_norm']:.5f}, fused loss "
          f"{first['pallas']['loss']:.6f} grad_norm "
          f"{first['pallas']['grad_norm']:.5f}, relative differences {rel} "
          f"(limit 1e-3: bf16 GRU inputs round the fp32 taps' last bits "
          f"differently)", flush=True)
    if max(rel.values()) > 1e-3:
        raise RuntimeError("fused and banded first steps disagree")
    return {"launches": launches, "steps": steps, "s_per_step": s_per_step,
            "peak_bytes": peak, "wall_s": wall, "first_step": first,
            "first_step_rel": rel}


def phase_epiband_kernel(torch, plan, model):
    """Phase 2: the epiband forward against its plain version at the
    plan's widest view (the main path's stages and the bf16 kernel's
    edges, fp32 and bf16), and both stages' bf16 times. Returns the
    largest error and the stages' timing rows."""
    from cermvs_torch.ops import epiband as eb

    rates = np.asarray(plan.view_rates)
    vmax = int(np.argmax(plan.view_s_max))
    s_v = plan.view_s_max[vmax]
    ws_v = plan.ws_r - (plan.s_max - s_v)
    C = model.dim_fmap
    d0 = model.auto_hyps(model.cascade[0][0])
    d1 = model.auto_hyps(model.cascade[1][0])
    inc0 = 0.0025 / model.cascade[0][1]
    inc1 = 0.0025 / model.cascade[1][1]
    wide = tuple(rates[vmax] * inc0)
    narrow = tuple(rates[vmax] * inc1)
    stage0 = (d0, inc0 / inc1)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.RandomState(0)
    max_err = 0.0
    # (name, D, base, sigma, C, pixels cut off w_r and ws): the main path's
    # stages, then the bf16 kernel's edges: a stage-1 tile band wider than
    # one 128-column chunk, tap pairs straddling a chunk edge, far and NaN
    # bases, a w_r that is no multiple of the 64-pixel tile, C = 44 and 16
    cases = [("stage0", d0, None, wide, C, 0),
             ("stage0", d0, None, narrow, C, 0),
             ("stage1", d1, "band", narrow, C, 0),
             ("stage1", d1, "band", wide, C, 0),
             ("stage1", d1, "main", narrow, C, 0),
             ("stage1_wide_band", d1, "main", wide, C, 0),
             ("straddling_taps", d1, "straddle", narrow, C, 0),
             ("far_and_nan_bases", d1, "far", narrow, C, 0),
             ("ragged_w_r", d0, None, wide, C, 24),
             ("c44", d1, "main", narrow, 44, 0),
             ("c16", d0, None, wide, 16, 0)]
    for dtype, rtol, atol in ((torch.float32, 1e-4, 1e-3),
                              (torch.bfloat16, 1e-3, 1e-2)):
        for name, D, base_kind, sig, Cc, cut in cases:
            fr, fs, base, sigma = epiband_case(
                torch, rng, plan.h_r, plan.w_r - cut, ws_v - cut, Cc, D,
                base_kind, sig, dtype, stage0, s_v)
            out = eb.epiband(fr, fs, base, sigma, D, s_v)
            torch.cuda.synchronize()
            ref = eb.epiband_reference(fr, fs, base, sigma, D, s_v)
            # NaN where the position is NaN, in both
            err = float((out - ref).nan_to_num().abs().max())
            ok = bool(torch.allclose(out, ref, rtol=rtol, atol=atol,
                                     equal_nan=True))
            max_err = max(max_err, err)
            print(f"phase 2: {name} D={D} C={Cc} w_r={plan.w_r - cut} "
                  f"base={base_kind} sigma=[{sig[0]:.3f},{sig[1]:.3f}] "
                  f"{str(dtype)[6:]}: max|kernel-plain|={err:.3e} (|plain|max "
                  f"{float(ref.nan_to_num().abs().max()):.2f}, NaN "
                  f"{int(ref.isnan().sum())}) ok={ok}", flush=True)
            if not ok:
                raise RuntimeError(f"epiband kernel disagrees with its plain "
                                   f"version ({name}, {dtype})")

    # timings at the main path's dtype and bases, stage by stage
    stages = {}
    for name, D, base_kind, sig, Cc, _ in (cases[0], cases[4]):
        fr, fs, base, sigma = epiband_case(
            torch, rng, plan.h_r, plan.w_r, ws_v, Cc, D, base_kind, sig,
            torch.bfloat16, stage0)
        ms, device_ms = cuda_ms_both(
            torch, lambda: eb.epiband(fr, fs, base, sigma, D, s_v))
        plain = cuda_ms(
            lambda: eb.epiband_reference(fr, fs, base, sigma, D, s_v), 3)
        bound, by = epiband_bounds(torch, fr, fs, base, sigma, D,
                                   s_v)["epiband_fwd"]
        stages[name] = dict(D=D, base=base_kind,
                            shape=[1, plan.h_r, plan.w_r, ws_v, Cc], ms=ms,
                            device_ms=device_ms, plain_ms=plain,
                            bound_ms=bound, bound_by=by)
        print(f"phase 2: {name} timing: kernel {ms:.4f} ms (device "
              f"{device_ms:.4f}){earlier('epiband_fwd', name)}, plain "
              f"{plain:.3f} ms, bound {bound:.4f} ms ({by})", flush=True)
    return max_err, stages


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    if not (REPO / "cermvs_torch" / "csrc" / "epiband.cu").is_file():
        raise SystemExit("chip_smoke: run it from a checkout of the "
                         "repository (cermvs_torch/ not found)")
    sys.path.insert(0, str(REPO))
    from cermvs_torch.models.raft import RAFT
    from cermvs_torch.ops import cudalib
    from cermvs_torch.ops import epiband as eb
    from cermvs_torch.ops import hatwarp as hw
    from cermvs_torch.ops import lookup as lk
    from cermvs_torch.ops.corr_rectified import RectifiedVolume
    from cermvs_torch.pipeline.inference import InferenceRunner, inference

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    # ---- phase 1: build ------------------------------------------------
    t0 = time.perf_counter()
    cudalib.build_all([eb.LIB, hw.LIB, lk.LIB], verbose=True)  # one nvcc each
    build_s = time.perf_counter() - t0
    print(f"phase 1: epiband.cu, hatwarp.cu and lookup.cu built in "
          f"{build_s:.1f} s", flush=True)

    # the slice's shapes come from the host plan of the full-size scene
    images, poses, intr = dtu_scene(H, W, NUM_FRAMES + 1)
    gen = torch.Generator().manual_seed(0)
    model = RAFT(test_mode=True, generator=gen)  # DTU defaults, bf16
    runner = InferenceRunner(model=model, construction="rectified",
                             device="cuda")
    order = runner.neighbor_order(poses)
    plan = runner.plan_for(poses[order], intr[order], 1.0, (H, W))
    if not plan.ok:
        raise RuntimeError(f"DTU scene rejected by the planner: {plan.reason}")
    print(f"plan: h_r={plan.h_r} w_r={plan.w_r} s_max={plan.s_max} "
          f"ws_r={plan.ws_r} twopass={plan.twopass} "
          f"view_s_max={plan.view_s_max}", flush=True)
    # ---- phase 2: kernel vs plain on the card -----------------------------
    max_err, stages = phase_epiband_kernel(torch, plan, model)

    # ---- phase 3: the lookup kernels vs plain on the card ------------------
    lookup_rows = phase_lookup_kernels(torch)

    # ---- phase 4: the slice at full width ---------------------------------
    torch.backends.cudnn.allow_tf32 = True  # the bf16 model's own setting
    runner(images, poses, intr, 1.0)  # warm-up (cuDNN autotune, allocator)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cudalib.reset_launches()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        disp = runner.submit(images, poses, intr, 1.0)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    infer_launches = {k: cudalib.launches.get(k, 0) for k in KERNELS}
    peak = torch.cuda.max_memory_allocated()
    V = NUM_FRAMES
    # per forward and view: an epiband launch per stage; two hat passes for
    # each of the two feature warps and each stage's volume back-warp
    expect = {k: 0 for k in KERNELS}
    expect.update(epiband_fwd=3 * len(model.cascade) * V,
                  hat_rows_fwd=3 * (2 + len(model.cascade)) * 2 * V)
    d = disp[0].float().cpu().numpy()
    print(f"phase 4: rectified {[round(t, 4) for t in times]} s/view, "
          f"path={runner.last_path}, launches={infer_launches} "
          f"(expected {expect}), peak {peak / 2**30:.2f} GiB, disparity "
          f"{d.shape} range [{d.min():.3e}, {d.max():.3e}]", flush=True)
    if runner.last_path != "rectified":
        raise RuntimeError("the rectified construction was not taken")
    if infer_launches != expect:
        raise RuntimeError(f"launches {infer_launches} != {expect}")
    if d.shape != (H // 4, W // 4) or not np.isfinite(d).all():
        raise RuntimeError(f"bad disparity: shape {d.shape}, finite "
                           f"{np.isfinite(d).all()}")

    if "--profile" in sys.argv:
        prof = profile_call(
            torch, lambda: runner.submit(images, poses, intr, 1.0))
        print(json.dumps({"profile_rectified": prof}), flush=True)

    exact = InferenceRunner(model=model, construction="exact", device="cuda")
    exact(images, poses, intr, 1.0)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t_exact = []
    for _ in range(3):
        t0 = time.perf_counter()
        de = exact.submit(images, poses, intr, 1.0)
        torch.cuda.synchronize()
        t_exact.append(time.perf_counter() - t0)
    peak_exact = torch.cuda.max_memory_allocated()
    de = de[0].float().cpu().numpy()
    print(f"phase 4: exact {[round(t, 4) for t in t_exact]} s/view, path="
          f"{exact.last_path}, peak {peak_exact / 2**30:.2f} GiB, "
          f"finite={np.isfinite(de).all()}", flush=True)
    if de.shape != d.shape or not np.isfinite(de).all():
        raise RuntimeError("bad exact-construction disparity")
    if "--profile" in sys.argv:
        prof = profile_call(
            torch, lambda: exact.submit(images, poses, intr, 1.0))
        print(json.dumps({"profile_exact": prof}), flush=True)
    del runner, exact

    # correctness on a small lateral scene (fp32, no TF32): rectification is
    # lossless there, so rectified (kernel), rectified (plain epiband) and
    # exact must agree. The delta heads are damped so the disparities stay
    # inside the hypothesis slabs and the volumes steer the result.
    torch.backends.cudnn.allow_tf32 = False
    small = RAFT(test_mode=True, dtype=torch.float32,
                 generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        for i in range(len(small.cascade)):
            getattr(small.update_block, f"delta{i}")[2].weight.mul_(1e-3)
    im_s, po_s, k_s = lateral_scene(128, 256, 5)
    r_rect = InferenceRunner(model=small, construction="rectified",
                             rect_lambda_max=0.1, device="cuda")
    r_exact = InferenceRunner(model=small, construction="exact",
                              device="cuda")
    cudalib.reset_launches()
    a = r_rect.submit(im_s, po_s, k_s, 1.0)[0].cpu().numpy()
    small_launches = cudalib.launches.get("epiband_fwd", 0)
    order_s = r_rect.neighbor_order(po_s)
    plan_s = r_rect.plan_for(po_s[order_s], k_s[order_s], 1.0, (128, 256))
    with torch.no_grad():
        b = r_rect.model(
            torch.from_numpy(im_s[order_s]).to(torch.bfloat16).cuda()[None],
            torch.from_numpy(po_s[order_s]).cuda()[None],
            torch.from_numpy(k_s[order_s]).cuda()[None],
            torch.ones(1, device="cuda"),
            volume_fn=RectifiedVolume(plan_s, impl="oracle"))
    b = b[0].cpu().numpy()
    c = r_exact.submit(im_s, po_s, k_s, 1.0)[0].cpu().numpy()
    e_kp = float(np.abs(a - b).max())
    e_re = float(np.abs(a - c).max())
    print(f"phase 4: small lateral scene: |kernel-plain| {e_kp:.3e}, "
          f"|rectified-exact| {e_re:.3e}, |disp| max {np.abs(c).max():.3e}, "
          f"path={r_rect.last_path}, launches={small_launches}", flush=True)
    if r_rect.last_path != "rectified" or small_launches == 0:
        raise RuntimeError("small scene did not take the rectified path")
    np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-8)
    np.testing.assert_allclose(a, c, rtol=1e-3, atol=1e-7)
    # the whole forward with the fused lookup kernel against the banded
    # lookup of the materialized pyramid: the taps differ in rounding only
    small.lookup_impl = "pallas"
    cudalib.reset_launches()
    d_fused = r_rect.submit(im_s, po_s, k_s, 1.0)[0].cpu().numpy()
    fused_launches = cudalib.launches.get("lookup_fused_fwd", 0)
    small.lookup_impl = "banded"
    e_fb = float(np.abs(d_fused - a).max())
    print(f"phase 4: small lateral scene, fused lookup: |fused-banded| "
          f"{e_fb:.3e}, lookup launches {fused_launches}", flush=True)
    check_launches({"lookup_fused_fwd": fused_launches},
                   {"lookup_fused_fwd": sum(s[2] for s in small.cascade)},
                   "fused-lookup forward")
    np.testing.assert_allclose(d_fused, a, rtol=1e-4, atol=1e-8)

    # ---- phase 5: inference() writes the PFM contract ----------------------
    class _Loader:
        class dataset:
            num_frames = NUM_FRAMES

        def __iter__(self):
            for ref in range(2):
                im, po, k = dtu_scene(96, 128, NUM_FRAMES + 1, seed=ref)
                yield im, po, k, [f"{ref:08d}"], 1.0

    build = REPO / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as out_dir:
        inference(_Loader(), model=RAFT(test_mode=True, generator=gen),
                  output_folder=out_dir, device="cuda")
        names = sorted(p.name for p in (Path(out_dir) / "depths").iterdir())
    print(f"phase 5: wrote {names}", flush=True)
    if names != [f"{r:08d}_scale1_nf{NUM_FRAMES}.pfm" for r in range(2)]:
        raise RuntimeError(f"unexpected PFM names {names}")

    del model, small, r_rect, r_exact
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(dir=build) as root:
        demo = phase_demo(torch, Path(root))
        true_fusion = phase_true_fusion(torch, Path(root))

    with tempfile.TemporaryDirectory(dir=build) as tree:
        train_plan, train_batch = plan_training_batch(torch, tree)
        rows = phase_training_kernels(torch, train_plan, train_batch)
        training = phase_train(torch, tree, train_plan, train_batch)
        fused_training = phase_train_pallas(torch, tree, train_plan,
                                            train_batch)
    rows.update(lookup_rows)

    s0 = stages["stage0"]
    rows["epiband_fwd"] = {
        "max_abs_err": max_err, "ms": s0["ms"], "plain_ms": s0["plain_ms"],
        "bound_ms": s0["bound_ms"], "bound_by": s0["bound_by"],
        "device_ms": s0["device_ms"], "library_ms": None, "stages": stages}
    # the demo's plans: errors into each row, rescale 2's times beside
    for name, err in demo.pop("kernel_errs").items():
        rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"], err)
    for name, row in demo.pop("kernel_rows_rescale2").items():
        rows[name]["demo_rescale2"] = row
    by_path = {"inference": infer_launches, "demo": demo["launches"],
               "training": training["launches"],
               "training_fused_lookup": fused_training["launches"]}
    # launches: the main path's count of each kernel: the demo's for the
    # fused lookup forward, the fused-lookup training run's for its
    # gradient (the prefix-sum variant is on no path), training's for the
    # rest
    main_path = {name: "training" for name in KERNELS}
    main_path.update(lookup_fused_fwd="demo", lookup_fused_v2="demo",
                     lookup_fused_bwd="training_fused_lookup")
    kernels = []
    for name in KERNELS:
        src, replaces = SOURCES[name]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces,
                        "launches": by_path[main_path[name]][name],
                        "launches_by_path": {
                            path: counts[name]
                            for path, counts in by_path.items()},
                        **rows[name]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"slice": {
        "rectified_s_per_view": times, "exact_s_per_view": t_exact,
        "rectified_peak_bytes": peak, "exact_peak_bytes": peak_exact,
        "train_s_per_step": training["s_per_step"],
        "train_peak_bytes": training["peak_bytes"],
        "train_steps": training["steps"], "train_plan": training["plan"],
        "demo": demo, "true_fusion": true_fusion,
        "fused_lookup_training": {k: v for k, v in fused_training.items()
                                  if k != "launches"},
        "build_s": build_s, "card": smi,
        "total_s": time.perf_counter() - T_START}}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()

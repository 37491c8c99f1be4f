#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``cermvs_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA card and ``nvcc``.
Phases (any failure raises, so the exit code is non-zero):

  1. build the kernels from ``cermvs_torch/csrc`` (``epiband.cu``,
     ``hatwarp.cu``), one nvcc each, all at once;
  2. hold the epiband forward kernel against its plain PyTorch version on
     the card at the DTU slice's shapes (stage 0: D=64, base == 0; stage 1:
     D=44 with bases inside and outside the band and with the main path's
     bases; narrow and wide sigma; fp32 and bf16), and time both stages on
     the main path's bases;
  3. drive the port's depth inference (``InferenceRunner``) at full DTU width
     — 1152x1600 images, 11 views, cascade (64,64,8)/(44,320,8), HR encoders,
     bf16, random weights from a seed — through the rectified construction
     (epiband and hat kernels) and through the exact one (one warm-up, three
     timed forwards each), and check the result: finite (288, 400)
     disparities, the launch counts, and rectified-vs-exact and
     kernel-vs-plain agreement on a small lateral-motion scene, where
     rectification is lossless;
  4. run ``inference()`` on a two-item in-memory loader and check the PFM
     names;
  5. write a synthetic DTU training tree (one scan, one light, 1200x1600
     PNGs and PFM depths, 49 cameras on an arc), plan its first training
     batch, and hold the epiband backward kernels and the hat-resample
     kernels against their plain versions at that plan's shapes (fp32 and
     bf16), with their times, bounds and, for the hat kernels, the time of
     one ``grid_sample`` call (forward) and of one
     ``grid_sampler_2d_backward`` call (transpose);
  6. train through ``train()`` with ``train_DTU.gin``'s bindings (rectified,
     batch 2, nf10, crop 1056x1440) for four steps, time the last three, and
     check the two-pass plan, finite loss and gradients, all five kernels'
     launch counts, and that the checkpoint restores its step.

Prints the card's name and power limit, a ``{"kernels": [...]}`` line, and
last ``{"ok": true, "device": {...}}``. Needs no network and one card.
``--profile`` adds a torch.profiler breakdown of one forward per
construction (device time per RAFT.forward range, top kernels, busy share).
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
H, W = 1152, 1600          # DTU images, cropped to the encoder stride
NUM_FRAMES = 10            # neighbours; 11 views in all
PEAK_BYTES_S = 3.35e12     # H100 SXM HBM3
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # dense, non-TF32 fp32
DTU_HW = (1200, 1600)      # DTU training images and depths
TRAIN_STEPS = 3            # train.num_steps: 4 steps, the first a warm-up
KERNELS = ("epiband_fwd", "epiband_bwd_dfr", "epiband_bwd_dfs",
           "hat_rows_fwd", "hat_rows_bwd")
_EB, _HW = "cermvs_torch/csrc/epiband.cu", "cermvs_torch/csrc/hatwarp.cu"
SOURCES = {  # kernel: (source, the TPU kernel's entry it replaces)
    "epiband_fwd": (_EB, "cermvs_tpu/ops/pallas/epiband.py:529"),
    "epiband_bwd_dfr": (_EB, "cermvs_tpu/ops/pallas/epiband.py:919"),
    "epiband_bwd_dfs": (_EB, "cermvs_tpu/ops/pallas/epiband.py:919"),
    "hat_rows_fwd": (_HW, "cermvs_tpu/ops/pallas/hatwarp.py:119"),
    "hat_rows_bwd": (_HW, "cermvs_tpu/ops/pallas/hatwarp.py:155"),
}


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


def write_dtu_tree(root, h, w, num_frames, scan="scan113", light=0, seed=0):
    """A DTU training tree for one scan and one light: ``Rectified/`` PNGs
    and ``Depths/`` PFMs of h x w (image/depth ratio 1), 49 cameras from
    :func:`dtu_arc_poses` with the DTU focal (2892 px at 1600 wide), and a
    ``pair.txt`` listing each view's ``num_frames`` nearest views. The 49
    views share 11 textures (hard links): the dataset indexes 49 views per
    scan, a step reads 2 x 11 of them, and what they show does not change
    the work."""
    import cv2

    from cermvs_torch.data.cams import write_cam_file
    from cermvs_torch.io.pfm import write_pfm

    root = Path(root)
    for d in ("Cameras", f"Rectified/{scan}", f"Depths/{scan}"):
        (root / d).mkdir(parents=True, exist_ok=True)
    poses = dtu_arc_poses()
    n = len(poses)
    f = 2892.0 * w / 1600
    K = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]])
    centers = np.stack([-P[:3, :3].T @ P[:3, 3] for P in poses])
    dist = np.linalg.norm(centers[:, None] - centers[None], axis=-1)
    lines = [f"{n}\n"]
    for i in range(n):
        write_cam_file(root / "Cameras" / f"{i:08d}_cam.txt", poses[i], K,
                       aux=[425.0, 2.5])
        near = [int(j) for j in np.argsort(dist[i], kind="stable")
                if j != i][:num_frames]
        lines += [f"{i}\n", f"{len(near)} " + " ".join(
            f"{j} {100.0 - r:.1f}" for r, j in enumerate(near)) + "\n"]
    (root / "Cameras" / "pair.txt").write_text("".join(lines))

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
                 stage0=None):
    """Inputs of one epiband call. base_kind None: base == 0 (stage 0);
    "band": bases inside and outside the band, so slabs fall partly or
    wholly off either end of the source row; "main": the main path's
    stage-1 bases (``main_path_base``, stage0 = (d0, ratio))."""
    dev = "cuda"
    fr = torch.from_numpy(rng.randn(1, h_r, w_r, C).astype(np.float32))
    fs = torch.from_numpy(rng.randn(1, h_r, ws, C).astype(np.float32))
    sigma = rng.uniform(sig[0], sig[1], (1, h_r, w_r)).astype(np.float32)
    base = None
    if base_kind == "band":
        base = rng.uniform(-(ws - w_r) / 2, ws, (1, h_r, w_r))
    elif base_kind == "main":
        base = main_path_base(rng, sigma, stage0[0], D, stage0[1])
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
    row (slope S/O) with sub-pixel jitter, a few rows fully outside."""
    img = torch.from_numpy(rng.randn(R, S, C).astype(np.float32))
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
    (``prefix``), the top kernels by self device time, and the
    device-busy share of the wall time."""
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
    return {"wall_ms": wall * 1e3, "device_busy_ms": busy,
            "busy_share": busy / (wall * 1e3), "spans_ms": spans,
            "top_self_device_ms": [[e.key[:90], e.count,
                                    dev(e, own=True) / 1e3] for e in top]}


def configure_training(tree):
    """``train_DTU.gin``'s bindings, the synthetic tree and one light."""
    from cermvs_torch import config as pcfg

    pcfg.clear_config()
    pcfg.parse_config_file(str(REPO / "configs" / "train_DTU.gin"))
    pcfg.bind_parameter("DTU.dataset_path", str(tree))
    pcfg.bind_parameter("DTU.light_number", 0)
    pcfg.bind_parameter("train.num_steps", TRAIN_STEPS)


def phase5_plan(torch, tree):
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
    print(f"phase 5: DTU tree {DTU_HW} written and first batch "
          f"{batch['images'].shape} planned in "
          f"{time.perf_counter() - t0:.1f} s: h_r={plan.h_r} w_r={plan.w_r} "
          f"s_max={plan.s_max} ws_r={plan.ws_r} twopass={plan.twopass} "
          f"view_s_max={plan.view_s_max}", flush=True)
    if not (plan.ok and plan.twopass):
        raise RuntimeError(f"training batch not planned two-pass: {plan}")
    return plan, batch


def phase5_kernels(torch, plan, batch):
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
    C, d0, d1 = 64, 64, 44
    inc0, inc1 = 0.0025 / 64, 0.0025 / 320
    errs = {k: 0.0 for k in KERNELS[1:]}
    rows = {k: {"stages": {}} for k in KERNELS[1:3]}
    rows.update({k: {"shapes": {}} for k in KERNELS[3:]})
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
            for name, a, b in zip(KERNELS[1:3], got, ref):
                err = float((a.float() - b.float()).abs().max())
                errs[name] = max(errs[name], err)
                # bf16: the plain version's roundings, so few elements differ
                differ = float((a != b).float().mean())
                ok = bool(torch.allclose(a.float(), b.float(), rtol=rtol,
                                         atol=atol)) and (
                    dtype != torch.bfloat16 or differ < 0.01)
                print(f"phase 5: {name} {stage} D={D} {str(dtype)[6:]}: "
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
                print(f"phase 5: {name} {stage} timing: kernel {ms:.4f} ms, "
                      f"plain (both gradients) {plain:.3f} ms, bound "
                      f"{bounds[name][0]:.4f} ms ({bounds[name][1]})",
                      flush=True)

    h, w = (s // 4 for s in batch["images"].shape[2:4])
    shapes = {"feature_warp": (h, w, ws_v, C),      # src warp, pass 1
              "volume_back_warp": (plan.h_r, plan.w_r, w, d0)}  # pass 1
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
                print(f"phase 5: {name} {shape_name} {(R, S, O, Cc)} "
                      f"{str(dtype)[6:]}: max|kernel-plain|={err:.3e} ok={ok}",
                      flush=True)
                if not ok:
                    raise RuntimeError(f"{name} disagrees with its plain "
                                       f"version ({shape_name}, {dtype})")
            if dtype != torch.bfloat16:
                continue
            bounds = hat_bounds(torch, img, pos)
            lib = grid_sample_rows(torch, img, pos)
            lib_bwd = grid_sample_rows_backward(torch, img, pos, dout)
            lib_err = {
                "hat_rows_fwd": float((lib()[:, :, 0].permute(0, 2, 1) - out)
                                      .abs().max()),
                "hat_rows_bwd": float((lib_bwd() - dimg.float()).abs().max())}
            timing = {
                "hat_rows_fwd": (
                    cuda_ms(lambda: hw.hat_resample_rows(img, pos), 20),
                    cuda_ms(lambda: hw.hat_resample_rows_reference(img, pos),
                            3),
                    cuda_ms(lib, 20)),
                "hat_rows_bwd": (
                    cuda_ms(lambda: hw.hat_rows_backward(dout, pos, S, dtype),
                            20),
                    cuda_ms(lambda: hw.hat_resample_rows_backward_reference(
                        dout, pos, S, dtype), 3),
                    cuda_ms(lib_bwd, 20))}
            for name, (ms, plain, lib_ms) in timing.items():
                rows[name]["shapes"][shape_name] = dict(
                    shape=[R, S, O, Cc], ms=ms, plain_ms=plain,
                    library_ms=lib_ms, bound_ms=bounds[name][0],
                    bound_by=bounds[name][1])
                print(f"phase 5: {name} {shape_name} timing: kernel "
                      f"{ms:.4f} ms, plain {plain:.3f} ms, library "
                      f"{lib_ms:.4f} ms (grid_sample |diff| "
                      f"{lib_err[name]:.2e}), bound "
                      f"{bounds[name][0]:.4f} ms ({bounds[name][1]})",
                      flush=True)
    # the report's row: stage 0 and the feature warp, the largest launches
    for name in KERNELS[1:]:
        main = (rows[name]["stages"]["stage0"] if "stages" in rows[name]
                else rows[name]["shapes"]["feature_warp"])
        rows[name].update(max_abs_err=errs[name], ms=main["ms"],
                          plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
                          bound_by=main["bound_by"],
                          library_ms=main.get("library_ms"))
    return rows


def phase6_train(torch, tree, plan5, batch5):
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
        print(f"phase 6: step {state.step}: loss {metrics['loss']:.5f} "
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
                "hat_rows_bwd": B * V * (2 + S) * 2}
    expect = {k: steps * v for k, v in per_step.items()}
    s_per_step = [b[0] - a[0] for a, b in zip(records, records[1:])]
    print(f"phase 6: {steps} steps in {wall:.1f} s, s/step after the first "
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
    print(f"phase 6: checkpoints at steps {mgr.all_steps()}, restore resumes "
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
        print(json.dumps({"profile_train_step": prof}), flush=True)
    plans = {(p.h_r, p.w_r, p.ws_r, p.view_s_max) for _, _, p in records}
    return {"launches": launches, "s_per_step": s_per_step,
            "peak_bytes": peak, "steps": steps,
            "plan": [list(p[:3]) + [list(p[3])] for p in sorted(plans)]}


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
    cudalib.build_all([eb.LIB, hw.LIB], verbose=True)  # one nvcc each
    build_s = time.perf_counter() - t0
    print(f"phase 1: epiband.cu and hatwarp.cu built in {build_s:.1f} s",
          flush=True)

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

    # ---- phase 2: kernel vs plain on the card -----------------------------
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.RandomState(0)
    max_err = 0.0
    cases = [("stage0", d0, None, wide), ("stage0", d0, None, narrow),
             ("stage1", d1, "band", narrow), ("stage1", d1, "band", wide),
             ("stage1", d1, "main", narrow)]
    for dtype, rtol, atol in ((torch.float32, 1e-4, 1e-3),
                              (torch.bfloat16, 1e-3, 1e-2)):
        for name, D, base_kind, sig in cases:
            fr, fs, base, sigma = epiband_case(
                torch, rng, plan.h_r, plan.w_r, ws_v, C, D, base_kind, sig,
                dtype, stage0)
            out = eb.epiband(fr, fs, base, sigma, D, s_v)
            torch.cuda.synchronize()
            ref = eb.epiband_reference(fr, fs, base, sigma, D, s_v)
            err = float((out - ref).abs().max())
            ok = bool(torch.allclose(out, ref, rtol=rtol, atol=atol))
            max_err = max(max_err, err)
            print(f"phase 2: {name} D={D} base={base_kind} "
                  f"sigma=[{sig[0]:.3f},{sig[1]:.3f}] {str(dtype)[6:]}: max|kernel-plain|={err:.3e} "
                  f"(|plain|max {float(ref.abs().max()):.2f}) ok={ok}",
                  flush=True)
            if not ok:
                raise RuntimeError(f"epiband kernel disagrees with its plain "
                                   f"version ({name}, {dtype})")

    # timings at the main path's dtype and bases, stage by stage
    stages = {}
    for name, D, base_kind, sig in (cases[0], cases[4]):
        fr, fs, base, sigma = epiband_case(
            torch, rng, plan.h_r, plan.w_r, ws_v, C, D, base_kind, sig,
            torch.bfloat16, stage0)
        ms = cuda_ms(lambda: eb.epiband(fr, fs, base, sigma, D, s_v), 50)
        plain = cuda_ms(
            lambda: eb.epiband_reference(fr, fs, base, sigma, D, s_v), 3)
        bound, by = epiband_bounds(torch, fr, fs, base, sigma, D,
                                   s_v)["epiband_fwd"]
        stages[name] = dict(D=D, base=base_kind,
                            shape=[1, plan.h_r, plan.w_r, ws_v, C], ms=ms, plain_ms=plain, bound_ms=bound,
                            bound_by=by)
        print(f"phase 2: {name} timing: kernel {ms:.4f} ms, plain "
              f"{plain:.3f} ms, bound {bound:.4f} ms ({by})", flush=True)

    # ---- phase 3: the slice at full width ---------------------------------
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
    print(f"phase 3: rectified {[round(t, 4) for t in times]} s/view, "
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
    print(f"phase 3: exact {[round(t, 4) for t in t_exact]} s/view, path="
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
    print(f"phase 3: small lateral scene: |kernel-plain| {e_kp:.3e}, "
          f"|rectified-exact| {e_re:.3e}, |disp| max {np.abs(c).max():.3e}, "
          f"path={r_rect.last_path}, launches={small_launches}", flush=True)
    if r_rect.last_path != "rectified" or small_launches == 0:
        raise RuntimeError("small scene did not take the rectified path")
    np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-8)
    np.testing.assert_allclose(a, c, rtol=1e-3, atol=1e-7)

    # ---- phase 4: inference() writes the PFM contract ----------------------
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
    print(f"phase 4: wrote {names}", flush=True)
    if names != [f"{r:08d}_scale1_nf{NUM_FRAMES}.pfm" for r in range(2)]:
        raise RuntimeError(f"unexpected PFM names {names}")

    with tempfile.TemporaryDirectory(dir=build) as tree:
        train_plan, train_batch = phase5_plan(torch, tree)
        rows = phase5_kernels(torch, train_plan, train_batch)
        training = phase6_train(torch, tree, train_plan, train_batch)

    s0 = stages["stage0"]
    rows["epiband_fwd"] = {
        "max_abs_err": max_err, "ms": s0["ms"], "plain_ms": s0["plain_ms"],
        "bound_ms": s0["bound_ms"], "bound_by": s0["bound_by"],
        "library_ms": None, "stages": stages}
    kernels = []
    for name in KERNELS:
        src, replaces = SOURCES[name]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces,
                        "launches": training["launches"][name],
                        "launches_by_path": {
                            "inference": infer_launches[name],
                            "training": training["launches"][name]},
                        **rows[name]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"slice": {
        "rectified_s_per_view": times, "exact_s_per_view": t_exact,
        "rectified_peak_bytes": peak, "exact_peak_bytes": peak_exact,
        "train_s_per_step": training["s_per_step"],
        "train_peak_bytes": training["peak_bytes"],
        "train_steps": training["steps"], "train_plan": training["plan"],
        "build_s": build_s, "card": smi}}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()

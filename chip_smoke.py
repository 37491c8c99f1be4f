#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``cermvs_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA card and ``nvcc``.
Phases (any failure raises, so the exit code is non-zero):

  1. build the epiband kernel from ``cermvs_torch/csrc`` with nvcc;
  2. hold the kernel against its plain PyTorch version on the card at the
     DTU slice's shapes (stage 0: D=64, base == 0; stage 1: D=44 with bases
     inside and outside the band and with the main path's bases; narrow and
     wide sigma; fp32 and bf16), and time both stages on the main path's
     bases;
  3. drive the port's depth inference (``InferenceRunner``) at full DTU width
     — 1152x1600 images, 11 views, cascade (64,64,8)/(44,320,8), HR encoders,
     bf16, random weights from a seed — through the rectified construction
     and through the exact one (one warm-up, three timed forwards each), and
     check the result: finite (288, 400) disparities, the epiband launch
     count, and rectified-vs-exact and kernel-vs-plain agreement on a small
     lateral-motion scene, where rectification is lossless;
  4. run ``inference()`` on a two-item in-memory loader and check the PFM
     names.

Prints the card's name and power limit, a ``{"kernels": [...]}`` line, and
last ``{"ok": true, "device": {...}}``. Needs no network and one card.
``--profile`` adds a torch.profiler breakdown of one forward per
construction (device time per RAFT.forward range, top kernels, busy share).
"""

import json
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


def epiband_bound(torch, fr, fs, base, sigma, D, s_max):
    """Least time for the work of these inputs: the bytes it must move over
    the memory rate, against its flops over the peak rate of the inputs'
    type. Bytes: the fr rows of pixels with an in-band tap, the fs columns
    that some in-band tap of the row reaches, base and sigma, each read
    once, and the fp32 volume written once. Flops: 2*C per in-band tap and
    4 per output (the lerp)."""
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
    nbytes = ((pixels + cols) * C * fr.element_size() + sigma.numel() * 4
              + (0 if base is None else base.numel() * 4)
              + V * h_r * w_r * D * 4)
    taps = int(ok0.sum() + ok1.sum())
    flops = 2 * C * taps + 4 * V * h_r * w_r * D
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[str(fr.dtype).split(".")[-1]] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def profile_forward(torch, runner, images, poses, intr):
    """One rectified forward under torch.profiler: device time per named
    range of RAFT.forward, the top kernels by self device time, and the
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
        runner.submit(images, poses, intr, 1.0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = prof.key_averages()
    spans = {e.key: dev(e) / 1e3 for e in rows if e.key.startswith("raft.")}
    # device-side rows only (kernels, copies): operator rows repeat their
    # kernels' time
    kernels = [e for e in rows if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.key.startswith("raft.")]
    busy = sum(dev(e, own=True) for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: dev(e, own=True), reverse=True)[:15]
    return {"wall_ms": wall * 1e3, "device_busy_ms": busy,
            "busy_share": busy / (wall * 1e3), "spans_ms": spans,
            "top_self_device_ms": [[e.key[:90], e.count,
                                    dev(e, own=True) / 1e3] for e in top]}


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    if not (REPO / "cermvs_torch" / "csrc" / "epiband.cu").is_file():
        raise SystemExit("chip_smoke: run it from a checkout of the "
                         "repository (cermvs_torch/ not found)")
    sys.path.insert(0, str(REPO))
    from cermvs_torch.models.raft import RAFT
    from cermvs_torch.ops import epiband as eb
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
    eb.build(verbose=True)
    print(f"phase 1: epiband built in {time.perf_counter() - t0:.1f} s",
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
        bound, by = epiband_bound(torch, fr, fs, base, sigma, D, s_v)
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
    eb.reset_launches()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        disp = runner.submit(images, poses, intr, 1.0)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = eb.launches
    peak = torch.cuda.max_memory_allocated()
    V = NUM_FRAMES
    expect = 3 * len(model.cascade) * V
    d = disp[0].float().cpu().numpy()
    print(f"phase 3: rectified {[round(t, 4) for t in times]} s/view, "
          f"path={runner.last_path}, epiband launches={launches} "
          f"(expected {expect}), peak {peak / 2**30:.2f} GiB, disparity "
          f"{d.shape} range [{d.min():.3e}, {d.max():.3e}]", flush=True)
    if runner.last_path != "rectified":
        raise RuntimeError("the rectified construction was not taken")
    if launches != expect:
        raise RuntimeError(f"epiband launches {launches} != {expect}")
    if d.shape != (H // 4, W // 4) or not np.isfinite(d).all():
        raise RuntimeError(f"bad disparity: shape {d.shape}, finite "
                           f"{np.isfinite(d).all()}")

    if "--profile" in sys.argv:
        prof = profile_forward(torch, runner, images, poses, intr)
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
        prof = profile_forward(torch, exact, images, poses, intr)
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
    eb.reset_launches()
    a = r_rect.submit(im_s, po_s, k_s, 1.0)[0].cpu().numpy()
    small_launches = eb.launches
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

    s0 = stages["stage0"]
    print(json.dumps({"kernels": [{
        "name": "epiband", "route": "cuda",
        "source": "cermvs_torch/csrc/epiband.cu",
        "replaces": "cermvs_tpu/ops/pallas/epiband.py:529",
        "launches": launches, "max_abs_err": max_err,
        "ms": s0["ms"], "plain_ms": s0["plain_ms"],
        "bound_ms": s0["bound_ms"], "bound_by": s0["bound_by"],
        "library_ms": None, "stages": stages}]}), flush=True)
    print(json.dumps({"slice": {
        "rectified_s_per_view": times, "exact_s_per_view": t_exact,
        "rectified_peak_bytes": peak, "exact_peak_bytes": peak_exact,
        "card": smi}}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()

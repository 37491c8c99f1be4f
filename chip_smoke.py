#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``cermvs_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA card and ``nvcc``.
Phases (any failure raises, so the exit code is non-zero):

  1. build the kernels from ``cermvs_torch/csrc`` (``epiband.cu``,
     ``hatwarp.cu``, ``lookup.cu``), one nvcc each, all at once, and beside
     them the host data runtime (``dataio.cpp``, g++, ``io/native.py``);
     hold this host's build of the runtime against its numpy version at the
     DTU and BlendedMVS training crops (and its PFM codec against the
     Python reader), and ``BasicEncoder(norm_fn="group")`` on the card
     against the CPU;
  2. hold the epiband forward kernel against its plain PyTorch version on
     the card at the DTU slice's shapes (stage 0: D=64, base == 0; stage 1:
     D=44 with bases inside and outside the band and with the main path's
     bases; narrow and wide sigma; fp32 and bf16), and at the kernel's
     edges (a stage-1 tile band wider than one chunk, tap pairs
     straddling a chunk edge, bases of +-1e5 and NaN, a ragged w_r, C = 44
     and 16); time both stages on the main path's bases, back to back
     (``ms``) and in device time (``device_ms``, a CUDA graph of launches),
     with bf16 features (beside the first design's back-to-back time) and
     with fp32 features (the split 3xTF32 product, beside the first
     design's device time), each beside its bound;
  3. hold the fused lookup kernels (forward, gradient, prefix-sum) against
     their plain versions at phase 4's (1,1,288,400,D), the demo's
     (1,1,300,400,D) and (1,1,600,800,D) and the training batch's
     (2,1,264,360,D) volumes, D = 64 and 44, with their times (the L2
     flushed before each launch, back to back and in device time, beside
     the earlier designs' times), plain times and bounds;
  4. drive the port's depth inference (``InferenceRunner``) at full DTU width
     — 1152x1600 images, 11 views, cascade (64,64,8)/(44,320,8), HR encoders,
     bf16, random weights from a seed — through the rectified construction
     (epiband and hat kernels) and through the exact one, each through the
     runner's CUDA graphs: the first dispatch (eager, then the capture),
     three timed dispatches, then on frames routed once three replays and
     three eager forwards (``graphed_pass``: s/view, the route's seconds,
     replay against eager bit for bit, launches per replay equal to an
     eager forward's, peak memory allocated, reserved and in the graphs'
     pool), and check the result: finite (288, 400)
     disparities, the launch counts, and rectified-vs-exact, kernel-vs-plain
     and fused-vs-banded lookup agreement on a small lateral-motion scene,
     where rectification is lossless; the mixed construction: the same
     scene with two neighbours moved onto the reference's optical axis, so
     the full planner rejects it and "auto" rectifies the other eight
     (epiband and hat kernels held against their plain versions at that
     partial plan, the same graphed pass beside the rectified and exact
     passes, the launches per rectified view), and on a small scene with
     one forward neighbour, mixed against exact; then the same forward of
     the fp32 model, which the runner builds from the binding ``RAFT.dtype
     = "float32"`` as a ``-p`` flag gives it, rectified with TF32 off (the
     same graphed pass, the bf16 pass's launch counts, finite
     disparities);
  5. run ``inference()`` on a two-item in-memory loader and check the PFM
     names; then view batching: ``inference()`` over eight items of
     384x512 with six neighbours at view_batch 1 and 4 under "auto" and 4
     under "rectified" (which warns), maps/s over the items cycled eight
     times (64 maps) and each record's route, and the fp32 model's depth
     maps at view_batch 4 against 1 ("exact", with and without cuDNN);
  6. the demo contract: write a synthetic DTU test scan (11 imaged views of
     1200x1600, 49 cameras on an arc) and random weights; plan it at
     rescale 1 and 2 as inference does and hold the epiband forward and hat
     kernels against their plain versions at those plans (the widest band
     and the largest grid; every hat pass, C = 64, 44 and 3; fp32 and
     bf16), timing them at rescale 2, both ways, with ``grid_sample``
     timed both ways beside the hat kernel; then
     run the port's CLIs with ``inference_DTU.gin`` and
     ``RAFT.lookup_impl="pallas"``: inference at rescale 1 (with the
     pinned side-stream upload, then without it) and 2, with maps/s,
     the pipeline-inclusive s/view, the seconds of each key's first
     dispatch (eager and graph capture) and the views where the graph key
     is new (checked against the scan's plans), peak memory allocated and
     reserved; multires, fusion at rescale 2 with view_batch 8; check
     every record's construction, the launches per forward and every
     file;
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
     batch 2, nf10, crop 1056x1440) and the JAX package's defaults that the
     file leaves unbound (the host data runtime's crop, ``RAFT.remat``:
     checked) for twelve steps through the state's
     StepRunner (a CUDA graph per batch shape and plan key: the first
     step eager, then its capture; a new plan's first step captured, then
     replayed; the others replayed): print each
     key's first-dispatch seconds (eager and capture), s/step over the
     replayed steps, peak memory allocated, reserved and in the graphs'
     pool; check at least three replays, that every step took the
     rectified construction and one at least its two-pass warps (a plan
     that is not two-pass warps by quad gathers), finite loss and
     gradients, the kernels' launch counts (a replay counts an eager
     step's), and that the checkpoint restores its step; time the host's
     plan and upload of phase 8's batch; from one snapshot of the state,
     two eager steps and a replay on that batch (each restored in place),
     the replay held to the eager steps' spread in loss, grad_norm,
     weights and AdamW moments; then on that batch from one set of seeded
     weights, ``RAFT.remat`` off, on and off again: an eager step each
     (the loss with remat held to the two others' spread, the largest
     gradient difference, peak allocated) and a fresh StepRunner's
     capture and replays (s/step, peak reserved, graph pool);
 10. train twelve steps the same way with the fused lookup, check its
     launches (32 forward, 16 of them recomputed by remat, and 16
     backward a step) and hold a replay
     against eager steps alike, and hold one step's loss from fixed
     weights on phase 8's batch against the banded lookup's;
 11. the demo's Tanks and Temples half: synthetic Ignatius (an orbit about
     an object) and Meetingroom (a forward walk with sideways sway) scans
     of 30 JPEGs of 1920x1056, camera files with an aux row, ``pair.txt``
     with 10 neighbours a view and one empty list; ``demo.run_tnt_depths``
     (rescale 1 nf15, rescale 2 nf25, multires) over views 0, 12 and 24
     of each (``get_test_data_loader.subset``) with each record's route,
     s/view, first-dispatch seconds and the peaks; each scan's fusion
     (``demo.run_tnt_fusion``) of those maps beside the other views' true
     depths, the cloud held to the true surface; one rescale-2 key
     through a runner's graph (replay against eager bit for bit); a
     runner's reserved memory, graph pool and host RSS as it captures six
     keys;
 12. ``demo_custom``'s three passes (0.5x nf10 writing the min-depth
     files, 1x nf15 and 2x nf25 reading them), multires and fusion on a
     TUM directory of 27 frames of 480x640: routes, s/view, the files;
 13. ``train()`` with ``train_BlendedMVS.gin`` (batch 2, nf10, crop
     1376x1824, rectified) for twelve steps through the step graphs on a
     synthetic BlendedMVS scene (1536x2048 JPEGs and PFM depths; orbit and
     sweep cameras and one forward-walk reference): each step's route,
     each key's first dispatch with the peaks after it, s/step, the
     launches; the walk's batch alone exact; a replay against eager steps;
     one batch read part by part in one thread (JPEG decode, float32
     cast, the PFM read native and in Python, ``np.median``, the scale and
     crop native and through cv2; one sample's native crop four times in a
     row and in four threads at once); the epiband forward and both
     gradients against their plain versions at the widest plan the run
     took (fp32 and bf16, both stages);
 14. the data and view axes (``parallel/``): (a) a world of one over NCCL
     on this card: ``InferenceRunner(mesh=make_mesh(1, 1))`` through the
     rectified, mixed and exact routes at phase 4's width, bit for bit the
     runner without a mesh, eager and replayed from a graph that holds the
     ``all_reduce`` (replays of both timed in turns), and ``train()`` with
     ``train_DTU.gin``'s bindings and ``data_parallel`` over that group on
     phase 8's batch six times, its losses, weights and AdamW moments
     bit for bit a run without a group, five steps replayed with the
     collective captured; (b) ``dryrun_multiprocess(2, "cuda")``: two gloo
     ranks sharing this card, the view-sharded forward (5 + 5 views,
     exact, rectified, mixed, and rectified with the mean, max and std
     aggregation, fp32 with two GRU iterations a stage; each frame
     encoded alone on both sides, the delta heads damped) against the unsharded one on each stage volume after the
     ``all_reduce`` and on the disparities, the max and std exchange alone
     against the model's aggregation on both ranks, the epiband and hat
     launches of both ranks summing to the unsharded forward's, a
     data-parallel step of phase 8's batch as 1 + 1 against the step of
     2 (exact and rectified; the ranks' plans exchanged), sharded fusion
     of a sphere's true depths against one process's cloud; (c) ``torchrun
     --nproc_per_node=1 -m cermvs_torch.launch_distributed -g train_DTU -p
     train.num_steps=1`` on phase 8's tree. Two ranks on one card show
     correctness and the split of the work, not scaling;
 15. the row and grid axes (``parallel/spatial.py``): (a) a ``(row,)``
     mesh of one NCCL rank (``make_row_mesh``) on phase 4's scene with the
     shipped model (delta heads damped): the exact and banded rectified
     routes through ``InferenceRunner(mesh=)``, a replay bit for bit the
     eager forward with the collectives in the graph, both against the
     runner without a mesh at ``SPATIAL_ONE_TOL``, replays timed in turns;
     (b) ``dryrun_spatial(4, "cuda")``: four gloo ranks sharing this card,
     rows over four (exact, banded rectified, exact with the mean, max and
     std) and a 2 x 2 grid (exact, rectified), fp32 with two GRU
     iterations a stage and TF32 off, each against the unsharded forward
     on each stage's owned rows (rebuilt from its origins) and on the
     disparities, each rank's epiband, hat and lookup launches (a row rank
     launches the unsharded forward's count, a grid's view ranks share
     it), its collectives timed alone, its seconds and peak; (c) a
     band-shaped epiband and hat launch (four row ranks' band of phase 4's
     plan) against their plain versions, timed.
 16. the tooling: (a) one fp32 train-mode forward of a small model on a
     lateral scene and its backward, each FLOP-counted
     (``utils/flops.count_flops``) on the CPU and on the card: the
     convolutions and products equal, each kernel's formula within
     KERNEL_COUNT_TOL; (b) the FLOPs of phase 4's rectified bf16 forward
     and of one ``train_DTU.gin`` step on phase 8's batch, each counted
     once eagerly, with the kernels' share, over the median replay of
     phase 4 and of phase 9's remat run, as TFLOP/s and MFU
     (``device_peak_flops``), each line with the card's name and power
     limit; (c) ``utils/memory.device_memory_stats`` and ``report``
     against ``torch.cuda.max_memory_allocated``, a ``ViewTimer`` record,
     and a ``utils/profiling.trace`` naming ``raft.encoders`` and
     ``epiband_mma_kernel``; (d) ``examples/e2e_synthetic`` on the card
     (3 views of 576x800: inference at rescale 1 and 2, multires, fusion)
     and its files, then the scan's true depths fused into points on its
     plane.

Each phase from 6 on first prints the device memory the phases before it
left (their runners' graph pools released).

Prints the card's name and power limit, a ``{"kernels": [...]}`` line, and
last ``{"ok": true, "device": {...}}``. Needs no network and one card.
``--profile`` adds a torch.profiler breakdown of one forward per
construction (eager for the ranges, and a replay for the busy share), of
one rescale-2 demo forward (the same two), of ``inference()`` over three
rescale-2 demo views with and without the pinned side-stream upload (its
host-to-device copy rows and busy share) and of one train step, eager and
replayed (device time per RAFT.forward range, top kernels, busy share; for
the step also a line with the device-busy time of each, the eager step's
dfr, dfs and hat_rows_bwd kernels' rows and its count of elementwise
launches; for the demo forward a line with the lookup_fused_fwd row; and
profiles of one fused-lookup train step, eager and replayed, with the
eager step's lookup_fused_fwd and lookup_fused_bwd rows).
"""

import copy
import gc
import itertools
import json
import os
import subprocess
import sys
import tempfile
import time
import types
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
T_START = time.perf_counter()
H, W = 1152, 1600          # DTU images, cropped to the encoder stride
NUM_FRAMES = 10            # neighbours; 11 views in all
DTU_HW = (1200, 1600)      # DTU training images and depths
TRAIN_STEPS = 11           # train.num_steps: 12 steps; the synthetic tree's
PALLAS_STEPS = 11          # batches took 3-5 plan keys in 6-8 steps
MIN_REPLAYS = 3            # replayed steps each training phase must take
REMAT_REPLAYS = 3          # phase 9's replays with RAFT.remat on and off
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
# atomics into a zeroed fp32 buffer (its memset and cast included), the
# thread-per-tap lookup forward, the thread-per-cell lookup gradient and
# the warp-per-pixel prefix-sum lookup (fp32, L2 flushed before each
# launch); the warp-per-pixel epiband forward with fp32 features in device
# time (a CUDA graph of launches).
# Printed in the phases' text beside this run's times; never part of the
# kernels line, which holds only this run's.
EARLIER_MS = {"epiband_fwd": {"stage0": 1.537, "stage1": 1.079,
                              "demo_rescale2": 5.125},
              "epiband_fwd_fp32": {"stage0": 1.4286, "stage1": 1.0031},
              "hat_rows_fwd": {"feature_warp": 0.115,
                               "volume_back_warp": 0.082,
                               "demo_rescale2": 0.480},
              "epiband_bwd_dfs": {"stage0": 4.860, "stage1": 1.829},
              "epiband_bwd_dfr": {"stage0": 1.2165, "stage1": 0.9670},
              "hat_rows_bwd": {"feature_warp": 0.134,
                               "volume_back_warp": 0.128},
              "lookup_fused_fwd": {"inference_stage0": 0.101,
                                   "demo_rescale2_stage0": 0.175,
                                   "training_stage0": 0.074},
              "lookup_fused_bwd": {"training_stage0": 0.120,
                                   "training_stage1": 0.091},
              "lookup_fused_v2": {"inference_stage0": 0.064,
                                  "demo_rescale2_stage0": 0.232}}
HAT_TIMED = ("feature_warp", "volume_back_warp")  # phase 8's timed hat shapes
MIXED_FORWARD = (3, 7)     # phase 4's mixed scene: neighbours moved forward
GRAPH_TOL = 0.0            # a replay against the eager forward: the same
#                            kernels on the same inputs, bit for bit
VB_HW = (384, 512)         # phase 5: the small-scene shape batching is for
VB_FRAMES = 6              # its neighbours (nf6)
VB_ITEMS = 8               # its loader's items
VB_CYCLES = 8              # the timed runs cycle them: 64 maps, seconds
VB_TOL = 1e-3              # vb-4 against vb-1 depth maps, relative (fp32,
#                            batch-invariant convolutions: cuDNN off)
VB_TOL_CUDNN = (1e-2, 2e-2)  # the same with cuDNN: max relative difference,
#                            share of pixels over 1e-5 (read 1.263e-3 and
#                            4.89e-3 on an H100: another summation order)
TNT_HW = (1056, 1920)      # phase 11: the MVSNet-preprocessed Tanks and
#                            Temples images the demo reads
TNT_SCANS = ("Ignatius", "Meetingroom")
TNT_VIEWS = 30             # imaged views of each scan
TNT_PAIRS = 10             # pair.txt neighbours (backfill reaches 15, 25)
TNT_EMPTY = 12             # the view whose pair list is empty (a window)
TNT_SUBSET = (0, TNT_VIEWS, 12)  # get_test_data_loader.subset: views 0,
#                            12, 24 of each scan
TNT_F = 1165.0             # focal (px) at 1920 wide
TNT_AUX = {"Ignatius": [0.7, 0.005, 256, 3.2],  # depth_min, interval, ...
           "Meetingroom": [2.5, 0.01, 256, 6.5]}
TNT_WALL_Z = 6.0           # Meetingroom's wall: the world plane z = 6 (m)
TNT_OBJECT_R = 2.2         # Ignatius's object: a sphere at the origin that
#                            fills every view (no silhouette to fuse across)
TNT_TOL = 5e-3             # fused true depths: distance to the surface (m)
TNT_GRAPHS = 6             # keys one runner captures while memory is read
CUSTOM_HW = (480, 640)     # phase 12: TUM frames
CUSTOM_FRAMES = 27         # demo_custom's rescale-2 window needs 26
BL_HW = (1536, 2048)       # phase 13: BlendedMVS full-res images, depths
BL_ORBIT, BL_SWEEP, BL_WALK = 12, 11, 3  # cameras of each capture style
BL_STEPS = 11              # train.num_steps: 12 steps, one epoch of its
#                            24 references (the walk's first view the only
#                            walk reference)
BL_F = 2200.0              # focal (px) at 2048 wide
PAR_STEPS = 5              # phase 14: train.num_steps of its world-of-one
#                            runs, six steps on phase 8's batch (five
#                            replays each, timed)
PAR_REPLAYS = 3            # phase 14: timed replays a route, in turns
PAR_FORWARD_TOL = dict(    # phase 14: two ranks' forward against one's
    volume_tol=dict(rtol=5e-5, atol=1e-6),  # each stage's volume, built
    #                        from the same origins by both, of the largest
    #                        |value|: fp32 sums of the same view volumes in
    #                        another order (the mixed one's means times
    #                        their counts; 9e-6 on an H100); each frame
    #                        encoded alone on both sides (the same features)
    disp_tol=dict(rtol=2e-2, atol=1e-6))    # disparities after 16 bf16 GRU
#                            iterations, of the largest |disparity| (delta
#                            heads damped 1e-3; 4.9e-3 on an H100)
PAR_PER_VIEW_MODEL = dict(  # phase 14: the mean, max and std forward's
    dtype="float32",       # model: fp32, two GRU iterations a stage, at
    cascade=((64, 64, 2), (-1, 320, 2)))  # full width. The exchange
#                            alone is exact for the max and within fp32
#                            rounding for the moments (3.6e-7 of 5.2 on an
#                            H100), but the random GRU amplifies that
#                            rounding with every iteration: disparities
#                            8.6e-4 of their max after 2 a stage, 1.7e-2
#                            after the shipped 8 (7.5e-2 in bf16), the
#                            same in every run; 8 would leave the
#                            disparity check no margin
PAR_TRAIN_TOL = dict(      # phase 14: a step of batch 1 + 1 against 2,
    model=dict(dtype="float32"), tf32=False,  # the fp32 model, TF32 off
    tol=None,              # (bf16 convs of batch 1 and 2 round apart)
    grad_rtol=2e-2,        # the clipped gradients' relative error: 16
    #                        iterations carry the two batch sizes' fp32
    #                        rounding to other lookup cells (6.2e-3-7.0e-3
    #                        on an H100; 3.6e-2 in bf16); the loss to 1e-4
    loss_tol=dict(rtol=1e-4, atol=0.0))     # (4.2e-6 there); the
#                            weights, each moved by ~lr either way by one
#                            AdamW step, say nothing more
SPATIAL_ONE_TOL = dict(    # phase 15(a): a (row,) mesh of one NCCL rank
    rtol=5e-2, atol=1e-6)  # against the unmeshed runner, of the largest
#                            |disparity|: the shipped bf16 model, 16 GRU
#                            iterations, delta heads damped 1e-3; the
#                            encoders' convolutions take their rows padded
#                            by a halo (another cuDNN call) and the norm its
#                            moments in two passes, so bf16 features round
#                            otherwise here and there
SPATIAL_SPEC = dict(       # phase 15(b): four gloo ranks sharing the card
    scene="ring", N=11, rect_lambda_max=0.00375, damp=1e-3, n_view=2,
    model=dict(dtype="float32", cascade=((64, 64, 2), (-1, 320, 2)),
               lookup_impl="pallas"),  # fp32, TF32 off, two iterations a
    tf32=False,            # stage: the rows' differences are fp32 rounding
    volume_tol=dict(rtol=1e-4, atol=1e-6),  # each stage's owned rows,
    #                        rebuilt from the same origins, of the largest
    #                        |value|
    disp_tol=dict(         # of the largest |disparity| (4.3e-4 to 5.3e-4),
        exact=dict(rtol=1e-4, atol=1e-9),   # from each route's readings
        rectified=dict(rtol=7e-3, atol=1e-9)))  # on an H100: exact
#                            1.6e-9 to 6.1e-9, rectified 1.97e-6 (the edge
#                            ranks' origin rows, zeros beyond the image as
#                            in the JAX package)
PAR_FUSION = dict(n_views=6, H=576, W=800, kind="sphere")  # phase 14's
#                            sharded fusion: a sphere's true depths
TOOLING_CASCADE = ((8, 64, 2), (-1, 320, 2))  # phase 16(a): the CPU slice
TOOLING_HW = (128, 256)    # test's cascade, on phase 4's small lateral scene
KERNEL_COUNT_TOL = 1e-3    # phase 16(a): each kernel's FLOPs, card against
# CPU, relative: a tap whose position lands on the other side of a floor
# on the card moves its count by 2 C
E2E_ARGS = ["--views", "3", "--num_frames", "2", "--size", "576", "800"]
E2E_Z = 600.0              # phase 16(d): SyntheticScan's plane (mm), the
# true depth of every view (its cameras only translate in x and y)
TOOLING_LIMIT_S = 60.0     # phase 16's share of the run


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


def mixed_ring_scene(h, w, n, seed=0):
    """:func:`dtu_scene` with the neighbours MIXED_FORWARD moved onto the
    reference's optical axis, 50 and 80 mm in front of it: their pairs fail
    the planner's baseline gate, so the full planner rejects the scene and
    the other neighbours keep the rectified path (the mixed construction)."""
    images, poses, intr = dtu_scene(h, w, n, seed)
    for i, d in zip(MIXED_FORWARD, (50.0, 80.0)):
        poses[i] = poses[0]
        poses[i, 2, 3] -= d
    return images, poses, intr


def lateral_forward_scene(h, w, n, seed=0):
    """:func:`lateral_scene` with its second neighbour moved along the
    optical axis instead: the mixed construction, lossless on the lateral
    views."""
    images, poses, intr = lateral_scene(h, w, n, seed)
    poses[2] = np.eye(4, dtype=np.float32)
    poses[2, 2, 3] = -1.0
    return images, poses, intr


class ItemLoader:
    """``inference()``'s loader interface over a list of items."""

    def __init__(self, items, num_frames):
        self.items = items
        self.dataset = types.SimpleNamespace(num_frames=num_frames)

    def __iter__(self):
        return iter(self.items)


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


def routed(runner, images, poses, intr, scale=1.0):
    """One view routed as ``runner.submit`` routes it: the forward's
    inputs on the device, its construction and key."""
    return runner.route(images[None], np.asarray(poses)[None],
                        np.asarray(intr)[None], [scale])


def eager(torch, runner, r):
    """The runner's forward of routed inputs ``r``, run eagerly."""
    with torch.no_grad():
        return runner.model(*r[:4], volume_fn=r.volume_fn)


def synced_s(torch, fn):
    """Host seconds of ``fn()`` to a device sync, and its result."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def graph_pool_bytes(torch, pool):
    """Bytes the CUDA caching allocator holds in the graphs' memory pool
    ``pool`` (``torch.cuda.max_memory_allocated`` does not see a replay's
    transients: they live there)."""
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", ())) == tuple(pool))


def graphed_pass(torch, runner, images, poses, intr, label, reps=3,
                 scale=1.0, phase="phase 4"):
    """One route of phase 4 through the runner's CUDA graphs: the first
    dispatch (an eager forward, then the capture); ``reps`` timed
    dispatches from numpy frames (``submit``: s/view, launches); then, on
    the frames routed once (``route``: its seconds), ``reps`` replays
    (``forward``) and ``reps`` eager forwards, each timed to a sync, with
    their launches. Peak bytes over the replays: allocated, reserved and
    in the graphs' pool. Fails unless the first dispatch captured and the
    others replayed, a replay launched each kernel as often as an eager
    forward, and replay and eager disparities agree to GRAPH_TOL. Returns
    the last replay's disparities with the figures."""
    from cermvs_torch.ops import cudalib

    first_s, _ = synced_s(torch, lambda: runner.submit(images, poses, intr,
                                                       scale))
    if not runner.last_dispatch_compiled:
        raise RuntimeError(f"{label}: the first dispatch did not capture")
    capture_s = runner.last_capture_s
    torch.cuda.reset_peak_memory_stats()
    cudalib.reset_launches()
    submit_s = []
    for _ in range(reps):
        submit_s.append(synced_s(torch, lambda: runner.submit(
            images, poses, intr, scale))[0])
        if runner.last_dispatch_compiled:
            raise RuntimeError(f"{label}: a repeated key captured again")
    launches = {k: cudalib.launches.get(k, 0) for k in KERNELS}
    route_s, r = synced_s(torch, lambda: routed(runner, images, poses,
                                                intr, scale))
    outs, times, counts = [], ([], []), []
    for fn, ts in zip((lambda: runner.forward(r),
                       lambda: eager(torch, runner, r)), times):
        cudalib.reset_launches()
        for _ in range(reps):
            t, out = synced_s(torch, fn)
            ts.append(t)
        outs.append(out)
        counts.append({k: cudalib.launches.get(k, 0) for k in KERNELS})
    (disp, de), (replay_s, eager_s) = outs, times
    peak = torch.cuda.max_memory_allocated()
    reserved = torch.cuda.max_memory_reserved()
    pool = graph_pool_bytes(torch, runner._pool)
    err = float((disp.float() - de.float()).abs().max())
    print(f"{phase}: {label}: first dispatch {first_s:.4f} s (capture "
          f"{capture_s:.4f} s); submit {[round(t, 4) for t in submit_s]} "
          f"s/view; route {route_s:.4f} s, then forward replayed "
          f"{[round(t, 4) for t in replay_s]} s, eager "
          f"{[round(t, 4) for t in eager_s]} s; max|replay - eager| "
          f"{err:.3e} (limit {GRAPH_TOL}); peak {peak / 2**30:.2f} GiB "
          f"allocated, {reserved / 2**30:.2f} GiB reserved, graph pool "
          f"{pool / 2**30:.2f} GiB", flush=True)
    check_launches(counts[0], counts[1], f"{label} replays")
    if not err <= GRAPH_TOL:
        raise RuntimeError(f"{label}: replay and eager disparities differ "
                           f"by {err:.3e}")
    return disp, dict(s_per_view=submit_s, route_s=route_s,
                      forward_replay_s=replay_s, forward_eager_s=eager_s,
                      first_dispatch_s=first_s, capture_s=capture_s,
                      replay_vs_eager=err, peak_bytes=peak,
                      peak_reserved_bytes=reserved, graph_pool_bytes=pool,
                      launches=launches)


def profile_graphed(torch, runner, images, poses, intr, label):
    """``--profile``: one eager forward (the per-range breakdown: a replay
    shows no ranges) and one replay (its device-busy share) of the same
    routed inputs, printed; returns the two busy shares."""
    r = routed(runner, images, poses, intr)
    prof = profile_call(torch, lambda: eager(torch, runner, r))
    replay = profile_call(torch, lambda: runner.forward(r))
    print(f"phase 4: {label} profile: device busy {prof['device_busy_ms']:.1f}"
          f" of {prof['wall_ms']:.1f} ms eager ({prof['busy_share']:.3f}), "
          f"{replay['device_busy_ms']:.1f} of {replay['wall_ms']:.1f} ms "
          f"replayed ({replay['busy_share']:.3f})", flush=True)
    print(json.dumps({f"profile_{label}": prof,
                      f"profile_{label}_replay": replay}), flush=True)
    return {"eager": prof["busy_share"], "replay": replay["busy_share"]}


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
    (back to back; the lookups' with the L2 flushed, as phase 3 times
    them)."""
    ms = EARLIER_MS.get(name, {}).get(shape)
    how = "L2 flushed" if name in LOOKUPS else "back to back"
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
    backward kernels: the bytes each must move (``ops/epiband.work``: what
    these inputs need, the in-band taps counted from the data) over the
    memory rate, against its FLOPs over the peak rate of the inputs' type.
    Returns {name: (bound_ms, bound_by)}."""
    from cermvs_torch.ops import epiband as eb
    from cermvs_torch.utils.flops import PEAK_FLOPS

    peak = PEAK_FLOPS[str(fr.dtype).split(".")[-1]]
    return {name: bound_of(nbytes, nflops, peak) for name, (nbytes, nflops)
            in eb.work(fr, fs, base, sigma, D, s_max).items()}


def bound_of(nbytes, flops, peak):
    """(ms, "bytes" or "operations"): the larger of ``nbytes`` over the
    card's memory rate and ``flops`` over ``peak``
    (``cermvs_torch/utils/flops.py``)."""
    from cermvs_torch.utils.flops import PEAK_BYTES_S

    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / peak * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def hat_bounds(torch, img, pos):
    """Least time of the hat resample and its transpose for these inputs
    (``ops/hatwarp.work``: img, pos and dout read once, out or dimg written
    once, 2 * C fp32 FLOPs per in-range tap)."""
    from cermvs_torch.ops import hatwarp as hw
    from cermvs_torch.utils.flops import PEAK_FLOPS

    work = hw.work(pos, img.shape[1], img.shape[2], img.dtype)
    return {name: bound_of(nbytes, nflops, PEAK_FLOPS["float32"])
            for name, (nbytes, nflops) in work.items()}


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
            "memcpy_ms": [[e.key[:90], e.count, dev(e, own=True) / 1e3]
                          for e in kernels if "Memcpy" in e.key],
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


def plan_label(plan):
    """A training step's construction key, printable."""
    if plan is None:
        return "exact"
    return (plan.h_r, plan.w_r, plan.ws_r, plan.view_s_max)


def released(torch, label):
    """Drop what the last phase left (its runners' graphs and pools) and
    print what the allocator still holds."""
    gc.collect()
    torch.cuda.empty_cache()
    print(f"{label}: device memory held before it: "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated, "
          f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved",
          flush=True)


def train_through_graphs(torch, tree, label, name):
    """``train()`` with the configured bindings: every step goes through
    the state's StepRunner (a key's first step eager, then its capture;
    later steps of the key replayed). Prints each step and, after the run,
    the distinct keys with their first dispatch's eager and capture
    seconds, s/step over the replayed steps, the launches and the peaks of
    allocated, reserved and graph-pool memory. Fails unless MIN_REPLAYS
    steps replayed. Returns the state and the figures."""
    from cermvs_torch import config as pcfg
    from cermvs_torch.ops import cudalib
    from cermvs_torch.training.train import train

    records = []

    def on_step(state, metrics, plan):
        torch.cuda.synchronize()
        r = state.runner
        records.append({"t": time.perf_counter(), "metrics": metrics,
                        "plan": plan, "first": r.last_dispatch_compiled,
                        "eager_s": r.last_eager_s,
                        "capture_s": r.last_capture_s})
        how = ("replayed" if not r.last_dispatch_compiled else
               f"its key's first dispatch: eager {r.last_eager_s:.3f} s, "
               f"capture {r.last_capture_s:.3f} s" if r.last_eager_s else
               f"its key's first dispatch: capture {r.last_capture_s:.3f} "
               f"s, then its replay")
        if r.last_dispatch_compiled:
            how += (f"; since the run's start peak "
                    f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
                    f"allocated, "
                    f"{torch.cuda.max_memory_reserved() / 2**30:.2f} GiB "
                    f"reserved, graph pool "
                    f"{graph_pool_bytes(torch, r._pool) / 2**30:.2f} GiB")
        print(f"{label}: step {state.step}: loss {metrics['loss']:.5f} "
              f"grad_norm {metrics['grad_norm']:.4f} plan "
              f"{plan_label(plan)}; {how}", flush=True)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cudalib.reset_launches()
    t0 = time.perf_counter()
    state = train(name=name, checkpoint_dir=str(Path(tree) / "checkpoints"),
                  run_dir=str(Path(tree) / "runs"), resume=False, log_every=1,
                  on_step=on_step, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: cudalib.launches.get(k, 0) for k in KERNELS}
    peak = torch.cuda.max_memory_allocated()
    reserved = torch.cuda.max_memory_reserved()
    pool = graph_pool_bytes(torch, state.runner._pool)
    bound = {k: v for k, v in pcfg.operative_config().get(
        "random_scale_and_crop", {}).items() if k == "use_native"}
    print(f"{label}: RAFT.remat {state.model.remat}, "
          f"random_scale_and_crop.use_native bound {bound or 'no'} "
          f"(the JAX package's defaults: remat, the native crop)",
          flush=True)
    if not state.model.remat or bound:
        raise RuntimeError(f"{label}: not run with the defaults")
    keys = [{"key": str(plan_label(r["plan"])), "step": i + 1,
             "eager_s": r["eager_s"], "capture_s": r["capture_s"]}
            for i, r in enumerate(records) if r["first"]]
    replay_s = [b["t"] - a["t"] for a, b in zip(records, records[1:])
                if not b["first"]]
    firsts = [(k["key"], round(k["eager_s"], 3), round(k["capture_s"], 3))
              for k in keys]
    print(f"{label}: {len(records)} steps in {wall:.1f} s; {len(keys)} "
          f"distinct keys, first dispatches (eager s, capture s) "
          f"{firsts} "
          f"(eager 0: captured, then replayed); "
          f"s/step over the {len(replay_s)} replayed steps "
          f"{[round(t, 4) for t in replay_s]}; peak {peak / 2**30:.2f} GiB "
          f"allocated, {reserved / 2**30:.2f} GiB reserved, graph pool "
          f"{pool / 2**30:.2f} GiB; launches {launches}", flush=True)
    if len(replay_s) < MIN_REPLAYS:
        raise RuntimeError(f"{label}: {len(replay_s)} replayed steps, fewer "
                           f"than {MIN_REPLAYS}")
    return state, {"records": records, "launches": launches, "wall_s": wall,
                   "keys": keys, "replay_s_per_step": replay_s,
                   "steps": len(records), "peak_bytes": peak,
                   "peak_reserved_bytes": reserved, "graph_pool_bytes": pool}


def train_launches(records, model, fused_lookup=False):
    """The launches a training run's steps make: per sample, view and stage
    an epiband forward and its two gradients on each rectified step; two
    hat passes per feature warp (2 per view) and per stage's volume
    back-warp, forward and transposed, on each two-pass one (a plan that
    is not two-pass warps by quad gathers, no kernel); with the fused
    lookup, its taps and their gradient once per GRU iteration, and under
    ``RAFT.remat`` the taps once more per iteration, recomputed in the
    backward pass."""
    B, V, S = 2, NUM_FRAMES, len(model.cascade)
    rect = sum(r["plan"] is not None for r in records)
    twopass = sum(r["plan"] is not None and r["plan"].twopass
                  for r in records)
    taps = len(records) * sum(s[2] for s in model.cascade) * fused_lookup
    return {"epiband_fwd": rect * B * V * S,
            "epiband_bwd_dfr": rect * B * V * S,
            "epiband_bwd_dfs": rect * B * V * S,
            "hat_rows_fwd": twopass * B * V * (2 + S) * 2,
            "hat_rows_bwd": twopass * B * V * (2 + S) * 2,
            "lookup_fused_fwd": taps * (1 + bool(model.remat)),
            "lookup_fused_bwd": taps, "lookup_fused_v2": 0}


def replay_against_eager(torch, state, batch, plan, label,
                         batch_name="phase 8's batch", graph_first=True):
    """On ``batch``, from one snapshot of ``state``: two eager steps
    (each from the snapshot, restored in place), then the replay of the
    runner's graph for the batch's key (captured first if the key is new:
    before the snapshot, or with ``graph_first=False`` after the eager
    steps, so that they run before the graphs' pool holds memory).
    Prints max|difference| of loss, grad_norm, the weights and AdamW's
    moments, eager against eager and replay against the nearer eager step,
    and fails where the replay's exceeds the eager steps' spread."""
    from cermvs_torch.ops.corr_rectified import RectifiedVolume
    from cermvs_torch.training.checkpoint import load_state, state_dicts
    from cermvs_torch.training.step import train_step

    runner, gw = state.runner, 0.5
    if graph_first:
        runner(batch, gw, plan)  # the key's graph exists from here on
    snap = copy.deepcopy(state_dicts(state))

    def parts():
        params = list(state.model.parameters())
        moments = [t for p in params for k, t in
                   state.optimizer.state[p].items() if k != "step"]
        return {"weights": torch.cat([p.detach().reshape(-1)
                                      for p in params]),
                "moments": torch.cat([t.reshape(-1) for t in moments])}

    def run(step):
        load_state(state, copy.deepcopy(snap))
        m = step()
        return dict(parts(), loss=torch.tensor(m["loss"]),
                    grad_norm=torch.tensor(m["grad_norm"]))

    eager = [run(lambda: train_step(
        state, batch, torch.tensor(gw, device="cuda"),
        volume_fn=RectifiedVolume(plan))) for _ in range(2)]
    if not graph_first:
        gc.collect()
        torch.cuda.empty_cache()
        run(lambda: runner(batch, gw, plan))  # the key's first dispatch
    replay = run(lambda: runner(batch, gw, plan))
    if runner.last_dispatch_compiled:
        raise RuntimeError(f"{label}: the key captured again")

    def diff(a, b):
        return {k: float((a[k].cpu() - b[k].cpu()).abs().max()) for k in a}

    spread = diff(*eager)
    to_second = diff(replay, eager[1])
    err = {k: min(v, to_second[k])
           for k, v in diff(replay, eager[0]).items()}
    print(f"{label}: replay against eager on {batch_name}: max|replay - "
          f"eager| {err}, eager against eager {spread} (the limit)",
          flush=True)
    if any(err[k] > spread[k] for k in err):
        raise RuntimeError(f"{label}: replay and eager steps differ beyond "
                           f"the eager steps' spread: {err} > {spread}")
    load_state(state, snap)
    return {"replay_vs_eager": err, "eager_vs_eager": spread}


def profile_train(torch, state, batch, plan, label):
    """``--profile``: one eager train step (the ranges and kernels) and one
    replayed step (its device-busy share), printed; returns both."""
    from cermvs_torch.ops.corr_rectified import RectifiedVolume
    from cermvs_torch.training.step import train_step

    vol = RectifiedVolume(plan)
    prof = profile_call(torch, lambda: train_step(state, batch, 0.5,
                                                  volume_fn=vol))
    replay = profile_call(torch, lambda: state.runner(batch, 0.5, plan))
    print(f"{label}: profile of one train step: device busy "
          f"{prof['device_busy_ms']:.1f} ms of {prof['wall_ms']:.1f} ms "
          f"wall eager ({prof['busy_share']:.3f}), "
          f"{replay['device_busy_ms']:.1f} ms of {replay['wall_ms']:.1f} ms "
          f"replayed ({replay['busy_share']:.3f})", flush=True)
    return prof, replay


def phase_train(torch, tree, plan5, batch5):
    """``train()`` through ``train_DTU.gin`` (rectified, batch 2, nf10,
    crop 1056x1440) for TRAIN_STEPS + 1 steps on the synthetic tree,
    through the runner's CUDA graphs; checks the path, the values, the
    launch counts (a replay counts an eager step's) and the checkpoint;
    times the host's plan and upload of phase 8's batch; holds a replay
    against eager steps on that batch."""
    from cermvs_torch.models.raft import RAFT
    from cermvs_torch.ops.rectify import PlanCache
    from cermvs_torch.training.checkpoint import CheckpointManager
    from cermvs_torch.training.step import batch_to_device, init_state
    from cermvs_torch.training.train import plan_batch

    configure_training(tree)
    torch.backends.cudnn.allow_tf32 = True  # the bf16 model's own setting
    state, run = train_through_graphs(torch, tree, "phase 9", "chip_smoke")
    records, launches = run["records"], run["launches"]
    steps = run["steps"]
    expect = train_launches(records, state.model)
    twopass = sum(r["plan"] is not None and r["plan"].twopass
                  for r in records)
    print(f"phase 9: {twopass} two-pass steps, {steps - twopass} with quad "
          f"warps; launches {launches} (expected {expect})", flush=True)
    if steps != TRAIN_STEPS + 1 or state.step != steps:
        raise RuntimeError(f"{steps} steps taken, state at {state.step}")
    if not twopass:
        raise RuntimeError("no step took the rectified two-pass "
                           "construction")
    for r in records:
        m = r["metrics"]
        if r["plan"] is None:
            raise RuntimeError("a step did not take the rectified "
                               "construction")
        if not (np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"])
                and m["grad_norm"] > 0):
            raise RuntimeError(f"bad step metrics {m}")
    if not all(bool(torch.isfinite(p).all())
               for p in state.model.parameters()):
        raise RuntimeError("non-finite weights after training")
    if launches != expect:
        raise RuntimeError(f"launches {launches} != {expect}")
    mgr = CheckpointManager(Path(tree) / "checkpoints" / "chip_smoke")
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
    del fresh, restored
    # the host's work per step that the graphs leave: the plan, the upload
    plan_s, upload_s = [], []
    for _ in range(3):
        t, _ = synced_s(torch, lambda: PlanCache().key_for(
            plan_batch(batch5, state.model.stride_factor)))
        plan_s.append(t)
        t, batch = synced_s(torch, lambda: batch_to_device(batch5, "cuda"))
        upload_s.append(t)
    print(f"phase 9: host work per step: plan {[round(t, 4) for t in plan_s]}"
          f" s, upload of the float32 batch "
          f"{[round(t, 4) for t in upload_s]} s", flush=True)
    check = replay_against_eager(torch, state, batch, plan5, "phase 9")
    profile = None
    if "--profile" in sys.argv:
        prof, replay = profile_train(torch, state, batch, plan5, "phase 9")
        grads = {g: [row for row in prof["port_kernels_ms"] if g in row[0]]
                 for g in ("dfr", "dfs", "hat_rows_bwd")}
        print(f"phase 9: eager step's dfr row {grads['dfr']}; dfs row "
              f"{grads['dfs']}; hat_rows_bwd row {grads['hat_rows_bwd']}; "
              f"elementwise launches {prof['elementwise_launches']} "
              f"({prof['elementwise_ms']:.2f} ms)", flush=True)
        print(json.dumps({"profile_train_step": prof,
                          "profile_train_step_replay": replay}), flush=True)
        profile = {"eager": prof["busy_share"], "replay": replay["busy_share"]}
    plans = {plan_label(r["plan"]) for r in records}
    return {"launches": launches, "s_per_step": run["replay_s_per_step"],
            "keys": run["keys"], "peak_bytes": run["peak_bytes"],
            "peak_reserved_bytes": run["peak_reserved_bytes"],
            "graph_pool_bytes": run["graph_pool_bytes"], "steps": steps,
            "plan_s": plan_s, "upload_s": upload_s, "busy_share": profile,
            **check,
            "plan": [list(p[:3]) + [list(p[3])] for p in sorted(plans)]}


def remat_both_ways(torch, plan, batch5):
    """Phase 8's batch, the same seeded weights, ``RAFT.remat`` off, on
    and off again: each a fresh state's eager train step (its loss, the
    weights' gradients and the peak allocated), then a fresh StepRunner's
    first dispatch (eager, then the capture) and REMAT_REPLAYS replays
    (s/step, peak reserved, the graph pool). The loss with remat must be
    the remat-off steps' within their spread (bit for bit where they
    agree); the gradients' largest difference is printed beside theirs."""
    from cermvs_torch.models.raft import RAFT
    from cermvs_torch.ops.corr_rectified import RectifiedVolume
    from cermvs_torch.training.step import (StepRunner, batch_to_device,
                                            init_state, train_step)

    torch.backends.cudnn.allow_tf32 = True  # the bf16 model's own setting
    batch = batch_to_device(batch5, "cuda")
    runs = []
    for remat in (False, True, False):
        released(torch, f"phase 9, remat {remat}")
        state = init_state(RAFT(remat=remat, device="cuda",
                                generator=torch.Generator().manual_seed(7)),
                           1000)
        torch.cuda.reset_peak_memory_stats()
        eager_s, m = synced_s(torch, lambda: train_step(
            state, batch, 0.5, volume_fn=RectifiedVolume(plan)))
        run = {"remat": remat, "loss": m["loss"],
               "grad_norm": m["grad_norm"], "eager_s": eager_s,
               "eager_peak_bytes": torch.cuda.max_memory_allocated(),
               "grads": torch.cat([p.grad.detach().reshape(-1).float()
                                   for p in state.model.parameters()])}
        state.runner = StepRunner(state)
        torch.cuda.reset_peak_memory_stats()
        first_s, _ = synced_s(torch, lambda: state.runner(batch, 0.5, plan))
        replay_s = [synced_s(torch, lambda: state.runner(batch, 0.5,
                                                         plan))[0]
                    for _ in range(REMAT_REPLAYS)]
        run.update(first_s=first_s, replay_s=replay_s,
                   peak_bytes=torch.cuda.max_memory_allocated(),
                   peak_reserved_bytes=torch.cuda.max_memory_reserved(),
                   graph_pool_bytes=graph_pool_bytes(torch,
                                                     state.runner._pool))
        print(f"phase 9: remat {remat}: eager step loss {run['loss']!r} "
              f"grad_norm {run['grad_norm']!r} in {eager_s:.3f} s, peak "
              f"{run['eager_peak_bytes'] / 2**30:.2f} GiB allocated; "
              f"through a StepRunner: first dispatch {first_s:.3f} s, "
              f"replays {[round(t, 4) for t in replay_s]} s/step, peak "
              f"{run['peak_bytes'] / 2**30:.2f} GiB allocated, "
              f"{run['peak_reserved_bytes'] / 2**30:.2f} GiB reserved, "
              f"graph pool {run['graph_pool_bytes'] / 2**30:.2f} GiB",
              flush=True)
        runs.append(run)
        del state
    off, on, off2 = runs
    spread = {"loss": abs(off["loss"] - off2["loss"]),
              "grads": float((off["grads"] - off2["grads"]).abs().max())}
    err = {"loss": min(abs(on["loss"] - r["loss"]) for r in (off, off2)),
           "grads": min(float((on["grads"] - r["grads"]).abs().max())
                        for r in (off, off2))}
    print(f"phase 9: remat on against off: max|difference| {err}, off "
          f"against off {spread} (the loss's limit); largest gradient "
          f"{float(on['grads'].abs().max()):.4e}", flush=True)
    if err["loss"] > spread["loss"]:
        raise RuntimeError(f"remat changes the loss: {err} > {spread}")
    for r in runs:
        del r["grads"]
    released(torch, "phase 9, remat compared")
    return {"on": on, "off": [off, off2], "max_diff": err,
            "off_spread": spread}


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
    of its gradient for these indices (``ops/lookup.work``: the level-0
    cells some in-range tap reaches, x0, the taps and the gradient moved
    once; fp32 operations per in-range pooled cell and per tap). Returns
    {name: (bound_ms, bound_by)}."""
    from cermvs_torch.ops import lookup as lk
    from cermvs_torch.utils.flops import PEAK_FLOPS

    return {name: bound_of(nbytes, nflops, PEAK_FLOPS["float32"])
            for name, (nbytes, nflops) in lk.work(x0, D, radius,
                                                   levels).items()}


def phase_lookup_kernels(torch):
    """The fused lookup kernels against their plain versions on the card at
    the main path's shapes (inference at scale 1 and the training batch,
    stage 0 and stage 1), with their times (L2 flushed before each launch,
    back to back, and in device time with a warm L2), plain times and
    bounds."""
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
            device = cuda_ms_graph(torch, kernel[name])  # warm L2
            rows[name]["shapes"][shape_name] = dict(
                shape=list(shape), ms=ms, warm_ms=warm, device_ms=device,
                plain_ms=plain_ms, bound_ms=bounds[name][0],
                bound_by=bounds[name][1])
            print(f"phase 3: {name} {shape_name} timing: kernel {ms:.4f} ms "
                  f"(L2 flushed{earlier(name, shape_name)}; back to back "
                  f"{warm:.4f}, device {device:.4f}), plain {plain_ms:.3f} "
                  f"ms, bound "
                  f"{bounds[name][0]:.4f} ms ({bounds[name][1]}), library "
                  f"{NO_LIBRARY}", flush=True)
    for name in LOOKUPS:
        main = rows[name]["shapes"]["training_stage0" if name ==
                                    "lookup_fused_bwd" else
                                    "inference_stage0"]
        rows[name].update(max_abs_err=errs[name], ms=main["ms"],
                          device_ms=main["device_ms"],
                          plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
                          bound_by=main["bound_by"], library_ms=None,
                          library=NO_LIBRARY)
    return rows


def sphere_depth(P, K, h, w, radius=SPHERE_R):
    """Depth (camera z) of the sphere of ``radius`` about the origin seen
    from world-to-camera pose P with intrinsics K, (h, w) fp32; 0 where a
    ray misses it."""
    u, v = np.meshgrid(np.arange(w, dtype=np.float64),
                       np.arange(h, dtype=np.float64))
    d = np.linalg.inv(K) @ np.stack([u.ravel(), v.ravel(), np.ones(u.size)])
    c = np.asarray(P, np.float64)[:3, 3]  # the centre in camera coordinates
    a = (d * d).sum(0)
    b = c @ d
    disc = b * b - a * (c @ c - radius ** 2)
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
    widest band and of the largest rectified grid; and every view's plan,
    in the loader's order (the runner's graph keys). Fails unless every
    plan is two-pass and phase 3 held the lookups at these feature
    sizes."""
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
    return picked, plans


def hold_rect_kernels(torch, plan, h, w, label, timed=False,
                      phase="phase 6"):
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
            print(f"{phase}: epiband_fwd {label} {shape} {stage} D={D} "
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
            print(f"{phase}: hat_rows_fwd {label} {name} {(R, S, O, C)} "
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
            print(f"{phase}: {name} {label} timing: kernel {row['ms']:.4f} "
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
    at rescale 1 (with ``device_prefetch`` on, then off) and 2 over every
    imaged view, the multires merge, fusion at rescale 2 with view_batch
    8. Per run: s/view (pipeline-inclusive), maps/s, each record's
    construction (checked), peak device memory, launches per forward
    (checked); the files (checked); fusion's seconds and points."""
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
    plans, view_plans = demo_plans(InferenceRunner(
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
    # rescale 1 twice, the second time without the pinned side-stream
    # upload (the prep thread alone), then rescale 2
    for rescale, prefetch in ((1, True), (1, False), (2, True)):
        label = rescale if prefetch else f"{rescale}_device_prefetch_off"
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        cudalib.reset_launches()
        t0 = time.perf_counter()
        records = run_cli(inference_cli.main, common + [
            f'inference.ckpt = "{ckpt}"', f'inference.output_folder = "{out}"',
            f"inference.rescale = {rescale}", "inference.do_report = True",
            f"inference.device_prefetch = {prefetch}"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: cudalib.launches.get(k, 0) for k in KERNELS}
        peak = torch.cuda.max_memory_allocated()
        reserved = torch.cuda.max_memory_reserved()
        n = len(records)
        paths = [r[2] for r in records]
        s_view = [r[1] for r in records]
        capture_s = [r[3] for r in records]
        # the graph keys: every view's plan at one image shape. The first
        # view's capture lies in no record; record i names view i+1's
        new_key = [i for i, p in enumerate(view_plans[rescale])
                   if p not in view_plans[rescale][:i]]
        marked = [i + 1 for i, c in enumerate(capture_s) if c > 0]
        print(f"phase 6: rescale {rescale}, device_prefetch {prefetch}: {n} "
              f"views in {wall:.1f} s, {n / wall:.3f} maps/s, s/view "
              f"(pipeline-inclusive) {[round(t, 4) for t in s_view]}, "
              f"of which first dispatches of a key (eager forward and graph "
              f"capture) {[round(t, 4) for t in capture_s]}; "
              f"{len(new_key)} distinct keys of {n} views, new at views "
              f"{new_key}; construction {sorted(set(paths))}, peak "
              f"{peak / 2**30:.2f} GiB allocated, {reserved / 2**30:.2f} GiB "
              f"reserved, launches {launches}", flush=True)
        # demo_plans held every view to a two-pass rectified plan
        if paths != ["rectified"] * DEMO_VIEWS:
            raise RuntimeError(f"demo routes at rescale {rescale}: {paths}")
        if [0] + marked != new_key:
            raise RuntimeError(f"captures at views {[0] + marked}, new keys "
                               f"at views {new_key}")
        V = NUM_FRAMES
        per_forward = {"lookup_fused_fwd": n_iters, "lookup_fused_bwd": 0,
                       "lookup_fused_v2": 0, "epiband_fwd": n_stages * V,
                       "hat_rows_fwd": (2 + n_stages) * 2 * V}
        check_launches(launches, {k: n * v for k, v in per_forward.items()},
                       f"demo inference at rescale {rescale}")
        for name, *_ in records:
            f = out / "depths" / f"{name}_scale{rescale}_nf{NUM_FRAMES}.pfm"
            if not f.is_file():
                raise RuntimeError(f"missing {f}")
        for k, v in launches.items():
            demo_launches[k] += v
        scales[label] = {"views": n, "s_per_view": s_view,
                         "capture_s": capture_s, "distinct_keys":
                         len(new_key), "new_key_views": new_key,
                         "maps_per_s": n / wall,
                         "construction": sorted(set(paths)),
                         "peak_bytes": peak, "peak_reserved_bytes": reserved,
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
    view at ``rescale``, as ``inference()`` prepares it; then of
    ``inference()`` over the first three views, with and without
    ``device_prefetch``."""
    from cermvs_torch import config as pcfg
    from cermvs_torch.data import get_test_data_loader
    from cermvs_torch.data.augment import pad_to_multiple, scale_operation
    from cermvs_torch.models.raft import RAFT
    from cermvs_torch.pipeline.inference import InferenceRunner, inference
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
    runner(images, poses, intr, scale)  # the capture
    # eager for the ranges and the kernels' rows, a replay for the busy share
    r = routed(runner, images, poses, intr, scale)
    prof = profile_call(torch, lambda: eager(torch, runner, r))
    replay = profile_call(torch, lambda: runner.forward(r))
    print(f"phase 6: profile of one rescale-{rescale} forward: device busy "
          f"{prof['device_busy_ms']:.1f} ms of {prof['wall_ms']:.1f} ms "
          f"wall eager, {replay['device_busy_ms']:.1f} of "
          f"{replay['wall_ms']:.1f} ms replayed; lookup_fused_fwd row "
          f"{[r for r in prof['port_kernels_ms'] if 'lookup_tile' in r[0]]}",
          flush=True)
    print(json.dumps({f"profile_demo_rescale{rescale}": prof,
                      f"profile_demo_rescale{rescale}_replay": replay}),
          flush=True)
    # the pipeline over the first views, with and without the pinned
    # side-stream upload: its host-to-device rows and the busy share
    loader = ItemLoader(list(itertools.islice(get_test_data_loader(
        "DTUTest", num_frames=NUM_FRAMES, num_workers=0), 3)), NUM_FRAMES)
    with tempfile.TemporaryDirectory(dir=REPO / "build") as out:
        for prefetch in (True, False):
            prof = profile_call(torch, lambda: inference(
                loader, model=model, output_folder=out, rescale=rescale,
                device_prefetch=prefetch))
            print(f"phase 6: profile of inference() over {len(loader.items)} "
                  f"rescale-{rescale} views, device_prefetch {prefetch}: "
                  f"device busy {prof['device_busy_ms']:.1f} ms of "
                  f"{prof['wall_ms']:.1f} ms wall "
                  f"({prof['busy_share']:.3f}); copies "
                  f"{prof['memcpy_ms']}", flush=True)
            print(json.dumps({f"profile_pipeline_rescale{rescale}_prefetch_"
                              f"{str(prefetch).lower()}": prof}), flush=True)


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
    PALLAS_STEPS + 1 steps through the runner's CUDA graphs (16 forward and
    16 backward lookup launches a step, the other kernels as the banded
    run), a replay held against eager steps on phase 8's batch, then one
    train step on that batch from one set of weights, banded against
    fused."""
    from cermvs_torch import config as pcfg
    from cermvs_torch.models.raft import RAFT
    from cermvs_torch.ops.corr_rectified import RectifiedVolume
    from cermvs_torch.training.step import (batch_to_device, init_state,
                                            train_step)

    configure_training(tree)
    pcfg.bind_parameter("RAFT.lookup_impl", "pallas")
    pcfg.bind_parameter("train.num_steps", PALLAS_STEPS)
    state, run = train_through_graphs(torch, tree, "phase 10",
                                      "chip_smoke_pallas")
    launches, steps = run["launches"], run["steps"]
    records = [r["metrics"] for r in run["records"]]
    if steps != PALLAS_STEPS + 1 or not all(
            np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"])
            and m["grad_norm"] > 0 for m in records):
        raise RuntimeError(f"bad fused-lookup steps {records}")
    check_launches(launches, train_launches(run["records"], state.model,
                                            fused_lookup=True),
                   "fused-lookup training")
    batch = batch_to_device(batch5, "cuda")
    check = replay_against_eager(torch, state, batch, plan5, "phase 10")
    if "--profile" in sys.argv:
        prof, replay = profile_train(torch, state, batch, plan5, "phase 10")
        rows = [r for r in prof["port_kernels_ms"] if "lookup_" in r[0]]
        print(f"phase 10: eager fused-lookup step's lookup rows {rows}",
              flush=True)
        print(json.dumps({"profile_train_step_fused_lookup": prof,
                          "profile_train_step_fused_lookup_replay": replay}),
              flush=True)
    del state
    released(torch, "phase 10, first steps")
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
    return {"launches": launches, "steps": steps,
            "s_per_step": run["replay_s_per_step"], "keys": run["keys"],
            "peak_bytes": run["peak_bytes"],
            "peak_reserved_bytes": run["peak_reserved_bytes"],
            "graph_pool_bytes": run["graph_pool_bytes"],
            "wall_s": run["wall_s"], "first_step": first,
            "first_step_rel": rel, **check}


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

    # timings on the main path's bases, stage by stage: bf16 features (the
    # bf16 model's) and fp32 (the fp32 model's, phase 4's last pass)
    stages = {}
    for dtype, suffix in ((torch.bfloat16, ""), (torch.float32, "_fp32")):
        for name, D, base_kind, sig, Cc, _ in (cases[0], cases[4]):
            fr, fs, base, sigma = epiband_case(
                torch, rng, plan.h_r, plan.w_r, ws_v, Cc, D, base_kind, sig,
                dtype, stage0)
            ms, device_ms = cuda_ms_both(
                torch, lambda: eb.epiband(fr, fs, base, sigma, D, s_v))
            plain = cuda_ms(
                lambda: eb.epiband_reference(fr, fs, base, sigma, D, s_v), 3)
            bound, by = epiband_bounds(torch, fr, fs, base, sigma, D,
                                       s_v)["epiband_fwd"]
            stages[name + suffix] = dict(
                D=D, base=base_kind, dtype=str(dtype)[6:],
                shape=[1, plan.h_r, plan.w_r, ws_v, Cc], ms=ms,
                device_ms=device_ms, plain_ms=plain, bound_ms=bound,
                bound_by=by)
            was = (earlier("epiband_fwd", name) if not suffix else
                   f", first design "
                   f"{EARLIER_MS['epiband_fwd_fp32'][name]} ms device")
            print(f"phase 2: {name} {str(dtype)[6:]} timing: kernel "
                  f"{ms:.4f} ms (device {device_ms:.4f}){was}, plain "
                  f"{plain:.3f} ms, bound {bound:.4f} ms ({by})", flush=True)
    return max_err, stages


def phase_fp32_forward(torch, images, poses, intr, expect, busy):
    """Phase 4's last pass: the fp32 model, built by the InferenceRunner
    from the binding ``RAFT.dtype = "float32"`` as a ``-p`` flag gives it,
    through the rectified construction with TF32 off (cuDNN and matmul):
    a capture, three timed replays and three eager forwards
    (:func:`graphed_pass`); the bf16 pass's launch counts (``expect``),
    finite disparities at a quarter of the image size. Returns the
    figures of :func:`graphed_pass`; with ``--profile`` adds the busy
    shares to ``busy``."""
    import argparse

    from cermvs_torch import config as pcfg
    from cermvs_torch.pipeline.inference import InferenceRunner

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    flags = pcfg.add_cli_flags(argparse.ArgumentParser()).parse_args(
        ["-p", 'RAFT.dtype = "float32"'])
    pcfg.clear_config()
    pcfg.parse_cli(flags)
    try:
        runner = InferenceRunner(construction="rectified", device="cuda")
    finally:
        pcfg.clear_config()
    if runner.model.dtype != torch.float32:
        raise RuntimeError(f"RAFT.dtype = \"float32\" built a "
                           f"{runner.model.dtype} model")
    disp, graphed = graphed_pass(torch, runner, images, poses, intr,
                                 "rectified fp32")
    times, peak = graphed["s_per_view"], graphed["peak_bytes"]
    launches = graphed["launches"]
    d = disp[0].float().cpu().numpy()
    hw = tuple(n // runner.model.stride_factor for n in images.shape[1:3])
    print(f"phase 4: rectified fp32 (RAFT.dtype = \"float32\") "
          f"{[round(t, 4) for t in times]} s/view, path={runner.last_path}, "
          f"launches={launches} (expected {expect}), peak "
          f"{peak / 2**30:.2f} GiB, disparity {d.shape} range "
          f"[{d.min():.3e}, {d.max():.3e}]", flush=True)
    if runner.last_path != "rectified":
        raise RuntimeError("the fp32 model did not take the rectified path")
    check_launches(launches, expect, "fp32 rectified forward")
    if d.shape != hw or not np.isfinite(d).all():
        raise RuntimeError(f"bad fp32 disparity: shape {d.shape}, finite "
                           f"{np.isfinite(d).all()}")
    if "--profile" in sys.argv:
        busy["fp32"] = profile_graphed(torch, runner, images, poses, intr,
                                       "rectified_fp32")
    return graphed


def phase_mixed(torch, model, passes, busy):
    """Phase 4's mixed pass: the full-width scene with the neighbours
    MIXED_FORWARD moved onto the reference's optical axis, so the full
    planner rejects it and "auto" takes the mixed construction; epiband_fwd
    and hat_rows_fwd held against their plain versions at the partial plan;
    a capture, three timed replays and three eager forwards
    (:func:`graphed_pass`; s/view and peak memory printed beside
    ``passes``, the rectified and exact passes'), the launches checked
    against the rectified views' count, finite disparities; with
    ``--profile`` the busy shares added to ``busy``."""
    from cermvs_torch.pipeline.inference import InferenceRunner

    images, poses, intr = mixed_ring_scene(H, W, NUM_FRAMES + 1)
    runner = InferenceRunner(model=model, construction="auto", device="cuda")
    order = runner.neighbor_order(poses)
    full = runner.plan_for(poses[order], intr[order], 1.0, (H, W))
    plan, rect_views = runner.mixed_plan(poses[order], intr[order], 1.0,
                                         (H, W))
    if full.ok or plan is None or not plan.twopass:
        raise RuntimeError(f"mixed scene: full plan ok={full.ok}, partial "
                           f"plan {plan}")
    print(f"phase 4: mixed scene: full plan rejected ({full.reason}); "
          f"rect_views {rect_views} of {NUM_FRAMES}, h_r={plan.h_r} "
          f"w_r={plan.w_r} ws_r={plan.ws_r} view_s_max={plan.view_s_max}",
          flush=True)
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    errs, _ = hold_rect_kernels(torch, plan, H // 4, W // 4, "mixed",
                                phase="phase 4")
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = tf32
    disp, graphed = graphed_pass(torch, runner, images, poses, intr, "mixed")
    times, peak = graphed["s_per_view"], graphed["peak_bytes"]
    launches = graphed["launches"]
    n_stages, n_rect = len(model.cascade), len(rect_views)
    expect = {k: 0 for k in KERNELS}
    expect.update(epiband_fwd=3 * n_stages * n_rect,
                  hat_rows_fwd=3 * (2 + n_stages) * 2 * n_rect)
    d = disp[0].float().cpu().numpy()
    beside = ", ".join(f"{k} {[round(t, 4) for t in v['s_per_view']]} s/view "
                       f"peak {v['peak_bytes'] / 2**30:.2f} GiB"
                       for k, v in passes.items())
    print(f"phase 4: mixed {[round(t, 4) for t in times]} s/view, path="
          f"{runner.last_path}, peak {peak / 2**30:.2f} GiB ({beside}), "
          f"launches={launches} (expected {expect}), disparity {d.shape} "
          f"range [{d.min():.3e}, {d.max():.3e}]", flush=True)
    if runner.last_path != "mixed":
        raise RuntimeError("the mixed construction was not taken")
    check_launches(launches, expect, "mixed forward")
    if d.shape != (H // 4, W // 4) or not np.isfinite(d).all():
        raise RuntimeError(f"bad mixed disparity: shape {d.shape}")
    if "--profile" in sys.argv:
        busy["mixed"] = profile_graphed(torch, runner, images, poses, intr,
                                        "mixed")
    return dict(s_per_view=times, peak_bytes=peak, rect_views=rect_views,
                launches=launches, kernel_errs=errs, graphed=graphed)


def phase_view_batch(torch, small):
    """Phase 5's view batching: ``inference()`` over VB_ITEMS items of
    VB_HW with VB_FRAMES neighbours (reference views along a DTU-like
    ring), with the bf16 model at view_batch 1 and 4 under "auto" and 4
    under "rectified" (which warns): one warm-up run of half the items,
    then maps/s over the items cycled VB_CYCLES times (a window of seconds:
    the host-bound rate of a handful of maps does not repeat), and each
    record's route. Then with the fp32 model ``small`` (TF32 off), "exact"
    at view_batch 1 and 4: the largest relative difference of the depth
    maps and the share of pixels over 1e-5, with cuDNN (held to
    VB_TOL_CUDNN) and without it (held to VB_TOL)."""
    import warnings

    from cermvs_torch.io.pfm import read_pfm
    from cermvs_torch.models.raft import RAFT
    from cermvs_torch.pipeline.inference import inference

    ring = dtu_ring_poses(VB_FRAMES + VB_ITEMS)
    f = 2892.0 * VB_HW[1] / 1600
    K = np.array([[f, 0, VB_HW[1] / 2], [0, f, VB_HW[0] / 2], [0, 0, 1]],
                 np.float32)
    rng = np.random.RandomState(5)
    items = [((rng.rand(VB_FRAMES + 1, *VB_HW, 3) * 255).astype(np.float32),
              ring[i:i + VB_FRAMES + 1],
              np.tile(K, (VB_FRAMES + 1, 1, 1)), [f"{i:08d}"], 1.0)
             for i in range(VB_ITEMS)]

    model = RAFT(test_mode=True, generator=torch.Generator().manual_seed(0))
    torch.backends.cudnn.allow_tf32 = True  # the bf16 model's own setting
    runs = {}
    with tempfile.TemporaryDirectory(dir=REPO / "build") as out:
        for label, vb, construction, route in (
                ("vb1_auto", 1, "auto", "rectified"),
                ("vb4_auto", 4, "auto", "exact"),
                ("vb4_rectified", 4, "rectified", "rectified")):
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                inference(ItemLoader(items[:VB_ITEMS // 2], VB_FRAMES),
                          model=model, output_folder=out, view_batch=vb,
                          construction=construction)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                records = inference(ItemLoader(items * VB_CYCLES,
                                               VB_FRAMES),
                                    model=model, output_folder=out,
                                    view_batch=vb, construction=construction)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            warned = any("view_batch > 1" in str(w.message) for w in caught)
            routes = [r[2] for r in records]
            runs[label] = dict(maps_per_s=len(records) / wall, wall_s=wall,
                               routes=sorted(set(routes)), warned=warned)
            print(f"phase 5: {label}: {len(records)} maps in {wall:.3f} s, "
                  f"{len(records) / wall:.2f} maps/s, routes "
                  f"{sorted(set(routes))}, warned={warned}", flush=True)
            if (routes != [route] * (VB_ITEMS * VB_CYCLES)
                    or warned != (construction == "rectified")):
                raise RuntimeError(f"phase 5 {label}: routes {routes}, "
                                   f"warned {warned}")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        # with cuDNN the convolutions of a batch of 4N frames may take
        # another algorithm (another summation order) than those of N, and
        # the random weights' iterations amplify that on a few pixels;
        # without it each frame's convolution is computed alike in both
        for cudnn in (True, False):
            maps = {}
            with torch.backends.cudnn.flags(enabled=cudnn, allow_tf32=False):
                for vb in (1, 4):
                    folder = Path(out) / f"exact_vb{vb}_cudnn{cudnn}"
                    inference(ItemLoader(items, VB_FRAMES), model=small,
                              output_folder=folder, view_batch=vb,
                              construction="exact")
                    maps[vb] = np.stack([
                        read_pfm(folder / "depths" /
                                 f"{i:08d}_scale1_nf{VB_FRAMES}.pfm")
                        for i in range(VB_ITEMS)])
            rel = (np.abs(maps[4] - maps[1])
                   / np.maximum(np.abs(maps[1]), 1e-30))
            max_rel, share = float(rel.max()), float((rel > 1e-5).mean())
            runs[f"exact_vb4_vs_vb1_cudnn_{cudnn}"] = {
                "max_rel": max_rel, "share_over_1e-5": share}
            limit = VB_TOL_CUDNN if cudnn else (VB_TOL, 1.0)
            print(f"phase 5: exact view_batch 4 against 1 (fp32, "
                  f"{VB_ITEMS} maps {maps[1][0].shape}, cuDNN {cudnn}): "
                  f"max relative difference {max_rel:.3e}, share of "
                  f"pixels over 1e-5 {share:.2e} (limits {limit})",
                  flush=True)
            if not (max_rel <= limit[0] and share <= limit[1]):
                raise RuntimeError(
                    f"view_batch 4 depth maps differ from view_batch 1 by "
                    f"{max_rel:.3e} (share over 1e-5 {share:.2e}) with "
                    f"cuDNN {cudnn}, limits {limit}")
    return runs


def look_at(eye, target, up=(0.0, 1.0, 0.0)):
    """World-to-camera pose of a camera at ``eye`` looking at ``target``
    (camera x: ``fwd x up``; y: ``fwd x x``)."""
    eye = np.asarray(eye, np.float64)
    fwd = np.asarray(target, np.float64) - eye
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, np.asarray(up, np.float64))
    right /= np.linalg.norm(right)
    R = np.stack([right, np.cross(fwd, right), fwd])
    P = np.eye(4)
    P[:3, :3] = R
    P[:3, 3] = -R @ eye
    return P


def world_rays(P, K, h, w):
    """Each pixel's ray in world coordinates (camera z = 1) and the camera
    centre, for world-to-camera pose P."""
    u, v = np.meshgrid(np.arange(w, dtype=np.float64),
                       np.arange(h, dtype=np.float64))
    d = np.linalg.inv(K) @ np.stack([u.ravel(), v.ravel(), np.ones(u.size)])
    R, t = np.asarray(P, np.float64)[:3, :3], np.asarray(P, np.float64)[:3, 3]
    return R.T @ d, -R.T @ t


def plane_depth(P, K, h, w, axis, value):
    """Depth (camera z) of the world plane ``x[axis] = value`` seen from P,
    (h, w) fp32; 0 where a ray runs away from it."""
    dw, c = world_rays(P, K, h, w)
    with np.errstate(divide="ignore", invalid="ignore"):
        s = (value - c[axis]) / dw[axis]
    return np.where(np.isfinite(s) & (s > 0), s, 0.0).reshape(h, w).astype(
        np.float32)


def pair_lines(centers, num, empty=(), short=()):
    """``pair.txt`` listing each view's ``num`` nearest by camera centre
    (none for the views in ``empty``, five for those in ``short``)."""
    dist = np.linalg.norm(centers[:, None] - centers[None], axis=-1)
    lines = [f"{len(centers)}\n"]
    for i in range(len(centers)):
        k = 0 if i in empty else 5 if i in short else num
        near = [int(j) for j in np.argsort(dist[i], kind="stable")
                if j != i][:k]
        lines += [f"{i}\n", f"{len(near)} " + " ".join(
            f"{j} {100.0 - r:.1f}" for r, j in enumerate(near)) + "\n"]
    return "".join(lines)


def texture(rng, h, w):
    """An (h, w, 3) uint8 image of smooth random texture: noise an eighth
    of the size, resized up (closer to a photo's JPEG than full-size
    noise)."""
    import cv2

    small = rng.randint(0, 256, (max(1, h // 8), max(1, w // 8), 3),
                        dtype=np.uint8)
    return cv2.resize(small, (w, h), interpolation=cv2.INTER_CUBIC)


def tnt_intrinsics(scale=1.0):
    h, w = TNT_HW
    return np.array([[TNT_F, 0, w / 2], [0, TNT_F, h / 2], [0, 0, 1]]) * [
        [scale], [scale], [1.0]]


def tnt_poses(scan):
    """World-to-camera poses (m) of a scan's TNT_VIEWS cameras. Ignatius:
    an orbit 3 m about an object at the origin, 4 degrees apart.
    Meetingroom: an indoor walk toward the wall at z = TNT_WALL_Z, 0.1 m
    forward a frame, swaying up to 0.3 m sideways with a little yaw, so
    that neighbours a few frames apart lie ahead of the reference."""
    poses = []
    for i in range(TNT_VIEWS):
        if scan == "Ignatius":
            az = np.deg2rad(4.0 * (i - (TNT_VIEWS - 1) / 2))
            eye = 3.0 * np.array([np.sin(az), -0.1, -np.cos(az)])
            poses.append(look_at(eye, [0.0, 0.0, 0.0]))
        else:
            eye = np.array([0.3 * np.sin(0.9 * i), 0.02 * (i % 2), 0.1 * i])
            yaw = np.deg2rad(2.0 * np.sin(0.5 * i))
            poses.append(look_at(eye, eye + [np.sin(yaw), 0.0, np.cos(yaw)]))
    return np.stack(poses)


def tnt_true_depth(scan, P, K, h, w):
    if scan == "Ignatius":
        return sphere_depth(P, K, h, w, radius=TNT_OBJECT_R)
    return plane_depth(P, K, h, w, 2, TNT_WALL_Z)


def write_tnt_scan(root, scan, seed):
    """``training_input/<scan>`` as the TNT dataset reads it: TNT_VIEWS
    JPEGs of smooth random texture of TNT_HW, camera files with the scan's
    aux row, and ``pair.txt`` with TNT_PAIRS nearest views each, none for
    view TNT_EMPTY."""
    import cv2

    from cermvs_torch.data.cams import write_cam_file

    d = Path(root) / "training_input" / scan
    (d / "images").mkdir(parents=True)
    (d / "cams").mkdir()
    poses = tnt_poses(scan)
    rng = np.random.RandomState(seed)
    for i, P in enumerate(poses):
        write_cam_file(d / "cams" / f"{i:08d}_cam.txt", P, tnt_intrinsics(),
                       aux=TNT_AUX[scan])
        cv2.imwrite(str(d / "images" / f"{i:08d}.jpg"),
                    texture(rng, *TNT_HW), [cv2.IMWRITE_JPEG_QUALITY, 90])
    centers = np.stack([-P[:3, :3].T @ P[:3, 3] for P in poses])
    (d / "pair.txt").write_text(pair_lines(centers, TNT_PAIRS,
                                           empty=(TNT_EMPTY,)))


def rss_gib():
    """The process's resident host memory (GiB)."""
    with open("/proc/self/status") as f:
        kib = next(int(line.split()[1]) for line in f
                   if line.startswith("VmRSS:"))
    return kib / 2**20


def tnt_item(root, scan, index, num_frames, rescale):
    """One TNT item prepared as ``inference()`` prepares it (scale, crop to
    the stride): numpy frames, poses, intrinsics, the item's scale."""
    from cermvs_torch.data.augment import pad_to_multiple, scale_operation
    from cermvs_torch.data.tnt import TNT

    images, poses, intr, names, scale = TNT(
        dataset_path=str(root), scan=scan, num_frames=num_frames)[index]
    images, intr = scale_operation(images, intr, rescale)
    images, intr = pad_to_multiple(images, intr, 4)
    return images, poses, intr, names, scale


def phase_tnt_demo(torch, root):
    """The demo's Tanks and Temples half on synthetic Ignatius (an orbit)
    and Meetingroom (a forward walk) scans of TNT_HW, with random weights:
    ``demo.run_tnt_depths`` (inference at rescale 1 with 15 neighbours and
    at rescale 2 with 25, multires) over views 0, 12 and 24 of each scan
    (``get_test_data_loader.subset``); then each scan's fusion
    (``demo.run_tnt_fusion``, rescale 1) of those views' merged maps beside
    the true depths of the other views, whose points must lie on the true
    surface. Then one rescale-2 key through a runner's graph (replay
    against eager, bit for bit), and a runner capturing TNT_GRAPHS keys
    with its reserved memory and the host's RSS after each."""
    from cermvs_torch import config as pcfg
    from cermvs_torch import demo
    from cermvs_torch.io.pfm import read_pfm, write_pfm
    from cermvs_torch.io.ply import read_ply
    from cermvs_torch.models.raft import RAFT
    from cermvs_torch.ops import cudalib
    from cermvs_torch.pipeline.inference import InferenceRunner
    from cermvs_torch.training.checkpoint import save_params

    os.chdir(REPO)
    t0 = time.perf_counter()
    for k, scan in enumerate(TNT_SCANS):
        write_tnt_scan(root / "TNT", scan, seed=20 + k)
    model = RAFT(test_mode=True, generator=torch.Generator().manual_seed(2))
    ckpt = root / "pretrained" / "train_BlendedMVS"
    save_params(ckpt, model)
    common = [f'TNT.dataset_path = "{root / "TNT"}"']
    refs = [f"{i:08d}" for i in range(*TNT_SUBSET)]
    print(f"phase 11: TNT scans {TNT_SCANS} ({TNT_VIEWS} views of {TNT_HW}, "
          f"view {TNT_EMPTY}'s pair list empty) and random weights written "
          f"in {time.perf_counter() - t0:.1f} s; references {refs}",
          flush=True)
    out = root / "results"
    runs = {}
    for scan in TNT_SCANS:
        pcfg.clear_config()
        pcfg.parse_config(common + [
            f"get_test_data_loader.subset = {TNT_SUBSET}"])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        cudalib.reset_launches()
        t0 = time.perf_counter()
        records = demo.run_tnt_depths(scan, str(ckpt), out)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        run = {"wall_s": wall, "launches": {k: cudalib.launches.get(k, 0)
                                            for k in KERNELS},
               "peak_bytes": torch.cuda.max_memory_allocated(),
               "peak_reserved_bytes": torch.cuda.max_memory_reserved()}
        for rescale, nf in ((1, 15), (2, 25)):
            recs = records[rescale]
            run[f"rescale{rescale}"] = {
                "routes": [r[2] for r in recs],
                "s_per_view": [r[1] for r in recs],
                "capture_s": [r[3] for r in recs]}
            print(f"phase 11: {scan} rescale {rescale} nf{nf}: views "
                  f"{[r[0] for r in recs]}, routes {[r[2] for r in recs]}, "
                  f"s/view (pipeline-inclusive) "
                  f"{[round(r[1], 3) for r in recs]}, of which the next "
                  f"key's first dispatch (eager and capture) "
                  f"{[round(r[3], 3) for r in recs]}", flush=True)
            if [r[0] for r in recs] != refs:
                raise RuntimeError(f"{scan}: records {recs}")
            for name in refs:
                d = read_pfm(out / scan / "depths"
                             / f"{name}_scale{rescale}_nf{nf}.pfm")
                if not np.isfinite(d).all():
                    raise RuntimeError(f"{scan} {name}: non-finite depths")
        for name in refs:
            m = read_pfm(out / scan / "depths"
                         / f"{name}_nf15_nf25_th0.02.pfm")
            if m.shape != (TNT_HW[0] // 2, TNT_HW[1] // 2) or not np.isfinite(
                    m).all():
                raise RuntimeError(f"{scan} {name}: merged map {m.shape}")
        print(f"phase 11: {scan}: both passes and multires in {wall:.1f} s, "
              f"peak {run['peak_bytes'] / 2**30:.2f} GiB allocated, "
              f"{run['peak_reserved_bytes'] / 2**30:.2f} GiB reserved, "
              f"launches {run['launches']}", flush=True)
        runs[scan] = run
    routes = sorted({r for run in runs.values() for k in ("rescale1",
                                                          "rescale2")
                     for r in run[k]["routes"]})
    print(f"phase 11: routes taken {routes}", flush=True)
    # fusion needs every view's map: the other views' true depths
    pcfg.clear_config()
    pcfg.parse_config(common)
    h, w = TNT_HW[0] // 2, TNT_HW[1] // 2
    fused = {}
    for scan in TNT_SCANS:
        for i, P in enumerate(tnt_poses(scan)):
            f = out / scan / "depths" / f"{i:08d}_nf15_nf25_th0.02.pfm"
            if not f.exists():
                write_pfm(f, tnt_true_depth(scan, P, tnt_intrinsics(0.5),
                                            h, w))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ply = demo.run_tnt_fusion(scan, out)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        xyz, _ = read_ply(ply)
        xyz = xyz.astype(np.float64)
        err = (np.abs(np.linalg.norm(xyz, axis=1) - TNT_OBJECT_R)
               if scan == "Ignatius" else np.abs(xyz[:, 2] - TNT_WALL_Z))
        on = float((err <= TNT_TOL).mean()) if len(xyz) else 0.0
        print(f"phase 11: {scan} fusion (rescale 1) in {secs:.2f} s: "
              f"{len(xyz)} points, {on:.4f} within {TNT_TOL} m of the true "
              f"surface (median {np.median(err):.2e} m)", flush=True)
        if Path(ply) != out / scan / "result.ply" or on < 0.98 or len(
                xyz) < 0.02 * (TNT_VIEWS - 3) * h * w:
            raise RuntimeError(f"{scan}: fused cloud off the surface")
        fused[scan] = {"seconds": secs, "points": len(xyz), "on_surface": on}
    # one rescale-2 key through a runner's graph, and a runner's memory
    # as it holds more graphs
    images, poses, intr, names, scale = tnt_item(root / "TNT", "Ignatius", 0,
                                                 25, 2)
    runner = InferenceRunner(model=model, device="cuda")
    _, graphed = graphed_pass(torch, runner, images, poses, intr,
                              f"Ignatius {names[0]} rescale 2 nf25", reps=1,
                              scale=scale, phase="phase 11")
    graphed["route"] = runner.last_path
    del runner, images
    released(torch, "phase 11, graph growth")
    runner = InferenceRunner(model=model, device="cuda")
    growth = []
    for i in range(TNT_GRAPHS):
        item = tnt_item(root / "TNT", "Meetingroom", i, 15, 1)
        runner.submit(*item[:3], item[4])
        torch.cuda.synchronize()
        growth.append({"graphs": len(runner._cache), "route":
                       runner.last_path, "capture_s": runner.last_capture_s,
                       "reserved_bytes": torch.cuda.memory_reserved(),
                       "pool_bytes": graph_pool_bytes(torch, runner._pool),
                       "rss_gib": rss_gib()})
    print(f"phase 11: one runner at rescale 1 nf15 holding 1..{TNT_GRAPHS} "
          f"graphs: reserved GiB "
          f"{[round(g['reserved_bytes'] / 2**30, 2) for g in growth]}, pool "
          f"GiB {[round(g['pool_bytes'] / 2**30, 2) for g in growth]}, host "
          f"RSS GiB {[round(g['rss_gib'], 2) for g in growth]}, routes "
          f"{[g['route'] for g in growth]}, captures s "
          f"{[round(g['capture_s'], 3) for g in growth]}", flush=True)
    if [g["graphs"] for g in growth] != list(range(1, TNT_GRAPHS + 1)):
        raise RuntimeError(f"graphs held {growth}")
    return {"scans": runs, "routes": routes, "fusion": fused,
            "graphed_rescale2": {k: v for k, v in graphed.items()
                                 if k != "launches"},
            "graph_growth": growth,
            "launches": {k: sum(r["launches"][k] for r in runs.values())
                         for k in KERNELS}}


def write_custom(root, seed=0):
    """A TUM directory of CUSTOM_FRAMES smooth-texture JPEGs of CUSTOM_HW:
    a hand-held sideways walk, 5 cm a frame with a little forward sway,
    facing +z; one intrinsic matrix (525 px)."""
    import cv2

    root = Path(root)
    (root / "images").mkdir(parents=True)
    rng = np.random.RandomState(seed)
    rows = []
    for i in range(CUSTOM_FRAMES):
        cv2.imwrite(str(root / "images" / f"{i:06d}.jpg"),
                    texture(rng, *CUSTOM_HW))
        rows.append([0.1 * i, 0.05 * i, 0.01 * np.sin(i), 0.02 * np.cos(i),
                     0.0, 0.0, 0.0, 1.0])
    np.savetxt(root / "cams.txt", np.asarray(rows))
    h, w = CUSTOM_HW
    np.savetxt(root / "intrinsic.txt",
               [[525.0, 0, w / 2], [0, 525.0, h / 2], [0, 0, 1]])


def phase_custom_demo(torch, root):
    """``demo_custom``'s three passes (0.5x with 10 neighbours writing the
    min-depth files, then 1x with 15 and 2x with 25 reading them), multires
    and fusion at rescale 1, on a TUM directory of CUSTOM_FRAMES frames of
    CUSTOM_HW, with random weights. Checks every pass's files, the
    min-depth files and the fused cloud."""
    from cermvs_torch import config as pcfg
    from cermvs_torch import demo_custom
    from cermvs_torch.io.pfm import read_pfm
    from cermvs_torch.io.ply import read_ply
    from cermvs_torch.models.raft import RAFT
    from cermvs_torch.ops import cudalib
    from cermvs_torch.training.checkpoint import save_params

    data, out = root / "custom", root / "results" / "custom"
    write_custom(data)
    ckpt = root / "pretrained" / "custom"
    save_params(ckpt, RAFT(test_mode=True,
                           generator=torch.Generator().manual_seed(3)))
    pcfg.clear_config()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cudalib.reset_launches()
    t0 = time.perf_counter()
    records, ply = demo_custom.run_custom(str(data), str(ckpt), out)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    names = [f"{i:06d}" for i in range(CUSTOM_FRAMES)]
    passes = {}
    for (rescale, nf), recs in zip(demo_custom.PASSES, records):
        passes[f"{rescale}_nf{nf}"] = {
            "routes": sorted({r[2] for r in recs}),
            "s_per_view": [r[1] for r in recs],
            "capture_s": [r[3] for r in recs]}
        print(f"phase 12: pass rescale {rescale} nf{nf}: {len(recs)} views, "
              f"routes {sorted({r[2] for r in recs})}, s/view median "
              f"{np.median([r[1] for r in recs]):.3f} max "
              f"{max(r[1] for r in recs):.3f}, keys first dispatched "
              f"{sum(r[3] > 0 for r in recs) + 1}", flush=True)
        if [r[0] for r in recs] != names:
            raise RuntimeError(f"pass {rescale}: records {recs}")
        for name in names:
            d = read_pfm(out / "depths" / f"{name}_scale{rescale}_nf{nf}.pfm")
            if not np.isfinite(d).all():
                raise RuntimeError(f"{name} at {rescale}: non-finite depths")
    md = [float(np.loadtxt(data / "min_depth" / f"{n}.txt")) for n in names]
    merged = [read_pfm(out / "depths" / f"{n}_nf15_nf25_th0.02.pfm")
              for n in names]
    xyz, _ = read_ply(ply)
    print(f"phase 12: demo_custom ({CUSTOM_FRAMES} frames of {CUSTOM_HW}) in "
          f"{wall:.1f} s; min-depth files {len(md)}, range "
          f"[{min(md):.3e}, {max(md):.3e}]; {len(merged)} merged maps; "
          f"fused {len(xyz)} points; peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB allocated, "
          f"{torch.cuda.max_memory_reserved() / 2**30:.2f} GiB reserved",
          flush=True)
    if not (all(np.isfinite(md)) and min(md) > 0 and all(
            np.isfinite(m).all() for m in merged)):
        raise RuntimeError("bad min-depth files or merged maps")
    if Path(ply) != out / "result.ply" or not np.isfinite(xyz).all():
        raise RuntimeError(f"bad fused cloud {ply}")
    return {"wall_s": wall, "passes": passes, "min_depth": [min(md),
                                                            max(md)],
            "fusion_points": len(xyz),
            "peak_bytes": torch.cuda.max_memory_allocated(),
            "peak_reserved_bytes": torch.cuda.max_memory_reserved(),
            "launches": {k: cudalib.launches.get(k, 0) for k in KERNELS}}


def blended_poses():
    """World-to-camera poses of the BlendedMVS scene: BL_ORBIT cameras of a
    drone orbit 600 units about a building at the origin (4 degrees apart,
    looking down a little), BL_SWEEP of a lawnmower sweep 600 units above
    the ground (40 apart, looking down), and BL_WALK walking toward the
    building along the optical axis (60 apart), as
    tests/test_blended_construction.py builds them."""
    poses = []
    for i in range(BL_ORBIT):
        a = np.deg2rad(4.0 * ((i + 1) // 2) * (1 if i % 2 else -1))
        poses.append(look_at(600.0 * np.array([np.sin(a), -0.3, -np.cos(a)]),
                             [0.0, 0.0, 0.0]))
    for i in range(BL_SWEEP):
        eye = np.array([40.0 * ((i + 1) // 2) * (1 if i % 2 else -1), -600.0,
                        10.0 * (i % 2)])
        poses.append(look_at(eye, [eye[0] * 0.8, 0.0, eye[2] * 0.8],
                             up=(0.0, 0.0, 1.0)))
    for i in range(BL_WALK):
        poses.append(look_at([1.0 * (i % 2), 0.0, -900.0 + 60.0 * i],
                             [0.0, 0.0, 100.0]))
    return np.stack(poses)


def blended_depth(P, K, h, w):
    """Depth of the scene (a building of radius 200 at the origin on the
    ground plane y = 200) from P, (h, w) fp32."""
    dw, c = world_rays(P, K, h, w)
    a = (dw * dw).sum(0)
    b = c @ dw
    disc = b * b - a * (c @ c - 200.0 ** 2)
    s_sphere = np.where(disc > 0, (-b - np.sqrt(np.maximum(disc, 0))) / a,
                        np.inf)
    with np.errstate(divide="ignore", invalid="ignore"):
        s_ground = (200.0 - c[1]) / dw[1]
    s_ground = np.where(np.isfinite(s_ground) & (s_ground > 0), s_ground,
                        np.inf)
    s = np.minimum(np.where(s_sphere > 0, s_sphere, np.inf), s_ground)
    return np.where(np.isfinite(s), s, 0.0).reshape(h, w).astype(np.float32)


def write_blended_tree(root, seed=0):
    """One BlendedMVS scene as the Blended dataset reads it:
    ``dataset_full_res_0-29/<hash>/<hash>/<hash>/`` with smooth-texture
    JPEGs of BL_HW, its true depths as PFMs, camera files and ``pair.txt``
    (each view's 10 nearest; five for the walk's later views, so the walk
    gives one reference). Returns the scene's directory."""
    import cv2

    from cermvs_torch.data.blended import TRAINING_SET
    from cermvs_torch.data.cams import write_cam_file
    from cermvs_torch.io.pfm import write_pfm

    scene = TRAINING_SET[0]
    d = Path(root) / "dataset_full_res_0-29" / scene / scene / scene
    for sub in ("blended_images", "rendered_depth_maps", "cams"):
        (d / sub).mkdir(parents=True)
    h, w = BL_HW
    K = np.array([[BL_F, 0, w / 2], [0, BL_F, h / 2], [0, 0, 1]])
    poses = blended_poses()
    rng = np.random.RandomState(seed)
    for i, P in enumerate(poses):
        depth = blended_depth(P, K, h, w)
        valid = depth[depth > 0]
        write_cam_file(d / "cams" / f"{i:08d}_cam.txt", P, K,
                       aux=[float(valid.min()), 1.0, 128,
                            float(valid.max())])
        write_pfm(d / "rendered_depth_maps" / f"{i:08d}.pfm", depth)
        cv2.imwrite(str(d / "blended_images" / f"{i:08d}.jpg"),
                    texture(rng, h, w), [cv2.IMWRITE_JPEG_QUALITY, 90])
    centers = np.stack([-P[:3, :3].T @ P[:3, 3] for P in poses])
    walk = BL_ORBIT + BL_SWEEP
    (d / "cams" / "pair.txt").write_text(pair_lines(
        centers, NUM_FRAMES, short=range(walk + 1, walk + BL_WALK)))
    return d


def hold_epiband_at_plan(torch, plan, phase):
    """epiband_fwd and both gradients against their plain versions at one
    training plan's widest view: stage 0 (base == 0) and stage 1 (the main
    path's bases), fp32 and bf16, at phase 2's and phase 8's tolerances.
    Prints the widest run of source columns one 64-pixel tile's stage-1
    taps reach (the bf16 kernel stages 128-column chunks). Returns each
    kernel's largest error."""
    from cermvs_torch.ops import epiband as eb

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.RandomState(13)
    rates = np.asarray(plan.view_rates)
    vmax = int(np.argmax(plan.view_s_max))
    s_v = plan.view_s_max[vmax]
    ws_v = plan.ws_r - (plan.s_max - s_v)
    (d0, inc0), (d1, inc1) = STAGES
    errs = {"epiband_fwd": 0.0, "epiband_bwd_dfr": 0.0, "epiband_bwd_dfs": 0.0}
    shape = f"h_r={plan.h_r} w_r={plan.w_r} ws={ws_v} s_max={s_v}"
    band = None
    for dtype, ftol, btol in ((torch.float32, (1e-4, 1e-3), (1e-4, 1e-3)),
                              (torch.bfloat16, (1e-3, 1e-2), (1e-2, 1e-2))):
        for stage, D, base_kind, inc in (("stage0", d0, None, inc0),
                                         ("stage1", d1, "main", inc1)):
            fr, fs, base, sigma = epiband_case(
                torch, rng, plan.h_r, plan.w_r, ws_v, C_FEAT, D, base_kind,
                tuple(rates[vmax] * inc), dtype, (d0, inc0 / inc1))
            if stage == "stage1" and band is None:
                x = torch.arange(plan.w_r, device="cuda", dtype=torch.float32)
                k = torch.arange(D, device="cuda", dtype=torch.float32)
                pos = (x + float(s_v))[None, None, :, None] - (
                    base[..., None] + sigma[..., None] * k)
                pos = pos.clamp(-1, ws_v)
                pad = -plan.w_r % 64
                lo = torch.nn.functional.pad(pos.amin(-1), (0, pad),
                                             value=float(ws_v))
                hi = torch.nn.functional.pad(pos.amax(-1), (0, pad),
                                             value=-1.0)
                band = int((hi.reshape(-1, 64).amax(-1)
                            - lo.reshape(-1, 64).amin(-1)).max()) + 2
            out = eb.epiband(fr, fs, base, sigma, D, s_v)
            torch.cuda.synchronize()
            ref = eb.epiband_reference(fr, fs, base, sigma, D, s_v)
            e = float((out - ref).abs().max())
            ok = bool(torch.allclose(out, ref, rtol=ftol[0], atol=ftol[1]))
            errs["epiband_fwd"] = max(errs["epiband_fwd"], e)
            print(f"{phase}: epiband_fwd {shape} {stage} D={D} "
                  f"{str(dtype)[6:]}: max|kernel-plain|={e:.3e} ok={ok}",
                  flush=True)
            if not ok:
                raise RuntimeError(f"epiband_fwd disagrees with its plain "
                                   f"version ({phase}, {stage}, {dtype})")
            del out, ref
            dout = torch.randn((1, plan.h_r, plan.w_r, D), device="cuda",
                               generator=torch.Generator(device="cuda")
                               .manual_seed(int(rng.randint(2**31))))
            args = (fr, fs, base, sigma, dout, s_v)
            got = (eb.backward_dfr(*args), eb.backward_dfs(*args))
            torch.cuda.synchronize()
            ref = eb.epiband_backward_reference(*args)
            for name, a, b in zip(("epiband_bwd_dfr", "epiband_bwd_dfs"),
                                  got, ref):
                e = float((a.float() - b.float()).abs().max())
                differ = float((a != b).float().mean())
                ok = bool(torch.allclose(a.float(), b.float(), rtol=btol[0],
                                         atol=btol[1])) and (
                    dtype != torch.bfloat16 or differ < 0.01)
                errs[name] = max(errs[name], e)
                print(f"{phase}: {name} {shape} {stage} D={D} "
                      f"{str(dtype)[6:]}: max|kernel-plain|={e:.3e}, share "
                      f"differing {differ:.4f}, ok={ok}", flush=True)
                if not ok:
                    raise RuntimeError(f"{name} disagrees with its plain "
                                       f"version ({phase}, {stage}, {dtype})")
            del got, ref, fr, fs
    print(f"{phase}: widest stage-1 band of a 64-pixel tile: {band} source "
          f"columns (the bf16 kernel's chunk: 128)", flush=True)
    return errs, {"shape": [1, plan.h_r, plan.w_r, ws_v, C_FEAT],
                  "s_max": s_v, "stage1_tile_band": band}


def phase_blended_train(torch, tree):
    """``train()`` with ``train_BlendedMVS.gin`` (batch 2, nf10, crop
    1376x1824, rectified) for BL_STEPS + 1 steps through the step graphs
    on a synthetic BlendedMVS scene (orbit, sweep and one forward-walk
    reference): each step's route and plan key, each key's first dispatch
    and the memory after it, replayed s/step, peaks. Checks that every
    batch but the walk's took the rectified construction and the walk's
    the exact one, the values and the launches; holds a replay against
    eager steps on the first batch; holds the epiband forward and both
    gradients against their plain versions at the widest plan the run
    took."""
    from cermvs_torch import config as pcfg
    from cermvs_torch import data
    from cermvs_torch.models.raft import RAFT
    from cermvs_torch.ops.rectify import PlanCache
    from cermvs_torch.training.step import (StepRunner, batch_to_device,
                                            init_state)
    from cermvs_torch.training.train import plan_batch

    t0 = time.perf_counter()
    write_blended_tree(tree)
    pcfg.clear_config()
    pcfg.parse_config_file(str(REPO / "configs" / "train_BlendedMVS.gin"))
    pcfg.bind_parameter("Blended.dataset_path", str(tree))
    pcfg.bind_parameter("train.num_steps", BL_STEPS)
    # one loader thread: the crops, drawn from the dataset's one RandomState,
    # then follow the seed and not the threads' order, so the run's plan keys
    # (8 in 12 steps, 4 replays) are the same in every run
    pcfg.bind_parameter("get_train_data_loader.num_workers", 1)
    crop = pcfg.query_parameter("random_scale_and_crop.crop_size")
    print(f"phase 13: BlendedMVS scene ({BL_ORBIT} orbit, {BL_SWEEP} sweep, "
          f"{BL_WALK} walk cameras, {BL_HW} JPEGs and PFM depths) written in "
          f"{time.perf_counter() - t0:.1f} s; crop {crop}", flush=True)
    torch.backends.cudnn.allow_tf32 = True  # the bf16 model's own setting
    state, run = train_through_graphs(torch, tree, "phase 13",
                                      "chip_smoke_blended")
    records, launches, steps = run["records"], run["launches"], run["steps"]
    routes = ["exact" if r["plan"] is None else "rectified" for r in records]
    expect = train_launches(records, state.model)
    print(f"phase 13: routes per step {routes}; launches {launches} "
          f"(expected {expect})", flush=True)
    if steps != BL_STEPS + 1 or routes.count("exact") != 1:
        raise RuntimeError(f"{steps} steps, routes {routes}: the walk's "
                           f"batch alone must take the exact construction")
    for r in records:
        m = r["metrics"]
        if not (np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"])
                and m["grad_norm"] > 0):
            raise RuntimeError(f"bad step metrics {m}")
    if launches != expect:
        raise RuntimeError(f"launches {launches} != {expect}")
    widest = max((r["plan"] for r in records if r["plan"] is not None),
                 key=lambda p: (p.ws_r, p.h_r * p.w_r))
    # replay against eager steps: an eager step beside the run's graph pool
    # (64 GiB) does not fit the card, so a fresh state steps eagerly first,
    # then captures and replays, on the first batch of a fresh loader that
    # plans (the walk's does not)
    del state
    released(torch, "phase 13, replay against eager")
    load_s = []
    t0 = time.perf_counter()
    for batch in data.get_train_data_loader(batch_size=2, num_workers=0):
        load_s.append(time.perf_counter() - t0)
        plan = plan_batch(batch, 4)
        if plan.ok:
            break
        t0 = time.perf_counter()
    plan = PlanCache().key_for(plan)
    fresh = init_state(RAFT(device="cuda"), BL_STEPS)
    fresh.runner = StepRunner(fresh)
    check = replay_against_eager(torch, fresh, batch_to_device(batch, "cuda"),
                                 plan, "phase 13", "the first planned batch",
                                 graph_first=False)
    # a replayed step on a batch already on the card: the step without the
    # loader, the plan and the upload
    resident = batch_to_device(batch, "cuda")
    replay_s = [synced_s(torch, lambda: fresh.runner(resident, 0.5, plan))[0]
                for _ in range(3)]
    print(f"phase 13: a batch loaded in one thread in "
          f"{[round(t, 3) for t in load_s]} s; replayed steps on a resident "
          f"batch {[round(t, 4) for t in replay_s]} s", flush=True)
    loader_parts = time_blended_loader(tree, crop)
    del fresh, resident
    released(torch, "phase 13, kernels at the widest plan")
    errs, at = hold_epiband_at_plan(torch, widest, "phase 13")
    plans = {plan_label(r["plan"]) for r in records}
    return {"launches": launches, "s_per_step": run["replay_s_per_step"],
            "keys": run["keys"], "routes": routes,
            "peak_bytes": run["peak_bytes"],
            "peak_reserved_bytes": run["peak_reserved_bytes"],
            "graph_pool_bytes": run["graph_pool_bytes"], "steps": steps,
            "wall_s": run["wall_s"], "kernel_errs": errs, "widest_plan": at,
            "load_s_one_thread": load_s, "resident_replay_s": replay_s,
            "loader_parts_s": loader_parts,
            "plans": [str(p) for p in sorted(plans, key=str)], **check}


def time_blended_loader(tree, crop):
    """One batch (two samples of NUM_FRAMES + 1 views) of the synthetic
    BlendedMVS scene read part by part as ``Blended.__getitem__`` reads it,
    in one thread, each part summed over the batch: the JPEG decode, the
    float32 cast, the PFM read (the host data runtime's codec, which the
    loader uses, and the Python reader), ``np.median`` over the valid
    depths, and the scale and crop (the host data runtime's, which the
    loader uses, and cv2's, at one scale); then one sample's native crop
    four times in a row and in four threads at once, as the loader's
    threads run it. Returns seconds by part."""
    import cv2

    from cermvs_torch.data.augment import _resize_stack
    from cermvs_torch.data.blended import Blended
    from cermvs_torch.io import native, pfm

    ds = Blended(dataset_path=str(tree), num_frames=NUM_FRAMES)
    parts = dict.fromkeys(("jpeg_decode", "float32_cast", "pfm_native",
                           "pfm_python", "median", "crop_native",
                           "crop_cv2", "crop_native_4_serial",
                           "crop_native_4_threads"), 0.0)

    def timed(part, fn):
        t0 = time.perf_counter()
        out = fn()
        parts[part] += time.perf_counter() - t0
        return out

    ch, cw = crop
    for index in (0, 1):
        scene, ref, neighbors = ds.index[index]
        d = ds._scene_dir(scene)
        images, depths = [], []
        for i in [ref] + list(neighbors):
            img = timed("jpeg_decode", lambda: cv2.imread(
                str(d / "blended_images" / f"{i:08d}.jpg")))
            images.append(timed("float32_cast",
                                lambda: img.astype(np.float32)))
            path = d / "rendered_depth_maps" / f"{i:08d}.pfm"
            depth = timed("pfm_native", lambda: native.read_pfm(path))
            if not np.array_equal(timed("pfm_python",
                                        lambda: pfm.read_pfm(path)), depth):
                raise RuntimeError(f"the PFM readers differ on {path}")
            depths.append(depth)
        images, depths = np.stack(images), np.stack(depths)
        timed("median", lambda: np.median(depths[depths > 0]))
        h, w = images.shape[1:3]
        rh, rw = int(2.0 ** 0.2 * h), int(2.0 ** 0.2 * w)
        y0, x0 = (rh - ch) // 2, (rw - cw) // 2
        timed("crop_native", lambda: (
            native.scale_and_crop(images, rh, rw, y0, x0, ch, cw, False),
            native.scale_and_crop(depths, rh, rw, y0, x0, ch, cw, True)))
        timed("crop_cv2", lambda: (
            _resize_stack(images, rh, rw, cv2.INTER_LINEAR)[
                :, y0:y0 + ch, x0:x0 + cw],
            _resize_stack(depths, rh, rw, cv2.INTER_NEAREST)[
                :, y0:y0 + ch, x0:x0 + cw]))
    # the loader's four threads each crop a sample while the runtime
    # splits each resize over up to eight threads of its own: the last
    # sample's crop four times, one after another and four at once
    crop_one = (lambda: native.scale_and_crop(images, rh, rw, y0, x0, ch,
                                              cw, False))
    timed("crop_native_4_serial", lambda: [crop_one() for _ in range(4)])
    with ThreadPoolExecutor(4) as pool:
        timed("crop_native_4_threads", lambda: [
            f.result() for f in [pool.submit(crop_one) for _ in range(4)]])
    print(f"phase 13: one batch ({2 * (NUM_FRAMES + 1)} frames of {BL_HW}) "
          f"read part by part in one thread, s: "
          f"{ {k: round(v, 4) for k, v in parts.items()} } (the loader "
          f"reads PFMs and crops natively; pfm_python and crop_cv2 beside; "
          f"crop_native_4_*: one sample's images four times)",
          flush=True)
    return parts


def host_runtime(torch):
    """Phase 1: this host's build of the host data runtime against its
    numpy version at the training crops (DTU 1200x1600 -> 1056x1440,
    BlendedMVS 1536x2048 -> 1376x1824, two frames each, scale 2^0.3):
    bilinear images at ``native.bilinear_tolerance``, nearest depths bit
    for bit; its PFM codec against the Python reader; each call's seconds.
    Then ``BasicEncoder(norm_fn="group")`` (HR, fp32, TF32 off) on the
    card against the CPU, rtol 1e-4 / atol 1e-4."""
    from cermvs_torch.io import native, pfm
    from cermvs_torch.models.extractor import BasicEncoder, init_conv_

    rng = np.random.RandomState(5)
    out = {}
    for name, (h, w), (ch, cw) in (("dtu", DTU_HW, (1056, 1440)),
                                   ("blended", BL_HW, (1376, 1824))):
        images = (rng.rand(2, h, w, 3) * 255).astype(np.float32)
        depths = (rng.rand(2, h, w) * 500 + 100).astype(np.float32)
        rh, rw = int(2.0 ** 0.3 * h), int(2.0 ** 0.3 * w)
        y0, x0 = (rh - ch) // 3, (rw - cw) // 2
        args = (rh, rw, y0, x0, ch, cw)
        t0 = time.perf_counter()
        img = native.scale_and_crop(images, *args, False)
        t1 = time.perf_counter()
        dep = native.scale_and_crop(depths, *args, True)
        t2 = time.perf_counter()
        err = float(np.abs(img - native.scale_and_crop_reference(
            images, *args, False)).max())
        tol = native.bilinear_tolerance(images)
        same = bool(np.array_equal(dep, native.scale_and_crop_reference(
            depths, *args, True)))
        with tempfile.TemporaryDirectory(dir=REPO / "build") as tmp:
            f = Path(tmp) / "d.pfm"
            pfm.write_pfm(f, depths[0])
            t3 = time.perf_counter()
            read = native.read_pfm(f)
            t4 = time.perf_counter()
            pfm_same = bool(np.array_equal(read, pfm.read_pfm(f)))
        out[name] = {"bilinear_max_abs_err": err, "bilinear_tol": tol,
                     "nearest_equal": same, "pfm_equal": pfm_same,
                     "bilinear_s": t1 - t0, "nearest_s": t2 - t1,
                     "pfm_read_s": t4 - t3}
        print(f"phase 1: dataio {name}: 2 frames {(h, w)} -> {(rh, rw)} "
              f"cropped to {(ch, cw)}: bilinear max|native-numpy| {err:.3e}"
              f" (tolerance {tol:.3e}) in {t1 - t0:.3f} s, nearest equal "
              f"{same} in {t2 - t1:.3f} s; PFM read equal {pfm_same} in "
              f"{t4 - t3:.4f} s", flush=True)
        if err > tol or not same or not pfm_same:
            raise RuntimeError(f"the host data runtime disagrees with its "
                               f"numpy version ({name})")
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    enc = BasicEncoder(128, "group", "HR", torch.float32)
    gen = torch.Generator().manual_seed(3)
    for m in enc.modules():
        if isinstance(m, torch.nn.Conv2d):
            init_conv_(m, gen)
    x = torch.from_numpy(rng.randn(2, 384, 512, 3).astype(np.float32))
    with torch.no_grad():
        want = enc(x)
        got = enc.cuda()(x.cuda()).cpu()
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = (
        tf32)
    e = float((got - want).abs().max())
    ok = bool(torch.allclose(got, want, rtol=1e-4, atol=1e-4))
    print(f"phase 1: BasicEncoder(norm_fn=\"group\") HR fp32 on the card "
          f"against the CPU: {tuple(got.shape)}, max|card-cpu| {e:.3e} "
          f"ok={ok}", flush=True)
    if not ok:
        raise RuntimeError("the group-norm encoder disagrees with the CPU")
    out["group_encoder_max_abs_err"] = e
    return out


def world_of_one_inference(torch, mesh, model, routes):
    """Phase 14(a): each route through a runner with a (1, 1) mesh and one
    without: the first dispatch (eager, then the capture with the
    ``all_reduce`` inside) and replays, all held bit for bit against the
    runner without a mesh; PAR_REPLAYS replays of each, in turns, timed.
    Returns the figures and the meshed runs' launches."""
    from cermvs_torch.ops import cudalib
    from cermvs_torch.pipeline.inference import GraphedForward, InferenceRunner

    out, launches = {}, {k: 0 for k in KERNELS}
    for label, construction, (images, poses, intr) in routes:
        meshed = InferenceRunner(model=model, mesh=mesh, device="cuda",
                                 construction=construction)
        plain = InferenceRunner(model=model, device="cuda",
                                construction=construction)
        cudalib.reset_launches()
        first = meshed.submit(images, poses, intr, 1.0).clone()
        replay = meshed.submit(images, poses, intr, 1.0).clone()
        torch.cuda.synchronize()
        for k in KERNELS:
            launches[k] += cudalib.launches.get(k, 0)
        p_first = plain.submit(images, poses, intr, 1.0).clone()
        p_replay = plain.submit(images, poses, intr, 1.0).clone()
        graphed = [isinstance(f, GraphedForward)
                   for f in meshed._cache.values()]
        errs = {"first": float((first - p_first).abs().max()),
                "replay": float((replay - p_first).abs().max()),
                "plain_replay": float((p_replay - p_first).abs().max())}
        times = {"meshed": [], "plain": []}
        for _ in range(PAR_REPLAYS):
            for name, runner in (("plain", plain), ("meshed", meshed)):
                t, _ = synced_s(torch, lambda: runner.submit(
                    images, poses, intr, 1.0))
                times[name].append(t)
        out[label] = {"path": meshed.last_path, "graphed": graphed,
                      "graphs": meshed.graphs, "errs": errs, "s": times}
        print(f"phase 14: (a) world of one, {label}: path "
              f"{meshed.last_path}/{plain.last_path}, captured {graphed}; "
              f"max|meshed - unmeshed| eager {errs['first']}, replay "
              f"{errs['replay']}; replays s (meshed) "
              f"{[round(t, 4) for t in times['meshed']]}, (no mesh) "
              f"{[round(t, 4) for t in times['plain']]}", flush=True)
        if not (meshed.last_path == plain.last_path == label
                and meshed.graphs and graphed == [True]):
            raise RuntimeError(f"phase 14 {label}: route or capture")
        if any(errs.values()):
            raise RuntimeError(f"phase 14 {label}: the meshed forward is "
                               f"not the unmeshed one bit for bit: {errs}")
        del meshed, plain
        released(torch, f"phase 14, {label}")
    return out, launches


def world_of_one_training(torch, tree, batch):
    """Phase 14(a): ``train()`` with ``train_DTU.gin``'s bindings on phase
    8's batch ``PAR_STEPS + 1`` times, with ``data_parallel`` over the world of one and
    without it: every loss and the final weights and AdamW moments bit for
    bit, the grouped steps replayed from graphs that hold the step's
    ``all_reduce`` calls. Returns the figures and the grouped launches."""
    from cermvs_torch import data as data_mod
    from cermvs_torch.ops import cudalib
    from cermvs_torch.training.train import train

    runs = {}
    loader = data_mod.get_train_data_loader
    data_mod.get_train_data_loader = lambda **kw: [batch] * (PAR_STEPS + 1)
    try:
        for grouped in (True, False):
            configure_training(tree)
            records = []

            def on_step(state, metrics, plan):
                torch.cuda.synchronize()
                records.append((time.perf_counter(), metrics["loss"],
                                state.runner.last_dispatch_compiled))

            cudalib.reset_launches()
            torch.cuda.reset_peak_memory_stats()
            with tempfile.TemporaryDirectory(dir=REPO / "build") as ck:
                state = train(name="chip_smoke_par", checkpoint_dir=ck,
                              run_dir=ck, resume=False, log_every=1,
                              on_step=on_step, device="cuda",
                              data_parallel=grouped, num_steps=PAR_STEPS)
            runs[grouped] = {
                "losses": [r[1] for r in records],
                "firsts": [r[2] for r in records],
                "replay_s": [b[0] - a[0] for a, b in zip(records, records[1:])
                             if not b[2]],
                "graphs": state.runner.graphs,
                "group": state.runner.group is not None,
                "launches": {k: cudalib.launches.get(k, 0) for k in KERNELS},
                "peak_reserved_bytes": torch.cuda.max_memory_reserved(),
                "tensors": [p.detach().clone()
                            for p in state.model.parameters()]
                + [t.clone() for st in state.optimizer.state.values()
                   for t in st.values() if torch.is_tensor(t)]}
            del state
            released(torch, f"phase 14, train grouped={grouped}")
    finally:
        data_mod.get_train_data_loader = loader
    g, u = runs[True], runs[False]
    same = (len(g["tensors"]) == len(u["tensors"])
            and all(torch.equal(a, b) for a, b in zip(g["tensors"],
                                                        u["tensors"])))
    print(f"phase 14: (a) train() over the world of one: losses "
          f"{g['losses']} (no group {u['losses']}), first dispatches "
          f"{g['firsts']}, replay s/step {[round(t, 4) for t in g['replay_s']]}"
          f" (no group {[round(t, 4) for t in u['replay_s']]}), weights and "
          f"moments equal: {same}, peak reserved "
          f"{g['peak_reserved_bytes'] / 2**30:.2f} GiB", flush=True)
    if not (g["group"] and g["graphs"] and not u["group"]):
        raise RuntimeError("phase 14: the grouped run was not grouped or "
                           "not captured")
    if g["losses"] != u["losses"] or not same or sum(
            not f for f in g["firsts"]) < 2:
        raise RuntimeError("phase 14: grouped steps differ from ungrouped "
                           "ones, or fewer than two replayed")
    fig = {k: {n: v[n] for n in ("losses", "firsts", "replay_s",
                                  "peak_reserved_bytes")}
           for k, v in (("grouped", g), ("ungrouped", u))}
    return fig, g["launches"]


def run_launcher(tree, tmp):
    """Phase 14(c): ``torchrun --nproc_per_node=1 -m
    cermvs_torch.launch_distributed -g train_DTU -p train.num_steps=1`` on
    phase 8's synthetic tree; its return code and seconds."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node=1", "-m", "cermvs_torch.launch_distributed",
           "-g", "train_DTU", "-p", "train.num_steps=1",
           "-p", f"DTU.dataset_path='{tree}'", "-p", "DTU.light_number=0",
           "-p", f"train.checkpoint_dir='{tmp}/ckpt'",
           "-p", f"train.run_dir='{tmp}/runs'"]
    env = dict(os.environ, PYTHONPATH=str(REPO))
    t0 = time.perf_counter()
    res = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=300)
    secs = time.perf_counter() - t0
    tail = (res.stdout + res.stderr).strip().splitlines()[-6:]
    print(f"phase 14: (c) {' '.join(cmd[1:5])} ... -g train_DTU -p "
          f"train.num_steps=1: rc {res.returncode} in {secs:.1f} s; last "
          f"lines {tail}", flush=True)
    if res.returncode != 0:
        # the rank's own error comes before torchrun's report of it: the
        # report first, then the start of the error output, last
        raise RuntimeError(f"phase 14: the launcher failed:\n"
                           f"{res.stdout[-3000:]}\n{res.stderr[-1500:]}\n"
                           f"the start of its error output:\n"
                           f"{res.stderr[:4000]}")
    return {"rc": res.returncode, "s": secs}


def phase_parallel(torch, tree, batch):
    """Phase 14: the data and view axes. (a) A world of one over NCCL on
    this card: ``InferenceRunner(mesh=make_mesh(1, 1))`` through the
    rectified, mixed and exact routes and ``train()`` with
    ``data_parallel``, bit for bit the runs without a group, eager and
    replayed from graphs that hold the ``all_reduce``; (b) a gloo world of
    two ranks on this card (``dryrun_multiprocess(2, "cuda")``): the
    view-sharded forward (5 + 5 views; the mean aggregation, and the
    mean, max and std) against the unsharded one on the stage volumes and
    the disparities, the ranks' epiband and hat launches
    summing to the unsharded forward's, a data-parallel step of batch 1 + 1
    against one of batch 2, and sharded fusion of a sphere's true depths
    against one process's cloud; (c) the torchrun launcher. The two ranks
    share one card, so this shows correctness and the split of the work,
    not scaling. Returns the figures and the launches of the meshed and
    grouped runs of (a)."""
    import torch.distributed as dist

    from cermvs_torch.models.raft import RAFT
    from cermvs_torch.parallel import dryrun
    from cermvs_torch.parallel.mesh import initialize_distributed, make_mesh

    t0 = time.perf_counter()
    out = {}
    with tempfile.TemporaryDirectory(dir=REPO / "build") as tmp:
        initialize_distributed("cuda", store=dist.FileStore(
            str(Path(tmp) / "store"), 1), rank=0, world_size=1)
        try:
            print(f"phase 14: NCCL world of one on "
                  f"{torch.cuda.current_device()}", flush=True)
            mesh = make_mesh(1, 1)
            model = RAFT(test_mode=True,
                         generator=torch.Generator().manual_seed(0))
            scene = dtu_scene(H, W, NUM_FRAMES + 1)
            out["inference"], launches = world_of_one_inference(
                torch, mesh, model, [
                    ("rectified", "rectified", scene),
                    ("mixed", "auto", mixed_ring_scene(H, W,
                                                       NUM_FRAMES + 1)),
                    ("exact", "exact", scene)])
            del model
            out["training"], train_launches = world_of_one_training(
                torch, tree, batch)
        finally:
            dist.destroy_process_group()
        for k in KERNELS:
            launches[k] += train_launches[k]
        released(torch, "phase 14 (b)")
        batch_file = str(Path(tmp) / "batch.npz")
        np.savez(batch_file, **{k: np.asarray(batch[k]) for k in (
            "images", "depths", "poses", "intrinsics")})
        spec = {"forward": dict(scene="ring", H=H, W=W, N=NUM_FRAMES + 1,
                                model=dict(encoder_chunk=1),
                                per_view_model=PAR_PER_VIEW_MODEL,
                                rect_lambda_max=0.00375, damp=1e-3,
                                **PAR_FORWARD_TOL),
                "train": dict(batch_file=batch_file, **PAR_TRAIN_TOL),
                "fusion": PAR_FUSION}
        t1 = time.perf_counter()
        report = dryrun.dryrun_multiprocess(2, "cuda", spec=spec)
        for case, aggregation in dryrun.FORWARD_CASES:
            case = dryrun.forward_label(case, aggregation)
            f = report[f"forward_{case}"]
            agg = ("" if aggregation == ("mean",) else
                   f"; the aggregation's exchange alone max|diff| (of "
                   f"max|value|) by rank {f['aggregate_err']}")
            print(f"phase 14: (b) two gloo ranks, {case} forward: views "
                  f"{f['views']}, stage volumes max|2 ranks - 1| "
                  f"{f['volume_err']} (of {f['volume_max']}), disparity "
                  f"{f['disp_err']:.3e} (of {f['disp_max']:.3e}); launches "
                  f"by rank {f['launches_by_rank']} against one rank's "
                  f"{f['plain_launches']}; eager ({f['eager_reason']}); "
                  f"a second forward {[round(t, 4) for t in f['s']]} s by "
                  f"rank against one rank's {f['plain_s']:.4f}; a stage-0 "
                  f"volume ({f['volume_bytes'][0] / 2**20:.1f} MiB) "
                  f"all-reduced alone in "
                  f"{[[round(t, 4) for t in r] for r in f['all_reduce_s']]}"
                  f" s; peak allocated by rank "
                  f"{[round(b / 2**30, 2) for b in f['peak_bytes']]} GiB"
                  + agg, flush=True)
        for c in ("exact", "rectified"):
            t = report[f"train_{c}"]
            print(f"phase 14: (b) two gloo ranks, {c} step of batch 1 + 1 "
                  f"against 2: loss {t['metrics']['loss']!r} against "
                  f"{t['ref_metrics']['loss']!r}, grad_norm "
                  f"{t['metrics']['grad_norm']!r} against "
                  f"{t['ref_metrics']['grad_norm']!r}, gradients' relative "
                  f"error {t['grad_rel_err']:.3e}, max|weights diff| "
                  f"{t['weights_err']:.3e} (lr {t['lr']:.3e}); peak "
                  f"allocated by rank "
                  f"{[round(b / 2**30, 2) for b in t['peak_bytes']]} GiB"
                  + (f", local plans differ {t['plans_differ']}"
                     if c == "rectified" else ""), flush=True)
        print(f"phase 14: (b) sharded fusion: {report['fusion']}; the world "
              f"of two in {time.perf_counter() - t1:.1f} s", flush=True)
        out["world_of_two"] = report
        out["launcher"] = run_launcher(tree, tmp)
    out["s"] = time.perf_counter() - t0
    print(f"phase 14: {out['s']:.1f} s", flush=True)
    return out, launches


def hold_band_kernels(torch, plan, band_h, rows_ext, h, w):
    """Phase 15(c): one band-shaped ``epiband_fwd`` launch (bf16, stage 1's
    bases, the plan's widest view on ``band_h`` rect rows) and one
    band-shaped ``hat_rows_fwd`` launch (bf16, the volume back-warp's second
    pass: (w, band_h) -> (w, rows_ext)), each held against its plain
    version at phase 6's tolerances, and timed. Returns each kernel's error
    and row."""
    from cermvs_torch.ops import epiband as eb
    from cermvs_torch.ops import hatwarp as hwp

    rng = np.random.RandomState(15)
    vmax = int(np.argmax(plan.view_s_max))
    s_v = plan.view_s_max[vmax]
    ws = plan.ws_r - (plan.s_max - s_v)
    (d0, inc0), (d1, inc1) = STAGES
    rate = np.asarray(plan.view_rates)[vmax]
    fr, fs, base, sigma = epiband_case(
        torch, rng, band_h, plan.w_r, ws, C_FEAT, d1, "main",
        tuple(rate * inc1), torch.bfloat16, (d0, inc0 / inc1))
    args = (fr, fs, base, sigma, d1, s_v)
    out = eb.epiband(*args)
    torch.cuda.synchronize()
    ref = eb.epiband_reference(*args)
    errs = {"epiband_fwd": float((out - ref).abs().max())}
    ok = {"epiband_fwd": bool(torch.allclose(out, ref, rtol=1e-3,
                                             atol=1e-2))}
    bound, by = epiband_bounds(torch, fr, fs, base, sigma, d1,
                               s_v)["epiband_fwd"]
    ms, device_ms = cuda_ms_both(torch, lambda: eb.epiband(*args), 20)
    rows = {"epiband_fwd": dict(
        shape=[1, band_h, plan.w_r, ws, C_FEAT], D=d1, ms=ms,
        device_ms=device_ms, bound_ms=bound, bound_by=by,
        plain_ms=cuda_ms(lambda: eb.epiband_reference(*args), 3))}
    del out, ref, fr, fs
    img, pos = hat_case(torch, rng, w, band_h, rows_ext, d1, torch.bfloat16)
    out = hwp.hat_resample_rows(img, pos)
    torch.cuda.synchronize()
    ref = hwp.hat_resample_rows_reference(img, pos)
    errs["hat_rows_fwd"] = float((out - ref).abs().max())
    ok["hat_rows_fwd"] = bool(torch.allclose(out, ref, rtol=1e-5, atol=1e-5))
    bound, by = hat_bounds(torch, img, pos)["hat_rows_fwd"]
    ms, device_ms = cuda_ms_both(torch, lambda: hwp.hat_resample_rows(img,
                                                                      pos))
    lib = grid_sample_rows(torch, img, pos)
    lib_ms, lib_device_ms = cuda_ms_both(torch, lib)
    rows["hat_rows_fwd"] = dict(
        shape=[w, band_h, rows_ext, d1], ms=ms, device_ms=device_ms,
        bound_ms=bound, bound_by=by, library_ms=lib_ms,
        library_device_ms=lib_device_ms,
        plain_ms=cuda_ms(lambda: hwp.hat_resample_rows_reference(img, pos),
                         3))
    for name, row in rows.items():
        print(f"phase 15: (c) {name} band {row['shape']} bf16: max|kernel - "
              f"plain| {errs[name]:.3e} ok={ok[name]}; kernel "
              f"{row['ms']:.4f} ms (device {row['device_ms']:.4f}), plain "
              f"{row['plain_ms']:.3f} ms, bound {row['bound_ms']:.4f} ms "
              f"({row['bound_by']})" + (
                  f", grid_sample {row['library_ms']:.4f} ms"
                  if "library_ms" in row else ""), flush=True)
        if not ok[name]:
            raise RuntimeError(f"phase 15: band-shaped {name} disagrees "
                               f"with its plain version")
    return errs, rows


def spatial_world_of_one(torch, mesh, model, scene):
    """Phase 15(a): the exact and banded rectified routes through a runner
    with a (row,) mesh of one NCCL rank and one without: the first dispatch
    (eager, then the capture with the collectives inside) against a replay
    bit for bit, and against the unmeshed runner at SPATIAL_ONE_TOL;
    PAR_REPLAYS replays of each, in turns, timed. Returns the figures, the
    meshed runs' launches, and the rectified route's plan."""
    from cermvs_torch.ops import cudalib
    from cermvs_torch.pipeline.inference import GraphedForward, InferenceRunner

    images, poses, intr = scene
    out, launches, plan = {}, {k: 0 for k in KERNELS}, None
    for construction in ("exact", "rectified"):
        meshed = InferenceRunner(model=model, mesh=mesh, device="cuda",
                                 construction=construction)
        plain = InferenceRunner(model=model, device="cuda",
                                construction=construction)
        cudalib.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        first = meshed.submit(images, poses, intr, 1.0).clone()
        replay = meshed.submit(images, poses, intr, 1.0).clone()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        for k in KERNELS:
            launches[k] += cudalib.launches.get(k, 0)
        run = dict(cudalib.launches)
        p_first = plain.submit(images, poses, intr, 1.0).clone()
        graphed = [isinstance(f, GraphedForward)
                   for f in meshed._cache.values()]
        d_max = float(p_first.abs().max())
        errs = {"replay": float((replay - first).abs().max()),
                "unmeshed": float((first - p_first).abs().max())}
        times = {"meshed": [], "plain": []}
        for _ in range(PAR_REPLAYS):
            for name, runner in (("plain", plain), ("meshed", meshed)):
                t, _ = synced_s(torch, lambda: runner.submit(
                    images, poses, intr, 1.0))
                times[name].append(t)
        (fwd,) = meshed._volumes.values()
        if construction == "rectified":
            plan = fwd.plan
        out[construction] = {
            "path": meshed.last_path, "graphed": graphed,
            "graphs": meshed.graphs, "errs": errs, "disp_max": d_max,
            "s": times, "launches": run, "peak_bytes": peak,
            "band_h": fwd.band_h}
        print(f"phase 15: (a) (row,) mesh of one, {construction}: path "
              f"{meshed.last_path}/{plain.last_path}, captured {graphed}, "
              f"band_h {fwd.band_h}; max|replay - eager| {errs['replay']}, "
              f"max|meshed - unmeshed| {errs['unmeshed']:.3e} (of "
              f"{d_max:.3e}); launches {run}; peak {peak / 2**30:.2f} GiB; "
              f"replays s (meshed) {[round(t, 4) for t in times['meshed']]}"
              f", (no mesh) {[round(t, 4) for t in times['plain']]}",
              flush=True)
        if not (meshed.last_path == plain.last_path == construction
                and meshed.graphs and graphed == [True]):
            raise RuntimeError(f"phase 15 {construction}: route or capture")
        if errs["replay"] != 0.0:
            raise RuntimeError(f"phase 15 {construction}: a replay is not "
                               f"the eager forward bit for bit")
        if errs["unmeshed"] > (SPATIAL_ONE_TOL["atol"]
                               + SPATIAL_ONE_TOL["rtol"] * d_max):
            raise RuntimeError(f"phase 15 {construction}: the meshed "
                               f"forward is off the unmeshed one: {errs}")
        del meshed, plain, fwd
        released(torch, f"phase 15, {construction}")
    return out, launches, plan


def phase_spatial(torch):
    """Phase 15: row and grid sharding (``parallel/spatial.py``). (a) A
    (row,) mesh of one NCCL rank on phase 4's scene with the shipped model:
    the exact and banded rectified routes through ``InferenceRunner(mesh=)``
    against the runner without a mesh, and a replay bit for bit against
    the eager forward with the collectives in the graph; (b) four gloo
    ranks sharing this card (``dryrun.dryrun_spatial(4, "cuda")``): rows
    over four (exact, rectified, exact with the mean, max and std) and a
    2 x 2 grid (exact, rectified), each against the unsharded forward on
    the stage volumes and the disparities, each rank's launches, peak and
    seconds; (c) a band-shaped epiband and hat launch against their plain
    versions. Returns the figures, (a)'s launches and (c)'s rows."""
    import torch.distributed as dist

    from cermvs_torch.models.raft import RAFT
    from cermvs_torch.parallel import dryrun
    from cermvs_torch.parallel.mesh import (initialize_distributed,
                                            make_row_mesh)
    from cermvs_torch.parallel.spatial import GHOST_RECT

    t0 = time.perf_counter()
    out = {}
    scene = dtu_scene(H, W, NUM_FRAMES + 1)
    with tempfile.TemporaryDirectory(dir=REPO / "build") as tmp:
        initialize_distributed("cuda", store=dist.FileStore(
            str(Path(tmp) / "store"), 1), rank=0, world_size=1)
        try:
            model = RAFT(test_mode=True,
                         generator=torch.Generator().manual_seed(0))
            with torch.no_grad():
                for i in range(len(model.cascade)):
                    getattr(model.update_block, f"delta{i}")[2].weight.mul_(
                        1e-3)
            out["world_of_one"], launches, plan = spatial_world_of_one(
                torch, make_row_mesh(), model, scene)
            del model
        finally:
            dist.destroy_process_group()
    released(torch, "phase 15 (b)")
    t1 = time.perf_counter()
    spec = dict(SPATIAL_SPEC, H=H, W=W)
    report = dryrun.dryrun_spatial(4, "cuda", spec=spec)
    for kind, case, aggregation in dryrun.SPATIAL_CASES:
        label = dryrun.spatial_label(kind, case, aggregation)
        f = report[label]
        print(f"phase 15: (b) four gloo ranks, {label}: views {f['views']}, "
              f"band_h {f['band_h']}, stage volumes max|sharded - one| "
              f"{f['volume_err']} (of {f['volume_max']}), disparity "
              f"{f['disp_err']:.3e} (of {f['disp_max']:.3e}); launches by "
              f"rank {f['launches_by_rank']} against one rank's "
              f"{f['plain_launches']}; eager ({f['eager_reason']}); a "
              f"second forward {[round(t, 4) for t in f['s']]} s by rank "
              f"against one rank's {f['plain_s']:.4f}; collectives timed "
              f"alone (count, MiB, s of the forward's s) by rank "
              f"{[(c['n'], round(c['bytes'] / 2**20, 1), round(c['s'], 4), round(c['forward_s'], 4)) for c in f['collectives']]}"
              f"; peak allocated by rank "
              f"{[round(b / 2**30, 2) for b in f['peak_bytes']]} GiB",
              flush=True)
    out["four_ranks"] = report
    out["four_ranks_s"] = time.perf_counter() - t1
    # (c) the band of four row ranks on phase 4's plan
    h, w = H // 4, W // 4
    hloc = h // 4
    q0, band_h = plan_row_bands_of(scene, plan, 4)
    errs, rows = hold_band_kernels(torch, plan, band_h, hloc + 2 * GHOST_RECT,
                                   h, w)
    out["band_kernels"] = {"q0": q0.tolist(), "band_h": band_h,
                           "rows": rows}
    out["s"] = time.perf_counter() - t0
    print(f"phase 15: (b) in {out['four_ranks_s']:.1f} s; {out['s']:.1f} s",
          flush=True)
    return out, launches, errs, rows


def count_small_step(torch, device):
    """Phase 16(a): one fp32 train-mode forward of a small model
    (TOOLING_CASCADE, the fused lookup, remat, the delta heads damped as
    phase 4's small model's) on phase 4's small lateral scene through the
    rectified construction, and the backward of its predictions' sum, each
    counted on ``device`` (``utils/flops.count_flops``). Returns the two
    counts and a function that runs the forward again without autograd."""
    from cermvs_torch.models.raft import RAFT
    from cermvs_torch.pipeline.inference import InferenceRunner
    from cermvs_torch.utils.flops import count_flops

    model = RAFT(cascade=TOOLING_CASCADE, dtype=torch.float32,
                 lookup_impl="pallas", device=device,
                 generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        for i in range(len(model.cascade)):
            getattr(model.update_block, f"delta{i}")[2].weight.mul_(1e-3)
    images, poses, intr = lateral_scene(*TOOLING_HW, 3)
    # a runner of its own routes the scene (it puts its model in test mode)
    runner = InferenceRunner(model=RAFT(cascade=TOOLING_CASCADE,
                                        dtype=torch.float32, device=device),
                             construction="rectified", rect_lambda_max=0.1,
                             device=device)
    r = routed(runner, images, poses, intr)
    if r.path != "rectified":
        raise RuntimeError(f"phase 16: the small scene routed {r.path}")
    held = {}

    def forward():
        held["loss"] = model(*r[:4], volume_fn=r.volume_fn).sum()

    def again():
        with torch.no_grad():
            return model(*r[:4], volume_fn=r.volume_fn)

    fwd = count_flops(forward)
    bwd = count_flops(lambda: held["loss"].backward())
    return fwd, bwd, again


def count_text(c):
    """A count, printable: its total and parts."""
    return (f"{c.total:.6e} FLOPs = {c.aten_total:.6e} convolutions and "
            f"products {c.aten} + {c.kernel_total:.6e} kernels {c.kernels} "
            f"(calls {c.calls})")


def count_dict(c):
    return {"total": c.total, "aten": c.aten, "kernels": c.kernels,
            "calls": c.calls}


def mfu_of(torch, label, count, seconds, smi):
    """Print and return ``count`` over the median replay ``seconds`` as
    FLOP/s and as a share of the card's dense bf16 peak."""
    from cermvs_torch.utils.flops import device_peak_flops, mfu

    peak = device_peak_flops()
    share = mfu(count.total, seconds)
    if share is None:
        raise RuntimeError(f"phase 16: no peak known for "
                           f"{torch.cuda.get_device_name(0)}")
    kernel_share = count.kernel_total / count.total
    print(f"phase 16: {label}: {count_text(count)}; the kernels' share "
          f"{kernel_share:.5f}; over the median replay {seconds:.4f} s: "
          f"{count.total / seconds / 1e12:.3f} TFLOP/s, MFU {share:.5f} of "
          f"{peak / 1e12:.0f} TFLOP/s dense bf16 ({smi})", flush=True)
    return {"count": count_dict(count), "median_replay_s": seconds,
            "kernel_share": kernel_share, "tflops": count.total / seconds
            / 1e12, "mfu": share, "peak_flops": peak, "card": smi}


def phase_tooling(torch, smi, replay_s, step_replay_s, train_plan,
                  train_batch, build):
    """Phase 16, the port's tooling on the card: (a) the FLOP count of a
    small fp32 forward and backward on the CPU and on the card (the
    convolutions and products equal, each kernel's formula within
    KERNEL_COUNT_TOL); (b) the FLOPs of phase 4's full-width bf16
    rectified forward and of one phase-9 ``train_DTU.gin`` step, each
    counted once eagerly, over the median replay its phase timed
    (``replay_s``, ``step_replay_s``), and the MFU; (c)
    ``utils/memory``'s stats and report against
    ``torch.cuda.max_memory_allocated``, a ``ViewTimer`` record of phase
    4's eager forward and a ``utils/profiling.trace`` of (a)'s forward on
    the card naming ``raft.encoders`` and ``epiband_mma_kernel``; (d) ``examples/e2e_synthetic`` on the card
    (3 views of 576x800) and its file contract, then the scan's true
    depths fused on the card into a cloud on the plane."""
    from cermvs_torch import config as pcfg
    from cermvs_torch.data.loader import DataLoader
    from cermvs_torch.examples import e2e_synthetic
    from cermvs_torch.io.pfm import read_pfm, write_pfm
    from cermvs_torch.io.ply import read_ply
    from cermvs_torch.models.raft import RAFT
    from cermvs_torch.ops.corr_rectified import RectifiedVolume
    from cermvs_torch.pipeline.fusion import fusion
    from cermvs_torch.pipeline.inference import InferenceRunner
    from cermvs_torch.training.step import (batch_to_device, init_state,
                                            train_step)
    from cermvs_torch.utils.flops import count_flops
    from cermvs_torch.utils.memory import device_memory_stats, report
    from cermvs_torch.utils.profiling import ViewTimer, trace

    t0 = time.perf_counter()
    pcfg.clear_config()
    out = {}
    # (a) the same small forward and backward counted on both devices
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    *cpu, _ = count_small_step(torch, "cpu")
    *card, small_forward = count_small_step(torch, "cuda")
    rel = {}
    for part, a, b in zip(("forward", "backward"), cpu, card):
        print(f"phase 16: small fp32 {part}: CPU {count_text(a)}; card "
              f"{count_text(b)}", flush=True)
        if a.aten != b.aten or a.calls != b.calls or set(a.kernels) != set(
                b.kernels):
            raise RuntimeError(f"phase 16: the {part}'s convolutions, "
                               f"products or kernel calls differ between "
                               f"the CPU and the card")
        for name, n in a.kernels.items():
            rel[f"{part}.{name}"] = abs(b.kernels[name] - n) / max(n, 1)
    print(f"phase 16: the kernels' FLOPs, card against CPU, relative: {rel} "
          f"(limit {KERNEL_COUNT_TOL})", flush=True)
    if max(rel.values()) > KERNEL_COUNT_TOL:
        raise RuntimeError(f"phase 16: the kernels' counts differ beyond "
                           f"{KERNEL_COUNT_TOL}: {rel}")
    out["small"] = {"cpu": [count_dict(c) for c in cpu],
                    "card": [count_dict(c) for c in card],
                    "kernels_rel_diff": rel}
    parts = {"a": time.perf_counter() - t0}

    # (b) the full-width forward and train step, counted eagerly
    torch.backends.cudnn.allow_tf32 = True  # the bf16 model's own setting
    torch.backends.cuda.matmul.allow_tf32 = False
    model = RAFT(test_mode=True, generator=torch.Generator().manual_seed(0))
    runner = InferenceRunner(model=model, construction="rectified",
                             device="cuda")
    images, poses, intr = dtu_scene(H, W, NUM_FRAMES + 1)
    r = routed(runner, images, poses, intr)
    with torch.no_grad():
        fwd = count_flops(eager, torch, runner, r)
    out["forward"] = mfu_of(torch, "phase 4's rectified forward, bf16, "
                            "11 views of 1152x1600", fwd,
                            float(np.median(replay_s)), smi)
    state = init_state(RAFT(device="cuda",
                            generator=torch.Generator().manual_seed(7)),
                       1000)
    batch = batch_to_device(train_batch, "cuda")
    step = count_flops(train_step, state, batch, 0.5,
                       volume_fn=RectifiedVolume(train_plan))
    out["train_step"] = mfu_of(
        torch, "a train_DTU.gin step (batch 2, nf10, 1056x1440, remat)",
        step, float(np.median(step_replay_s)), smi)
    del state, batch
    parts["b"] = time.perf_counter() - t0 - sum(parts.values())

    # (c) memory, the view timer and a trace
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    timer = ViewTimer(device="cuda")
    with timer.view("phase 4's eager forward"):
        eager(torch, runner, r)
    stats = device_memory_stats()
    mine = stats[str(torch.device("cuda", 0))]
    peak = torch.cuda.max_memory_allocated(0) / 2**20
    total = torch.cuda.get_device_properties(0).total_memory / 2**20
    report()
    rec = timer.records
    print(f"phase 16: device_memory_stats {stats}; max_memory_allocated "
          f"{peak:.3f} MiB; ViewTimer records {rec}, summary "
          f"{timer.summary()}", flush=True)
    if (len(stats) != torch.cuda.device_count()
            or mine["peak_bytes_in_use_mb"] != peak
            or mine["bytes_limit_mb"] != total or len(rec) != 1
            or rec[0]["peak_hbm_mb"] != peak or not rec[0]["seconds"] > 0):
        raise RuntimeError("phase 16: the memory stats or the view timer "
                           "disagree with the allocator")
    with tempfile.TemporaryDirectory(dir=build) as d:
        t_trace = time.perf_counter()
        with trace(d) as prof:
            small_forward()
            torch.cuda.synchronize()
        files = list(Path(d).glob("*.pt.trace.json"))
        text = files[0].read_text() if len(files) == 1 else ""
        names = {n: n in text for n in ("raft.encoders",
                                         "epiband_mma_kernel")}
        device_us = sum(e.device_time_total for e in prof.key_averages())
        print(f"phase 16: trace {[f.name for f in files]} "
              f"({len(text) / 2**20:.1f} MiB) in "
              f"{time.perf_counter() - t_trace:.1f} s names {names}; "
              f"device time in its key averages {device_us / 1e3:.1f} ms",
              flush=True)
        if not all(names.values()):
            raise RuntimeError(f"phase 16: the trace misses {names}")
    out["memory"] = {"stats": stats, "view_timer": rec,
                     "trace_names": names, "trace_device_ms": device_us / 1e3}
    del runner, model, r
    parts["c"] = time.perf_counter() - t0 - sum(parts.values())
    released(torch, "phase 16(d)")

    # (d) the synthetic end-to-end example on the card
    with tempfile.TemporaryDirectory(dir=build) as d:
        t_e2e = time.perf_counter()
        e2e = Path(d) / "e2e"
        ply = e2e_synthetic.main(E2E_ARGS + ["--out", str(e2e)])
        views = range(3)
        want = ({f"depths/{v}_scale{s}_nf2.pfm" for v in views
                 for s in (1, 2)}
                | {f"depths/{v}_nf2_nf2_th0.02.pfm" for v in views}
                | {f"depths/{v}.png" for v in views}
                | {f"mask/{v}_nf2_nf2_th0.02.png" for v in views}
                | {"result.ply"})
        names = {str(f.relative_to(e2e)) for f in e2e.rglob("*")
                 if f.is_file()}
        shapes = {s: read_pfm(e2e / "depths" / f"0_scale{s}_nf2.pfm").shape
                  for s in (1, 2)}
        random_points = len(read_ply(ply)[0])
        e2e_s = time.perf_counter() - t_e2e
        if names != want or shapes != {1: (144, 200), 2: (288, 400)}:
            raise RuntimeError(f"phase 16: e2e_synthetic wrote {names} "
                               f"(shapes {shapes}), not {want}")
        # the scan's true depths through the same fusion: a cloud on the
        # plane (random weights' depths agree across no views)
        scan = e2e_synthetic.SyntheticScan(3, 576, 800, 2)
        true = Path(d) / "true"
        (true / "depths").mkdir(parents=True)
        for v in views:
            write_pfm(true / "depths" / f"{v}_true.pfm",
                      np.full(shapes[2], E2E_Z, np.float32))
        xyz, _ = read_ply(fusion(DataLoader(scan, batch_size=None,
                                            num_workers=0),
                                 true, rescale=2, suffix="_true", tot_iter=4,
                                 device="cuda"))
        err = float(np.abs(xyz[:, 2] - E2E_Z).max()) if len(xyz) else None
        print(f"phase 16: e2e_synthetic {' '.join(E2E_ARGS)} on the card in "
              f"{e2e_s:.1f} s: {len(names)} files as the JAX example writes "
              f"them, depth maps {shapes}, {random_points} fused points "
              f"from the random weights' depths; the scan's true depths "
              f"fused into {len(xyz)} points, max|z - {E2E_Z}| {err}",
              flush=True)
        if not len(xyz) or err > TRUE_TOL_MM:
            raise RuntimeError(f"phase 16: the true depths fused into "
                               f"{len(xyz)} points, max error {err}")
        out["e2e"] = {"seconds": e2e_s, "files": len(names),
                      "random_points": random_points,
                      "true_points": len(xyz), "true_max_err_mm": err}
    out["seconds"] = time.perf_counter() - t0
    parts["d"] = out["seconds"] - sum(parts.values())
    out["parts_s"] = parts
    print(f"phase 16: {out['seconds']:.1f} s (limit {TOOLING_LIMIT_S} s; "
          f"by part {({k: round(v, 1) for k, v in parts.items()})})",
          flush=True)
    if out["seconds"] > TOOLING_LIMIT_S:
        raise RuntimeError(f"phase 16 took {out['seconds']:.1f} s")
    return out


def plan_row_bands_of(scene, plan, n):
    """``rectify.plan_row_bands`` of a (images, poses, intrinsics) scene
    in the runner's neighbour order at the feature stride."""
    from cermvs_torch.ops.rectify import plan_row_bands
    from cermvs_torch.parallel.spatial import GHOST_RECT
    from cermvs_torch.pipeline.inference import InferenceRunner

    images, poses, intr = scene
    order = InferenceRunner.neighbor_order(poses)
    K4 = np.asarray(intr[order], np.float64).copy()
    K4[..., :2, :] /= 4
    return plan_row_bands(np.asarray(poses[order], np.float64), K4,
                          images.shape[1] // 4, images.shape[2] // 4, plan, n,
                          GHOST_RECT)


def mark(ends, phase):
    """Record and print the seconds since the start at which ``phase``
    ended (where the run's time goes)."""
    ends[phase] = time.perf_counter() - T_START
    print(f"{phase}: ended at {ends[phase]:.1f} s", flush=True)


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    if not (REPO / "cermvs_torch" / "csrc" / "epiband.cu").is_file():
        raise SystemExit("chip_smoke: run it from a checkout of the "
                         "repository (cermvs_torch/ not found)")
    sys.path.insert(0, str(REPO))
    from cermvs_torch.io import native
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
    with ThreadPoolExecutor(1) as pool:  # g++ beside the nvcc builds
        host_build = pool.submit(native.build)
        cudalib.build_all([eb.LIB, hw.LIB, lk.LIB], verbose=True)
        host_build.result()
    build_s = time.perf_counter() - t0
    print(f"phase 1: epiband.cu, hatwarp.cu and lookup.cu (nvcc) and "
          f"dataio.cpp (g++) built in {build_s:.1f} s", flush=True)
    host = host_runtime(torch)
    ends = {}
    mark(ends, "phase 1")

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
    mark(ends, "phase 2")

    # ---- phase 3: the lookup kernels vs plain on the card ------------------
    lookup_rows = phase_lookup_kernels(torch)
    mark(ends, "phase 3")

    # ---- phase 4: the slice at full width ---------------------------------
    # each route through the runner's CUDA graphs (a capture, then
    # replays), against its eager forward
    torch.backends.cudnn.allow_tf32 = True  # the bf16 model's own setting
    disp, graphed = graphed_pass(torch, runner, images, poses, intr,
                                 "rectified")
    times, peak = graphed["s_per_view"], graphed["peak_bytes"]
    infer_launches = graphed["launches"]
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
    busy = {}
    if "--profile" in sys.argv:
        busy["rectified"] = profile_graphed(torch, runner, images, poses,
                                            intr, "rectified")

    exact = InferenceRunner(model=model, construction="exact", device="cuda")
    de, graphed_exact = graphed_pass(torch, exact, images, poses, intr,
                                     "exact")
    t_exact, peak_exact = (graphed_exact["s_per_view"],
                           graphed_exact["peak_bytes"])
    de = de[0].float().cpu().numpy()
    print(f"phase 4: exact {[round(t, 4) for t in t_exact]} s/view, path="
          f"{exact.last_path}, peak {peak_exact / 2**30:.2f} GiB, "
          f"finite={np.isfinite(de).all()}", flush=True)
    if de.shape != d.shape or not np.isfinite(de).all():
        raise RuntimeError("bad exact-construction disparity")
    if "--profile" in sys.argv:
        busy["exact"] = profile_graphed(torch, exact, images, poses, intr,
                                        "exact")
    del runner, exact
    mixed = phase_mixed(torch, model, {
        "rectified": {"s_per_view": times, "peak_bytes": peak},
        "exact": {"s_per_view": t_exact, "peak_bytes": peak_exact}}, busy)

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
    # a runner of its own: the first one's graph holds the banded lookup
    small.lookup_impl = "pallas"
    r_fused = InferenceRunner(model=small, construction="rectified",
                              rect_lambda_max=0.1, device="cuda")
    cudalib.reset_launches()
    d_fused = r_fused.submit(im_s, po_s, k_s, 1.0)[0].cpu().numpy()
    fused_launches = cudalib.launches.get("lookup_fused_fwd", 0)
    small.lookup_impl = "banded"
    del r_fused
    e_fb = float(np.abs(d_fused - a).max())
    print(f"phase 4: small lateral scene, fused lookup: |fused-banded| "
          f"{e_fb:.3e}, lookup launches {fused_launches}", flush=True)
    check_launches({"lookup_fused_fwd": fused_launches},
                   {"lookup_fused_fwd": sum(s[2] for s in small.cascade)},
                   "fused-lookup forward")
    np.testing.assert_allclose(d_fused, a, rtol=1e-4, atol=1e-8)
    # the mixed construction on a small scene with one forward neighbour:
    # lossless on the lateral views, so it agrees with the exact one at the
    # CPU tests' tolerance (tests/test_torch_pipeline.py)
    im_m, po_m, k_m = lateral_forward_scene(128, 256, 5)
    r_auto = InferenceRunner(model=small, construction="auto",
                             rect_lambda_max=0.1, device="cuda")
    cudalib.reset_launches()
    d_mixed = r_auto.submit(im_m, po_m, k_m, 1.0)[0].cpu().numpy()
    mixed_launches = cudalib.launches.get("epiband_fwd", 0)
    d_exact = r_exact.submit(im_m, po_m, k_m, 1.0)[0].cpu().numpy()
    e_me = float(np.abs(d_mixed - d_exact).max())
    print(f"phase 4: small lateral-and-forward scene: |mixed-exact| "
          f"{e_me:.3e}, |disp| max {np.abs(d_exact).max():.3e}, path="
          f"{r_auto.last_path}, epiband launches {mixed_launches}",
          flush=True)
    if r_auto.last_path != "mixed" or mixed_launches == 0:
        raise RuntimeError("small scene did not take the mixed path")
    np.testing.assert_allclose(d_mixed, d_exact, rtol=1e-3, atol=1e-7)
    fp32 = phase_fp32_forward(torch, images, poses, intr, expect, busy)
    mark(ends, "phase 4")

    # ---- phase 5: inference() writes the PFM contract ----------------------
    loader = ItemLoader([(*dtu_scene(96, 128, NUM_FRAMES + 1, seed=ref),
                          [f"{ref:08d}"], 1.0) for ref in range(2)],
                        NUM_FRAMES)
    build = REPO / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as out_dir:
        inference(loader, model=RAFT(test_mode=True, generator=gen),
                  output_folder=out_dir, device="cuda")
        names = sorted(p.name for p in (Path(out_dir) / "depths").iterdir())
    print(f"phase 5: wrote {names}", flush=True)
    if names != [f"{r:08d}_scale1_nf{NUM_FRAMES}.pfm" for r in range(2)]:
        raise RuntimeError(f"unexpected PFM names {names}")
    view_batch = phase_view_batch(torch, small)
    mark(ends, "phase 5")

    del model, small, r_rect, r_exact, r_auto
    released(torch, "phase 6")
    with tempfile.TemporaryDirectory(dir=build) as root:
        demo = phase_demo(torch, Path(root))
        mark(ends, "phase 6")
        true_fusion = phase_true_fusion(torch, Path(root))
        mark(ends, "phase 7")

    # phase 8's DTU tree, which phase 14 trains on again
    dtu_dir = tempfile.TemporaryDirectory(dir=build)
    dtu_tree = dtu_dir.name
    released(torch, "phase 8")
    train_plan, train_batch = plan_training_batch(torch, dtu_tree)
    rows = phase_training_kernels(torch, train_plan, train_batch)
    mark(ends, "phase 8")
    released(torch, "phase 9")
    training = phase_train(torch, dtu_tree, train_plan, train_batch)
    training["remat"] = remat_both_ways(torch, train_plan, train_batch)
    mark(ends, "phase 9")
    released(torch, "phase 10")
    fused_training = phase_train_pallas(torch, dtu_tree, train_plan,
                                        train_batch)
    mark(ends, "phase 10")
    with tempfile.TemporaryDirectory(dir=build) as root:
        released(torch, "phase 11")
        tnt = phase_tnt_demo(torch, Path(root))
        mark(ends, "phase 11")
        released(torch, "phase 12")
        custom = phase_custom_demo(torch, Path(root))
        mark(ends, "phase 12")
    with tempfile.TemporaryDirectory(dir=build) as tree:
        released(torch, "phase 13")
        blended = phase_blended_train(torch, Path(tree))
        mark(ends, "phase 13")
    released(torch, "phase 14")
    parallel, parallel_launches = phase_parallel(torch, dtu_tree,
                                                 train_batch)
    mark(ends, "phase 14")
    dtu_dir.cleanup()
    released(torch, "phase 15")
    spatial, spatial_launches, band_errs, band_rows = phase_spatial(torch)
    mark(ends, "phase 15")
    released(torch, "phase 16")
    tooling = phase_tooling(torch, smi, graphed["forward_replay_s"],
                            training["remat"]["on"]["replay_s"], train_plan,
                            train_batch, build)
    mark(ends, "phase 16")
    rows.update(lookup_rows)

    s0 = stages["stage0"]
    rows["epiband_fwd"] = {
        "max_abs_err": max_err, "ms": s0["ms"], "plain_ms": s0["plain_ms"],
        "bound_ms": s0["bound_ms"], "bound_by": s0["bound_by"],
        "device_ms": s0["device_ms"], "library_ms": None, "stages": stages}
    # the demo's and the mixed scene's plans: errors into each row, the
    # demo's rescale-2 times beside
    for errs in (demo.pop("kernel_errs"), mixed["kernel_errs"],
                 blended.pop("kernel_errs")):
        for name, err in errs.items():
            rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"], err)
    for name, row in demo.pop("kernel_rows_rescale2").items():
        rows[name]["demo_rescale2"] = row
    for name, row in band_rows.items():
        rows[name]["row_band"] = row
        rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"],
                                        band_errs[name])
    by_path = {"inference": infer_launches, "mixed": mixed["launches"],
               "demo": demo["launches"], "training": training["launches"],
               "training_fused_lookup": fused_training["launches"],
               "tnt_demo": tnt.pop("launches"),
               "custom_demo": custom.pop("launches"),
               "training_blended": blended.pop("launches"),
               "parallel": parallel_launches,
               "parallel_spatial": spatial_launches}
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
        "rectified_fp32_s_per_view": fp32["s_per_view"],
        "rectified_fp32_peak_bytes": fp32["peak_bytes"],
        "graphs": {"rectified": graphed, "exact": graphed_exact,
                   "mixed": mixed["graphed"], "fp32": fp32,
                   "busy_share": busy},
        "mixed": {k: v for k, v in mixed.items() if k != "kernel_errs"},
        "view_batch": view_batch,
        "train_s_per_step": training["s_per_step"],
        "train_peak_bytes": training["peak_bytes"],
        "train_steps": training["steps"], "train_plan": training["plan"],
        "train_graphs": {k: training[k] for k in (
            "keys", "peak_reserved_bytes", "graph_pool_bytes", "plan_s",
            "upload_s", "busy_share", "replay_vs_eager", "eager_vs_eager")},
        "train_remat": training["remat"],
        "demo": demo, "true_fusion": true_fusion,
        "fused_lookup_training": {k: v for k, v in fused_training.items()
                                  if k != "launches"},
        "tnt_demo": tnt, "custom_demo": custom, "blended_training": blended,
        "parallel": parallel, "parallel_spatial": spatial,
        "tooling": tooling, "host_runtime": host,
        "build_s": build_s, "phase_end_s": ends, "card": smi,
        "total_s": time.perf_counter() - T_START}}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()

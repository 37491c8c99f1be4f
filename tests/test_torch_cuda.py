"""CUDA-only tests of the port: the epiband forward and backward kernels, the
hat-resample kernels, the quad warp kernels and the fused lookup kernels
(forward, gradient, prefix-sum) against their plain PyTorch versions on the
card, wrong inputs raising and leaving the card usable, the small end-to-end
agreement of the rectified (kernel) and exact constructions, the compiled
train step (with ``RAFT.remat``: replay against eager, remat on against
off), the group-norm encoder against the CPU, and the parallel paths (an
NCCL world of one: the meshed forward and the data-parallel step captured
with their ``all_reduce`` and replayed; two gloo ranks sharing the card:
the view-sharded forward's launches split between them), and the tracing
marks that a captured forward and train step replay. They skip where
``torch.cuda.is_available()`` is false. This file imports nothing of JAX, so
it also runs on a machine without it:

    python -m pytest tests/test_torch_cuda.py --noconftest -q -p no:cacheprovider

Tolerances: kernel against plain on the same tensors rtol 1e-4 / atol 1e-3
with fp32 features and rtol 1e-3 / atol 1e-2 with bf16 features (both
accumulate in fp32; only the summation order differs). The backward kernels
are held at the same tolerances in fp32 and at 1e-2 in bf16 (their results
are returned in bf16, where another summation order may move a value by
one bf16 rounding); with bf16 features they round where the plain version
rounds, so under 1% of the elements may differ at all. The quad warp's
forward is held bit for bit; its transpose (fp32 atomics, rounded once) to
one ulp of the image's dtype plus fp32 reordering of the plain fp32
transpose (``assert_backward_close``).
"""

import copy
from pathlib import Path

import numpy as np
import pytest
import torch

from cermvs_torch.ops import cudalib
from cermvs_torch.ops import epiband as eb
from cermvs_torch.ops import hatwarp as hw
from cermvs_torch.ops import quadwarp as qw

V, H_R, W_R, WS, C = 2, 8, 128, 224, 8
S_MAX = WS - W_R - 16

# (id, sigma range, base range or None for base == 0, D, bounded windows)
CASES = [
    ("bounded", (1.0, 3.0), (-4.0, 40.0), 8, True),
    ("full_window", (1.0, 3.0), (-4.0, 40.0), 8, False),
    ("out_of_band", (1.0, 3.0), (-60.0, 90.0), 8, True),
    ("narrow_sigma_stage1", (0.4, 0.7), (-10.0, 70.0), 16, True),
    ("static_base_d8", (1.0, 3.0), None, 8, True),
    ("static_base_d16", (0.4, 0.7), None, 16, True),
]




def inputs(rng, base_rng, sigma_rng, ws=WS, v=V):
    fr = rng.randn(v, H_R, W_R, C).astype(np.float32)
    fs = rng.randn(v, H_R, ws, C).astype(np.float32)
    base = rng.uniform(*base_rng, (v, H_R, W_R)).astype(np.float32)
    sigma = rng.uniform(*sigma_rng, (v, H_R, W_R)).astype(np.float32)
    return fr, fs, base, sigma


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol,atol", [(torch.float32, 1e-4, 1e-3),
                                             (torch.bfloat16, 1e-3, 1e-2)])
@pytest.mark.parametrize("name,sig,base_rng,D,bounds", CASES,
                         ids=[c[0] for c in CASES])
def test_kernel_matches_plain(cuda_device, dtype, rtol, atol, name, sig,
                              base_rng, D, bounds):
    rng = np.random.RandomState(0)
    fr, fs, base, sigma = inputs(rng, base_rng or (0.0, 0.0), sig)
    dev = cuda_device
    fr, fs = (torch.from_numpy(a).to(dev, dtype).contiguous()
              for a in (fr, fs))
    base = None if base_rng is None else torch.from_numpy(base).to(dev)
    sigma = torch.from_numpy(sigma).to(dev)
    before = cudalib.launches.get("epiband_fwd", 0)
    out = eb.epiband(fr, fs, base, sigma, D, S_MAX)
    torch.cuda.synchronize()
    assert cudalib.launches["epiband_fwd"] == before + 1
    ref = eb.epiband_reference(fr, fs, base, sigma, D, S_MAX)
    torch.testing.assert_close(out, ref, rtol=rtol, atol=atol)


# (id, w_r, ws, C, D, base kind, sigma range): the bf16 kernel's edges
EDGE_CASES = [
    # stage-0 slabs of ~6 x 63 columns: a tile's band spans several chunks
    ("band_wider_than_chunk", 128, 700, 64, 64, None, (5.0, 7.0)),
    # taps at 127|128, 255|256, ...: the pair straddles two chunks
    ("straddling_taps", 128, 600, 64, 44, "straddle", (0.5, 1.5)),
    ("far_and_nan_bases", 128, 400, 64, 44, "far", (0.5, 1.5)),
    ("ragged_w_r", 100, 300, 64, 64, "band", (1.0, 3.0)),
    ("c44", 128, 300, 44, 44, "band", (0.5, 1.5)),
    ("c16", 128, 300, 16, 64, "band", (1.0, 3.0)),
]


def edge_inputs(rng, w_r, ws, C, D, base_kind, sig):
    fr = rng.randn(1, 4, w_r, C).astype(np.float32)
    fs = rng.randn(1, 4, ws, C).astype(np.float32)
    sigma = rng.uniform(*sig, (1, 4, w_r)).astype(np.float32)
    s_max = ws - w_r - 8
    x = np.arange(w_r, dtype=np.float32)
    base = None
    if base_kind == "band":
        base = rng.uniform(-20.0, s_max + 20.0, (1, 4, w_r))
    elif base_kind == "straddle":
        # hypothesis 3 of every pixel at column 128 m - 1 + 0.25 (m >= 1)
        edge = 128.0 * rng.randint(1, ws // 128, (1, 4, w_r)) - 0.75
        base = x + s_max - 3 * sigma - edge
    elif base_kind == "far":
        base = rng.uniform(-20.0, s_max + 20.0, (1, 4, w_r))
        base[0, 0, ::3] = 1e5
        base[0, 1, ::3] = -1e5
        base[0, 2, ::5] = np.nan
    if base is not None:
        base = base.astype(np.float32)
    return fr, fs, base, sigma, s_max


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol,atol", [(torch.float32, 1e-4, 1e-3),
                                             (torch.bfloat16, 1e-3, 1e-2)])
@pytest.mark.parametrize("name,w_r,ws,C,D,base_kind,sig", EDGE_CASES,
                         ids=[c[0] for c in EDGE_CASES])
def test_kernel_edges_match_plain(cuda_device, dtype, rtol, atol, name, w_r,
                                  ws, C, D, base_kind, sig):
    """The forward kernel against its plain version where the bf16 kernel's
    chunks, tiles and padded channels have edges; a NaN base gives NaN
    outputs in both."""
    rng = np.random.RandomState(6)
    fr, fs, base, sigma, s_max = edge_inputs(rng, w_r, ws, C, D, base_kind,
                                             sig)
    fr, fs = (torch.from_numpy(a).to(cuda_device, dtype) for a in (fr, fs))
    base = None if base is None else torch.from_numpy(base).to(cuda_device)
    sigma = torch.from_numpy(sigma).to(cuda_device)
    out = eb.epiband(fr, fs, base, sigma, D, s_max)
    torch.cuda.synchronize()
    ref = eb.epiband_reference(fr, fs, base, sigma, D, s_max)
    assert float(ref.nan_to_num().abs().max()) > 1.0
    assert (base_kind == "far") == bool(ref.isnan().any())
    torch.testing.assert_close(out, ref, rtol=rtol, atol=atol,
                               equal_nan=True)


# (id, w_r, ws, C, D, base kind, sigma range): the fp32 kernel's own edges:
# hypotheses in groups of at most 64 (one block each, the last shorter),
# and a row of more than 64 of its 64-column chunks, whose far chunks the
# bitmap marks in shared memory, not in registers
FP32_EDGE_CASES = [
    ("groups_65", 100, 700, 64, 65, "band", (1.0, 3.0)),
    ("groups_100_stage0", 128, 900, 64, 100, None, (4.0, 6.0)),
    ("groups_257", 45, 600, 44, 257, "band", (0.5, 1.5)),
    ("row_of_94_chunks", 128, 6000, 64, 44, "band", (0.5, 1.5)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("name,w_r,ws,C,D,base_kind,sig", FP32_EDGE_CASES,
                         ids=[c[0] for c in FP32_EDGE_CASES])
def test_fp32_kernel_groups_and_wide_rows_match_plain(cuda_device, name, w_r,
                                                      ws, C, D, base_kind,
                                                      sig):
    """Shapes the bf16 kernel refuses or never meets: every output is
    written (``out`` starts as NaN) and matches the plain version."""
    rng = np.random.RandomState(10)
    fr, fs, base, sigma, s_max = edge_inputs(rng, w_r, ws, C, D, base_kind,
                                             sig)
    fr, fs = (torch.from_numpy(a).to(cuda_device) for a in (fr, fs))
    base = None if base is None else torch.from_numpy(base).to(cuda_device)
    sigma = torch.from_numpy(sigma).to(cuda_device)
    out = torch.full((1, 4, w_r, D), float("nan"), device=cuda_device)
    eb._launch(fr, fs, base, sigma, D, s_max, out=out)
    torch.cuda.synchronize()
    ref = eb.epiband_reference(fr, fs, base, sigma, D, s_max)
    assert not bool(out.isnan().any())
    assert float(ref.abs().max()) > 1.0
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol,atol", [(torch.float32, 1e-4, 1e-3),
                                             (torch.bfloat16, 1e-3, 1e-2)])
@pytest.mark.parametrize("C", [64, 44])
def test_kernel_takes_features_two_elements_in(cuda_device, dtype, rtol,
                                               atol, C):
    """fr and fs two elements into their storage (8 bytes for fp32, 4 for
    bf16): the copies narrow to channel pairs, and the result holds."""
    rng = np.random.RandomState(12)
    fr, fs, base, sigma, s_max = edge_inputs(rng, 100, 400, C, 44, "band",
                                             (0.5, 1.5))

    def shifted(a):
        flat = torch.zeros(a.size + 2, device=cuda_device, dtype=dtype)
        flat[2:] = torch.from_numpy(a.reshape(-1)).to(cuda_device, dtype)
        return flat[2:].view(a.shape)

    fr, fs = shifted(fr), shifted(fs)
    base, sigma = (torch.from_numpy(a).to(cuda_device) for a in (base, sigma))
    geo = eb.launch_geometry(1, 4, 100, 400, C, 44, dtype,
                             min(cudalib.pointer_alignment(fr),
                                 cudalib.pointer_alignment(fs)))
    assert geo.vec == 2
    out = eb.epiband(fr, fs, base, sigma, 44, s_max)
    torch.cuda.synchronize()
    torch.testing.assert_close(
        out, eb.epiband_reference(fr, fs, base, sigma, 44, s_max), rtol=rtol,
        atol=atol)


# sha256 prefixes of the bf16 forward's outputs on ``forward_digest_case``'s
# inputs, phase 2's two stage shapes, taken from the kernel before it was
# templated for fp32 (NVIDIA H100 80GB HBM3, CUDA 12.8): they must not change
BF16_FORWARD_DIGESTS = {0: "26d26def6eb64317", 1: "739c76e5762ab735"}


def forward_digest_case(dev, stage):
    """Phase 2's stage shapes (the inference plan's widest view, (1, 512,
    512) pixels against 1104 source columns, C = 64): stage 0, D = 64 with
    base == 0; stage 1, D = 44 with bases as the main path forms them
    (sigma * (5 k0 - 22), k0 a smooth stage-0 estimate), bf16 features."""
    rng = np.random.default_rng(31 + stage)
    fr = rng.standard_normal((1, 512, 512, 64), dtype=np.float32)
    fs = rng.standard_normal((1, 512, 1104, 64), dtype=np.float32)
    sig = (4.26, 5.64) if stage == 0 else (0.85, 1.13)
    sigma = rng.uniform(*sig, (1, 512, 512)).astype(np.float32)
    base = None
    if stage == 1:
        yy, xx = np.meshgrid(np.linspace(0, 1, 512), np.linspace(0, 1, 512),
                             indexing="ij")
        k0 = 63 * (0.5 + 0.25 * np.sin(2 * np.pi * xx)
                   + 0.25 * np.cos(2 * np.pi * yy))
        k0 = np.clip(k0 + rng.uniform(-0.5, 0.5, k0.shape), 0, 63)
        base = torch.from_numpy(
            (sigma * (5.0 * k0 - 22.0)).astype(np.float32)).to(dev)
    fr, fs = (torch.from_numpy(a).to(dev, torch.bfloat16) for a in (fr, fs))
    return fr, fs, base, torch.from_numpy(sigma).to(dev), (64, 44)[stage]


def forward_digests(dev):
    """{stage: sha256 prefix of the bf16 forward's output}."""
    import hashlib

    got = {}
    for stage in (0, 1):
        fr, fs, base, sigma, D = forward_digest_case(dev, stage)
        out = eb.epiband(fr, fs, base, sigma, D, 576)
        torch.cuda.synchronize()
        got[stage] = hashlib.sha256(
            out.cpu().numpy().tobytes()).hexdigest()[:16]
    return got


@pytest.mark.cuda
def test_bf16_forward_outputs_unchanged(cuda_device):
    assert forward_digests(cuda_device) == BF16_FORWARD_DIGESTS


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C,offset", [(64, 0), (44, 0), (3, 0), (64, 1)])
def test_hat_kernel_non_monotonic_positions(cuda_device, dtype, C, offset):
    """Positions in random order (no column reuse between neighbours), and
    an image one element into its storage (narrower vector loads)."""
    rng = np.random.RandomState(8)
    R, S, O = 12, 90, 150
    img = torch.from_numpy(rng.randn(R, S, C).astype(np.float32)).to(
        cuda_device, dtype)
    if offset:
        flat = torch.zeros(img.numel() + offset, device=cuda_device,
                           dtype=dtype)
        flat[offset:] = img.reshape(-1)
        img = flat[offset:].view(R, S, C)
    pos = rng.uniform(-3.0, S + 2.0, (R, O)).astype(np.float32)
    pos[0, :3] = [-1e4, 1e4, S - 1.0]
    pos = torch.from_numpy(pos).to(cuda_device)
    out = hw.hat_resample_rows(img, pos)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, hw.hat_resample_rows_reference(img, pos),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol,atol", [(torch.float32, 1e-4, 1e-3),
                                             (torch.bfloat16, 1e-3, 1e-2)])
@pytest.mark.parametrize("w_r,C,D", [(100, 64, 64), (37, 44, 44),
                                     (70, 16, 100), (17, 64, 256)])
def test_epiband_kernel_writes_every_output(cuda_device, dtype, rtol, atol,
                                            w_r, C, D):
    """A ragged launch at each bf16 tile (64, 32, 16 pixels) writes every
    output: ``out`` starts as NaN, and in-band and out-of-band bases give
    finite values only."""
    rng = np.random.RandomState(9)
    ws = w_r + 300
    s_max = ws - w_r - 8
    fr, fs = (torch.from_numpy(rng.randn(2, 3, n, C).astype(np.float32)).to(
        cuda_device, dtype) for n in (w_r, ws))
    base, sigma = (torch.from_numpy(rng.uniform(lo, hi, (2, 3, w_r)).astype(
        np.float32)).to(cuda_device) for lo, hi in ((-20.0, s_max + 20.0),
                                                    (0.5, 1.5)))
    out = torch.full((2, 3, w_r, D), float("nan"), device=cuda_device)
    eb._launch(fr, fs, base, sigma, D, s_max, out=out)
    torch.cuda.synchronize()
    assert not bool(out.isnan().any())
    torch.testing.assert_close(
        out, eb.epiband_reference(fr, fs, base, sigma, D, s_max), rtol=rtol,
        atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,O,C", [(90, 151, 64), (33, 7, 44), (50, 300, 3),
                                   (20, 1000, 2)])
def test_hat_kernel_writes_every_output(cuda_device, dtype, S, O, C):
    """Ragged rows, channel counts that take each vector width, and more
    positions than one block holds: ``out`` starts as NaN and none is
    left."""
    rng = np.random.RandomState(10)
    R = 5
    img = torch.from_numpy(rng.randn(R, S, C).astype(np.float32)).to(
        cuda_device, dtype)
    pos = torch.from_numpy(rng.uniform(-3.0, S + 2.0, (R, O)).astype(
        np.float32)).to(cuda_device)
    out = torch.full((R, O, C), float("nan"), device=cuda_device)
    hw._launch_forward(img, pos, out=out)
    torch.cuda.synchronize()
    assert not bool(out.isnan().any())
    torch.testing.assert_close(out, hw.hat_resample_rows_reference(img, pos),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol,atol", [(torch.float32, 1e-4, 1e-3),
                                             (torch.bfloat16, 1e-2, 1e-2)])
@pytest.mark.parametrize("name,sig,base_rng,D,bounds", CASES,
                         ids=[c[0] for c in CASES])
def test_backward_kernels_match_plain(cuda_device, dtype, rtol, atol, name,
                                      sig, base_rng, D, bounds):
    rng = np.random.RandomState(1)
    fr, fs, base, sigma = inputs(rng, base_rng or (0.0, 0.0), sig)
    dev = cuda_device
    fr, fs = (torch.from_numpy(a).to(dev, dtype).contiguous()
              for a in (fr, fs))
    base = None if base_rng is None else torch.from_numpy(base).to(dev)
    sigma = torch.from_numpy(sigma).to(dev)
    dout = torch.from_numpy(rng.randn(V, H_R, W_R, D).astype(np.float32)
                            ).to(dev)
    before = dict(cudalib.launches)
    dfr, dfs = eb.epiband_backward(fr, fs, base, sigma, dout, S_MAX)
    torch.cuda.synchronize()
    for k in ("epiband_bwd_dfr", "epiband_bwd_dfs"):
        assert cudalib.launches[k] == before.get(k, 0) + 1
    rfr, rfs = eb.epiband_backward_reference(fr, fs, base, sigma, dout,
                                             S_MAX)
    assert dfr.dtype == dfs.dtype == dtype
    torch.testing.assert_close(dfr.float(), rfr.float(), rtol=rtol,
                               atol=atol)
    torch.testing.assert_close(dfs.float(), rfs.float(), rtol=rtol,
                               atol=atol)
    if dtype == torch.bfloat16:
        # the same bf16 roundings as the plain version: all but a few
        # elements equal
        for a, b in ((dfr, rfr), (dfs, rfs)):
            assert float((a != b).float().mean()) < 0.01


# (id, w_r, ws, C, D, base kind, sigma range): the dfs kernel at C = 64, 44
# and 16 (its registers hold 64, 64 and 16 channels), the training plan's
# ws (three windows of 352 columns), a ragged ws, eight windows, one tap
# per column, a negative sigma, and NaN and +-1e5 bases
DFS_CASES = [
    ("c64_stage0", 128, 1040, 64, 64, None, (0.8, 1.2)),
    ("c44_stage1", 128, 1040, 44, 44, "band", (0.02, 0.1)),
    ("c16", 128, 300, 16, 64, "band", (1.0, 3.0)),
    ("ragged_ws", 100, 1037, 64, 44, "band", (0.4, 0.7)),
    ("windows_c64", 128, 4000, 64, 64, "band", (2.0, 4.0)),
    ("windows_c16", 100, 4001, 16, 44, "band", (0.5, 1.5)),
    ("one_tap_per_column", 128, 700, 64, 64, None, (5.0, 7.0)),
    ("far_and_nan_bases", 128, 400, 64, 44, "far", (0.5, 1.5)),
    ("negative_sigma", 128, 600, 64, 44, "band", (-1.5, -0.5)),
]


def dfs_inputs(rng, dev, dtype, w_r, ws, C, D, base_kind, sig):
    fr, fs, base, sigma, s_max = edge_inputs(rng, w_r, ws, C, D, base_kind,
                                             sig)
    fr, fs = (torch.from_numpy(a).to(dev, dtype) for a in (fr, fs))
    base = None if base is None else torch.from_numpy(base).to(dev)
    dout = torch.from_numpy(rng.randn(1, 4, w_r, D).astype(np.float32)).to(
        dev)
    return fr, fs, base, torch.from_numpy(sigma).to(dev), dout, s_max


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol,atol", [(torch.float32, 1e-4, 1e-3),
                                             (torch.bfloat16, 1e-2, 1e-2)])
@pytest.mark.parametrize("name,w_r,ws,C,D,base_kind,sig", DFS_CASES,
                         ids=[c[0] for c in DFS_CASES])
def test_dfs_kernel_matches_plain(cuda_device, dtype, rtol, atol, name, w_r,
                                  ws, C, D, base_kind, sig):
    """The shared-memory dfs kernel against the plain version's dfs; with
    bf16 features it rounds where the plain version rounds, so under 1% of
    the elements differ at all. NaN and far bases add nothing in both."""
    rng = np.random.RandomState(11)
    args = dfs_inputs(rng, cuda_device, dtype, w_r, ws, C, D, base_kind, sig)
    if name.startswith("windows"):  # what the case is for
        assert eb.dfs_launch_geometry(1, 4, ws, C, D, dtype).grid[0] >= 8
    before = cudalib.launches.get("epiband_bwd_dfs", 0)
    dfs = eb.backward_dfs(*args)
    torch.cuda.synchronize()
    assert cudalib.launches["epiband_bwd_dfs"] == before + 1
    ref = eb.epiband_backward_reference(*args)[1]
    assert dfs.dtype == dtype and dfs.shape == ref.shape
    assert bool(ref.isfinite().all()) and float(ref.abs().max()) > 1.0
    torch.testing.assert_close(dfs.float(), ref.float(), rtol=rtol, atol=atol)
    if dtype == torch.bfloat16:
        assert float((dfs != ref).float().mean()) < 0.01


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name,w_r,ws,C,D,base_kind,sig",
                         [c for c in DFS_CASES if c[0] in (
                             "c44_stage1", "ragged_ws", "windows_c16",
                             "far_and_nan_bases")],
                         ids=["c44_stage1", "ragged_ws", "windows_c16",
                              "far_and_nan_bases"])
def test_dfs_writes_every_output(cuda_device, dtype, name, w_r, ws, C, D,
                                 base_kind, sig):
    """``out`` filled with NaN: the kernel writes every element of every
    slice and window (a ragged slice, a ragged ws, windows, rows of far and
    NaN bases), columns no tap reaches included."""
    rng = np.random.RandomState(12)
    args = dfs_inputs(rng, cuda_device, dtype, w_r, ws, C, D, base_kind, sig)
    out = torch.full((1, 4, ws, C), float("nan"), device=cuda_device,
                     dtype=dtype)
    eb.backward_dfs(*args, out=out)
    torch.cuda.synchronize()
    assert not bool(out.isnan().any())
    ref = eb.epiband_backward_reference(*args)[1]
    tol = 1e-3 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)


# the dfs cases, and for dfr's own layouts: D = 40 (lanes across hypotheses
# beyond one warp's 32, not a multiple of 32), C = 62 and 42 (C % 4 != 0:
# each lane's channel pairs at 2i and 32 + 2i), and C = 64 with fs two
# elements into its storage, where only the pairs' alignment holds
DFR_CASES = DFS_CASES + [
    ("d40", 100, 700, 64, 40, "band", (0.8, 2.0)),
    ("c62_pairs", 100, 500, 62, 44, "band", (0.5, 1.5)),
    ("c64_pairs_offset", 128, 400, 64, 64, None, (2.0, 4.0)),
]


def dfr_inputs(rng, dev, dtype, name, w_r, ws, C, D, base_kind, sig):
    fr, fs, base, sigma, dout, s_max = dfs_inputs(rng, dev, dtype, w_r, ws,
                                                  C, D, base_kind, sig)
    if name.endswith("_offset"):  # a view two elements into its storage
        fs = torch.cat([fs.new_zeros(2), fs.flatten()])[2:].view(fs.shape)
    return fr, fs, base, sigma, dout, s_max


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol,atol", [(torch.float32, 1e-4, 1e-3),
                                             (torch.bfloat16, 1e-2, 1e-2)])
@pytest.mark.parametrize("name,w_r,ws,C,D,base_kind,sig", DFR_CASES,
                         ids=[c[0] for c in DFR_CASES])
def test_dfr_kernel_matches_plain(cuda_device, dtype, rtol, atol, name, w_r,
                                  ws, C, D, base_kind, sig):
    """The dfr kernel against the plain version's dfr; with bf16 features
    it rounds where the plain version rounds, so under 1% of the elements
    differ at all. NaN and far bases add nothing in both."""
    rng = np.random.RandomState(13)
    args = dfr_inputs(rng, cuda_device, dtype, name, w_r, ws, C, D,
                      base_kind, sig)
    geo = eb.dfr_launch_geometry(1, 4, w_r, ws, C, D, dtype,
                                 cudalib.pointer_alignment(args[1]))
    assert geo.vec == (2 if "pairs" in name else 4)  # what the case is for
    before = cudalib.launches.get("epiband_bwd_dfr", 0)
    dfr = eb.backward_dfr(*args)
    torch.cuda.synchronize()
    assert cudalib.launches["epiband_bwd_dfr"] == before + 1
    ref = eb.epiband_backward_reference(*args)[0]
    assert dfr.dtype == dtype and dfr.shape == ref.shape
    assert bool(ref.isfinite().all()) and float(ref.abs().max()) > 1.0
    torch.testing.assert_close(dfr.float(), ref.float(), rtol=rtol, atol=atol)
    if dtype == torch.bfloat16:
        assert float((dfr != ref).float().mean()) < 0.01


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name,w_r,ws,C,D,base_kind,sig",
                         [c for c in DFR_CASES if c[0] in (
                             "ragged_ws", "far_and_nan_bases",
                             "negative_sigma", "d40", "c62_pairs")],
                         ids=["ragged_ws", "far_and_nan_bases",
                              "negative_sigma", "d40", "c62_pairs"])
def test_dfr_writes_every_output(cuda_device, dtype, name, w_r, ws, C, D,
                                 base_kind, sig):
    """``out`` filled with NaN: the kernel writes every element of every
    pixel (a ragged tile, pixels of far and NaN bases, whose taps all miss
    the row, and the channels of the pair layout) and nothing else."""
    rng = np.random.RandomState(14)
    args = dfr_inputs(rng, cuda_device, dtype, name, w_r, ws, C, D,
                      base_kind, sig)
    n = 4 * w_r * C
    flat = torch.full((n + 64,), float("nan"), device=cuda_device,
                      dtype=dtype)
    out = flat[:n].view(1, 4, w_r, C)
    eb.backward_dfr(*args, out=out)
    torch.cuda.synchronize()
    assert not bool(out.isnan().any())
    assert bool(flat[n:].isnan().all())
    ref = eb.epiband_backward_reference(*args)[0]
    tol = 1e-3 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
def test_backward_through_autograd_launches_both_kernels(cuda_device):
    rng = np.random.RandomState(2)
    fr, fs, base, sigma = (torch.from_numpy(a).to(cuda_device) for a in
                           inputs(rng, (-4.0, 40.0), (1.0, 3.0)))
    fr.requires_grad_(True)
    fs.requires_grad_(True)
    cudalib.reset_launches()
    out = eb.epiband(fr, fs, base, sigma, 8, S_MAX)
    out.square().sum().backward()
    torch.cuda.synchronize()
    assert {k: cudalib.launches.get(k, 0) for k in eb.KERNELS} == {
        "epiband_fwd": 1, "epiband_bwd_dfr": 1, "epiband_bwd_dfs": 1}
    rfr, rfs = eb.epiband_backward_reference(
        fr.detach(), fs.detach(), base, sigma, 2 * out.detach(), S_MAX)
    torch.testing.assert_close(fr.grad, rfr, rtol=1e-4, atol=1e-3)
    torch.testing.assert_close(fs.grad, rfs, rtol=1e-4, atol=1e-3)


def hat_inputs(rng, R=16, S=300, O=420, C=44):
    img = rng.randn(R, S, C).astype(np.float32)
    pos = (np.linspace(-5, S + 5, O)[None] * np.ones((R, 1))
           + rng.uniform(-0.7, 0.7, (R, O))).astype(np.float32)
    pos[0, :3] = [-1e4, 1e4, -1.0]
    return img, pos


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C", [44, 64, 3])
def test_hat_kernels_match_plain(cuda_device, dtype, C):
    rng = np.random.RandomState(3)
    img, pos = hat_inputs(rng, C=C)
    img = torch.from_numpy(img).to(cuda_device, dtype)
    pos = torch.from_numpy(pos).to(cuda_device)
    dout = torch.from_numpy(rng.randn(16, 420, C).astype(np.float32)).to(
        cuda_device)
    before = dict(cudalib.launches)
    out = hw.hat_resample_rows(img, pos)
    dimg = hw.hat_rows_backward(dout, pos, img.shape[1], dtype)
    torch.cuda.synchronize()
    for k in hw.KERNELS:
        assert cudalib.launches[k] == before.get(k, 0) + 1
    torch.testing.assert_close(out, hw.hat_resample_rows_reference(img, pos),
                               rtol=1e-5, atol=1e-5)
    ref = hw.hat_resample_rows_backward_reference(dout, pos, img.shape[1],
                                                  dtype)
    assert dimg.dtype == dtype
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(dimg.float(), ref.float(), rtol=tol, atol=tol)


def hat_backward_case(dev, rng, R, S, O, C, pos, dtype, offset=0):
    """dout (R, O, C) fp32, ``offset`` elements into its storage (narrower
    vector loads), for positions ``pos``; returns the kernel's and the
    plain version's dimg."""
    dout = torch.from_numpy(rng.randn(R, O, C).astype(np.float32)).to(dev)
    if offset:
        flat = torch.zeros(dout.numel() + offset, device=dev)
        flat[offset:] = dout.reshape(-1)
        dout = flat[offset:].view(R, O, C)
    pos = torch.from_numpy(pos.astype(np.float32)).to(dev)
    before = cudalib.launches.get("hat_rows_bwd", 0)
    dimg = hw.hat_rows_backward(dout, pos, S, dtype)
    torch.cuda.synchronize()
    assert cudalib.launches["hat_rows_bwd"] == before + 1
    assert dimg.dtype == dtype and tuple(dimg.shape) == (R, S, C)
    return dimg, hw.hat_resample_rows_backward_reference(dout, pos, S, dtype)


def hat_backward_tol(dtype):
    return 1e-5 if dtype == torch.float32 else 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C,offset", [(64, 0), (44, 0), (3, 0), (64, 1)])
def test_hat_backward_non_monotonic_positions(cuda_device, dtype, C, offset):
    """The transpose with positions in random order (bins far from their
    first output: the one-warp ranking) and with a jittered sweep (the
    counting ranking), each with a dout one element into its storage in
    one case."""
    rng = np.random.RandomState(11)
    R, S, O = 12, 90, 150
    shuffled = rng.uniform(-3.0, S + 2.0, (R, O))
    shuffled[0, :3] = [-1e4, 1e4, S - 1.0]
    sweep = (np.linspace(-4, S + 4, O)[None] + rng.uniform(-0.5, 0.5, (R, O)))
    for pos in (shuffled, sweep):
        dimg, ref = hat_backward_case(cuda_device, rng, R, S, O, C, pos,
                                      dtype, offset)
        tol = hat_backward_tol(dtype)
        torch.testing.assert_close(dimg.float(), ref.float(), rtol=tol,
                                   atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_hat_backward_pile_up_and_rows_off_the_image(cuda_device, dtype):
    """A clamp-mode pile-up (every output on column 0 or S-1, one bin's list
    holding most of the row), rows wholly at -1e4 (empty lists: zeros), and
    a clamped sweep whose edge bins hold long runs."""
    rng = np.random.RandomState(12)
    R, S, O, C = 6, 40, 700, 44
    pos = np.where(rng.rand(R, O) < 0.5, 0.0, S - 1.0)
    pos[1] = 0.0
    pos[2] = -1e4
    pos[3] = np.clip(np.linspace(-300, S + 300, O), 0.0, S - 1.0)
    dimg, ref = hat_backward_case(cuda_device, rng, R, S, O, C, pos, dtype)
    assert bool((dimg[2] == 0).all())
    tol = hat_backward_tol(dtype)
    torch.testing.assert_close(dimg.float(), ref.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,O,C", [(90, 151, 64), (33, 7, 44), (50, 300, 3),
                                   (20, 1000, 2), (300, 40, 16)])
def test_hat_backward_writes_every_output(cuda_device, dtype, S, O, C):
    """``out`` filled with NaN, passed to ``hat_rows_backward(..., out=)``:
    every element is written (columns no output reaches get zero), with
    several rows per block where rows are small, and two launches give the
    same bits."""
    rng = np.random.RandomState(13)
    R = 5
    pos = torch.from_numpy(rng.uniform(-3.0, S + 2.0, (R, O)).astype(
        np.float32)).to(cuda_device)
    dout = torch.from_numpy(rng.randn(R, O, C).astype(np.float32)).to(
        cuda_device)
    out = torch.full((R, S, C), float("nan"), device=cuda_device, dtype=dtype)
    got = hw.hat_rows_backward(dout, pos, S, dtype, out=out)
    again = hw.hat_rows_backward(dout, pos, S, dtype)
    torch.cuda.synchronize()
    assert got.data_ptr() == out.data_ptr()
    assert not bool(out.isnan().any())
    assert torch.equal(out.view(torch.int16 if dtype == torch.bfloat16
                                else torch.int32),
                       again.view(torch.int16 if dtype == torch.bfloat16
                                  else torch.int32))
    tol = hat_backward_tol(dtype)
    torch.testing.assert_close(
        out.float(), hw.hat_resample_rows_backward_reference(
            dout, pos, S, dtype).float(), rtol=tol, atol=tol)


@pytest.mark.cuda
def test_hat_backward_is_deterministic_at_a_training_shape(cuda_device):
    """Two launches at a feature warp's shape give identical bits (a sum
    order fixed by the lists, not by the scheduler)."""
    rng = np.random.RandomState(14)
    R, S, O, C = 64, 360, 1040, 64
    pos = torch.from_numpy((np.linspace(-4, S + 4, O)[None]
                            + rng.uniform(-0.5, 0.5, (R, O))).astype(
        np.float32)).to(cuda_device)
    dout = torch.randn((R, O, C), device=cuda_device,
                       generator=torch.Generator(cuda_device).manual_seed(0))
    for dtype in (torch.float32, torch.bfloat16):
        a = hw.hat_rows_backward(dout, pos, S, dtype)
        b = hw.hat_rows_backward(dout, pos, S, dtype)
        torch.cuda.synchronize()
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_hat_kernel_rejects_bad_inputs_and_card_stays_usable(cuda_device):
    img = torch.zeros(4, 30, 8, device=cuda_device)
    pos = torch.zeros(4, 10, device=cuda_device)
    with pytest.raises(ValueError, match="one device"):
        hw.hat_resample_rows(img, pos.cpu())
    with pytest.raises(ValueError, match="contiguous"):
        hw.hat_resample_rows(img.transpose(0, 1).contiguous().transpose(0, 1),
                             pos)
    with pytest.raises(TypeError):
        hw.hat_resample_rows(img.half(), pos)
    out = hw.hat_resample_rows(img + 1.0, pos + 3.0)
    torch.cuda.synchronize()
    assert float(out.min()) == float(out.max()) == 1.0


# ---------------------------------------------------------------------------
# The quad warp (ops/quadwarp.py): forward bit for bit the plain version,
# transpose within one rounding of the image's dtype and fp32 reordering
# ---------------------------------------------------------------------------

# (image (H, W, C), dtype, positions (rows, cols), rotation in degrees,
# mode) of the one-pass warps at a training plan's shapes: the reference
# and source feature warps, the two stages' volume back-warps, the origin
QUAD_CASES = {
    "ref_warp": ((264, 360, 64), torch.bfloat16, (448, 512), 12.0, "zero"),
    "src_warp": ((264, 360, 64), torch.bfloat16, (448, 1040), -7.0, "zero"),
    "back_warp_d64": ((448, 512, 64), torch.bfloat16, (264, 360), -12.0,
                      "zero"),
    "back_warp_d44": ((448, 512, 44), torch.bfloat16, (264, 360), 25.0,
                      "zero"),
    "origin": ((264, 360, 1), torch.float32, (448, 512), 12.0, "clamp"),
}


def rotation_map(dev, rows, cols, H, W, angle, rng, scale=1.0):
    """Positions of a (rows, cols) grid rotated by ``angle`` about the
    image's centre (a rectifying rotation keeps the focal length: scale
    1), jittered by up to a tenth of a pixel."""
    t = np.deg2rad(angle)
    r, q = np.mgrid[0:rows, 0:cols].astype(np.float64)
    r -= (rows - 1) / 2
    q -= (cols - 1) / 2
    x = scale * (np.cos(t) * q - np.sin(t) * r) + (W - 1) / 2
    y = scale * (np.sin(t) * q + np.cos(t) * r) + (H - 1) / 2
    x += rng.uniform(-0.1, 0.1, x.shape)
    y += rng.uniform(-0.1, 0.1, y.shape)
    return (torch.from_numpy(x.astype(np.float32)).to(dev),
            torch.from_numpy(y.astype(np.float32)).to(dev))


def quad_inputs(dev, rng, shape, dtype, x):
    img = torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dev,
                                                                    dtype)
    dout = torch.from_numpy(rng.randn(*x.shape, shape[2]).astype(
        np.float32)).to(dev)
    return img, dout


def quad_transpose(dout, x, y, shape, dtype, mode="zero", counter=None):
    """The kernel's transpose as the port reaches it: autograd through
    ``quad_warp`` of an image of ``shape`` and ``dtype``."""
    leaf = torch.zeros(shape, dtype=dtype, device=dout.device,
                       requires_grad=True)
    out = qw.quad_warp(leaf, x, y, mode, counter=counter)
    (dimg,) = torch.autograd.grad(out, leaf, dout)
    return dimg


def assert_forward_bit_equal(img, x, y, mode):
    """The kernel's forward against the plain version on the card, bit for
    bit (NaN and the sign of zero included)."""
    before = cudalib.launches.get("quad_warp_fwd", 0)
    out = qw.quad_warp(img, x, y, mode)
    ref = qw.warp_image_reference(img, x, y, mode)
    torch.cuda.synchronize()
    assert cudalib.launches["quad_warp_fwd"] == before + 1
    assert out.dtype == torch.float32 and out.shape == ref.shape
    assert torch.equal(out.view(torch.int32), ref.view(torch.int32))
    return out


def assert_backward_close(dimg, dout, x, y, shape, dtype, mode, n_terms=64):
    """The transpose against the plain fp32 one (``index_add_``, not
    rounded): within one ulp of the image's dtype (at most 2^-7 of the
    value in bf16, none in fp32) plus fp32 reordering, n_terms * 2^-24 of
    the element's sum of |terms|."""
    ref = qw.warp_image_backward_reference(dout, x, y, shape, torch.float32,
                                           mode)
    terms = qw.warp_image_backward_reference(dout.abs(), x, y, shape,
                                             torch.float32, mode)
    assert dimg.dtype == dtype and tuple(dimg.shape) == tuple(shape)
    ulp = 2.0 ** -7 * ref.abs() if dtype == torch.bfloat16 else 0.0
    err = (dimg.float() - ref).abs()
    allowed = ulp + n_terms * 2.0 ** -24 * terms
    assert bool((err <= allowed).all()), float((err - allowed).max())
    return ref


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(QUAD_CASES))
def test_quad_warp_matches_plain_at_training_shapes(cuda_device, case):
    shape, dtype, (rows, cols), angle, mode = QUAD_CASES[case]
    rng = np.random.RandomState(21)
    x, y = rotation_map(cuda_device, rows, cols, *shape[:2], angle, rng)
    img, dout = quad_inputs(cuda_device, rng, shape, dtype, x)
    out = assert_forward_bit_equal(img, x, y, mode)
    assert float(out.abs().max()) > 0
    counter = torch.zeros(2, dtype=torch.int32, device=cuda_device)
    before = cudalib.launches.get("quad_warp_bwd", 0)
    dimg = quad_transpose(dout, x, y, shape, dtype, mode, counter=counter)
    torch.cuda.synchronize()
    assert cudalib.launches["quad_warp_bwd"] == before + 1
    assert_backward_close(dimg, dout, x, y, shape, dtype, mode)
    active, fallback = counter.tolist()
    # a rotation of scale 1: every tile's footprint fits shared memory
    assert active > 0 and fallback == 0


def edge_positions(dev, kind, rng, H, W, shape=(40, 56)):
    """Positions outside the image and across its edges, on its last row
    and column, or on integers."""
    if kind == "outside":
        x = rng.uniform(-6, W + 5, shape)
        y = rng.uniform(-6, H + 5, shape)
        x.reshape(-1)[:4] = [-1e4, 1e4, -1.0, W - 0.5]
        y.reshape(-1)[:4] = [3.0, 2.0, -1e4, 1e4]
    elif kind == "last_row_and_column":
        x = np.where(rng.rand(*shape) < 0.5, W - 1.0,
                     rng.uniform(W - 1.5, W - 0.5, shape))
        y = np.where(rng.rand(*shape) < 0.5, H - 1.0,
                     rng.uniform(H - 1.5, H - 0.5, shape))
    else:  # integers, one past each edge included
        x = rng.randint(-1, W + 1, shape).astype(np.float64)
        y = rng.randint(-1, H + 1, shape).astype(np.float64)
    return (torch.from_numpy(x.astype(np.float32)).to(dev),
            torch.from_numpy(y.astype(np.float32)).to(dev))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["outside", "last_row_and_column",
                                  "integers"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("mode", ["zero", "clamp"])
@pytest.mark.parametrize("C", [64, 3])
def test_quad_warp_edges_match_plain(cuda_device, C, mode, dtype, kind):
    rng = np.random.RandomState(22)
    H, W = 30, 41
    x, y = edge_positions(cuda_device, kind, rng, H, W)
    img, dout = quad_inputs(cuda_device, rng, (H, W, C), dtype, x)
    assert_forward_bit_equal(img, x, y, mode)
    dimg = quad_transpose(dout, x, y, (H, W, C), dtype, mode)
    torch.cuda.synchronize()
    assert_backward_close(dimg, dout, x, y, (H, W, C), dtype, mode)


@pytest.mark.cuda
@pytest.mark.parametrize("C", [64, 44, 1])
def test_quad_backward_pile_up(cuda_device, C):
    """Every position within a third of a pixel of one source pixel: each
    tile's four shared-memory cells take 64 positions' shares at once
    (shared atomics contending), and nothing falls back."""
    rng = np.random.RandomState(23)
    H, W, rows, cols = 64, 64, 64, 96
    x = torch.from_numpy((40.0 + rng.uniform(0, 0.3, (rows, cols))).astype(
        np.float32)).to(cuda_device)
    y = torch.from_numpy((20.0 + rng.uniform(0, 0.3, (rows, cols))).astype(
        np.float32)).to(cuda_device)
    _, dout = quad_inputs(cuda_device, rng, (H, W, C), torch.float32, x)
    counter = torch.zeros(2, dtype=torch.int32, device=cuda_device)
    for dtype in (torch.float32, torch.bfloat16):
        counter.zero_()
        dimg = quad_transpose(dout, x, y, (H, W, C), dtype,
                                counter=counter)
        torch.cuda.synchronize()
        assert counter.tolist() == [(rows // 8) * (cols // 8), 0]
        ref = assert_backward_close(dimg, dout, x, y, (H, W, C), dtype,
                                    "zero", n_terms=rows * cols)
        assert int((ref != 0).any(-1).sum()) == 4


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_quad_backward_falls_back_where_a_footprint_overflows(cuda_device,
                                                              dtype):
    """Positions strewn over a 128 x 128 image of 64 channels: a tile's
    box spans most of the image (~4 MB, past a block's shared memory), so
    every block with a corner on the image adds straight to the buffer,
    and the counter says so."""
    rng = np.random.RandomState(24)
    H, W, C = 128, 128, 64
    x = torch.from_numpy(rng.uniform(-2, W + 1, (80, 72)).astype(
        np.float32)).to(cuda_device)
    y = torch.from_numpy(rng.uniform(-2, H + 1, (80, 72)).astype(
        np.float32)).to(cuda_device)
    _, dout = quad_inputs(cuda_device, rng, (H, W, C), torch.float32, x)
    counter = torch.zeros(2, dtype=torch.int32, device=cuda_device)
    dimg = quad_transpose(dout, x, y, (H, W, C), dtype, counter=counter)
    torch.cuda.synchronize()
    assert counter.tolist() == [10 * 9, 10 * 9]
    assert_backward_close(dimg, dout, x, y, (H, W, C), dtype, "zero")


@pytest.mark.cuda
def test_quad_backward_runs_agree(cuda_device):
    """Two launches at the source warp's shape: the atomics meet in
    another order, so the fp32 sums agree to reordering, and after
    rounding to bf16 to one ulp."""
    shape, dtype, (rows, cols), angle, mode = QUAD_CASES["src_warp"]
    rng = np.random.RandomState(25)
    x, y = rotation_map(cuda_device, rows, cols, *shape[:2], angle, rng)
    _, dout = quad_inputs(cuda_device, rng, shape, dtype, x)
    terms = qw.warp_image_backward_reference(dout.abs(), x, y, shape,
                                             torch.float32)
    for dt in (torch.float32, torch.bfloat16):
        a = quad_transpose(dout, x, y, shape, dt).float()
        b = quad_transpose(dout, x, y, shape, dt).float()
        torch.cuda.synchronize()
        ulp = 2.0 ** -7 * a.abs() if dt == torch.bfloat16 else 0.0
        assert bool(((a - b).abs() <= ulp + 2 * 64 * 2.0 ** -24
                     * terms).all())


@pytest.mark.cuda
def test_quad_warp_graph_replay_equals_eager(cuda_device):
    """The forward and its gradient captured in a CUDA graph (the fp32
    buffer zeroed and rounded inside it: no host copy, no sync): a replay
    on new inputs gives the eager forward bit for bit and the gradient to
    the transpose's tolerance, and the capture's launches come out of the
    counts."""
    shape, (rows, cols) = (96, 128, 64), (120, 150)
    rng = np.random.RandomState(26)
    x, y = rotation_map(cuda_device, rows, cols, *shape[:2], 20.0, rng)
    img, dout = quad_inputs(cuda_device, rng, shape, torch.bfloat16, x)
    leaf = img.clone().requires_grad_(True)

    def step():
        out = qw.quad_warp(leaf, x, y)
        (g,) = torch.autograd.grad(out, leaf, dout)
        return out, g

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with cudalib.captured_launches() as seen:
        with torch.cuda.graph(graph):
            out_g, g_g = step()
    assert seen == {"quad_warp_fwd": 1, "quad_warp_bwd": 1}
    x2, y2 = rotation_map(cuda_device, rows, cols, *shape[:2], -15.0, rng)
    img2, dout2 = quad_inputs(cuda_device, rng, shape, torch.bfloat16, x)
    with torch.no_grad():
        for dst, src in ((leaf, img2), (x, x2), (y, y2), (dout, dout2)):
            dst.copy_(src)
    graph.replay()
    torch.cuda.synchronize()
    out_e, g_e = step()
    torch.cuda.synchronize()
    assert torch.equal(out_g.view(torch.int32), out_e.view(torch.int32))
    assert_backward_close(g_g, dout, x, y, shape, torch.bfloat16, "zero")
    assert_backward_close(g_e, dout, x, y, shape, torch.bfloat16, "zero")


@pytest.mark.cuda
def test_quad_warp_refuses_and_card_stays_usable(cuda_device):
    img = torch.zeros(6, 7, 8, device=cuda_device)
    x = torch.zeros(3, 4, device=cuda_device)
    with pytest.raises(ValueError, match="one device"):
        qw.quad_warp(img, x.cpu(), x)
    with pytest.raises(TypeError):
        qw.quad_warp(img.half(), x, x)
    with pytest.raises(ValueError, match="no gradient"):
        qw.quad_warp(img, x.clone().requires_grad_(True), x)
    with pytest.raises(ValueError, match="counter"):
        qw.quad_warp(img, x, x, counter=torch.zeros(2, device=cuda_device))
    out = qw.quad_warp(img + 1.0, x + 2.5, x + 3.25)
    torch.cuda.synchronize()
    assert float(out.min()) == float(out.max()) == 1.0


def general_scene_torch(dev, h=24, w=40, n=3):
    """Cameras on an arc looking at the origin (moderate rotations): a
    scene the planner rectifies."""
    def lookat(eye, target=(0.1, -0.1, 0.0), up=(0, 1, 0)):
        eye = np.asarray(eye, np.float64)
        fwd = np.asarray(target, np.float64) - eye
        fwd /= np.linalg.norm(fwd)
        right = np.cross(fwd, np.asarray(up, np.float64))
        right /= np.linalg.norm(right)
        P = np.eye(4)
        P[:3, :3] = np.stack([right, np.cross(fwd, right), fwd], 0)
        P[:3, 3] = -P[:3, :3] @ eye
        return P

    K = np.array([[40.0, 0, w / 2], [0, 40.0, h / 2], [0, 0, 1]])
    eyes = [(0.0, 0.0, -10.0), (2.0, 0.6, -9.5), (-1.8, -0.8, -9.8)][:n]
    poses = np.stack([lookat(e) for e in eyes])[None].astype(np.float32)
    intr = np.tile(K, (1, n, 1, 1)).astype(np.float32)
    return poses, intr, h, w


@pytest.mark.cuda
def test_one_pass_rectified_volume_runs_the_quad_kernels(cuda_device):
    """A one-pass plan's volume (stage 1: the origin warped too) and its
    gradient: per view the feature warps, the origin and the back-warp
    launch the quad forward, the three with a gradient its transpose, and
    aten's ``indexing_backward_kernel`` runs once, for the neighbours'
    gather ``f[0, jj]`` (the four per warp of the plain warps' gradients
    are gone)."""
    import dataclasses

    from cermvs_torch.ops import rectify
    from cermvs_torch.ops.corr_rectified import RectifiedVolume

    poses, intr, h, w = general_scene_torch(cuda_device)
    plan = rectify.plan_rectification(poses, intr, h, w, lambda_max=0.14)
    assert plan.ok, plan.reason
    plan = dataclasses.replace(plan, twopass=False)
    N = poses.shape[1]
    ii = torch.zeros(N - 1, dtype=torch.long, device=cuda_device)
    jj = torch.arange(1, N, device=cuda_device)
    rng = np.random.RandomState(27)
    fm = torch.from_numpy(rng.randn(1, N, h, w, 16).astype(np.float32)).to(
        cuda_device).requires_grad_(True)
    origin = torch.from_numpy((0.02 + 0.03 * rng.rand(1, 1, h, w)).astype(
        np.float32)).to(cuda_device)
    vol_fn = RectifiedVolume(plan)
    cudalib.reset_launches()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        ctx = vol_fn.prepare(fm, torch.from_numpy(poses).to(cuda_device),
                             torch.from_numpy(intr).to(cuda_device), ii, jj,
                             torch.bfloat16)
        vol = vol_fn.build(ctx, origin, 16, 0.002)
        vol.square().sum().backward()
        torch.cuda.synchronize()
    V = N - 1
    assert {k: cudalib.launches.get(k, 0) for k in qw.KERNELS} == {
        "quad_warp_fwd": 4 * V, "quad_warp_bwd": 3 * V}
    events = prof.key_averages()
    assert any("quad_warp_bwd_kernel" in e.key for e in events)
    assert sum(e.count for e in events
               if "indexing_backward_kernel" in e.key) <= 1
    assert bool(torch.isfinite(fm.grad).all()) and float(
        fm.grad.abs().max()) > 0


@pytest.mark.cuda
def test_kernel_rejects_mixed_devices(cuda_device):
    fr = torch.zeros(1, 2, 128, 8, device=cuda_device)
    fs = torch.zeros(1, 2, 200, 8, device=cuda_device)
    sigma = torch.ones(1, 2, 128)
    with pytest.raises(ValueError, match="one device"):
        eb.epiband(fr, fs, None, sigma, 4, 40)


@pytest.mark.cuda
def test_kernel_rejects_odd_channels(cuda_device):
    fr = torch.zeros(1, 2, 128, 7, device=cuda_device)
    fs = torch.zeros(1, 2, 200, 7, device=cuda_device)
    sigma = torch.ones(1, 2, 128, device=cuda_device)
    with pytest.raises(ValueError, match="even channel count"):
        eb.epiband(fr, fs, None, sigma, 4, 40)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_rejects_misaligned_view(cuda_device, dtype):
    """A contiguous view one element into its storage would fault on the
    kernel's vector loads: the wrapper raises, and the card stays usable."""
    fr = torch.zeros(1, 2, 128, 8, device=cuda_device, dtype=dtype)
    flat = torch.zeros(1 + 2 * 200 * 8, device=cuda_device, dtype=dtype)
    fs = flat[1:].view(1, 2, 200, 8)
    sigma = torch.ones(1, 2, 128, device=cuda_device)
    before = cudalib.launches.get("epiband_fwd", 0)
    with pytest.raises(ValueError, match="fs must start on a"):
        eb.epiband(fr, fs, None, sigma, 4, 40)
    with pytest.raises(ValueError, match="fs must start on a"):
        eb.epiband_backward(fr, fs, None, sigma,
                            torch.zeros(1, 2, 128, 4, device=cuda_device), 40)
    out = eb.epiband(fr, fs.contiguous().clone(), None, sigma, 4, 40)
    torch.cuda.synchronize()
    assert cudalib.launches["epiband_fwd"] == before + 1
    assert float(out.abs().max()) == 0.0


@pytest.mark.cuda
def test_rectified_kernel_route_matches_exact_on_lateral_scene(cuda_device):
    """Lateral baselines: rectification is lossless, so the rectified
    construction through the kernel equals the exact one (fp32, delta
    heads damped so the estimates stay inside the slabs)."""
    from cermvs_torch.models.raft import RAFT
    from cermvs_torch.pipeline.inference import InferenceRunner

    model = RAFT(test_mode=True, dtype=torch.float32, device=cuda_device,
                 cascade=((8, 64, 2), (-1, 320, 2)),
                 generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        for i in range(2):
            getattr(model.update_block, f"delta{i}")[2].weight.mul_(1e-3)
    H, W, n = 64, 192, 3
    K = np.array([[80.0, 0, W / 2], [0, 80.0, H / 2], [0, 0, 1]], np.float32)
    poses = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    for i, bx in enumerate([0.0, 1.2, -1.6]):
        poses[i, 0, 3] = -bx
    images = np.random.RandomState(0).rand(n, H, W, 3).astype(np.float32)
    images *= 255
    intr = np.tile(K, (n, 1, 1))
    rect = InferenceRunner(model=model, construction="rectified",
                           rect_lambda_max=0.1, device=cuda_device)
    exact = InferenceRunner(model=model, construction="exact",
                            device=cuda_device)
    cudalib.reset_launches()
    a = rect.submit(images, poses, intr, 1.0)[0].cpu().numpy()
    assert rect.last_path == "rectified"
    # per view: the epiband forward in each stage; two passes for each of
    # the two feature warps and of each stage's volume back-warp
    assert cudalib.launches["epiband_fwd"] == 2 * (n - 1)
    assert cudalib.launches["hat_rows_fwd"] == 8 * (n - 1)
    b = exact.submit(images, poses, intr, 1.0)[0].cpu().numpy()
    np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-7)


def lookup_inputs(rng, D, shape=(2, 1, 24, 36)):
    """A volume and clamped indices inside, at 0 and past D."""
    corr = rng.randn(*shape, D).astype(np.float32)
    x0 = np.maximum(rng.rand(*shape).astype(np.float32) * (D + 16) - 4, 0)
    x0.reshape(-1)[:3] = [0.0, D - 1.0, D + 40.0]
    return corr, x0


@pytest.mark.cuda
@pytest.mark.parametrize("D,radius,levels", [(64, 5, 3), (44, 5, 3),
                                             (16, 2, 2)])
def test_lookup_kernels_match_plain(cuda_device, D, radius, levels):
    """Forward, gradient and prefix-sum kernels against their plain versions:
    rtol / atol 1e-5 (fp32 pooling and lerps in another order), the
    prefix-sum kernel 1e-4 against its plain version (both prefix sums; the
    scan order differs) and 2e-3 against the pooled taps."""
    from cermvs_torch.ops import lookup as lk

    rng = np.random.RandomState(4)
    corr, x0 = lookup_inputs(rng, D)
    T = levels * (2 * radius + 1)
    corr = torch.from_numpy(corr).to(cuda_device).requires_grad_(True)
    x0 = torch.from_numpy(x0).to(cuda_device)
    g = torch.from_numpy(rng.randn(*x0.shape, T).astype(np.float32)).to(
        cuda_device)
    cudalib.reset_launches()
    out = lk.lookup_fused(corr, x0, radius, levels)
    (out * g).sum().backward()
    v2 = lk.lookup_fused_v2(corr.detach(), x0, radius, levels)
    torch.cuda.synchronize()
    assert {k: cudalib.launches.get(k, 0) for k in lk.KERNELS} == {
        "lookup_fused_fwd": 1, "lookup_fused_bwd": 1, "lookup_fused_v2": 1}
    ref = lk.lookup_fused_reference(corr.detach(), x0, radius, levels)
    torch.testing.assert_close(out.detach(), ref, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(
        corr.grad, lk.lookup_fused_backward_reference(g, x0, D, radius,
                                                      levels),
        rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(
        v2, lk.lookup_fused_v2_reference(corr.detach(), x0, radius, levels),
        rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(v2, ref, rtol=2e-3, atol=2e-3)


@pytest.mark.cuda
def test_lookup_kernel_takes_strided_volumes(cuda_device):
    """A permuted (non-contiguous) volume is copied once and gives the
    taps of its contiguous copy; mixed devices raise."""
    from cermvs_torch.ops import lookup as lk

    rng = np.random.RandomState(5)
    corr, x0 = lookup_inputs(rng, 44)
    base = torch.from_numpy(corr).to(cuda_device)
    strided = base.permute(0, 1, 4, 2, 3).contiguous().permute(0, 1, 3, 4, 2)
    assert not strided.is_contiguous()
    x0 = torch.from_numpy(x0).to(cuda_device)
    torch.testing.assert_close(lk.lookup_fused(strided, x0),
                               lk.lookup_fused(base, x0), rtol=0, atol=0)
    with pytest.raises(ValueError, match="one device"):
        lk.lookup_fused(base, x0.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("shape,D,radius,levels", [
    ((1, 1, 7, 9), 64, 5, 3),      # 63 pixels: one short tile
    ((2, 1, 13, 11), 64, 5, 3),    # 286 pixels: 4 whole tiles and a part
    ((1, 2, 9, 10), 44, 5, 3),
    ((2, 1, 15, 9), 33, 5, 1),     # rows of 132 bytes: the scalar copy
    ((1, 1, 20, 10), 16, 2, 2)])
def test_lookup_forward_writes_every_output(cuda_device, shape, D, radius,
                                            levels):
    """The tiled forward against its plain version (rtol / atol 1e-5) with
    M not a multiple of the tile, D = 44, and D = 33 (rows not 16-byte
    aligned); ``out`` starts as NaN and none is left."""
    from cermvs_torch.ops import lookup as lk

    rng = np.random.RandomState(15)
    corr, x0 = lookup_inputs(rng, D, shape)
    corr = torch.from_numpy(corr).to(cuda_device).reshape(-1, D)
    x0 = torch.from_numpy(x0).to(cuda_device).reshape(-1)
    geo = lk.lookup_launch_geometry(corr.shape[0], D, radius, levels)
    assert geo.vec == (1 if D % 4 else 4)
    T = levels * (2 * radius + 1)
    out = torch.full((corr.shape[0], T), float("nan"), device=cuda_device)
    got = lk._launch_forward(corr, x0, radius, levels, out=out)
    torch.cuda.synchronize()
    assert got.data_ptr() == out.data_ptr()
    assert not bool(out.isnan().any())
    torch.testing.assert_close(
        out, lk.lookup_fused_reference(corr, x0, radius, levels), rtol=1e-5,
        atol=1e-5)


@pytest.mark.cuda
def test_lookup_forward_takes_a_misaligned_volume(cuda_device):
    """A volume one float into its storage takes the scalar copy and gives
    the taps of an aligned copy, bit for bit."""
    from cermvs_torch.ops import lookup as lk

    rng = np.random.RandomState(16)
    corr, x0 = lookup_inputs(rng, 64)
    corr = torch.from_numpy(corr).to(cuda_device).reshape(-1, 64)
    flat = torch.zeros(corr.numel() + 1, device=cuda_device)
    flat[1:] = corr.reshape(-1)
    shifted = flat[1:].view(corr.shape)
    x0 = torch.from_numpy(x0).to(cuda_device).reshape(-1)
    assert lk.lookup_launch_geometry(
        corr.shape[0], 64, 5, 3, cudalib.pointer_alignment(shifted)).vec == 1
    a = lk._launch_forward(corr, x0, 5, 3)
    b = lk._launch_forward(shifted, x0, 5, 3)
    torch.cuda.synchronize()
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))


# sha256 prefixes of the lookup gradient and prefix-sum kernels' outputs on
# the inputs of ``lookup_digest_case``, from the kernels before the forward
# was tiled (NVIDIA H100 80GB HBM3, CUDA 12.8): they must not change
LOOKUP_DIGESTS = {
    (64, 5, 3): {"bwd": "6d5502e45ec63bc7", "v2": "f20c0d651423d60e"},
    (44, 5, 3): {"bwd": "f7ce011f6807e9b4", "v2": "59b5b31591177aa5"},
    (16, 2, 2): {"bwd": "b85e061c743111b1", "v2": "f62b080e7caa76ba"},
}


def lookup_digest_case(dev, D, radius, levels):
    rng = np.random.RandomState(21)
    shape = (2, 1, 24, 36)
    corr = torch.from_numpy(rng.randn(*shape, D).astype(np.float32)).to(dev)
    x0 = np.maximum(rng.rand(*shape).astype(np.float32) * (D + 16) - 4, 0)
    x0.reshape(-1)[:3] = [0.0, D - 1.0, D + 40.0]
    x0 = torch.from_numpy(x0).to(dev)
    T = levels * (2 * radius + 1)
    g = torch.from_numpy(rng.randn(*shape, T).astype(np.float32)).to(dev)
    return corr, x0, g


@pytest.mark.cuda
@pytest.mark.parametrize("D,radius,levels", list(LOOKUP_DIGESTS))
def test_lookup_gradient_and_prefix_sum_outputs_unchanged(cuda_device, D,
                                                          radius, levels):
    import hashlib

    from cermvs_torch.ops import lookup as lk

    corr, x0, g = lookup_digest_case(cuda_device, D, radius, levels)
    got = {"bwd": lk.lookup_fused_backward(g, x0, D, radius, levels),
           "v2": lk.lookup_fused_v2(corr, x0, radius, levels)}
    torch.cuda.synchronize()
    digests = {k: hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()[:16]
               for k, t in got.items()}
    assert digests == LOOKUP_DIGESTS[(D, radius, levels)]


# (D, radius, levels) of the tiled gradient and prefix-sum kernels' cases:
# rows of 16-128 cells (33: not a whole number of 16-byte vectors), at the
# main path's radius and levels and at fewer
LOOKUP_TILE_CASES = [(D, r, L) for D in (16, 33, 44, 64, 128)
                     for r, L in ((5, 3), (2, 2), (5, 1))]


def lookup_tile_inputs(dev, D, radius, levels, seed):
    """286 pixels (4 whole tiles of 64 and a part) with indices at 0, D - 1,
    D + 40, 3e7 and NaN besides the drawn ones, their volume and a tap
    gradient, flattened."""
    rng = np.random.RandomState(seed)
    corr, x0 = lookup_inputs(rng, D, (2, 1, 13, 11))
    x0.reshape(-1)[3:5] = [3e7, np.nan]
    T = levels * (2 * radius + 1)
    g = rng.randn(x0.size, T).astype(np.float32)
    return (torch.from_numpy(corr).to(dev).reshape(-1, D),
            torch.from_numpy(x0).to(dev).reshape(-1),
            torch.from_numpy(g).to(dev))


@pytest.mark.cuda
@pytest.mark.parametrize("D,radius,levels", LOOKUP_TILE_CASES)
def test_lookup_backward_writes_every_output(cuda_device, D, radius, levels):
    """The tiled gradient against its plain version (rtol / atol 1e-5: the
    adds in another order) at a ragged M, with far and NaN indices (no
    gradient); ``out`` starts as NaN and none is left."""
    from cermvs_torch.ops import lookup as lk

    _, x0, g = lookup_tile_inputs(cuda_device, D, radius, levels, 17)
    M = x0.numel()
    geo = lk.backward_launch_geometry(M, D, radius, levels)
    assert (geo.vec, geo.cells) == (4, 1 if D % 4 else 4)
    out = torch.full((M, D), float("nan"), device=cuda_device)
    got = lk._launch_backward(g, x0, D, radius, levels, out=out)
    torch.cuda.synchronize()
    assert got.data_ptr() == out.data_ptr()
    assert not bool(out.isnan().any())
    torch.testing.assert_close(
        out, lk.lookup_fused_backward_reference(g, x0, D, radius, levels),
        rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("D,radius,levels", LOOKUP_TILE_CASES)
def test_lookup_v2_writes_every_output(cuda_device, D, radius, levels):
    """The tiled prefix-sum kernel against its plain version (rtol / atol
    1e-4: both prefix sums, another scan order) and the pooled taps (2e-3)
    at a ragged M; a NaN index gives NaN taps in all three, and ``out``
    starts as NaN and holds none elsewhere."""
    from cermvs_torch.ops import lookup as lk

    corr, x0, _ = lookup_tile_inputs(cuda_device, D, radius, levels, 18)
    M, T = x0.numel(), levels * (2 * radius + 1)
    assert lk.lookup_launch_geometry(M, D, radius, levels).vec == (
        1 if D % 4 else 4)
    out = torch.full((M, T), float("nan"), device=cuda_device)
    got = lk._launch_forward(corr, x0, radius, levels, out=out, prefix=True)
    torch.cuda.synchronize()
    assert got.data_ptr() == out.data_ptr()
    assert torch.equal(out.isnan().any(-1), x0.isnan())
    torch.testing.assert_close(
        out, lk.lookup_fused_v2_reference(corr, x0, radius, levels),
        rtol=1e-4, atol=1e-4, equal_nan=True)
    torch.testing.assert_close(
        out, lk.lookup_fused_reference(corr, x0, radius, levels), rtol=2e-3,
        atol=2e-3, equal_nan=True)


def one_float_in(t):
    """``t``'s values at an address 4 bytes past a 16-byte boundary."""
    flat = torch.zeros(t.numel() + 1, dtype=t.dtype, device=t.device)
    flat[1:] = t.reshape(-1)
    return flat[1:].view(t.shape)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 44])
def test_lookup_backward_takes_misaligned_tensors(cuda_device, D):
    """Tap gradients one float into their storage take the 4-byte copy, an
    output one float in the one-cell threads, and both give the aligned
    launch's gradient bit for bit."""
    from cermvs_torch.ops import lookup as lk

    _, x0, g = lookup_tile_inputs(cuda_device, D, 5, 3, 19)
    M = x0.numel()
    shifted = one_float_in(g)
    out = one_float_in(torch.empty((M, D), device=cuda_device))
    geo = lk.backward_launch_geometry(M, D, 5, 3,
                                      cudalib.pointer_alignment(shifted),
                                      cudalib.pointer_alignment(out))
    assert (geo.vec, geo.cells) == (1, 1)
    a = lk._launch_backward(g, x0, D, 5, 3)
    b = lk._launch_backward(shifted, x0, D, 5, 3, out=out)
    torch.cuda.synchronize()
    assert b.data_ptr() == out.data_ptr()
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.cuda
def test_lookup_v2_takes_a_misaligned_volume(cuda_device):
    """A volume one float into its storage takes the scalar copy and gives
    the prefix-sum taps of an aligned copy, bit for bit."""
    from cermvs_torch.ops import lookup as lk

    corr, x0, _ = lookup_tile_inputs(cuda_device, 64, 5, 3, 20)
    shifted = one_float_in(corr)
    assert lk.lookup_launch_geometry(
        corr.shape[0], 64, 5, 3, cudalib.pointer_alignment(shifted)).vec == 1
    a = lk._launch_forward(corr, x0, 5, 3, prefix=True)
    b = lk._launch_forward(shifted, x0, 5, 3, prefix=True)
    torch.cuda.synchronize()
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))


# sha256 prefixes of the lookup forward's outputs on the inputs of
# ``lookup_digest_case``, from the tiled forward as it stood before the
# gradient and prefix-sum kernels shared its tile (NVIDIA H100 80GB HBM3,
# CUDA 12.8): they must not change
FORWARD_DIGESTS = {
    (64, 5, 3): "676ecf66222ade4b",
    (44, 5, 3): "ec5e8eddaad2b728",
    (16, 2, 2): "09d04b58857abc4c",
}


@pytest.mark.cuda
@pytest.mark.parametrize("D,radius,levels", list(FORWARD_DIGESTS))
def test_lookup_forward_outputs_unchanged(cuda_device, D, radius, levels):
    import hashlib

    from cermvs_torch.ops import lookup as lk

    corr, x0, _ = lookup_digest_case(cuda_device, D, radius, levels)
    out = lk.lookup_fused(corr, x0, radius, levels)
    torch.cuda.synchronize()
    digest = hashlib.sha256(out.cpu().numpy().tobytes()).hexdigest()[:16]
    assert digest == FORWARD_DIGESTS[(D, radius, levels)]


@pytest.mark.cuda
def test_lookup_launchers_refuse_a_layout_they_do_not_share(cuda_device):
    """The gradient and prefix-sum launchers refuse shared memory other
    than their layout's, a prefix-sum row past 128 cells and a 16-byte
    store into an unaligned output; the card stays usable."""
    from cermvs_torch.ops import lookup as lk

    corr, x0, g = lookup_tile_inputs(cuda_device, 64, 5, 3, 22)
    M = x0.numel()
    out = torch.empty((M, 64), device=cuda_device)
    taps = torch.empty((M, 33), device=cuda_device)
    stream = cudalib.stream_of(g)
    bwd = lk.backward_launch_geometry(M, 64, 5, 3)
    fwd = lk.lookup_launch_geometry(M, 64, 5, 3)
    shifted = one_float_in(out)
    for fn, args in [
            ("lookup_backward", (g, out, 64, bwd.pixels, 1, 4,
                                 bwd.smem_bytes + 16)),
            ("lookup_backward", (g, shifted, 64, bwd.pixels, 1, 4,
                                 bwd.smem_bytes)),
            ("lookup_v2_forward", (corr, taps, 64, fwd.pixels, 1,
                                   fwd.smem_bytes - 16)),
            ("lookup_v2_forward", (corr, taps, 129, fwd.pixels, 0,
                                   lk.forward_smem_bytes(fwd.pixels, 129, 5,
                                                         3)))]:
        src, dst, D, *rest = args
        with pytest.raises(RuntimeError, match="invalid argument"):
            lk.LIB.call(fn, src.data_ptr(), x0.data_ptr(), dst.data_ptr(), M,
                        D, 5, 3, *rest, stream)
    torch.testing.assert_close(
        lk.lookup_fused_backward(g, x0, 64),
        lk.lookup_fused_backward_reference(g, x0, 64), rtol=1e-5, atol=1e-5)


def pipeline_items(n, H=66, W=194):
    """``n`` loader items, each a reference and three neighbours with
    frames of their own: lateral neighbours, and every third item a
    forward-moving one (the mixed construction)."""
    K = np.array([[80.0, 0, W / 2], [0, 80.0, H / 2], [0, 0, 1]], np.float32)
    rng = np.random.RandomState(0)
    items = []
    for i in range(n):
        poses = np.tile(np.eye(4, dtype=np.float32), (4, 1, 1))
        poses[1, 0, 3] = -1.2
        if i % 3 == 1:
            poses[2, 2, 3] = -1.0
        else:
            poses[2, 0, 3] = 1.0
        poses[3, 0, 3] = 1.6
        images = rng.rand(4, H, W, 3).astype(np.float32) * 255
        items.append((images, poses, np.tile(K, (4, 1, 1)), [f"{i:08d}"],
                      1.0))
    return items


class PipelineLoader:
    class dataset:
        num_frames = 3

    def __init__(self, items):
        self.items = items

    def __iter__(self):
        return iter(self.items)


def pipeline_model(device):
    from cermvs_torch.models.raft import RAFT

    return RAFT(test_mode=True, dtype=torch.float32, device=device,
                cascade=((8, 64, 2), (-1, 320, 2)),
                generator=torch.Generator().manual_seed(0))


@pytest.mark.cuda
def test_pipeline_device_prefetch_writes_identical_pfms(cuda_device,
                                                        tmp_path):
    """inference() with the pinned side-stream upload and without it: the
    same routes and the same bytes in every PFM."""
    from cermvs_torch.pipeline.inference import inference

    model = pipeline_model(cuda_device)
    items = pipeline_items(6)
    runs = {}
    for prefetch in (True, False):
        out = tmp_path / str(prefetch)
        records = inference(PipelineLoader(items), model=model,
                            output_folder=out, device_prefetch=prefetch,
                            device=cuda_device)
        runs[prefetch] = ([(r[0], r[2]) for r in records],
                          {p.name: p.read_bytes()
                           for p in sorted((out / "depths").iterdir())})
    assert runs[True] == runs[False]
    assert [r[1] for r in runs[True][0]] == ["rectified", "mixed",
                                             "rectified"] * 2


@pytest.mark.cuda
def test_side_stream_uploads_keep_their_frames(cuda_device, tmp_path):
    """Many small items through the pinned side-stream upload: each depth
    map equals the runner's on the same frames uploaded from pageable
    memory on the compute stream, so no upload was read before its copy
    ended or overwritten while a forward read it. Pageable frames are
    refused."""
    from cermvs_torch.data.augment import pad_to_multiple
    from cermvs_torch.io.pfm import read_pfm
    from cermvs_torch.pipeline.inference import (InferenceRunner, inference,
                                                 to_bf16)

    model = pipeline_model(cuda_device)
    items = pipeline_items(16, H=34, W=98)
    inference(PipelineLoader(items), model=model, output_folder=tmp_path,
              construction="exact", device=cuda_device)
    runner = InferenceRunner(model=model, construction="exact",
                             device=cuda_device)
    assert runner.upload_stream != torch.cuda.current_stream()
    for images, poses, intr, names, scale in items:
        images, intr = pad_to_multiple(images, intr, 4)
        np.testing.assert_array_equal(
            read_pfm(tmp_path / "depths" / f"{names[0]}_scale1_nf3.pfm"),
            runner(images, poses, intr, scale))
    with pytest.raises(ValueError, match="pinned"):
        runner.upload(to_bf16(items[0][0]))
    up = runner.upload(to_bf16(items[0][0], pin=True))
    assert up.frames.device.type == "cuda" and up.frames.is_contiguous()


def graph_scene(kind, seed=0, H=64, W=192):
    """A reference and three neighbours, moved sideways ("lateral": the
    rectified route) or one of them along the optical axis ("mixed")."""
    K = np.array([[80.0, 0, W / 2], [0, 80.0, H / 2], [0, 0, 1]], np.float32)
    poses = np.tile(np.eye(4, dtype=np.float32), (4, 1, 1))
    poses[1, 0, 3] = -1.2
    if kind == "mixed":
        poses[2, 2, 3] = -1.0
    else:
        poses[2, 0, 3] = 1.0
    poses[3, 0, 3] = 1.6
    images = np.random.RandomState(seed).rand(4, H, W, 3).astype(np.float32)
    return images * 255, poses, np.tile(K, (4, 1, 1))


def eager(runner, images, poses, intr):
    """The runner's forward without its graphs, routed as submit routes."""
    r = runner.route(images[None], poses[None], intr[None], [1.0])
    with torch.no_grad():
        return runner.model(*r[:4], volume_fn=r.volume_fn)


GRAPH_ROUTES = [("rectified", "lateral", "auto"), ("mixed", "mixed", "auto"),
                ("exact", "lateral", "exact")]


@pytest.mark.cuda
@pytest.mark.parametrize("route,kind,construction", GRAPH_ROUTES)
def test_graph_replay_equals_eager(cuda_device, route, kind, construction):
    """Each route's first dispatch captures and returns the eager result;
    later dispatches replay, on new frames too, bit for bit the eager
    forward's disparities."""
    from cermvs_torch.pipeline.inference import InferenceRunner

    runner = InferenceRunner(model=pipeline_model(cuda_device),
                             construction=construction, rect_lambda_max=0.1,
                             device=cuda_device)
    for seed, compiled in ((0, True), (0, False), (1, False)):
        images, poses, intr = graph_scene(kind, seed)
        got = runner.submit(images, poses, intr, 1.0)
        assert runner.last_dispatch_compiled == compiled
        assert runner.last_path == route
        assert torch.equal(got, eager(runner, images, poses, intr))
    assert len(runner._cache) == 1


@pytest.mark.cuda
def test_capture_after_a_dropped_runner(cuda_device):
    """A runner whose graphs only the garbage collector frees (a reference
    cycle), dropped; then another runner captures a new key with the
    collector set to run at every allocation. A graph freed during a
    capture would end it: the capture collects first."""
    import gc

    from cermvs_torch.pipeline.inference import InferenceRunner

    model = pipeline_model(cuda_device)
    dropped = InferenceRunner(model=model, rect_lambda_max=0.1,
                              device=cuda_device)
    dropped.submit(*graph_scene("lateral"), 1.0)
    assert dropped.last_dispatch_compiled and len(dropped._cache) == 1
    dropped.cycle = dropped
    del dropped
    runner = InferenceRunner(model=model, rect_lambda_max=0.1,
                             device=cuda_device)
    threshold = gc.get_threshold()
    gc.set_threshold(1)
    try:
        images, poses, intr = graph_scene("mixed")
        runner.submit(images, poses, intr, 1.0)
        assert runner.last_dispatch_compiled and runner.last_path == "mixed"
    finally:
        gc.set_threshold(*threshold)
    got = runner.submit(images, poses, intr, 1.0)
    assert not runner.last_dispatch_compiled
    assert torch.equal(got, eager(runner, images, poses, intr))


@pytest.mark.cuda
def test_two_keys_replay_alternately(cuda_device):
    """Two keys of one shape share the static inputs and the memory pool:
    replayed in turn after both captures, each gives its eager result."""
    from cermvs_torch.pipeline.inference import InferenceRunner

    runner = InferenceRunner(model=pipeline_model(cuda_device),
                             rect_lambda_max=0.1, device=cuda_device)
    for kind in ("lateral", "mixed"):
        runner.submit(*graph_scene(kind), 1.0)
        assert runner.last_dispatch_compiled
    for seed in (1, 2, 3):
        for kind, route in (("lateral", "rectified"), ("mixed", "mixed")):
            images, poses, intr = graph_scene(kind, seed)
            got = runner.submit(images, poses, intr, 1.0)
            assert not runner.last_dispatch_compiled
            assert runner.last_path == route
            assert torch.equal(got, eager(runner, images, poses, intr))


@pytest.mark.cuda
def test_replays_dispatched_before_a_fetch_keep_their_output(cuda_device):
    """Two views of one key dispatched before either is read, as
    inference() dispatches a batch before it fetches the one before: each
    keeps its own disparities (a replay returns a clone of the graph's
    static output)."""
    from cermvs_torch.pipeline.inference import InferenceRunner

    runner = InferenceRunner(model=pipeline_model(cuda_device),
                             rect_lambda_max=0.1, device=cuda_device)
    runner.submit(*graph_scene("lateral"), 1.0)
    scenes = [graph_scene("lateral", seed) for seed in (1, 2)]
    outs = [runner.submit(*scene, 1.0) for scene in scenes]
    fetched = [runner.fetch(d) for d in outs]
    for scene, f in zip(scenes, fetched):
        np.testing.assert_array_equal(
            runner.finalize_batch(f),
            runner.finalize_batch(eager(runner, *scene)))
    assert not torch.equal(outs[0], outs[1])


@pytest.mark.cuda
def test_weights_loaded_in_place_reach_the_graph(cuda_device):
    """A graph reads the weights at their addresses: after
    load_state_dict of other weights its replay is the new weights'
    eager forward."""
    from cermvs_torch.models.raft import RAFT
    from cermvs_torch.pipeline.inference import InferenceRunner

    runner = InferenceRunner(model=pipeline_model(cuda_device),
                             rect_lambda_max=0.1, device=cuda_device)
    images, poses, intr = graph_scene("lateral")
    before = runner.submit(images, poses, intr, 1.0)
    other = RAFT(test_mode=True, dtype=torch.float32, device="cpu",
                 cascade=((8, 64, 2), (-1, 320, 2)),
                 generator=torch.Generator().manual_seed(1))
    runner.model.load_state_dict(other.state_dict())
    after = runner.submit(images, poses, intr, 1.0)
    assert not runner.last_dispatch_compiled
    assert not torch.equal(after, before)
    assert torch.equal(after, eager(runner, images, poses, intr))


@pytest.mark.cuda
@pytest.mark.parametrize("route,kind,construction", GRAPH_ROUTES[:2])
def test_replays_count_the_launches_of_the_eager_forward(
        cuda_device, route, kind, construction):
    """The capture's launch counts are taken out and added back per
    replay: a replay counts what an eager forward counts."""
    from cermvs_torch.pipeline.inference import InferenceRunner

    runner = InferenceRunner(model=pipeline_model(cuda_device),
                             construction=construction, rect_lambda_max=0.1,
                             device=cuda_device)
    images, poses, intr = graph_scene(kind)
    cudalib.reset_launches()
    runner.submit(images, poses, intr, 1.0)  # eager, then the capture
    first = dict(cudalib.launches)
    cudalib.reset_launches()
    runner.submit(images, poses, intr, 1.0)
    replay = dict(cudalib.launches)
    cudalib.reset_launches()
    eager(runner, images, poses, intr)
    assert runner.last_path == route
    assert replay == first == dict(cudalib.launches)
    assert replay["epiband_fwd"] > 0 and replay["hat_rows_fwd"] > 0


@pytest.fixture
def deterministic():
    """Deterministic algorithms: at these small shapes cuDNN's default
    weight gradients, and the exact construction's gather gradients, sum
    in a varying order, so two eager steps differ."""
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    yield
    torch.use_deterministic_algorithms(False)
    torch.backends.cudnn.deterministic = False


def train_model(device, seed=0, **kw):
    from cermvs_torch.models.raft import RAFT

    return RAFT(dtype=torch.float32, device=device,
                cascade=((8, 64, 2), (-1, 320, 2)),
                generator=torch.Generator().manual_seed(seed), **kw)


def train_batch(seed, forward=False):
    """A host batch of two samples of graph_scene's rig with depths: the
    lateral rig (the planner keeps it, a rectified key) or one neighbour
    moved along the optical axis (the planner rejects it: exact)."""
    scenes = [graph_scene("mixed" if forward else "lateral", seed + b)
              for b in range(2)]
    images, poses, intr = (np.stack(a) for a in zip(*scenes))
    depths = np.random.RandomState(seed).rand(*images.shape[:4]) * 20 + 20
    return {"images": images, "depths": depths.astype(np.float32),
            "poses": poses, "intrinsics": intr}


def train_key(batch):
    """``train()``'s construction key of a host batch."""
    from cermvs_torch.ops.rectify import PlanCache
    from cermvs_torch.training.train import plan_batch

    plan = plan_batch(batch, 4)
    return PlanCache().key_for(plan) if plan.ok else None


def train_state(device, num_steps=10, **kw):
    from cermvs_torch.training.step import StepRunner, init_state

    state = init_state(train_model(device, **kw), num_steps)
    state.runner = StepRunner(state)
    return state


def snapshot(state):
    from cermvs_torch.training.checkpoint import state_dicts

    return copy.deepcopy(state_dicts(state))


def restore(state, snap):
    from cermvs_torch.training.checkpoint import load_state

    load_state(state, copy.deepcopy(snap))


def flat_state(state):
    """The weights, and AdamW's moments and step counts, each in one
    vector."""
    params = list(state.model.parameters())
    return {"weights": torch.cat([p.detach().reshape(-1) for p in params]),
            "optimizer": torch.cat([t.reshape(-1).float() for p in params
                                    for t in state.optimizer.state[p]
                                    .values()])}


def eager_run(state, snap, steps):
    """From ``snap``: eager train steps over ``steps`` ((device batch, gw,
    key) each; gw as a device tensor, as the runner gives it). Returns the
    metrics of each step and the flat state after, by name."""
    from cermvs_torch.ops.corr_rectified import RectifiedVolume
    from cermvs_torch.training.step import train_step

    restore(state, snap)
    dev = state.runner.device
    metrics = [train_step(state, b, torch.tensor(gw, device=dev),
                          volume_fn=None if key is None
                          else RectifiedVolume(key))
               for b, gw, key in steps]
    return run_values(metrics, state)


def run_values(metrics, state):
    """A run's loss and grad_norm by step and its flat state. The depth
    metrics are left out: the <3/<10/<25 fractions count pixels on either
    side of a threshold and the mean depth error sums 1 / disparity, so a
    last-bit difference in one disparity (the exact construction's gathers
    sum their gradients in a varying order) moves them by a whole pixel or
    by a large inverse."""
    out = {f"{k}_{i}": torch.tensor(m[k]) for i, m in enumerate(metrics)
           for k in ("loss", "grad_norm")}
    out.update(flat_state(state))
    return out


def max_diff(a, b):
    return {k: float((a[k].cpu() - b[k].cpu()).abs().max()) for k in a}


EAGER_RUNS = 3


def replay_against_eager(state, snap, steps, replayed):
    """The replayed run (its metrics; the state after) against EAGER_RUNS
    eager runs of the same steps from ``snap``, by quantity: the replay's
    distance to the nearest eager run, and the eager runs' spread (their
    largest pairwise distance)."""
    replay = run_values(replayed, state)
    eager = [eager_run(state, snap, steps) for _ in range(EAGER_RUNS)]
    to_each = [max_diff(replay, e) for e in eager]
    pairs = [max_diff(a, b) for i, a in enumerate(eager)
             for b in eager[i + 1:]]
    return ({k: min(d[k] for d in to_each) for k in replay},
            {k: max(d[k] for d in pairs) for k in replay})


def assert_within_spread(err, spread):
    """Replay against eager to the eager runs' spread: bit for bit where
    the eager runs agree bit for bit, else within twice their spread
    (one more sample of the same nondeterministic sums)."""
    bad = {k: (err[k], spread[k]) for k in err if err[k] > 2 * spread[k]}
    assert not bad, bad


@pytest.mark.cuda
@pytest.mark.parametrize("forward", [False, True], ids=["rectified", "exact"])
def test_train_replay_equals_eager(cuda_device, deterministic,
                                   forward):
    """A key's first dispatch steps eagerly and captures; three replays on
    new batches, with the curriculum weight and the learning rate moving,
    leave the weights, AdamW's moments and the metrics of eager steps, to
    the eager-vs-eager spread (bit for bit where that is 0)."""
    from cermvs_torch.training.step import batch_to_device

    state = train_state(cuda_device)
    batches = [train_batch(s, forward) for s in (0, 2, 4, 6)]
    key = train_key(batches[0])
    assert (key is None) == forward
    steps = [(batch_to_device(b, cuda_device), gw, key)
             for b, gw in zip(batches, (0.0, 0.4, 0.7, 1.0))]
    snap = snapshot(state)
    replayed = []
    for i, (b, gw, k) in enumerate(steps):
        replayed.append(state.runner(b, gw, k))
        assert state.runner.last_dispatch_compiled == (i == 0)
    assert len(state.runner._steps) == 1
    assert_within_spread(*replay_against_eager(state, snap, steps,
                                               replayed))


@pytest.mark.cuda
def test_train_keys_alternate_on_one_pool(cuda_device, deterministic):
    """A rectified plan and the exact construction, captured one after the
    other into the runner's one pool, then replayed in turn: each replay
    gives the eager step's values (to the eager-vs-eager spread)."""
    from cermvs_torch.training.step import batch_to_device

    state = train_state(cuda_device)
    steps = []
    for s in range(3):
        for forward in (False, True):
            b = train_batch(2 * s, forward)
            steps.append((batch_to_device(b, cuda_device),
                          0.25 * len(steps) / 2, train_key(b)))
    assert steps[0][2] is not None and steps[1][2] is None
    snap = snapshot(state)
    replayed = []
    for i, (b, gw, k) in enumerate(steps):
        replayed.append(state.runner(b, gw, k))
        assert state.runner.last_dispatch_compiled == (i < 2)
    assert len(state.runner._steps) == 2
    assert_within_spread(*replay_against_eager(state, snap, steps,
                                               replayed))


@pytest.mark.cuda
def test_schedule_and_curriculum_weight_reach_a_replay(
        cuda_device, deterministic):
    """After the capture (at gw 0 and the first step's learning rate) a
    replay at gw 1 and a learning rate 50 steps on equals the eager step at
    those values, and differs from the eager step at the captured ones."""
    from cermvs_torch.ops.corr_rectified import RectifiedVolume
    from cermvs_torch.training.step import batch_to_device, train_step

    state = train_state(cuda_device)
    b = train_batch(0)
    key = train_key(b)
    batch = batch_to_device(b, cuda_device)
    state.runner(batch, 0.0, key)  # eager, then the capture
    lr0 = float(state.optimizer.param_groups[0]["lr"])
    for _ in range(49):
        state.scheduler.step()
    lr = float(state.optimizer.param_groups[0]["lr"])
    assert lr == pytest.approx(state.schedule(50), rel=1e-6)
    assert abs(lr - lr0) > 0.3 * lr0
    snap = snapshot(state)
    replayed = [state.runner(batch, 1.0, key)]
    assert not state.runner.last_dispatch_compiled
    err, spread = replay_against_eager(state, snap, [(batch, 1.0, key)],
                                       replayed)
    assert_within_spread(err, spread)
    at = eager_run(state, snap, [(batch, 1.0, key)])["weights"]
    gw0 = eager_run(state, snap, [(batch, 0.0, key)])["weights"]
    restore(state, snap)
    state.optimizer.param_groups[0]["lr"].fill_(lr0)
    train_step(state, batch, torch.tensor(1.0, device=cuda_device),
               volume_fn=RectifiedVolume(key))
    for other in (gw0, flat_state(state)["weights"]):
        moved = float((other - at).abs().max())
        assert moved > 100 * max(spread["weights"], 1e-9), moved


@pytest.mark.cuda
def test_checkpoint_restored_into_a_state_with_graphs(
        cuda_device, deterministic, tmp_path):
    """A checkpoint saved from the run (its learning rate a device tensor)
    and one saved on the CPU (a float) restore in place into a state whose
    runner holds a graph: the next replay is the eager step from the
    checkpoint."""
    from cermvs_torch.training.checkpoint import CheckpointManager
    from cermvs_torch.training.step import (batch_to_device, init_state,
                                            train_step)

    state = train_state(cuda_device)
    b = train_batch(0)
    key = train_key(b)
    batch = batch_to_device(b, cuda_device)
    mgr = CheckpointManager(tmp_path / "gpu", save_interval=1)
    for gw in (0.0, 0.5):
        state.runner(batch, gw, key)
        state.step += 1
    assert mgr.maybe_save(state)
    cpu = init_state(train_model("cpu", seed=3), 10)
    train_step(cpu, batch_to_device(b, "cpu"), 0.3)
    cpu_mgr = CheckpointManager(tmp_path / "cpu", save_interval=1)
    assert cpu_mgr.maybe_save(cpu)
    for m in (mgr, cpu_mgr):
        state.runner(batch, 0.9, key)  # the graph's state moves on
        m.restore(state)
        snap = snapshot(state)
        replayed = [state.runner(batch, 0.7, key)]
        assert not state.runner.last_dispatch_compiled
        assert_within_spread(*replay_against_eager(
            state, snap, [(batch, 0.7, key)], replayed))


@pytest.mark.cuda
def test_train_replays_count_the_launches_of_the_eager_step(cuda_device):
    """The capture's launch counts come out and go back per replay: a
    replayed step counts what an eager step counts."""
    from cermvs_torch.ops.corr_rectified import RectifiedVolume
    from cermvs_torch.training.step import batch_to_device, train_step

    state = train_state(cuda_device)
    b = train_batch(0)
    key = train_key(b)
    batch = batch_to_device(b, cuda_device)
    counts = []
    for run in ("first", "replay", "eager"):
        cudalib.reset_launches()
        if run == "eager":
            train_step(state, batch, 0.5, volume_fn=None if key is None
                       else RectifiedVolume(key))
        else:
            state.runner(batch, 0.5, key)
        counts.append({k: v for k, v in cudalib.launches.items() if v})
    assert counts[0] == counts[1] == counts[2]
    # a two-pass step: the hat warps, and the quad forward for the origin
    assert set(counts[0]) == {"epiband_fwd", "epiband_bwd_dfr",
                              "epiband_bwd_dfs", "hat_rows_fwd",
                              "hat_rows_bwd", "quad_warp_fwd"}


@pytest.fixture
def tracing():
    """Tracing on (the marks' library built and loaded), off and cleared
    after the test."""
    from cermvs_torch.utils import profiling

    profiling.reset()
    profiling.enable()
    yield profiling
    profiling.enable(False)
    profiling.reset()


def replay_trace(directory, fn):
    """``fn()`` under ``profiling.trace``, synchronised; its trace file."""
    from cermvs_torch.utils import profiling

    with profiling.trace(directory):
        out = fn()
        torch.cuda.synchronize()
    (path,) = Path(directory).glob("*.pt.trace.json")
    return out, path


@pytest.mark.cuda
def test_forward_replays_run_their_marks(cuda_device, tracing, tmp_path):
    """A forward captured with tracing on: its replay runs the begin and
    end mark of every model span, gives a replay captured with tracing off
    its disparities bit for bit and counts the same launches; captured
    with tracing off, it runs no mark."""
    from cermvs_torch.pipeline.inference import InferenceRunner

    images, poses, intr = graph_scene("lateral")
    got = {}
    for on in (True, False):
        tracing.enable(on)
        runner = InferenceRunner(model=pipeline_model(cuda_device),
                                 construction="auto", rect_lambda_max=0.1,
                                 device=cuda_device)
        runner.submit(images, poses, intr, 1.0)  # eager, then the capture
        cudalib.reset_launches()
        out, path = replay_trace(tmp_path / str(on), lambda: runner.submit(
            images, poses, intr, 1.0))
        assert not runner.last_dispatch_compiled
        got[on] = (out, {k: v for k, v in cudalib.launches.items() if v},
                   tracing.marked_spans(path))
    assert torch.equal(got[True][0], got[False][0])
    assert got[True][1] == got[False][1] and got[True][1]["epiband_fwd"]
    assert got[False][2] == []
    spans = got[True][2]
    assert sorted(n for n, _, _ in spans) == sorted(
        ["raft.encoders", "raft.volume_prepare", "raft.volume_stage0",
         "raft.volume_stage1", "raft.iterations_stage0",
         "raft.iterations_stage1"])
    assert all(e > s for _, s, e in spans)
    assert [n for n, _, _ in spans][0] == "raft.encoders"


@pytest.mark.cuda
def test_train_replay_runs_the_step_marks(cuda_device, tracing, tmp_path):
    """A train step captured with tracing on: its replay runs the forward,
    backward and optimizer marks in that order, the model's inside the
    forward; the runner counts one capture, one eager and one replayed
    dispatch, and the replay's host spans lie in the trace."""
    from cermvs_torch.training.step import batch_to_device

    state = train_state(cuda_device)
    b = train_batch(0)
    key = train_key(b)
    batch = batch_to_device(b, cuda_device)
    state.runner(batch, 0.5, key)  # eager, then the capture
    _, path = replay_trace(tmp_path, lambda: state.runner(batch, 0.5, key))
    spans = {n: (s, e) for n, s, e in tracing.marked_spans(path)}
    fwd, bwd, opt = (spans[f"step.{p}"] for p in ("forward", "backward",
                                                  "optimizer"))
    assert fwd[1] <= bwd[0] and bwd[1] <= opt[0]
    assert fwd[0] <= spans["raft.encoders"][0] <= spans["raft.encoders"][1]
    assert spans["raft.iterations_stage1"][1] <= fwd[1]
    got = tracing.counters()
    assert (got["captures"], got["dispatch.eager"],
            got["dispatch.replay"]) == (1, 1, 1)
    assert got["capture_s"] > 0
    hosts = {n for n, *_ in tracing.host_spans(path)}
    assert {"step.copy_in", "step.replay", "step.metrics_wait",
            "step.schedule"} <= hosts


@pytest.mark.cuda
@pytest.mark.parametrize("lookup_impl", ["banded", "pallas"])
def test_remat_train_replay_equals_eager(cuda_device, deterministic,
                                         lookup_impl):
    """A step with ``RAFT.remat`` (the encoders and each GRU iteration
    recomputed in the backward pass, inside the capture) captured and
    replayed gives the eager steps' values (to their spread); with the
    fused lookup a step launches its taps twice per iteration (once
    recomputed) and their gradient once, replayed or eager."""
    from cermvs_torch.ops.corr_rectified import RectifiedVolume
    from cermvs_torch.training.step import batch_to_device, train_step

    state = train_state(cuda_device, remat=True, lookup_impl=lookup_impl)
    batches = [train_batch(s) for s in (0, 2, 4)]
    key = train_key(batches[0])
    assert key is not None
    steps = [(batch_to_device(b, cuda_device), gw, key)
             for b, gw in zip(batches, (0.0, 0.5, 1.0))]
    snap = snapshot(state)
    replayed, counts = [], []
    for b, gw, k in steps:
        cudalib.reset_launches()
        replayed.append(state.runner(b, gw, k))
        counts.append({n: v for n, v in cudalib.launches.items() if v})
    assert_within_spread(*replay_against_eager(state, snap, steps,
                                               replayed))
    cudalib.reset_launches()
    train_step(state, steps[0][0], 0.5, volume_fn=RectifiedVolume(key))
    counts.append({n: v for n, v in cudalib.launches.items() if v})
    iters = sum(s[2] for s in state.model.cascade)
    want = ({"lookup_fused_fwd": 2 * iters, "lookup_fused_bwd": iters}
            if lookup_impl == "pallas" else {})
    for c in counts:
        assert {n: c.get(n, 0) for n in want} == want, c
        assert c["epiband_fwd"] == c["epiband_bwd_dfs"] > 0


@pytest.mark.cuda
def test_remat_matches_no_remat_on_the_card(cuda_device, deterministic):
    """One eager step from the same weights and batch with ``RAFT.remat``
    on and off: the loss and every gradient equal, to the spread of two
    steps with it off (bit for bit where they agree)."""
    from cermvs_torch.ops.corr_rectified import RectifiedVolume
    from cermvs_torch.training.step import (batch_to_device, init_state,
                                            train_step)

    b = train_batch(0)
    key = train_key(b)
    batch = batch_to_device(b, cuda_device)
    runs = []
    for remat in (False, True, False):
        state = init_state(train_model(cuda_device, remat=remat), 10)
        m = train_step(state, batch, 0.5, volume_fn=RectifiedVolume(key))
        runs.append({"loss": torch.tensor(m["loss"]),
                     "grads": torch.cat([p.grad.reshape(-1) for p in
                                         state.model.parameters()])})
    err = {k: min(max_diff(runs[1], r)[k] for r in (runs[0], runs[2]))
           for k in runs[1]}
    assert_within_spread(err, max_diff(runs[0], runs[2]))


@pytest.mark.cuda
@pytest.mark.parametrize("enc_type", ["HR", "LR"])
def test_group_norm_encoder_matches_cpu(cuda_device, enc_type):
    """``BasicEncoder(norm_fn="group")`` on the card against the CPU, fp32
    with TF32 off, rtol 1e-4 / atol 1e-4."""
    from cermvs_torch.models.extractor import BasicEncoder, init_conv_

    enc = BasicEncoder(96, "group", enc_type, torch.float32)
    gen = torch.Generator().manual_seed(4)
    for m in enc.modules():
        if isinstance(m, torch.nn.Conv2d):
            init_conv_(m, gen)
    x = torch.from_numpy(np.random.RandomState(4).randn(2, 64, 96, 3)
                         .astype(np.float32))
    with torch.no_grad():
        want = enc(x)
        got = enc.to(cuda_device)(x.to(cuda_device)).cpu()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.fixture
def nccl_world_of_one(cuda_device, tmp_path):
    """An NCCL group of this process alone on the card, destroyed after."""
    import torch.distributed as dist

    from cermvs_torch.parallel.mesh import initialize_distributed

    initialize_distributed(cuda_device, store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
@pytest.mark.parametrize("kind,construction,route", [
    ("lateral", "rectified", "rectified"), ("mixed", "auto", "mixed"),
    ("lateral", "exact", "exact")], ids=["rectified", "mixed", "exact"])
def test_nccl_world_of_one_forward_is_unmeshed(nccl_world_of_one, kind,
                                               construction, route):
    """``InferenceRunner(mesh=make_mesh(1, 1))`` over NCCL: its first
    dispatch (eager, then the capture of a graph that holds the
    ``all_reduce``) and a replay equal the runner without a mesh bit for
    bit."""
    from cermvs_torch.parallel.mesh import make_mesh
    from cermvs_torch.pipeline.inference import (GraphedForward,
                                                 InferenceRunner)

    torch.backends.cudnn.allow_tf32 = False
    model = train_model("cuda")
    model.test_mode = True
    images, poses, intr = graph_scene(kind)
    kw = dict(construction=construction, rect_lambda_max=0.1, device="cuda")
    meshed = InferenceRunner(model=model, mesh=make_mesh(1, 1), **kw)
    plain = InferenceRunner(model=model, **kw)
    assert meshed.graphs and meshed.eager_reason is None
    first = meshed.submit(images, poses, intr, 1.0).clone()
    replay = meshed.submit(images, poses, intr, 1.0).clone()
    assert not meshed.last_dispatch_compiled
    assert [type(f) for f in meshed._cache.values()] == [GraphedForward]
    ref = plain.submit(images, poses, intr, 1.0)
    assert meshed.last_path == plain.last_path == route
    assert torch.equal(first, ref) and torch.equal(replay, ref)


@pytest.mark.cuda
def test_nccl_world_of_one_step_replays_as_eager(cuda_device,
                                                 nccl_world_of_one,
                                                 deterministic):
    """A data-parallel ``StepRunner`` over the NCCL world of one captures
    its step with the ``all_reduce`` calls inside; three replays leave the
    weights, AdamW's moments and the metrics of eager steps without a group
    (to the eager-vs-eager spread, bit for bit where that is 0)."""
    from cermvs_torch.training.step import StepRunner, batch_to_device

    state = train_state(cuda_device)
    state.runner = StepRunner(state, group=nccl_world_of_one)
    assert state.runner.graphs
    batches = [train_batch(s) for s in (0, 2, 4, 6)]
    key = train_key(batches[0])
    steps = [(batch_to_device(b, cuda_device), gw, key)
             for b, gw in zip(batches, (0.0, 0.4, 0.7, 1.0))]
    snap = snapshot(state)
    replayed = []
    for i, (b, gw, k) in enumerate(steps):
        replayed.append(state.runner(b, gw, k))
        assert state.runner.last_dispatch_compiled == (i == 0)
    assert_within_spread(*replay_against_eager(state, snap, steps,
                                               replayed))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["rectified", "mixed"])
def test_gloo_world_of_two_splits_the_launches(cuda_device, case):
    """Two gloo ranks sharing the card (``dryrun.World``): the view-sharded
    forward's epiband and hat launches, summed over the ranks, are the
    unsharded forward's, each rank steps eagerly, and the disparities
    agree at the dry run's CPU tolerances."""
    from cermvs_torch.parallel import dryrun

    # each frame encoded alone on both sides: the same conv shapes, so the
    # same cuDNN algorithms and features
    spec = dict(dryrun.SMALL["forward"])
    spec["model"] = dict(spec["model"], encoder_chunk=1)
    with dryrun.World(2, "cuda") as world:
        res = world.run(dryrun.forward_task, spec, case, "cuda")
    total = {}
    for r in res:
        for k, v in r["launches"].items():
            total[k] = total.get(k, 0) + v
    plain = {k: v for k, v in res[0]["plain_launches"].items() if v}
    assert plain["epiband_fwd"] > 0 and plain["hat_rows_fwd"] > 0
    assert {k: v for k, v in total.items() if v} == plain
    assert all(0 < r["launches"]["epiband_fwd"] < plain["epiband_fwd"]
               for r in res)
    assert not res[0]["graphs"] and "gloo" in res[0]["eager_reason"]
    tol = spec["disp_tol"]
    assert res[0]["disp_err"] <= tol["atol"] + tol["rtol"] * res[0][
        "disp_max"]

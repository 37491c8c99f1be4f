"""CUDA-only tests of the port: the epiband forward and backward kernels, the
hat-resample kernels and the fused lookup kernels (forward, gradient,
prefix-sum) against their plain PyTorch versions on the card,
wrong inputs raising and leaving the card usable, and the small end-to-end
agreement of the rectified (kernel) and exact constructions. They skip where
``torch.cuda.is_available()`` is false. This file imports nothing of JAX, so
it also runs on a machine without it:

    python -m pytest tests/test_torch_cuda.py --noconftest -q -p no:cacheprovider

Tolerances: kernel against plain on the same tensors rtol 1e-4 / atol 1e-3
with fp32 features and rtol 1e-3 / atol 1e-2 with bf16 features (both
accumulate in fp32; only the summation order differs). The backward kernels
are held at the same tolerances in fp32 and at 1e-2 in bf16 (their results
are returned in bf16, where another summation order may move a value by
one bf16 rounding); with bf16 features they round where the plain version
rounds, so under 1% of the elements may differ at all.
"""

import numpy as np
import pytest
import torch

from cermvs_torch.ops import cudalib
from cermvs_torch.ops import epiband as eb
from cermvs_torch.ops import hatwarp as hw

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

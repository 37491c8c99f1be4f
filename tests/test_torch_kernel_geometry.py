"""Launch geometry of the epiband forward, epiband dfr and dfs and hat-resample
forward kernels, on the CPU: the pure-Python helpers
(``epiband.launch_geometry``, ``epiband.dfr_launch_geometry``,
``epiband.dfs_launch_geometry``, ``hatwarp.launch_geometry``) whose values
the wrappers pass to the C launchers, at the shapes the main path gives the
kernels (inference, training and the demo at rescale 1 and 2; ws up to 2448;
C of 64, 44, 16 and 3; D of 64 and 44; fp32 and bf16). Each launch must stay
within a block's shared memory, launch a grid that covers every output and
read whole channel vectors. That the kernels write every output of such a
grid is held on the card (``test_torch_cuda.py``:
``*_writes_every_output``).
"""

import pytest
import torch

from cermvs_torch.ops import epiband as eb
from cermvs_torch.ops import hatwarp as hw

SMEM_LIMIT = 232448  # bytes of shared memory an H100 block can use

# (V, h_r, w_r, ws, D) of the epiband forward on the main path: the widest
# view of each plan (PERF.md's kernel table), and a ragged small case
EPIBAND_SHAPES = {
    "inference_stage0": (1, 512, 512, 1104, 64),
    "inference_stage1": (1, 512, 512, 1104, 44),
    "training_stage0": (1, 448, 512, 1040, 64),
    "training_stage1": (1, 448, 512, 1040, 44),
    "demo_rescale2_stage0": (1, 864, 1024, 2448, 64),
    "demo_rescale2_stage1": (1, 992, 1024, 2448, 44),
    "ragged": (2, 8, 100, 300, 64),
}
# (R, S, O) of the hat passes: feature warps and volume back-warps
HAT_SHAPES = {
    "training_feature_warp": (264, 360, 1040),
    "training_volume_back_warp": (448, 512, 360),
    "inference_ref_warp_pass1": (288, 400, 512),
    "inference_src_warp_pass2": (1104, 288, 512),
    "demo_rescale2_src_warp_pass1": (600, 800, 2448),
    "demo_rescale2_src_warp_pass2": (2448, 600, 992),
    "demo_rescale2_back_warp_pass1": (992, 1024, 800),
}
DTYPES = [torch.float32, torch.bfloat16]


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("C", [64, 44, 16])
@pytest.mark.parametrize("shape", list(EPIBAND_SHAPES.values()),
                         ids=list(EPIBAND_SHAPES))
def test_epiband_geometry(shape, C, dtype):
    V, h_r, w_r, ws, D = shape
    geo = eb.launch_geometry(V, h_r, w_r, ws, C, D, dtype)
    assert geo.smem_bytes <= SMEM_LIMIT
    assert geo.grid[1:] == (h_r, V)
    assert geo.grid[0] * geo.tile >= w_r > (geo.grid[0] - 1) * geo.tile
    assert C % geo.vec == 0
    if dtype == torch.float32:
        assert (geo.tile, geo.smem_bytes) == (eb.FP32_PIXELS, 0)
        return
    assert geo.tile in (16, 32, 64) and geo.tile * D <= (
        eb.THREADS * eb.MAX_OUT)
    assert geo.chunk % 64 == 0 and ws <= 32 * eb.REACH_WORDS * geo.chunk
    assert geo.vec * 2 <= 16


@pytest.mark.parametrize("D", [8, 64, 100, 200, 256])
def test_epiband_tile_keeps_outputs_in_registers(D):
    geo = eb.launch_geometry(1, 4, 300, 700, 64, D, torch.bfloat16)
    assert geo.tile == {8: 64, 64: 64, 100: 32, 200: 16, 256: 16}[D]
    assert geo.grid == (-(-300 // geo.tile), 4, 1)


@pytest.mark.parametrize("C,align,vec", [(64, 16, 8), (64, 8, 4), (64, 4, 2),
                                         (44, 16, 4), (16, 16, 8), (2, 16, 2),
                                         (6, 16, 2)])
def test_epiband_copy_width_follows_channels_and_alignment(C, align, vec):
    geo = eb.launch_geometry(1, 4, 128, 300, C, 44, torch.bfloat16, align)
    assert geo.vec == vec


@pytest.mark.parametrize("kw", [dict(D=257), dict(ws=262145),
                                dict(h_r=65536)])
def test_epiband_geometry_rejects_what_the_kernel_does_not_take(kw):
    args = dict(V=1, h_r=8, w_r=128, ws=300, C=64, D=64)
    args.update(kw)
    with pytest.raises(ValueError):
        eb.launch_geometry(**args, dtype=torch.bfloat16)


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("C", [64, 44, 16])
@pytest.mark.parametrize("shape", list(EPIBAND_SHAPES.values()),
                         ids=list(EPIBAND_SHAPES))
def test_dfs_geometry(shape, C, dtype):
    """The dfs kernel's blocks fit a block's shared memory, and their
    windows (32 columns a warp) cover every column of the gradient once,
    with as few windows as a block's warps allow."""
    V, h_r, _, ws, D = shape
    geo = eb.dfs_launch_geometry(V, h_r, ws, C, D, dtype)
    assert geo.smem_bytes <= SMEM_LIMIT
    assert geo.window % 32 == 0 and geo.window <= 32 * eb.DFS_WARPS
    windows = -(-ws // geo.window)
    assert geo.grid == (windows, h_r, V)
    assert windows * geo.window >= ws > (windows - 1) * geo.window
    assert windows == -(-ws // (32 * eb.DFS_WARPS))


# ws -> (window, windows): the training plan's rows, the demo's at rescale 2,
# a row one window holds, and wider ones (a window holds 32 * DFS_WARPS =
# 256 columns at most)
DFS_WINDOWS = {
    "training": (1040, (224, 5)),
    "rescale2": (2448, (256, 10)),
    "narrow": (300, (160, 2)),
    "one_full_window": (256, (256, 1)),
    "two_windows": (257, (160, 2)),
    "wide": (4001, (256, 16)),
}


@pytest.mark.parametrize("ws,want", list(DFS_WINDOWS.values()),
                         ids=list(DFS_WINDOWS))
def test_dfs_window_choice(ws, want):
    geo = eb.dfs_launch_geometry(1, 448, ws, 64, 64, torch.bfloat16)
    assert (geo.window, geo.grid[0]) == want


def test_dfs_shared_memory_at_the_main_shapes():
    """At the training plan (bf16, D = 64 and 44) two blocks fit an SM's
    228 KB (1 KB of it reserved per block); fp32 features and the demo's
    rescale-2 rows (which no backward runs at) fit one block's limit, the
    two buffers of staged fr rows being twice as wide in fp32."""
    for D in (64, 44):
        geo = eb.dfs_launch_geometry(1, 448, 1040, 64, D, torch.bfloat16)
        assert geo.smem_bytes <= 113 * 1024
    for dtype in DTYPES:
        geo = eb.dfs_launch_geometry(1, 864, 2448, 64, 64, dtype)
        assert geo.smem_bytes <= SMEM_LIMIT
    bf = eb.dfs_launch_geometry(1, 448, 1040, 64, 64, torch.bfloat16)
    f32 = eb.dfs_launch_geometry(1, 448, 1040, 64, 64, torch.float32)
    assert f32.smem_bytes - bf.smem_bytes == 2 * eb.DFS_CHUNK * 64 * 2


@pytest.mark.parametrize("kw", [dict(h_r=65536), dict(V=65536),
                                dict(D=5000)])
def test_dfs_geometry_rejects_what_the_kernel_does_not_take(kw):
    args = dict(V=1, h_r=8, ws=300, C=64, D=64, dtype=torch.bfloat16)
    args.update(kw)
    with pytest.raises(ValueError):
        eb.dfs_launch_geometry(**args)


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("C", [64, 44, 16])
@pytest.mark.parametrize("shape", list(EPIBAND_SHAPES.values()),
                         ids=list(EPIBAND_SHAPES))
def test_dfr_geometry(shape, C, dtype):
    """The dfr kernel's blocks fit a block's shared memory, and their tiles
    (two pixels a warp at a time) cover every pixel of a row once."""
    V, h_r, w_r, ws, D = shape
    geo = eb.dfr_launch_geometry(V, h_r, w_r, ws, C, D, dtype)
    assert geo.smem_bytes <= SMEM_LIMIT
    assert geo.tile == eb.DFR_TILE and geo.tile % (2 * eb.DFR_WARPS) == 0
    assert geo.grid[1:] == (h_r, V)
    assert geo.grid[0] * geo.tile >= w_r > (geo.grid[0] - 1) * geo.tile
    assert geo.vec == 4 and C % geo.vec == 0


# (V, h_r, w_r, ws, D) -> (tiles of 32 pixels, shared-memory bytes): the
# training plan's widest view at stage 0 and 1, the inference plan's, and a
# ragged row
DFR_LAUNCHES = {
    "training_stage0": ((1, 448, 512, 1040, 64), (16, 24576)),
    "training_stage1": ((1, 448, 512, 1040, 44), (16, 16896)),
    "inference_stage0": ((1, 512, 512, 1104, 64), (16, 24576)),
    "ragged_d44": ((2, 8, 100, 300, 44), (4, 16896)),
}


@pytest.mark.parametrize("shape,want", list(DFR_LAUNCHES.values()),
                         ids=list(DFR_LAUNCHES))
def test_dfr_tile_and_bytes(shape, want):
    for dtype in DTYPES:
        geo = eb.dfr_launch_geometry(*shape[:4], 64, shape[4], dtype)
        # per warp: D tap records of 16 bytes, two lists of 2 D records of 8
        assert (geo.grid[0], geo.smem_bytes) == want
        assert geo.smem_bytes == eb.DFR_WARPS * 48 * shape[4]


@pytest.mark.parametrize("dtype,C,align,vec", [
    (torch.bfloat16, 64, 16, 4), (torch.bfloat16, 64, 8, 4),
    (torch.bfloat16, 64, 4, 2), (torch.bfloat16, 62, 16, 2),
    (torch.float32, 64, 16, 4), (torch.float32, 64, 8, 2),
    (torch.float32, 44, 16, 4), (torch.float32, 42, 16, 2)])
def test_dfr_channel_layout_follows_channels_and_alignment(dtype, C, align,
                                                          vec):
    """4-channel vectors where C % 4 == 0 and fs and dfr allow them (8 bytes
    of bf16, 16 of fp32), else the channel pairs."""
    geo = eb.dfr_launch_geometry(1, 448, 512, 1040, C, 64, dtype, align)
    assert geo.vec == vec


def test_dfr_largest_d_fits_a_block():
    largest = SMEM_LIMIT // (eb.DFR_WARPS * 48)
    geo = eb.dfr_launch_geometry(1, 8, 128, 300, 64, largest, torch.bfloat16)
    assert geo.smem_bytes <= SMEM_LIMIT


@pytest.mark.parametrize("kw", [dict(C=63), dict(C=7), dict(C=66),
                                dict(C=128), dict(h_r=65536), dict(V=65536),
                                dict(D=SMEM_LIMIT // 384 + 1),
                                dict(ws=2 ** 25 + 1)])
def test_dfr_geometry_rejects_what_the_kernel_does_not_take(kw):
    args = dict(V=1, h_r=8, w_r=128, ws=300, C=64, D=64,
                dtype=torch.bfloat16)
    args.update(kw)
    with pytest.raises(ValueError):
        eb.dfr_launch_geometry(**args)


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("C", [64, 44, 16, 3])
@pytest.mark.parametrize("shape", list(HAT_SHAPES.values()),
                         ids=list(HAT_SHAPES))
def test_hat_geometry(shape, C, dtype):
    R, S, O = shape
    geo = hw.launch_geometry(R, S, O, C, dtype)
    esize = 2 if dtype == torch.bfloat16 else 4
    groups, positions = geo.block
    assert C % geo.vec == 0 and geo.vec * esize <= 16
    # 16-byte loads wherever the channels allow them
    assert geo.vec * esize == 16 or C % (16 // esize) != 0
    assert groups * positions <= hw.THREADS
    assert geo.grid == (R, -(-O // positions))
    assert geo.grid[1] <= hw.MAX_GRID_Y
    # a position's threads span its channels' vectors, or loop over them
    assert groups == min(C // geo.vec, hw.THREADS)
    assert geo.grid[1] * positions >= O > (geo.grid[1] - 1) * positions


@pytest.mark.parametrize("dtype,align,vec", [
    (torch.bfloat16, 16, 8), (torch.bfloat16, 8, 4), (torch.bfloat16, 4, 2),
    (torch.bfloat16, 2, 1), (torch.float32, 16, 4), (torch.float32, 8, 2),
    (torch.float32, 4, 1)])
def test_hat_vector_follows_alignment(dtype, align, vec):
    assert hw.launch_geometry(8, 90, 150, 64, dtype, align).vec == vec


def test_hat_geometry_rejects_rows_past_32_bit_indexing():
    with pytest.raises(ValueError):
        hw.launch_geometry(2, 2 ** 26, 100, 64, torch.bfloat16)
    with pytest.raises(ValueError):
        hw.launch_geometry(2, 100, 2 ** 26, 64, torch.bfloat16)

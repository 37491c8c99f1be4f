"""Launch geometry of the epiband forward, epiband dfr and dfs, hat-resample
forward and transpose and fused lookup (forward, prefix-sum, gradient)
kernels, on the CPU: the pure-Python helpers (``epiband.launch_geometry``,
``epiband.dfr_launch_geometry``, ``epiband.dfs_launch_geometry``,
``hatwarp.launch_geometry``, ``hatwarp.backward_launch_geometry``,
``lookup.lookup_launch_geometry``, which the prefix-sum kernel shares,
``lookup.backward_launch_geometry``, ``quadwarp.launch_geometry``,
``quadwarp.backward_launch_geometry``) whose values
the wrappers pass to the C launchers, at the shapes the main path gives the
kernels (inference, training and the demo at rescale 1 and 2; ws up to 2448;
C of 64, 44, 16 and 3; D of 64 and 44; fp32 and bf16). Each launch must stay
within a block's shared memory, launch a grid that covers every output and
read whole channel vectors. That the kernels write every output of such a
grid is held on the card (``test_torch_cuda.py``:
``*_writes_every_output``). The lookup gradient's and prefix-sum kernel's
index arithmetic (integer taps from an integer floor or a sentinel; prefix
sums turned into pooled cells in place) is emulated in numpy here and held
against the plain versions.
"""

import numpy as np
import pytest
import torch

from cermvs_torch.ops import epiband as eb
from cermvs_torch.ops import hatwarp as hw
from cermvs_torch.ops import lookup as lk
from cermvs_torch.ops import quadwarp as qw

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
    esize = 2 if dtype == torch.bfloat16 else 4
    assert geo.vec * esize <= 16
    if dtype == torch.float32:
        words = -(-(-(-ws // eb.FP32_CHUNK)) // 32)
        layout = forward_layout(eb.FP32_TILE, C, D, eb.FP32_CHUNK, words, 4)
        assert (geo.tile, geo.hyps, geo.chunk) == (eb.FP32_TILE, D,
                                                    eb.FP32_CHUNK)
        assert geo.smem_bytes == layout["total"]
        # three blocks an SM (228 KB, 1 KB of it reserved per block)
        assert 3 * (geo.smem_bytes + 1024) <= 228 * 1024
        return
    assert geo.tile in (16, 32, 64) and geo.tile * D <= (
        eb.THREADS * eb.MAX_OUT)
    assert geo.chunk % 64 == 0 and ws <= 32 * eb.REACH_WORDS * geo.chunk
    assert geo.smem_bytes == forward_layout(geo.tile, C, D, eb.CHUNK,
                                            eb.REACH_WORDS, 2)["total"]


def forward_layout(tile, C, hyps, chunk, words, esize):
    """Offsets (bytes) of the forward's shared-memory layout, as ``Smem``
    in ``csrc/epiband.cu`` sets them: staged rows of lds elements, G rows of
    gs floats, output rows of os floats."""
    lds = (C + 15) // 16 * 16 + 8
    gs, os_ = chunk + 8, hyps | 1
    b = tile * lds * esize
    g = b + 2 * chunk * lds * esize
    prm = g + tile * max(gs, os_) * 4
    reach = prm + 2 * tile * 4
    return dict(lds=lds, gs=gs, os=os_, b=b, g=g, prm=prm, reach=reach,
                total=reach + words * 4)


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("C", [64, 44, 16, 2])
def test_epiband_layout_banks_and_alignment(C, dtype):
    """The staged rows' stride gives conflict-free fragment loads: bf16, an
    odd number of 16-byte units (ldmatrix's eight rows); fp32, 8 words past
    a multiple of 16 (a half-warp's float2 loads, rows g..g+3 at words 2t
    and 2t + 1). G rows are 8 words past a multiple of 32 (the float2
    stores of rows g..g+3). Every region starts on 16 bytes (uint4 zeroing,
    16-byte cp.async)."""
    esize = 2 if dtype == torch.bfloat16 else 4
    chunk = eb.CHUNK if esize == 2 else eb.FP32_CHUNK
    lay = forward_layout(64, C, 64, chunk, 1, esize)
    if esize == 2:
        assert lay["lds"] * 2 % 16 == 0 and lay["lds"] * 2 // 16 % 2 == 1
    else:
        assert lay["lds"] % 16 == 8
        halfwarp = {(g * lay["lds"] + 2 * t + j) % 32 for g in range(4)
                    for t in range(4) for j in range(2)}
        assert len(halfwarp) == 32
    assert lay["gs"] % 32 == 8
    assert all(lay[k] % 16 == 0 for k in ("b", "g", "prm", "reach"))


# D -> (hypotheses per block, groups) of the fp32 forward (tile 64): all D
# up to 64, else the fewest equal groups of at most 64
FP32_GROUPS = {8: (8, 1), 44: (44, 1), 64: (64, 1), 65: (33, 2),
               100: (50, 2), 128: (64, 2), 257: (52, 5), 1000: (63, 16)}


@pytest.mark.parametrize("D,want", list(FP32_GROUPS.items()),
                         ids=[str(d) for d in FP32_GROUPS])
def test_epiband_fp32_groups_cover_every_hypothesis(D, want):
    """Each block's threads keep hypotheses k0 + warp + 8 i (8 warps, 8
    slots, below its group's end): over the groups, every k in [0, D)
    once."""
    geo = eb.launch_geometry(1, 4, 300, 700, 64, D, torch.float32)
    groups = -(-D // geo.hyps)
    assert (geo.hyps, groups) == want
    assert geo.grid == (-(-300 // 64) * groups, 4, 1)
    assert geo.smem_bytes == forward_layout(64, 64, geo.hyps, 64, 1,
                                            4)["total"]
    seen = []
    for g in range(groups):
        k0, k_end = g * geo.hyps, min(D, (g + 1) * geo.hyps)
        seen += [k0 + w + 8 * i for i in range(8) for w in range(8)
                 if k0 + w + 8 * i < k_end]
    assert sorted(seen) == list(range(D))


@pytest.mark.parametrize("kw", [dict(D=257), dict(ws=262145),
                                dict(D=1000, ws=1_000_000)])
def test_epiband_fp32_takes_what_bf16_refuses(kw):
    """The bf16 caps (tile * D <= 4096, a 64-word bitmap) are not the fp32
    kernel's: it groups hypotheses and sizes its bitmap by ws."""
    args = dict(V=1, h_r=8, w_r=128, ws=300, C=64, D=64)
    args.update(kw)
    with pytest.raises(ValueError):
        eb.launch_geometry(**args, dtype=torch.bfloat16)
    geo = eb.launch_geometry(**args, dtype=torch.float32)
    words = -(-(-(-args["ws"] // 64)) // 32)
    assert geo.smem_bytes == forward_layout(64, 64, geo.hyps, 64, words,
                                            4)["total"] <= SMEM_LIMIT


@pytest.mark.parametrize("kw", [dict(h_r=65536), dict(V=65536),
                                dict(ws=2 ** 27)])
def test_epiband_fp32_geometry_refuses_its_edges(kw):
    """A grid past 65535 rows or views, and a row whose bitmap leaves no
    room in a block's shared memory."""
    args = dict(V=1, h_r=8, w_r=128, ws=300, C=64, D=64)
    args.update(kw)
    with pytest.raises(ValueError):
        eb.launch_geometry(**args, dtype=torch.float32)


@pytest.mark.parametrize("C,align,vec", [(64, 16, 4), (64, 8, 2),
                                         (44, 16, 4), (16, 16, 4), (6, 16, 2),
                                         (2, 16, 2)])
def test_epiband_fp32_copy_width_follows_channels_and_alignment(C, align,
                                                                vec):
    geo = eb.launch_geometry(1, 4, 128, 300, C, 44, torch.float32, align)
    assert geo.vec == vec


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


# (R, S, O, C) of the transposed hat passes on the training path (the
# feature warps' and volume back-warps' two passes) and at the demo's
# rescale-2 widths, which the forward reaches
HAT_BWD_SHAPES = {
    "training_feature_warp_pass1": (264, 360, 1040, 64),
    "training_feature_warp_pass2": (1040, 264, 448, 64),
    "training_volume_back_warp_pass1": (448, 512, 360, 64),
    "training_volume_back_warp_pass2": (360, 448, 264, 64),
    "training_stage1_back_warp_pass1": (448, 512, 360, 44),
    "inference_src_warp_pass2": (1104, 288, 512, 64),
    "image_warp": (264, 360, 1040, 3),
    "demo_rescale2_src_warp_pass1": (600, 800, 2448, 64),
    "demo_rescale2_src_warp_pass2": (2448, 600, 992, 64),
    "small_rows": (5, 20, 1000, 2),
}


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", list(HAT_BWD_SHAPES.values()),
                         ids=list(HAT_BWD_SHAPES))
def test_hat_backward_geometry(shape, dtype):
    R, S, O, C = shape
    geo = hw.backward_launch_geometry(R, S, O, C, dtype)
    threads = hw.THREADS // geo.rows
    assert geo.rows in (1, 2, 4, 8) and threads % 32 == 0
    assert C % geo.vec == 0 and geo.vec * 4 <= 16
    # 16-byte fp32 loads of dout wherever the channels allow them
    assert geo.vec == 4 or C % 4 != 0
    assert geo.groups == min(C // geo.vec, threads)
    assert geo.smem_bytes == geo.rows * hw.backward_row_bytes(S, O)
    assert geo.smem_bytes <= SMEM_LIMIT and geo.smem_bytes % 16 == 0
    row_blocks, splits = geo.grid
    assert row_blocks * geo.rows >= R > (row_blocks - 1) * geo.rows
    # column ranges of at least two passes of a block's columns each
    passes = -(-S // (threads // geo.groups))
    assert splits == 1 or 2 <= passes // splits
    # a row's records and bins: 16 bytes per output, 8 per bin
    assert hw.backward_row_bytes(S, O) >= 16 * O + 8 * (S + 1)


@pytest.mark.parametrize("shape,splits", [
    ((264, 360, 1040, 64), 2), ((448, 512, 360, 64), 1),
    ((1040, 264, 448, 64), 1), ((360, 448, 264, 64), 1), ((8, 600, 100, 64), 19),
    ((8, 30, 100, 64), 1)])
def test_hat_backward_splits_columns_where_rows_are_few(shape, splits):
    """Blocks share a row's columns where the rows alone give fewer than
    ``BWD_TARGET_BLOCKS`` blocks (the feature warp's 264 rows), as long as
    each range keeps two passes of columns."""
    assert hw.backward_launch_geometry(*shape, torch.bfloat16).grid[1] == \
        splits


@pytest.mark.parametrize("shape,rows", [
    ((264, 360, 1040, 64), 1), ((264, 360, 1040, 3), 1),
    ((5, 20, 1000, 2), 4), ((64, 20, 30, 2), 8), ((64, 40, 30, 4), 4)])
def test_hat_backward_rows_share_a_block_only_where_rows_are_small(shape,
                                                                   rows):
    assert hw.backward_launch_geometry(*shape, torch.bfloat16).rows == rows


@pytest.mark.parametrize("align,vec", [(16, 4), (8, 2), (4, 1)])
def test_hat_backward_vector_follows_alignment(align, vec):
    assert hw.backward_launch_geometry(8, 90, 150, 64, torch.bfloat16,
                                       align).vec == vec


@pytest.mark.parametrize("shape", [(0, 360, 1040, 64), (4, 0, 10, 64),
                                   (4, 360, 0, 64), (4, 360, 1040, 0)])
def test_hat_backward_geometry_takes_empty_shapes(shape):
    """The wrapper asks for a geometry before the launcher skips an empty
    launch: no division by an empty dimension."""
    geo = hw.backward_launch_geometry(*shape, torch.float32)
    assert geo.grid[0] >= 1 and geo.grid[1] >= 1 and geo.groups >= 1


def test_hat_backward_takes_rows_of_8192():
    geo = hw.backward_launch_geometry(4, 8192, 8192, 64, torch.bfloat16)
    assert geo.rows == 1 and geo.smem_bytes <= SMEM_LIMIT


@pytest.mark.parametrize("kw", [dict(O=14500), dict(S=30000),
                                dict(O=8192, S=14000), dict(S=2 ** 25, O=4),
                                dict(O=4000, C=2 ** 20)])
def test_hat_backward_geometry_refuses_rows_past_its_limits(kw):
    args = dict(R=4, S=360, O=1040, C=64)
    args.update(kw)
    with pytest.raises(ValueError, match="hat_rows_backward"):
        hw.backward_launch_geometry(args["R"], args["S"], args["O"],
                                    args["C"], torch.bfloat16)


# (M, D) of the fused lookup forward: the (B, V, h, w) pixels of the main
# path's volumes (chip_smoke.LOOKUP_SHAPES) and the tests' small ones
LOOKUP_FWD_SHAPES = {
    "inference_stage0": (288 * 400, 64),
    "inference_stage1": (288 * 400, 44),
    "demo_rescale1_stage0": (300 * 400, 64),
    "demo_rescale2_stage0": (600 * 800, 64),
    "demo_rescale2_stage1": (600 * 800, 44),
    "training_stage0": (2 * 264 * 360, 64),
    "training_stage1": (2 * 264 * 360, 44),
    "ragged": (286, 64),
    "odd_rows": (270, 33),
}


@pytest.mark.parametrize("radius,levels", [(5, 3), (2, 2), (5, 1)])
@pytest.mark.parametrize("shape", list(LOOKUP_FWD_SHAPES.values()),
                         ids=list(LOOKUP_FWD_SHAPES))
def test_lookup_forward_geometry(shape, radius, levels):
    M, D = shape
    geo = lk.lookup_launch_geometry(M, D, radius, levels)
    T, J = levels * (2 * radius + 1), 2 * radius + 2
    assert geo.pixels == lk.TILE_PIXELS  # every main-path row fits
    assert geo.grid * geo.pixels >= M > (geo.grid - 1) * geo.pixels
    assert geo.smem_bytes == lk.forward_smem_bytes(geo.pixels, D, radius,
                                                   levels)
    # tables, two buffers of rows and x0, and per (pixel, level) a record
    # and a band of J cells
    assert geo.smem_bytes >= 4 * T + 4 * geo.pixels * (
        2 * D + 2 + levels * (2 + J))
    assert geo.smem_bytes <= SMEM_LIMIT and geo.smem_bytes % 16 == 0
    # 16-byte row copies wherever a row is a whole number of them
    assert geo.vec == (4 if D % 4 == 0 else 1)


def test_lookup_forward_tile_shrinks_to_fit_wide_rows():
    geo = lk.lookup_launch_geometry(1000, 8192, 5, 3)
    assert 1 <= geo.pixels < lk.TILE_PIXELS
    assert geo.smem_bytes <= SMEM_LIMIT < lk.forward_smem_bytes(
        geo.pixels + 1, 8192, 5, 3)


@pytest.mark.parametrize("align,vec", [(16, 4), (8, 1), (4, 1)])
def test_lookup_forward_copy_follows_alignment(align, vec):
    assert lk.lookup_launch_geometry(1000, 64, 5, 3, align).vec == vec


def test_lookup_forward_refuses_a_row_that_does_not_fit():
    with pytest.raises(ValueError, match="lookup_forward"):
        lk.lookup_launch_geometry(10, 30000, 5, 3)
    lk.lookup_launch_geometry(10, 28000, 5, 3)  # one pixel still fits


@pytest.mark.parametrize("radius,levels", [(5, 3), (2, 2), (5, 1)])
def test_lookup_forward_geometry_holds_the_widest_prefix_rows(radius,
                                                              levels):
    """The prefix-sum kernel runs at the forward's geometry (it scans each
    staged row in place): its widest rows, 128 cells, at the full tile."""
    geo = lk.lookup_launch_geometry(288 * 400, lk.V2_MAX_D, radius, levels)
    assert (geo.pixels, geo.vec) == (lk.TILE_PIXELS, 4)
    assert geo.smem_bytes <= SMEM_LIMIT


@pytest.mark.parametrize("radius,levels", [(5, 3), (2, 2), (5, 1)])
@pytest.mark.parametrize("shape", list(LOOKUP_FWD_SHAPES.values()),
                         ids=list(LOOKUP_FWD_SHAPES))
def test_lookup_backward_geometry(shape, radius, levels):
    M, D = shape
    geo = lk.backward_launch_geometry(M, D, radius, levels)
    T = levels * (2 * radius + 1)
    assert geo.pixels == lk.TILE_PIXELS  # every main-path tile fits
    assert geo.grid * geo.pixels >= M > (geo.grid - 1) * geo.pixels
    assert geo.smem_bytes == lk.backward_smem_bytes(geo.pixels, radius,
                                                    levels)
    # two buffers of tap gradients and x0, a 16-byte record per (pixel,
    # level)
    assert geo.smem_bytes >= 4 * geo.pixels * (2 * T + 2 + 4 * levels)
    assert geo.smem_bytes <= SMEM_LIMIT and geo.smem_bytes % 16 == 0
    # 16-byte copies (a tile's span of P * T floats starts aligned), and 4
    # cells a thread with a 16-byte store wherever a row holds whole vectors
    assert geo.vec == 4 and geo.pixels * T % 4 == 0
    assert geo.cells == (4 if D % 4 == 0 else 1)


def test_lookup_backward_tile_shrinks_to_fit_wide_taps():
    geo = lk.backward_launch_geometry(1000, 64, 200, 3)  # T = 1203
    assert 1 <= geo.pixels < lk.TILE_PIXELS
    assert geo.smem_bytes <= SMEM_LIMIT < lk.backward_smem_bytes(
        geo.pixels + 1, 200, 3)
    # a span of P * T floats is no whole number of vectors: 4-byte copies
    assert geo.vec == (4 if geo.pixels * 1203 % 4 == 0 else 1)


@pytest.mark.parametrize("g_align,out_align,D,vec,cells", [
    (16, 16, 64, 4, 4), (8, 16, 64, 1, 4), (4, 16, 44, 1, 4),
    (16, 8, 64, 4, 1), (16, 4, 44, 4, 1), (16, 16, 33, 4, 1),
    (4, 4, 33, 1, 1)])
def test_lookup_backward_copy_and_store_follow_alignment(g_align, out_align,
                                                         D, vec, cells):
    geo = lk.backward_launch_geometry(1000, D, 5, 3, g_align, out_align)
    assert (geo.vec, geo.cells) == (vec, cells)


def test_lookup_backward_refuses_taps_that_do_not_fit():
    with pytest.raises(ValueError, match="lookup_backward"):
        lk.backward_launch_geometry(10, 64, 5000, 3)
    lk.backward_launch_geometry(10, 64, 4000, 3)  # one pixel still fits


FAR_CELL, NO_CELL = 2.0 ** 22, -(1 << 30)


def backward_emulation(g, x0, D, radius, levels):
    """The gradient kernel's arithmetic in numpy fp32: per (pixel, level) a
    record {floor(x0 * 2^-l) as an integer, or a sentinel where it is huge
    or NaN; (1 - f) * 2^-l; f * 2^-l}, then per cell j and level the
    integer taps k1 = (j >> l) - c0 + r and k1 - 1, added in that order."""
    K = 2 * radius + 1
    M = x0.shape[0]
    out = np.zeros((M, D), np.float32)
    j = np.arange(D)
    for lvl in range(levels):
        inv = np.float32(2.0 ** -lvl)
        q = x0 * inv
        c0 = np.floor(q)
        f = q - c0
        with np.errstate(invalid="ignore"):
            near = (c0 >= -FAR_CELL) & (c0 <= FAR_CELL)
        cell = np.where(near, np.nan_to_num(c0), NO_CELL).astype(np.int64)
        w1, w2 = (np.float32(1) - f) * inv, f * inv
        ci = j >> lvl
        k1 = ci[None] - cell[:, None] + radius
        assert np.abs(k1).max() < 2 ** 31  # the kernel's int32 holds it
        whole = (ci < D >> lvl)[None]
        for k, w in ((k1, w1), (k1 - 1, w2)):
            tap = whole & (k >= 0) & (k < K)
            gk = np.take_along_axis(g[:, lvl * K:(lvl + 1) * K],
                                    np.where(tap, k, 0), axis=1)
            out += np.where(tap, gk * w[:, None], np.float32(0))
    return out


def v2_emulation(corr, x0, D, radius, levels):
    """The prefix-sum kernel's arithmetic in numpy fp32: each row's
    inclusive prefix sums S in place (a lane's four cells in order, then
    the scan over the 32 lanes' totals as the shuffle scan adds them), and
    pooled cell c of level l is (S[(c+1) 2^l - 1] - S[c 2^l - 1]) * 2^-l
    with S[-1] = 0."""
    M = corr.shape[0]
    cells = np.zeros((M, 128), np.float32)
    cells[:, :D] = corr
    runs = np.cumsum(cells.reshape(M, 32, 4), axis=2, dtype=np.float32)
    incl = runs[:, :, 3].copy()
    for off in (1, 2, 4, 8, 16):  # Hillis-Steele, as __shfl_up_sync
        incl[:, off:] = incl[:, off:] + incl[:, :-off].copy()
    excl = np.concatenate([np.zeros((M, 1), np.float32), incl[:, :-1]], 1)
    S = (excl[:, :, None] + runs).reshape(M, 128)[:, :D]
    outs = []
    for lvl in range(levels):
        inv, Dl = np.float32(2.0 ** -lvl), D >> lvl
        q = x0 * inv
        c0 = np.floor(q)
        f = (q - c0)[:, None]
        with np.errstate(invalid="ignore"):
            near = (c0 >= -FAR_CELL) & (c0 <= FAR_CELL)
        c0i = np.where(near, np.nan_to_num(c0), NO_CELL).astype(np.int64)
        c = c0i[:, None] - radius + np.arange(2 * radius + 2)
        inside = (c >= 0) & (c < Dl)
        cs = np.where(inside, c, 0)
        hi = np.take_along_axis(S, ((cs + 1) << lvl) - 1, axis=1)
        lo = np.where(cs > 0, np.take_along_axis(
            S, np.maximum((cs << lvl) - 1, 0), axis=1), np.float32(0))
        band = np.where(inside, (hi - lo) * inv, np.float32(0))
        outs.append((np.float32(1) - f) * band[:, :-1] + f * band[:, 1:])
    return np.concatenate(outs, axis=1)


EMULATED_INDICES = [0.0, None, None, 3e7, np.nan]  # None: D - 1, D + 40


def emulation_inputs(D, T, seed):
    rng = np.random.RandomState(seed)
    x0 = np.maximum(rng.rand(60).astype(np.float32) * (D + 16) - 4, 0)
    x0[:5] = [D - 1.0 if i == 1 else D + 40.0 if i == 2 else v
              for i, v in enumerate(EMULATED_INDICES)]
    return (rng.randn(60, D).astype(np.float32), x0,
            rng.randn(60, T).astype(np.float32))


@pytest.mark.parametrize("D", [16, 33, 44, 64])
@pytest.mark.parametrize("radius,levels", [(5, 3), (2, 2), (5, 1)])
def test_lookup_backward_integer_taps_match_plain(D, radius, levels):
    """Integer taps from the integer floor and the sentinel (x0 at 0,
    D - 1, D + 40, 3e7 and NaN) give the plain gradient (rtol / atol 1e-6;
    a NaN or far index no gradient)."""
    _, x0, g = emulation_inputs(D, levels * (2 * radius + 1), 31)
    got = backward_emulation(g, x0, D, radius, levels)
    want = lk.lookup_fused_backward_reference(
        torch.from_numpy(g), torch.from_numpy(x0), D, radius, levels)
    assert not np.any(got[3:5])
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("D", [16, 33, 44, 64, 128])
@pytest.mark.parametrize("radius,levels", [(5, 3), (2, 2), (5, 1)])
def test_lookup_v2_prefix_in_place_matches_plain(D, radius, levels):
    """Pooled cells from in-place inclusive prefix sums (S[-1] = 0) give
    the plain prefix-sum taps (rtol / atol 1e-5: another scan order) and
    the pooled taps (2e-3); NaN taps where x0 is NaN, as in both."""
    corr, x0, _ = emulation_inputs(D, 1, 32)
    got = v2_emulation(corr, x0, D, radius, levels)
    ct, xt = torch.from_numpy(corr), torch.from_numpy(x0)
    np.testing.assert_allclose(
        got, lk.lookup_fused_v2_reference(ct, xt, radius, levels).numpy(),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        got, lk.lookup_fused_reference(ct, xt, radius, levels).numpy(),
        rtol=2e-3, atol=2e-3)
    assert np.array_equal(np.isnan(got).any(1), np.isnan(x0))


def tf32_rna(x):
    """fp32 values rounded to TF32 (10 mantissa bits), to nearest with ties
    away from zero: ``cvt.rna.tf32.f32``."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def tf32_product(a, b, split):
    """G = a . b^T as the fp32 forward's mma.sync m16n8k8 steps form it:
    per 8-channel step, each pass's eight TF32 products (exact) added to
    the fp32 accumulator. ``split``: the 3xTF32 passes A_lo B_hi, A_hi B_lo,
    A_hi B_hi; else one pass of A_hi B_hi."""
    ah, bh = tf32_rna(a), tf32_rna(b)
    al, bl = tf32_rna(a - ah), tf32_rna(b - bh)
    passes = [(al, bh), (ah, bl), (ah, bh)] if split else [(ah, bh)]
    acc = np.zeros((a.shape[0], b.shape[0]), np.float32)
    for k in range(0, a.shape[1], 8):
        for x, y in passes:
            step = x[:, k:k + 8].astype(np.float64) @ y[:, k:k + 8].astype(
                np.float64).T
            acc = (acc + step).astype(np.float32)
    return acc


@pytest.mark.parametrize("C", [64, 44, 16])
def test_split_tf32_product_holds_the_fp32_tolerance(C):
    """The fp32 forward's G tile over phase 2's values (standard normal
    features, a 64-pixel tile against a 1104-column row) against fp64
    products: the split product's worst error is under 5% of what rtol
    1e-4 / atol 1e-3 allow, where one TF32 pass exceeds it."""
    rng = np.random.RandomState(C)
    a = rng.randn(64, C).astype(np.float32)
    b = rng.randn(1104, C).astype(np.float32)
    exact = a.astype(np.float64) @ b.astype(np.float64).T
    allowed = 1e-3 + 1e-4 * np.abs(exact)

    def worst(split):
        return float((np.abs(tf32_product(a, b, split) - exact)
                      / allowed).max())

    assert worst(split=True) < 0.05
    assert worst(split=False) > 1.0


# (P, C) of the quad warp's forward on the one-pass path: a training
# plan's reference and source feature warps (448 x 512, 448 x 1040 rect
# positions), its volume back-warps (264 x 360, D = 64 and 44) and the slab
# origin (C = 1)
QUAD_SHAPES = {
    "training_ref_warp": (448 * 512, 64),
    "training_src_warp": (448 * 1040, 64),
    "training_back_warp_stage0": (264 * 360, 64),
    "training_back_warp_stage1": (264 * 360, 44),
    "origin": (448 * 512, 1),
    "image_warp": (100, 3),
}


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", list(QUAD_SHAPES.values()),
                         ids=list(QUAD_SHAPES))
def test_quad_geometry(shape, dtype):
    P, C = shape
    geo = qw.launch_geometry(P, C, dtype)
    esize = 2 if dtype == torch.bfloat16 else 4
    groups, positions = geo.block
    assert C % geo.vec == 0 and geo.vec * esize <= 16
    # 16-byte loads wherever the channels allow them
    assert geo.vec * esize == 16 or C % (16 // esize) != 0
    assert groups == min(C // geo.vec, qw.THREADS)
    assert groups * positions <= qw.THREADS
    assert geo.grid[0] * positions >= P > (geo.grid[0] - 1) * positions


@pytest.mark.parametrize("dtype,C,align,vec", [
    (torch.bfloat16, 64, 16, 8), (torch.bfloat16, 64, 8, 4),
    (torch.bfloat16, 64, 4, 2), (torch.bfloat16, 64, 2, 1),
    (torch.bfloat16, 44, 16, 4), (torch.bfloat16, 1, 16, 1),
    (torch.float32, 64, 16, 4), (torch.float32, 64, 8, 2),
    (torch.float32, 44, 16, 4), (torch.float32, 1, 16, 1)])
def test_quad_vector_follows_channels_and_alignment(dtype, C, align, vec):
    assert qw.launch_geometry(1000, C, dtype, align).vec == vec


@pytest.mark.parametrize("shape,vec4", [((448, 512, 64), True),
                                        ((264, 360, 44), True),
                                        ((448, 512, 1), False),
                                        ((7, 9, 3), False)])
def test_quad_backward_geometry(shape, vec4):
    R, Q, C = shape
    geo = qw.backward_launch_geometry(R, Q, C)
    assert geo.vec4 == vec4
    assert geo.grid == (-(-Q // qw.TILE), -(-R // qw.TILE))
    # four blocks an SM: the box, the tile's corners (36 bytes a position)
    # and a block's reserved kilobyte each
    per_block = geo.smem_bytes + 36 * qw.TILE ** 2 + 16 + 1024
    assert geo.smem_bytes % 16 == 0 and 4 * per_block <= 228 * 1024


def test_quad_backward_geometry_refuses_rows_past_the_grid():
    with pytest.raises(ValueError):
        qw.backward_launch_geometry(qw.TILE * qw.MAX_GRID_Y + 1, 8, 64)


def tile_boxes(x, y, H, W):
    """The backward kernel's box per TILE x TILE tile, emulated in numpy:
    the pixels from the lowest to the highest column and row of the
    corners that land on the image (tiles with none left out)."""
    x0, y0 = np.floor(x), np.floor(y)
    boxes = []
    for r in range(0, x.shape[0], qw.TILE):
        for q in range(0, x.shape[1], qw.TILE):
            xs = x0[r:r + qw.TILE, q:q + qw.TILE]
            ys = y0[r:r + qw.TILE, q:q + qw.TILE]
            cx, cy = [], []
            for dx, dy in ((0, 0), (1, 0), (0, 1), (1, 1)):
                m = ((xs + dx >= 0) & (xs + dx <= W - 1) & (ys + dy >= 0)
                     & (ys + dy <= H - 1))
                cx.append((xs + dx)[m])
                cy.append((ys + dy)[m])
            cx, cy = np.concatenate(cx), np.concatenate(cy)
            if cx.size:
                boxes.append((cx.max() - cx.min() + 1)
                             * (cy.max() - cy.min() + 1))
    return np.asarray(boxes)


@pytest.mark.parametrize("angle", [0.0, 10.0, 30.0, 45.0, 90.0])
def test_quad_backward_box_fits_a_rotated_unit_map(angle):
    """A map of scale 1 at any rotation (the rectified warps rotate about
    the optical axis and keep the focal length): every tile's box of 64
    channels fits the backward's shared memory, so no block of such a map
    falls back to global atomics."""
    H, W = 64, 80
    t = np.deg2rad(angle)
    r, q = np.mgrid[0:48, 0:56].astype(np.float64)
    x = np.cos(t) * q - np.sin(t) * r + 30.3
    y = np.sin(t) * q + np.cos(t) * r - 10.7
    boxes = tile_boxes(x, y, H, W)
    assert len(boxes) > 0
    assert boxes.max() * 64 * 4 <= qw.BWD_SMEM_BYTES

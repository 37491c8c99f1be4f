"""The port's grid and four-rank row sharding against the JAX package's on
the CPU, and the dry run of both: ``row_sharded_forward`` over a
``(row, view)`` mesh of 2 x 2 gloo ranks against JAX's
``grid_sharded_forward`` on a (2, 2) device mesh, exact and rectified;
over a ``(row,)`` mesh of four against JAX's on four devices; and
``dryrun.dryrun_spatial`` on the four ranks.

One ``dryrun.World`` of four spawned processes serves the module (the
ranks import the port alone). Scene, model and tolerances are
``tests/test_torch_spatial.py``'s. The grid's view sums run in another
order: JAX pads the three views to four with a zero-weight view and
widens every epiband window to the plan's scene-wide bounds; the port
deals the views 2 + 1 and builds each in its own window.
"""

import numpy as np
import pytest
import torch

from cermvs_tpu.ops import rectify as jrect
from cermvs_torch.parallel import dryrun
import torch_parallel_tasks as tasks
from test_torch_spatial import (DAMP, MODEL, TOL, feature_geometry,
                                jax_row_forward, spatial_scene)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def world():
    w = dryrun.World(4, "cpu")
    yield w
    w.close()


@pytest.mark.parametrize("construction", ["exact", "rectified"])
def test_grid_of_four_matches_jax(world, construction):
    """Rows over two ranks and views over two: each rank encodes and
    builds its share of the views, one ``all_reduce`` a stage over the
    view axis; the same disparities on every rank, JAX's within fp32
    order."""
    images, poses, intr = spatial_scene()
    plan = None
    if construction == "rectified":
        plan = jrect.plan_rectification(*feature_geometry(
            poses, intr, *images.shape[1:3]))
        assert plan.ok, plan.reason
    scale = np.full((1,), 1.5, np.float32)
    dj = jax_row_forward(("mean",), images, poses, intr, scale, 4, plan,
                         grid=True)
    vec = None if plan is None else jrect.pack_plan(plan, 3)
    outs = world.run(tasks.row_forward, MODEL, DAMP, images[None],
                     poses[None], intr[None], scale, 2, vec)
    for o in outs[1:]:
        np.testing.assert_array_equal(o, outs[0])
    assert outs[0].shape == dj.shape == (1, 32, 12)
    assert np.abs(dj).max() >= 100 * TOL["atol"]
    np.testing.assert_allclose(outs[0], dj, **TOL)


def test_four_row_ranks_match_jax(world):
    """The exact construction over four row ranks of 8 feature rows each,
    the ghost margin ``GHOST`` exactly: every rank's ghosts come from its
    immediate neighbours only."""
    images, poses, intr = spatial_scene()
    scale = np.ones((1,), np.float32)
    dj = jax_row_forward(("mean",), images, poses, intr, scale, 4)
    outs = world.run(tasks.row_forward, MODEL, DAMP, images[None],
                     poses[None], intr[None], scale)
    for o in outs[1:]:
        np.testing.assert_array_equal(o, outs[0])
    assert np.abs(dj).max() >= 100 * TOL["atol"]
    np.testing.assert_allclose(outs[0], dj, **TOL)


def test_dryrun_spatial_on_four_ranks(world):
    """``dryrun_spatial`` at its CPU size (``SMALL["spatial"]``: 256x48,
    four views): every row and grid case's route, stage volumes,
    disparities and launches against the runner without a mesh."""
    report = dryrun.dryrun_spatial(4, "cpu", world=world)
    labels = [dryrun.spatial_label(*c) for c in dryrun.SPATIAL_CASES]
    assert labels == ["row_exact", "row_rectified", "row_exact_mean_max_std",
                      "grid_exact", "grid_rectified"]
    for label in labels:
        case = report[label]
        assert case["path"] == label.split("_")[1]
        # 8 x the row ranks: four, or two on the 2 x 2 grid
        assert case["shape_multiple"] == (32 if label.startswith("row")
                                          else 16)
        assert case["disp_max"] >= 100 * dryrun.SMALL["spatial"][
            "disp_tol"][case["path"]]["atol"]
        assert case["eager_reason"] == "a CPU runner"
    assert report["row_rectified"]["band_h"] == 64
    assert report["row_exact"]["views"] == [[0, 1, 2, 3]] * 4
    assert report["grid_exact"]["views"] == [[0, 2], [1, 3]] * 2


@pytest.mark.parametrize("construction", ["exact", "rectified"])
def test_dryrun_fails_stale_ghost_rows(world, construction):
    """A planted fault: every rank keeps its stale ghost rows instead of
    taking them again from its neighbours. The stage volumes, rebuilt from
    the unsharded forward's origins, still agree; the disparity limit of
    ``SMALL["spatial"]`` for the route fails it."""
    case = ("row", construction, ("mean",))
    world.run(tasks.skip_ghost_refresh, True)
    try:
        with pytest.raises(AssertionError, match="disparity") as err:
            dryrun.dryrun_spatial(4, "cpu", world=world, cases=(case,))
    finally:
        world.run(tasks.skip_ghost_refresh, False)
    assert f"row_{construction}: disparity" in str(err.value)
    # the same world, repaired, passes the route again
    report = dryrun.dryrun_spatial(4, "cpu", world=world, cases=(case,))
    assert report[f"row_{construction}"]["disp_err"] > 0


def test_halo_by_send_recv_equals_slot_form(world):
    """``halo``'s send/recv batch (NCCL's form) and its slot all-reduce
    (gloo's) give the same rows bit for bit, fp32 and bf16, for the halo
    sizes of the encoders' convolutions and the ghost refresh: each
    rank's neighbours' rows, zeros beyond the first and last rank."""
    outs = world.run(tasks.halo_both_ways, 3)
    for r, pairs in enumerate(outs):
        for p2p, slots in pairs:
            np.testing.assert_array_equal(p2p, slots)
    # rank 1's (1, 1) halo of the fp32 tensor: rank 0's last row, its own
    # five, rank 2's first row
    mid = outs[1][0][0]
    np.testing.assert_array_equal(mid[:, 1:6], outs[1][2][0][:, 1:6])
    assert mid.shape == (1, 7, 3, 2)
    np.testing.assert_array_equal(mid[:, 0], outs[0][0][0][:, 5])
    np.testing.assert_array_equal(mid[:, 6], outs[2][0][0][:, 1])
    assert not outs[0][0][0][:, 0].any() and not outs[3][0][0][:, 6].any()

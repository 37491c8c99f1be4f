"""A run of each cell at a small size on the CPU, the look for a card
skipped: sound, it comes out correct; with the timed path broken
underneath, ``correct`` comes out false, once for each fault the cell can
have. And the control: the reference in float8 in the program's place
fails the cell's limits."""

import copy
import importlib
import time
from argparse import Namespace
from unittest import mock

import pytest
import torch

from portbench import check, harness, traffic
from portbench.run import execute, make_run

SMALL = {"tnt_nf15.infer_walk": dict(image_hw=[64, 128], num_frames=3),
         "dtu_nf10.train": dict(image_hw=[120, 160], crop_hw=[96, 128],
                                num_frames=3)}


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(n)


def small_run(workload, seed=123456789012, trace=0):
    args = Namespace(workload=workload, seed=seed, seconds=2.0, trace=trace)
    r = make_run(args, torch.device("cpu"), time.perf_counter())
    r.config = copy.deepcopy(r.config)
    r.config["model"]["cascade"] = [[8, 64, 2], [-1, 320, 2]]
    r.config.update(SMALL[workload])
    r.mix = dict(r.mix, bank=8)
    if r.mix["kind"] == "batches":
        # at this size the planner keys every batch two-pass
        r.mix["plans"] = {"twopass": 4}
    elif r.mix.get("pool"):
        r.mix["pool"] = r.mix["warm"] = 2
    r.cell = dict(r.cell, trace_items=3, trace_skip=1,
                  check_views=min(r.cell.get("check_views", 2), 2))
    return r


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_sound_run_is_correct(workload):
    result = execute(small_run(workload))
    assert result["correct"], result["compared"]
    assert result["failed"] == 0 and result["attempted"] > 0
    assert "setup_s" in result["metrics"]
    assert list(result)[-1] == "compared"


@pytest.mark.parametrize("workload", ["tnt_nf15.infer_walk"])
def test_altered_answer_is_not_correct(workload):
    """Every depth map altered where it is produced: half again as deep."""
    infer_mod = importlib.import_module("cermvs_torch.pipeline.inference")
    finalize = infer_mod.InferenceRunner.finalize_batch

    def altered(disp):
        return finalize(disp) * 1.5

    with mock.patch.object(infer_mod.InferenceRunner, "finalize_batch",
                           staticmethod(altered)):
        result = execute(small_run(workload))
    assert not result["correct"], result["compared"]


def test_lost_answer_is_not_correct():
    """A depth map that never comes counts as failed."""
    infer_mod = importlib.import_module("cermvs_torch.pipeline.inference")
    write = infer_mod.write_pfm

    def lossy(path, depth):
        if "v000001" not in str(path):
            write(path, depth)

    with mock.patch.object(infer_mod, "write_pfm", lossy):
        result = execute(small_run("tnt_nf15.infer_walk"))
    assert result["failed"] >= 1 and not result["correct"]


def test_unchanged_state_is_not_correct():
    """A step that returns the state unchanged: the program's optimizer
    skips its update."""
    step_mod = importlib.import_module("cermvs_torch.training.step")
    fetch = step_mod.fetch_optimizer

    def idle(*args, **kwargs):
        opt, *rest = fetch(*args, **kwargs)
        opt.step = lambda closure=None: None
        return (opt, *rest)

    with mock.patch.object(step_mod, "fetch_optimizer", idle):
        result = execute(small_run("dtu_nf10.train"))
    assert not result["correct"], result["compared"]
    assert result["compared"]["change_gap"]["value"] == 1.0


def test_half_batch_is_not_correct():
    """Half of the batch left out, the mean taken over the rest."""
    step_mod = importlib.import_module("cermvs_torch.training.step")
    to_device = step_mod.batch_to_device

    def half(batch, device):
        b = to_device(batch, device)
        n = max(1, b["images"].shape[0] // 2)
        return {k: v[:n] for k, v in b.items()}

    with mock.patch.object(step_mod, "batch_to_device", half):
        result = execute(small_run("dtu_nf10.train"))
    assert not result["correct"], result["compared"]


@pytest.mark.parametrize("workload", ["tnt_nf15.infer_walk"])
def test_float8_control_separates(workload):
    """The control, the reference in float8 in the program's place, at a
    size this run can hold: on every seed it reads three times or more
    what the reference in bf16 (the program's precision) reads, on the
    numbers the cell compares. The chip's readings at the cell's size,
    which set the limits, are in the cell's file and PERF.md."""
    r = small_run(workload)
    cfg = copy.deepcopy(r.config)
    cfg["model"]["cascade"] = [[64, 64, 4], [-1, 320, 4]]
    cfg["image_hw"] = [192, 256]
    for seed in (5, 6, 7):
        w = _weights(cfg, seed)
        views = traffic.make(r.mix, cfg, seed, torch.device("cpu"))
        images, poses, intr, _, scale = views.visit(0)
        gaps = {}
        for dtype in ("float32", "bfloat16", "float8"):
            model = check.model_of(cfg, w, dtype, True, "cpu")
            gaps[dtype] = check.view_disparity(model, images, poses, intr,
                                               scale, "cpu")
        unit = check.spacing(cfg)
        low = check.view_gaps(gaps["bfloat16"], gaps["float32"], unit)
        high = check.view_gaps(gaps["float8"], gaps["float32"], unit)
        for k in r.cell["limits"]:
            assert high[k] >= 3 * low[k], (seed, k, low, high)


def test_float8_control_separates_in_training():
    r = small_run("dtu_nf10.train")
    cfg = r.config
    batches = traffic.make(r.mix, cfg, 7, torch.device("cpu"))
    pool = [batches.batch(i) for i in range(3)]
    weights = _weights(cfg, 7)
    gws = [0.0] * 3
    want = check.reference_steps(cfg, weights, pool, gws, "cpu")
    low = check.train_gaps(check.reference_steps(
        cfg, weights, pool, gws, "cpu", dtype="bfloat16"), want)
    high = check.train_gaps(check.reference_steps(
        cfg, weights, pool, gws, "cpu", dtype="float8"), want)
    assert any(high[k] >= 3 * low[k] for k in r.cell["limits"]), (low, high)


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_limits_lie_between_their_readings(workload):
    """Each limit lies above the largest reading of sound runs and below
    the smallest of the control and the faults, which is three times the
    former or more (the chip's readings, kept in the cell's file)."""
    cell = harness.load("cells", workload)
    for k, lim in cell["limits"].items():
        lo, hi = cell["readings"][k]["lower"], cell["readings"][k]["upper"]
        assert lo < lim < hi and hi >= 3 * lo, (k, lo, lim, hi)


def _weights(cfg, seed):
    from cermvs_torch.models.raft import RAFT
    from portbench.drivers.infer import model_kwargs

    model = RAFT(test_mode=True, device="cpu", **model_kwargs(cfg))
    return harness.make_weights(model, seed, torch.device("cpu"),
                                cfg.get("weight_scales"))

"""The yardstick against the port at small sizes on the CPU: the analytic
FLOP count against the port's counter, and the plain reference against the
port's forward and train step (fp32: the same arithmetic, to rounding)."""

import copy

import numpy as np
import pytest
import torch

from portbench import check, flops, harness, traffic
from portbench.drivers.infer import model_kwargs

# a DTU test run's rig (the traffic of an inference cell on the rectified
# construction, which the benchmark does not run yet): 8 reference cameras
# of the 49-camera arc, cycled
RIG = {"kind": "views", "scene": "arc",
       "scene_params": {"n": 49, "step": 0.04, "radius": 600.0,
                        "elevation": 0.015},
       "focal": 2892.0, "focal_at_width": 1600, "cameras": 49, "pool": 8,
       "bank": 24, "warm": 8, "warm_rounds": 2}

SMALL = dict(cascade=[[8, 64, 2], [-1, 320, 2]], image_hw=[96, 128],
             crop_hw=[64, 96], num_frames=2)


def small_config(name="dtu_nf10", dtype="float32"):
    cfg = copy.deepcopy(harness.load("configs", name))
    cfg["model"]["cascade"] = SMALL["cascade"]
    cfg["model"]["dtype"] = dtype
    for k in ("image_hw", "crop_hw", "num_frames"):
        cfg[k] = SMALL[k]
    return cfg


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(n)


def port_model(cfg, test_mode, seed=3):
    from cermvs_torch.models.raft import RAFT

    model = RAFT(test_mode=test_mode, device="cpu", **model_kwargs(cfg))
    weights = harness.make_weights(model, seed, torch.device("cpu"),
                                   cfg.get("weight_scales"))
    return model, weights


def test_analytic_flops_match_the_ports_counter():
    """The convolutions of one forward (encoders, the GRU iterations and
    their per-stage gate term) counted from shapes against
    ``count_flops`` of the port's eager forward through the exact
    construction, whose correlation the counter does not see (its other
    products are the 4x4 projections)."""
    from cermvs_torch.utils.flops import count_flops

    cfg = small_config()
    model, _ = port_model(cfg, True)
    views = traffic.make(RIG | {"bank": 4},
                         cfg, 5, torch.device("cpu"))
    images, poses, intr, _, scale = views.visit(0)
    args = (torch.from_numpy(images)[None], torch.from_numpy(poses)[None],
            torch.from_numpy(intr)[None])
    with torch.no_grad():
        counted = count_flops(model, *args)
    H, W = cfg["image_hw"]
    m = cfg["model"]
    analytic = (flops.forward_flops(m, cfg["num_frames"] + 1, H, W)
                - flops.correlation_flops(H // 4, W // 4, cfg["num_frames"],
                                          m))
    assert counted.kernel_total == 0
    assert counted.aten["aten.convolution"] == analytic


@pytest.mark.parametrize("kind", ["rig", "walk_sway"])
def test_reference_forward_equals_the_ports(kind):
    """fp32 on both sides, the same frames, poses and weights, each side
    routing the view itself: the depth maps agree to rounding."""
    import importlib

    infer_mod = importlib.import_module("cermvs_torch.pipeline.inference")
    cfg = small_config("dtu_nf10" if kind == "rig" else "tnt_nf15")
    cfg["num_frames"] = 3
    model, weights = port_model(cfg, True)
    mix = (RIG if kind == "rig" else harness.load("traffic", kind)) | {
        "bank": 6}
    if mix.get("pool"):
        mix["pool"] = 2
    views = traffic.make(mix, cfg, 11, torch.device("cpu"))
    runner = infer_mod.InferenceRunner(model=model, device="cpu")
    ref = check.model_of(cfg, weights, "float32", True, "cpu")
    for i in range(2):
        images, poses, intr, _, scale = views.visit(i)
        prog = runner.submit_batch(torch.from_numpy(images)[None],
                                   poses[None], intr[None], [scale])
        prog = prog[0].double().numpy()
        want = check.view_disparity(ref, images, poses, intr, scale, "cpu")
        gaps = check.view_gaps(prog, want, check.spacing(cfg))
        assert gaps["gap_max"] < 1e-3, gaps


def test_reference_train_steps_equal_the_ports():
    """Three fp32 train steps of the port's runner against the reference's
    from the same weights on the same batches: losses, the first gradient
    as AdamW got it and the change, to rounding."""
    from cermvs_torch.training.step import (StepRunner, batch_to_device,
                                            init_state)
    from cermvs_torch.training.train import plan_batch
    from cermvs_torch.ops.rectify import PlanCache

    cfg = small_config()
    model, weights = port_model(cfg, False)
    num_steps = cfg["train"]["num_steps"]
    state = init_state(model, num_steps)
    runner = StepRunner(state)
    cache = PlanCache()
    mix = harness.load("traffic", "train_arc") | {"bank": 8,
                                                   "plans": {"twopass": 3}}
    batches = traffic.make(mix, cfg, 21, torch.device("cpu"))
    pool = [batches.batch(i) for i in range(3)]
    program = {"losses": []}
    for i, b in enumerate(pool):
        plan = plan_batch(b, 4)
        key = cache.key_for(plan) if plan.ok else None
        out = runner(batch_to_device(b, "cpu"), i / num_steps, key)
        program["losses"].append(out["loss"])
        if i == 0:
            program["grad1"] = {
                n: state.optimizer.state[p]["exp_avg"] / 0.1
                for n, p in model.named_parameters()}
    program["change"] = {n: p.detach() - weights[n]
                         for n, p in model.named_parameters()}
    ref = check.reference_steps(cfg, weights, pool,
                                [i / num_steps for i in range(3)], "cpu")
    gaps = check.train_gaps(program, ref)
    assert gaps["loss_gap"] < 1e-5, gaps
    assert gaps["grad_gap"] < 1e-4, gaps
    assert gaps["change_gap"] < 1e-3, gaps
    assert np.isfinite(list(gaps.values())).all()


@pytest.mark.parametrize("geometry_seed", [0, 5])
def test_train_pool_steps_its_stated_mix(geometry_seed):
    """At the cell's size, the port's planner and plan cache, fed the pool
    in its order, key each batch to the construction the traffic states
    (planning only: no frames, no depths); the cell's pool (geometry seed
    0) puts a one-pass key among the three checked steps."""
    from cermvs_torch.ops.rectify import PlanCache
    from cermvs_torch.training.train import plan_batch

    cfg = harness.load("configs", "dtu_nf10")
    mix = harness.load("traffic", "train_arc") | {
        "bank": 2, "geometry_seed": geometry_seed}
    batches = traffic.make(mix, cfg, 1, torch.device("cpu"))
    cache, kinds = PlanCache(), []
    for j in batches.slots:
        parts = [batches._geometry(j, b) for b in range(cfg["batch_size"])]
        batch = {"poses": np.stack([np.stack([batches.pose(i) for i in ids])
                                    for ids, _ in parts]),
                 "intrinsics": np.stack([np.tile(K, (len(ids), 1, 1))
                                         for ids, K in parts]),
                 "images": np.zeros((2, 1, *cfg["crop_hw"], 1), np.uint8)}
        plan = plan_batch(batch, 4)
        key = cache.key_for(plan) if plan.ok else None
        kinds.append("exact" if key is None
                     else "twopass" if key.twopass else "onepass")
    assert kinds == batches.kinds
    assert {k: kinds.count(k) for k in set(kinds)} == mix["plans"]
    if geometry_seed == harness.load("traffic", "train_arc")["geometry_seed"]:
        assert "onepass" in kinds[:3]

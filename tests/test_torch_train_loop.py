"""The port's training loop on the CPU: checkpoints (cadence, rolling
window, resume), ``train()`` through the rectified construction with a
patched loader (lateral batches train rectified, forward-motion batches
fall back to exact), the PlanCache keeping a long stream of batch plans to
a handful, the plan helpers against the JAX package's, and the CLI.
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

import cermvs_torch.data as data_mod
from cermvs_tpu.ops import rectify as jrect
from cermvs_torch import config as pcfg
from cermvs_torch.models.raft import RAFT
from cermvs_torch.ops import cudalib
from cermvs_torch.ops import rectify as prect
from cermvs_torch.training.checkpoint import (CheckpointManager, load_params,
                                              save_params)
from cermvs_torch.training.step import batch_to_device, init_state, train_step
from cermvs_torch.training.train import train
from test_train_rectified import _batches

SMALL = ((4, 64, 1),)


def _model(seed=0):
    return RAFT(cascade=SMALL, hyp_chunk=4, dtype=torch.float32, device="cpu",
                generator=torch.Generator().manual_seed(seed))


def _np_batches(n, **kw):
    return [{k: np.array(v) for k, v in b.items()}
            for b in _batches(n, **kw)]


def test_checkpoint_roundtrip_and_resume(tmp_path):
    state = init_state(_model(), num_steps=10)
    batch = batch_to_device(_np_batches(1, H=16, W=32)[0], "cpu")
    mgr = CheckpointManager(tmp_path / "ckpt", max_to_keep=2,
                            save_interval=3)
    saved = []
    for _ in range(4):
        train_step(state, batch, 0.5)
        saved.append(mgr.maybe_save(state))
    assert saved == [True, False, True, False]  # step 1, then every 3
    assert mgr.maybe_save(state, force=True)
    assert mgr.all_steps() == [3, 4]  # a rolling window of two
    assert mgr.latest_step() == 4

    other = init_state(_model(seed=1), num_steps=10)
    restored = mgr.restore(other)
    assert restored.step == 4
    for a, b in zip(state.model.state_dict().values(),
                    restored.model.state_dict().values()):
        assert torch.equal(a, b)
    assert (restored.optimizer.param_groups[0]["lr"]
            == state.optimizer.param_groups[0]["lr"])
    assert restored.scheduler.last_epoch == state.scheduler.last_epoch == 4
    # the restored optimizer continues as the original does
    m1 = train_step(state, batch, 0.5)
    m2 = train_step(restored, batch, 0.5)
    assert m1 == pytest.approx(m2, rel=1e-6)
    with pytest.raises(FileNotFoundError):
        CheckpointManager(tmp_path / "empty").restore(other)

    save_params(tmp_path / "w.pt", state.model)
    for k, v in load_params(tmp_path / "w.pt").items():
        assert torch.equal(v, state.model.state_dict()[k])


@pytest.mark.parametrize("forward_motion", [False, True])
def test_train_loop_rectified(tmp_path, monkeypatch, forward_motion):
    pcfg.clear_config()
    pcfg.bind_parameter("RAFT.cascade", SMALL)
    pcfg.bind_parameter("RAFT.dtype", torch.float32)
    pcfg.bind_parameter("RAFT.hyp_chunk", 4)
    try:
        batches = _np_batches(2, forward_motion=forward_motion)
        monkeypatch.setattr(data_mod, "get_train_data_loader",
                            lambda batch_size=2, **kw: batches)
        seen = []
        cudalib.reset_launches()
        state = train(name="t_rect", batch_size=2, num_steps=2,
                      SAVE_FREQ=1000, checkpoint_dir=str(tmp_path / "ckpt"),
                      resume=False, log_every=1000, construction="rectified",
                      device="cpu", run_dir=str(tmp_path / "runs"),
                      on_step=lambda s, m, plan: seen.append((s.step, m,
                                                              plan)))
        assert state.step == 3  # num_steps + 1 steps from 0
        assert [s for s, _, _ in seen] == [1, 2, 3]
        for _, m, plan in seen:
            assert np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"])
            if forward_motion:
                assert plan is None  # the planner rejects: exact
            else:
                assert plan.ok and plan.twopass
        if not forward_motion:  # one cached plan serves every batch
            assert len({id(p) for _, _, p in seen}) == 1
        assert all(torch.isfinite(p).all() for p in state.model.parameters())
        assert not any(cudalib.launches.values())  # CPU: no kernel launched
        mgr = CheckpointManager(tmp_path / "ckpt" / "t_rect")
        assert mgr.all_steps() == [1, 3]  # step 1 and the forced final save
        resumed = train(name="t_rect", batch_size=2, num_steps=3,
                        SAVE_FREQ=1000, checkpoint_dir=str(tmp_path / "ckpt"),
                        log_every=1000, construction="rectified",
                        device="cpu", run_dir=str(tmp_path / "runs"))
        assert resumed.step == 4  # resumed at 3, one more step
    finally:
        pcfg.clear_config()


def _stream_plans(mod, n_batches=200):
    """Plans of a stream of DTU-like batches (jittered baselines, small
    rotations, the scale law of random_scale_and_crop) merged per batch."""
    B, n, H, W, f = 2, 4, 32, 64, 4
    rng = np.random.RandomState(7)
    for _ in range(n_batches):
        plans = []
        aug = 2.0 ** rng.uniform(-0.15, 0.5)
        for _b in range(B):
            poses = np.tile(np.eye(4), (n, 1, 1))
            for i in range(1, n):
                poses[i, 0, 3] = (1.0 + 0.35 * rng.rand()) * (-1) ** i
                poses[i, 1, 3] = 0.08 * rng.randn()
                a = 0.03 * rng.randn()
                ca, sa = np.cos(a), np.sin(a)
                poses[i, :3, :3] = np.array([[ca, 0, sa], [0, 1, 0],
                                             [-sa, 0, ca]])
            Kf = np.array([[40.0 * aug, 0, W / 2], [0, 40.0 * aug, H / 2],
                           [0, 0, 1]])
            Kf[:2] /= f
            plans.append(mod.plan_rectification(
                poses, np.tile(Kf, (n, 1, 1)), H // f, W // f))
        yield mod.plan_union(plans)


def test_plan_cache_bounds_plans():
    cache = prect.PlanCache()
    raw = set()
    for plan in _stream_plans(prect):
        assert plan.ok, plan.reason
        raw.add(plan)
        key = cache.key_for(plan)
        assert key.covers(plan)
    assert len(cache) <= 8 < len(raw)


def test_plan_helpers_match_jax():
    """plan_union, widen_plan, covers and the PlanCache's decisions equal
    the JAX package's on the same stream."""
    pc, jc = prect.PlanCache(), jrect.PlanCache()
    for pp, jp in zip(_stream_plans(prect, 40), _stream_plans(jrect, 40)):
        assert dataclasses.asdict(pp) == dataclasses.asdict(jp)
        assert (dataclasses.asdict(prect.widen_plan(pp))
                == dataclasses.asdict(jrect.widen_plan(jp)))
        assert (dataclasses.asdict(pc.key_for(pp))
                == dataclasses.asdict(jc.key_for(jp)))
    assert len(pc) == len(jc)
    base = prect.RectPlan(64, 128, 96, 8, True, "", rate_lo=0.8,
                          rate_hi=1.2, view_rates=((0.8, 1.0), (0.9, 1.2)),
                          view_s_max=(64, 96), twopass=True)
    for other in (prect.widen_plan(base),
                  dataclasses.replace(base, twopass=False),
                  dataclasses.replace(base, w_r=256),
                  dataclasses.replace(base, h_r=48, s_max=80, rate_lo=0.9),
                  prect.RectPlan(0, 0, 0, 0, False, "x")):
        ja = jrect.RectPlan(**dataclasses.asdict(base))
        jb = jrect.RectPlan(**dataclasses.asdict(other))
        assert base.covers(other) == ja.covers(jb)
        assert other.covers(base) == jb.covers(ja)
    bad = prect.plan_union([base, dataclasses.replace(
        base, view_rates=((0.8, 1.0),), view_s_max=(64,))])
    assert not bad.ok and "view-count" in bad.reason


def test_cli_binds_train_config(monkeypatch):
    import cermvs_torch.train as cli

    seen = {}

    def fake_train(**kw):
        seen.update(kw)
        seen["num_steps"] = pcfg.query_parameter("train.num_steps")
        seen["construction"] = pcfg.query_parameter("train.construction")
        seen["crop"] = pcfg.query_parameter(
            "random_scale_and_crop.crop_size")

    monkeypatch.setattr(cli, "train", fake_train)
    monkeypatch.chdir(Path(__file__).resolve().parent.parent)  # configs/
    pcfg.clear_config()
    try:
        cli.main(["-g", "train_DTU", "-p", "train.num_steps=3"])
    finally:
        pcfg.clear_config()
    assert seen == {"seed": 1234, "num_steps": 3,
                    "construction": "rectified", "crop": [1056, 1440]}

"""The port's compiled train step on the CPU: the device-side clip and the
tensor curriculum weight (no host sync in the step), ``train()``'s keys
against the JAX package's ``pick_step``, the CPU path against direct
``train_step`` calls, and checkpoints restored in place. The captures
themselves run on a card: ``tests/test_torch_cuda.py``.

Tolerances: the clip bit for bit against the host-branch clip it replaced
(the same divide and multiply; 1 below the limit is exact); the loss at a
0-dim tensor weight against JAX's at ``jnp.float32(gw)`` rtol 1e-5 (fp32,
as ``test_torch_training.py``); ``train()`` on the CPU against direct
``train_step`` calls bit for bit (the same eager arithmetic).
"""

import copy
import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cermvs_torch.data as data_mod
from cermvs_tpu.ops import rectify as jrect
from cermvs_tpu.training.loss import sequence_loss as j_loss
from cermvs_torch import config as pcfg
from cermvs_torch.models.raft import RAFT
from cermvs_torch.ops.corr_rectified import RectifiedVolume
from cermvs_torch.ops.rectify import PlanCache
from cermvs_torch.training.checkpoint import CheckpointManager, load_state
from cermvs_torch.training.loss import sequence_loss
from cermvs_torch.training.optim import (clip_by_global_norm, global_norm,
                                         one_cycle_linear)
from cermvs_torch.training.step import batch_to_device, init_state, train_step
from cermvs_torch.training.train import plan_batch, train

SMALL = ((4, 64, 1),)


def host_branch_clip(grads, max_norm):
    """The clip as it was: a host sync on the norm, then a branch."""
    norm = global_norm(grads)
    if float(norm) > max_norm:
        for g in grads:
            g.div_(norm).mul_(max_norm)
    return norm


@pytest.mark.parametrize("scale", [0.01, 0.3, 5.0])
@pytest.mark.parametrize("max_norm", [1.0, 0.5])
def test_device_clip_keeps_the_host_branch_bits(scale, max_norm):
    rng = np.random.RandomState(3)
    shapes = [(5, 3), (7,), (2, 4, 3)]
    grads = [torch.from_numpy((rng.randn(*s) * scale).astype(np.float32))
             for s in shapes]
    grads.append(torch.from_numpy(rng.randn(6).astype(np.float32) * scale)
                 .to(torch.bfloat16))
    before = [g.clone() for g in grads]
    old = [g.clone() for g in grads]
    n_new = clip_by_global_norm(grads + [None], max_norm)
    n_old = host_branch_clip(old, max_norm)
    assert torch.equal(n_new, n_old)
    for a, b in zip(grads, old):
        assert a.dtype == b.dtype and torch.equal(a, b)
    clipped = float(n_old) > max_norm
    assert clipped == (scale > 0.01)  # the norm is about 6 * scale
    assert clipped != all(torch.equal(a, b) for a, b in zip(grads, before))


@pytest.mark.parametrize("gw", [0.0, 0.3, 0.7, 1.0])
def test_sequence_loss_takes_a_tensor_weight_as_jax_float32(rng, gw):
    T, B, h, w, H, W = 3, 2, 4, 6, 8, 12
    est = rng.rand(T, B, h, w).astype(np.float32) * 0.2 + 1e-3
    gt = rng.rand(B, H, W).astype(np.float32) * 0.2
    gt[gt < 0.05] = 0.0
    lj, mj = j_loss(jnp.asarray(est), jnp.asarray(gt), jnp.float32(gw))
    lp, mp = sequence_loss(torch.from_numpy(est), torch.from_numpy(gt),
                           torch.tensor(gw, dtype=torch.float32))
    np.testing.assert_allclose(float(lp), float(lj), rtol=1e-5)
    assert set(mp) == set(mj)
    for k in mp:
        np.testing.assert_allclose(float(mp[k]), float(mj[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)


def stream_batch(scale, forward=False, B=2, n=3, H=32, W=64, seed=0):
    """A batch of ``tests/test_train_rectified.py``'s rig with its baselines
    times ``scale``, moved sideways (the planner keeps it) or along the
    optical axis (the planner rejects it)."""
    K = np.array([[40.0, 0, W / 2], [0, 40.0, H / 2], [0, 0, 1]], np.float32)
    rng = np.random.RandomState(seed)
    poses = np.tile(np.eye(4, dtype=np.float32), (B, n, 1, 1))
    for b in range(B):
        for i, bx in enumerate([0.0, (1.2 + 0.2 * b) * scale, -1.6 * scale]):
            poses[b, i, 2 if forward else 0, 3] = bx if forward else -bx
    return {"images": (rng.rand(B, n, H, W, 3) * 255).astype(np.float32),
            "depths": (rng.rand(B, n, H, W) * 20 + 20).astype(np.float32),
            "poses": poses, "intrinsics": np.tile(K, (B, n, 1, 1))}


def jax_pick_step_keys(batches, stride=4):
    """A replica of the JAX package's ``train()`` choosing its step
    (``cermvs_tpu/training/train.py`` ``pick_step``): the plan of each
    batch, None (the exact step) where the planner rejects it, else its
    ``PlanCache`` key; and whether the step was compiled at that batch (the
    exact step at its first use, a rectified one where ``_rect_steps``
    grows)."""
    cache, seen, out = jrect.PlanCache(), set(), []
    for batch in batches:
        intr = batch["intrinsics"].astype(np.float64).copy()
        intr[..., :2, :] /= stride
        H, W = batch["images"].shape[2:4]
        plan = jrect.plan_union(jrect.plan_rectification(
            batch["poses"][b].astype(np.float64), intr[b], H // stride,
            W // stride) for b in range(batch["poses"].shape[0]))
        key = cache.key_for(plan) if plan.ok else None
        out.append((key, key not in seen))
        seen.add(key)
    return out


@pytest.fixture
def small_raft():
    pcfg.clear_config()
    pcfg.bind_parameter("RAFT.cascade", SMALL)
    pcfg.bind_parameter("RAFT.dtype", torch.float32)
    pcfg.bind_parameter("RAFT.hyp_chunk", 4)
    yield
    pcfg.clear_config()


def run_train(tmp_path, monkeypatch, batches, **kw):
    """``train()`` on the CPU over ``batches`` (one pass), recording after
    each step the runner's key and whether the key was new."""
    monkeypatch.setattr(data_mod, "get_train_data_loader",
                        lambda batch_size=2, **_: batches)
    seen = []

    def on_step(state, metrics, plan):
        r = state.runner
        assert r.last_key[1] is plan
        seen.append((r.last_key, r.last_dispatch_compiled, metrics))

    state = train(name="t", batch_size=2, num_steps=len(batches) - 1,
                  SAVE_FREQ=1000, checkpoint_dir=str(tmp_path / "ckpt"),
                  resume=False, construction="rectified", device="cpu",
                  run_dir=str(tmp_path / "runs"), on_step=on_step, **kw)
    return state, seen


def test_train_keys_follow_jax_pick_step(tmp_path, monkeypatch, small_raft):
    """A new key exactly where the JAX package compiles a step: a rectified
    plan where its ``_rect_steps`` grows, the exact construction at the
    first batch the planner rejects; the key carries the batch's shapes."""
    batches = [stream_batch(s, f) for s, f in (
        (1.0, False), (1.0, False), (1.0, True), (3.0, False), (1.0, False),
        (1.0, True), (0.5, False), (3.0, False))]
    state, seen = run_train(tmp_path, monkeypatch, batches)
    want = jax_pick_step_keys(batches)
    assert [c for _, c in want] == [True, False, True, True, False, False,
                                    True, False]
    assert len(seen) == len(want) == state.step
    shapes = tuple((tuple(b.shape), torch.float32) for b in
                   batch_to_device(batches[0], "cpu").values())
    for (key, compiled, m), (jkey, jcompiled) in zip(seen, want):
        assert key[0] == shapes
        assert compiled == jcompiled
        if jkey is None:
            assert key[1] is None
        else:
            assert dataclasses.asdict(key[1]) == dataclasses.asdict(jkey)
        assert np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"])
    assert len(state.runner._steps) == 4  # three plans and the exact step


def test_train_on_the_cpu_equals_direct_train_steps(tmp_path, monkeypatch,
                                                    small_raft):
    """On the CPU train() runs each step eagerly: the weights, AdamW's state
    and the metrics equal those of direct train_step calls with the same
    curriculum weights and constructions; its log reads the schedule."""
    batches = [stream_batch(s, f, seed=i) for i, (s, f) in enumerate(
        ((1.0, False), (1.0, True), (1.0, False)))]
    state, seen = run_train(tmp_path, monkeypatch, batches, log_every=2)

    direct = init_state(RAFT(generator=torch.Generator().manual_seed(1234),
                             device="cpu"), num_steps=len(batches) - 1)
    cache = PlanCache()
    for i, (batch, (key, _, m)) in enumerate(zip(batches, seen)):
        plan = plan_batch(batch, 4)
        plan = cache.key_for(plan) if plan.ok else None
        assert plan == key[1]
        got = train_step(direct, batch_to_device(batch, "cpu"),
                         i / (len(batches) - 1),
                         volume_fn=None if plan is None
                         else RectifiedVolume(plan))
        assert got == m
    assert direct.step == state.step == len(batches)
    for a, b in zip(state.model.parameters(), direct.model.parameters()):
        assert torch.equal(a, b)
    for p, q in zip(state.model.parameters(), direct.model.parameters()):
        sa, sb = state.optimizer.state[p], direct.optimizer.state[q]
        assert sa.keys() == sb.keys()
        for k in sa:
            assert torch.equal(sa[k], sb[k]), k
    assert (state.optimizer.param_groups[0]["lr"]
            == direct.optimizer.param_groups[0]["lr"])
    log = [json.loads(x) for x in (tmp_path / "runs" / "t" / "metrics.jsonl")
           .read_text().splitlines()]
    schedule = one_cycle_linear(2.5e-4, len(batches) - 1 + 100)
    assert log and all(r["lr"] == schedule(r["step"]) for r in log)


def test_restore_loads_in_place(tmp_path, small_raft):
    """A restore copies into the tensors the state holds (a captured step
    reads them at their addresses) and the state then steps as the saved
    one did."""
    batch = batch_to_device(stream_batch(1.0, seed=4), "cpu")
    state = init_state(RAFT(device="cpu"), num_steps=10)
    mgr = CheckpointManager(tmp_path / "ckpt", save_interval=2)
    assert mgr.maybe_save(state, force=True)  # step 0: no AdamW state yet
    first = train_step(init_state(RAFT(device="cpu"), num_steps=10), batch,
                       0.5)
    for _ in range(2):
        train_step(state, batch, 0.5)
    assert mgr.maybe_save(state)
    saved = copy.deepcopy((list(state.model.parameters()),
                           state.optimizer.state_dict()))
    fresh = mgr.restore(init_state(RAFT(generator=torch.Generator()
                                        .manual_seed(1), device="cpu"), 10))
    after_save = train_step(fresh, batch, 0.5)
    train_step(state, batch, 0.5)
    params = list(state.model.parameters())
    held = {id(p): dict(state.optimizer.state[p]) for p in params}
    mgr.restore(state)
    assert state.step == 2
    for i, (p, q) in enumerate(zip(params, saved[0])):
        assert torch.equal(p, q)
        assert held[id(p)].keys() == state.optimizer.state[p].keys()
        for k, t in held[id(p)].items():
            assert state.optimizer.state[p][k] is t
            assert torch.equal(t, saved[1]["state"][i][k]), k
    assert train_step(state, batch, 0.5) == after_save
    # a checkpoint of another implementation (a CUDA run's capturable
    # AdamW) keeps the state's own flags
    other = copy.deepcopy(torch.load(mgr._path(2)))
    for g in other["optimizer"]["param_groups"]:
        g.update(capturable=True, foreach=True)
    load_state(state, other)
    group = state.optimizer.param_groups[0]
    assert not group["capturable"] and group["foreach"] is None
    # a checkpoint without AdamW state: the held moments and step counts
    # are zeroed in place, as a fresh optimizer's, and the state steps as
    # a fresh one
    mgr.restore(state, step=0)
    assert state.step == 0
    for p in params:
        for k, t in held[id(p)].items():
            assert state.optimizer.state[p][k] is t
            assert not t.any()
    assert train_step(state, batch, 0.5) == first

"""The port's training pieces against the JAX package's on the CPU: the
sequence loss, the OneCycle schedule, AdamW with global-norm clipping
against optax over several steps, the ground-truth disparity, and the
logger.

Tolerances: loss and metrics rtol 1e-5 (fp32, the same resize as matrix
products); schedule rtol 1e-6 / atol 5e-11 (JAX evaluates it in fp32,
the port in float64: near the end ``max + (min - max) * pct`` cancels in
fp32 to within 2 ulp of 2.5e-4, 3e-11); parameters after three AdamW steps rtol 1e-5 / atol 1e-7 (fp32
updates of order lr = 2.5e-4 on weights of order 1).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cermvs_tpu.training.loss import sequence_loss as j_loss
from cermvs_tpu.training.optim import fetch_optimizer as j_fetch
from cermvs_tpu.training.optim import one_cycle_linear as j_cycle
from cermvs_tpu.training.step import disp_ground_truth as j_disp_gt
from cermvs_torch import config as pcfg
from cermvs_torch.training.loss import sequence_loss
from cermvs_torch.training.optim import (clip_by_global_norm, fetch_optimizer,
                                         global_norm, one_cycle_linear)
from cermvs_torch.training.step import disp_ground_truth
from cermvs_torch.utils.logger import Logger


@pytest.mark.parametrize("gw", [0.0, 0.3, 1.0])
def test_sequence_loss_matches_jax(rng, gw):
    T, B, h, w, H, W = 3, 2, 4, 6, 8, 12
    est = rng.rand(T, B, h, w).astype(np.float32) * 0.2 + 1e-3
    gt = rng.rand(B, H, W).astype(np.float32) * 0.2
    gt[gt < 0.05] = 0.0  # invalid holes
    lj, mj = j_loss(jnp.asarray(est), jnp.asarray(gt), gw)
    lp, mp = sequence_loss(torch.from_numpy(est), torch.from_numpy(gt), gw)
    np.testing.assert_allclose(float(lp), float(lj), rtol=1e-5)
    assert set(mp) == set(mj)
    for k in mp:
        np.testing.assert_allclose(float(mp[k]), float(mj[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)


def test_sequence_loss_gradient_matches_jax(rng):
    est = rng.rand(3, 2, 4, 6).astype(np.float32) * 0.2 + 1e-3
    gt = rng.rand(2, 8, 12).astype(np.float32) * 0.2
    gt[gt < 0.05] = 0.0
    gj = jax.grad(lambda e: j_loss(e, jnp.asarray(gt), 0.4)[0])(
        jnp.asarray(est))
    t = torch.from_numpy(est).requires_grad_(True)
    sequence_loss(t, torch.from_numpy(gt), 0.4)[0].backward()
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(gj), rtol=1e-5,
                               atol=1e-9)


@pytest.mark.parametrize("total,pct", [(150, 0.001), (1000, 0.01),
                                       (216190, 0.001)])
def test_one_cycle_matches_jax(total, pct):
    ours = one_cycle_linear(2.5e-4, total, pct)
    theirs = j_cycle(2.5e-4, total, pct)
    steps = sorted({0, 1, 2, 5, int(pct * total), total // 2, total - 2,
                    total - 1, total + 3})
    np.testing.assert_allclose([ours(s) for s in steps],
                               [float(theirs(s)) for s in steps], rtol=1e-6,
                               atol=5e-11)


def test_disp_ground_truth():
    depths = np.array([[[[2.0, 0.0], [4.0, 0.5]]], [[[1.0, 1.0], [0.0, 8.0]]]],
                      np.float32)
    gt = disp_ground_truth(torch.from_numpy(depths)).numpy()
    np.testing.assert_allclose(gt[0], [[0.5, 0.0], [0.25, 2.0]])
    np.testing.assert_allclose(gt[1], [[1.0, 1.0], [0.0, 0.125]])
    np.testing.assert_array_equal(gt, np.asarray(j_disp_gt(depths)))


def test_clip_scales_only_above_the_limit():
    g = [torch.full((4,), 3.0), torch.full((3,), 0.0)]
    norm = clip_by_global_norm(g, 1.0)
    assert float(norm) == pytest.approx(6.0)
    np.testing.assert_allclose(float(global_norm(g)), 1.0, rtol=1e-6)
    small = [torch.tensor([0.3, 0.4])]
    clip_by_global_norm(small, 1.0)
    assert torch.equal(small[0], torch.tensor([0.3, 0.4]))
    # optax's clip has no epsilon; torch's clip_grad_norm_ divides by
    # norm + 1e-6
    a = [torch.tensor([2.0])]
    clip_by_global_norm(a, 1.0)
    assert float(a[0]) == 1.0


@pytest.mark.parametrize("clip_norm", [None, 0.5])
def test_adamw_with_clip_matches_optax(rng, clip_norm):
    """Three steps of the port's AdamW, LambdaLR and clip against optax's
    clip_by_global_norm + adamw chain on the same gradients (one step's
    gradients above the clip limit, the others below), at the default
    bound and at ``optimizer.clip_norm = 0.5`` bound in the port's
    configuration (the second step's gradients, of norm ~0.2-0.7, then
    clip too or not at all, as in optax)."""
    shapes = {"a": (5, 3), "b": (7,)}
    p0 = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.randn(*s) * scale).astype(np.float32)
              for k, s in shapes.items()} for scale in (2.0, 0.05, 0.3)]
    tx, _ = j_fetch(num_steps=40, clip_norm=clip_norm or 1.0)
    pj = {k: jnp.asarray(v) for k, v in p0.items()}
    opt_state = tx.init(pj)
    params = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
              for k, v in p0.items()}
    pcfg.clear_config()
    if clip_norm is not None:
        pcfg.parse_config([f"optimizer.clip_norm = {clip_norm}"])
    try:
        opt, sched, clip, schedule = fetch_optimizer(list(params.values()),
                                                     num_steps=40)
    finally:
        pcfg.clear_config()
    assert clip == (clip_norm or 1.0)
    for g in grads:
        upd, opt_state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                   opt_state, pj)
        pj = optax.apply_updates(pj, upd)
        for k, p in params.items():
            p.grad = torch.from_numpy(g[k].copy())
        norm = clip_by_global_norm([p.grad for p in params.values()], clip)
        np.testing.assert_allclose(
            float(norm), float(optax.global_norm(g)), rtol=1e-6)
        opt.step()
        sched.step()
        # the host schedule train()'s logger reads is the scheduler's
        assert opt.param_groups[0]["lr"] == pytest.approx(
            schedule(sched.last_epoch), rel=1e-12)
    for k in p0:
        np.testing.assert_allclose(params[k].detach().numpy(),
                                   np.asarray(pj[k]), rtol=1e-5, atol=1e-7)
        assert np.abs(params[k].detach().numpy() - p0[k]).max() > 1e-4


def test_logger_writes_running_means(tmp_path, capsys):
    log = Logger("run", run_dir=str(tmp_path), SUM_FREQ=3,
                 lr_fn=lambda s: 1e-4)
    for i in range(5):
        log.push({"loss": float(i), "epe": 2.0})
    log.close()
    recs = [json.loads(x) for x in
            (tmp_path / "run" / "metrics.jsonl").read_text().splitlines()]
    # flushed after steps 2 and 5 (step % SUM_FREQ == SUM_FREQ - 1), each
    # time the running sums over SUM_FREQ
    assert [r["step"] for r in recs] == [2, 5]
    assert recs[0]["loss"] == pytest.approx((0 + 1) / 3)
    assert recs[1]["loss"] == pytest.approx((2 + 3 + 4) / 3)
    assert recs[0]["lr"] == 1e-4
    assert "Training Metrics (2)" in capsys.readouterr().out

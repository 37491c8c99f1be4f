"""One train step of the port (``training.step.train_step``) against the JAX
package's ``make_train_step`` on the CPU, through the exact and through the
rectified construction (the JAX epiband kernels interpreted, the port's
plain versions): the same batch, the same weights, the same AdamW.

Batches: ``tests/test_training.py``'s ``_tiny_batch`` (exact) and
``tests/test_train_rectified.py``'s ``_batches`` (rectified), B = 2, 3
views. Weights: the port's seeded init with the delta heads damped 1e-3x,
as in ``test_torch_slice.py``, carried to JAX with ``convert_raft``; fp32
on both sides.

Tolerances: loss and metrics rtol 1e-5 and grad_norm rtol 1e-4 (fp32 sums
in another order). Each weight's gradient, before the optimizer step,
against ``jax.grad`` of the same loss: relative norm 1e-4 per leaf (the
worst leaf agrees to 6e-6: fp32 sums through the iterations in another
order). The fnet conv biases ahead of an instance norm have a gradient that
is zero but for rounding (~1e-12 of the global norm on both sides); they
are held under 1e-9 of the global norm instead. Parameters after the step atol 1e-6: a first AdamW step
moves every weight by about lr = 2.5e-4 (``g / (|g| + eps)``), the two agree
to 1.9e-7 (fp32 rounding of weights of order 0.1-1, and the Adam ratio of
gradients near eps = 1e-8), and 1e-6 is 0.4% of an update.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cermvs_tpu.models.raft import RAFT as JRAFT
from cermvs_tpu.ops import rectify as jrect
from cermvs_tpu.ops.corr_rectified import (
    make_rectified_volume_fn as j_rect_fn)
from cermvs_tpu.training.loss import sequence_loss as j_sequence_loss
from cermvs_tpu.training.optim import fetch_optimizer as j_fetch
from cermvs_tpu.training.step import TrainState as JState
from cermvs_tpu.training.step import disp_ground_truth as j_disp_gt
from cermvs_tpu.training.step import make_train_step
from cermvs_tpu.utils.torch_import import convert_raft
from cermvs_torch.models.raft import RAFT
from cermvs_torch.ops import rectify as prect
from cermvs_torch.ops.corr_rectified import RectifiedVolume
from cermvs_torch.training.step import batch_to_device, init_state, train_step
from test_train_rectified import _batches
from test_training import TINY, _tiny_batch


GRAD_RTOL = 1e-4  # per leaf, |g_port - g_jax| / |g_jax|
ZERO_LEAF = 1e-9  # leaves under this share of the global norm are zero


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield prefix, np.asarray(tree)


def _jax_grads(model, params, batch, gradual_weight):
    """``jax.grad`` of the loss that ``make_train_step`` differentiates."""
    def loss_fn(p):
        preds = model.apply({"params": p}, batch["images"], batch["poses"],
                            batch["intrinsics"])
        return j_sequence_loss(preds, j_disp_gt(batch["depths"]),
                               gradual_weight)[0]

    return jax.jit(jax.grad(loss_fn))(params)


def _port_grads(model):
    """The port's ``.grad`` of every weight in the JAX tree's layout (zeros
    for state that is not a parameter)."""
    named = dict(model.named_parameters())

    def grad(k, v):
        p = named.get(k)
        g = torch.zeros_like(v) if p is None or p.grad is None else p.grad
        return g.detach().numpy().copy()

    return convert_raft({k: grad(k, v)
                         for k, v in model.state_dict().items()})["params"]


def _plan(plan_fn, union, batch):
    B, _, H, W = batch["images"].shape[:4]
    intr = batch["intrinsics"].astype(np.float64).copy()
    intr[..., :2, :] /= 4  # RAFT's stride
    return union(plan_fn(batch["poses"][b].astype(np.float64), intr[b],
                         H // 4, W // 4) for b in range(B))


@pytest.mark.parametrize("construction", ["exact", "rectified"])
def test_train_step_matches_jax(construction):
    rng = np.random.RandomState(0)
    batch = (_tiny_batch(rng) if construction == "exact"
             else _batches(1)[0])
    batch = {k: np.array(v) for k, v in batch.items()}
    port = RAFT(cascade=TINY, dtype=torch.float32, device="cpu",
                generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        for i in range(len(TINY)):
            getattr(port.update_block, f"delta{i}")[2].weight.mul_(1e-3)
    params = convert_raft({k: v.numpy().copy()
                           for k, v in port.state_dict().items()})["params"]

    kw, volume_fn = {}, None
    if construction == "rectified":
        plan_j = _plan(jrect.plan_rectification, jrect.plan_union, batch)
        plan_p = _plan(prect.plan_rectification, prect.plan_union, batch)
        assert dataclasses.asdict(plan_j) == dataclasses.asdict(plan_p)
        assert plan_p.ok and plan_p.twopass
        kw["volume_fn"] = j_rect_fn(plan_j)
        volume_fn = RectifiedVolume(plan_p)
    tx, _ = j_fetch(num_steps=50)
    jmodel = JRAFT(cascade=TINY, dtype=jnp.float32, **kw)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    gj = _jax_grads(jmodel, params, jbatch, 0.5)
    jstep = make_train_step(jmodel, tx, donate=False)
    js, mj = jstep(JState(jnp.zeros((), jnp.int32), params, tx.init(params)),
                   jbatch, 0.5)

    state = init_state(port, num_steps=50)
    mp = train_step(state, batch_to_device(batch, "cpu"), 0.5,
                    volume_fn=volume_fn)
    assert state.step == int(js.step) == 1
    assert set(mp) == set(mj)
    for k in mp:
        tol = 1e-4 if k == "grad_norm" else 1e-5
        np.testing.assert_allclose(mp[k], float(mj[k]), rtol=tol, atol=1e-7,
                                   err_msg=k)
    # each leaf's gradient: the port's after its clip, JAX's clipped alike
    gnorm = float(mj["grad_norm"])
    clip = min(1.0, 1.0 / gnorm)
    errs = {}
    for (path, a), (path_p, b) in zip(_leaves(gj), _leaves(_port_grads(port))):
        assert path == path_p
        a = a * clip
        if np.linalg.norm(a) < ZERO_LEAF * gnorm * clip:
            # a conv bias ahead of an instance norm: zero but for rounding
            assert np.linalg.norm(b) < ZERO_LEAF * gnorm * clip, path
            continue
        errs["/".join(path)] = float(np.linalg.norm(b - a)
                                     / np.linalg.norm(a))
    worst = max(errs, key=errs.get)
    assert len(errs) > 40 and errs[worst] < GRAD_RTOL, (worst, errs[worst])
    new = convert_raft({k: v.detach().numpy().copy()
                        for k, v in port.state_dict().items()})["params"]
    moved = 0.0
    for (path, a), (_, b), (_, o) in zip(_leaves(js.params), _leaves(new),
                                         _leaves(params)):
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-6,
                                   err_msg="/".join(path))
        moved = max(moved, float(np.abs(b - o).max()))
    assert moved > 1e-4  # the step moved the weights by about lr

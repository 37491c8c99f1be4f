"""The fused pyramid lookup: the port's plain versions against the JAX
package's Pallas kernels (``ops/pallas/lookup.py`` forward and custom VJP,
``ops/pallas/lookup_v2.py``), run in interpret mode on the CPU as
``tests/test_pallas_lookup.py`` runs them, and the RAFT forward and its
gradients with ``lookup_impl="pallas"`` against JAX's (the test-mode
forward: test_torch_raft_lookup.py). The CUDA kernels against the plain
versions: test_torch_cuda.py.

Tolerances: forward rtol 1e-5 / atol 1e-6 (banded pooling against JAX's
dense one-hot sums: the same products in another order); gradient rtol
1e-4 / atol 1e-5; the prefix-sum variant rtol / atol 2e-3, JAX's own
(prefix-sum differences lose low bits to cancellation). RAFT: the
tolerances of test_torch_train_step.py (gradients, relative norm per
leaf).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from cermvs_tpu.models.raft import RAFT as JRAFT
from cermvs_tpu.ops import corr as jcorr
from cermvs_tpu.ops.pallas.lookup import lookup_fused as j_fused
from cermvs_tpu.ops.pallas.lookup_v2 import lookup_fused_v2 as j_fused_v2
from cermvs_tpu.utils.torch_import import convert_raft
from cermvs_torch.models.raft import RAFT
from cermvs_torch.ops import corr as pcorr
from cermvs_torch.ops import cudalib
from cermvs_torch.ops import lookup as lk
from cermvs_torch.training.loss import sequence_loss
from cermvs_torch.training.step import disp_ground_truth
from test_torch_train_step import (GRAD_RTOL, ZERO_LEAF, _jax_grads,
                                   _leaves, _port_grads)
from test_training import TINY, _tiny_batch

FWD = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-5)
V2 = dict(rtol=2e-3, atol=2e-3)


@pytest.fixture
def interpret():
    with pltpu.force_tpu_interpret_mode():
        yield


def _t(a):
    return torch.from_numpy(np.array(a))


def _inputs(rng, D, shape=(1, 2, 6, 8)):
    """A volume and indices below 0 (clamped to 0 as the caller does),
    inside, and past D, where every cell of a tap is outside."""
    corr = rng.randn(*shape, D).astype(np.float32)
    x0 = np.maximum(rng.rand(*shape).astype(np.float32) * (D + 16) - 4, 0)
    x0.reshape(-1)[:3] = [0.0, D - 1.0, D + 40.0]
    return corr, x0


@pytest.mark.parametrize("D", [64, 44])
def test_lookup_fused_matches_jax(rng, interpret, D):
    corr, x0 = _inputs(rng, D)
    j = np.asarray(j_fused(jnp.asarray(corr), jnp.asarray(x0), 5, 3))
    before = dict(cudalib.launches)
    p = lk.lookup_fused(_t(corr), _t(x0), 5, 3).numpy()
    assert cudalib.launches == before  # CPU tensors: the plain version
    assert p.shape == j.shape == corr.shape[:-1] + (33,)
    np.testing.assert_allclose(p, j, **FWD)
    # and the taps of the materialized pyramid (JAX's banded lookup)
    banded = np.asarray(jcorr._lookup_banded(
        jcorr.build_pyramid(jnp.asarray(corr), 3), jnp.asarray(x0), 5))
    np.testing.assert_allclose(p, banded, **FWD)


@pytest.mark.parametrize("D,radius,levels", [(64, 5, 3), (44, 5, 3),
                                             (16, 2, 2)])
def test_lookup_fused_gradient_matches_jax(rng, interpret, D, radius,
                                           levels):
    corr, x0 = _inputs(rng, D)
    T = levels * (2 * radius + 1)
    g = rng.randn(*x0.shape, T).astype(np.float32)

    def loss(c, x):
        return jnp.sum(j_fused(c, x, radius, levels) * g)

    jc, jx = jax.grad(loss, argnums=(0, 1))(jnp.asarray(corr),
                                             jnp.asarray(x0))
    c = _t(corr).requires_grad_()
    x = _t(x0).requires_grad_()
    (lk.lookup_fused(c, x, radius, levels) * _t(g)).sum().backward()
    np.testing.assert_allclose(c.grad.numpy(), np.asarray(jc), **GRAD)
    assert x.grad is None and not np.asarray(jx).any()  # x0: no gradient
    # the plain backward on its own
    np.testing.assert_allclose(
        lk.lookup_fused_backward(_t(g), _t(x0), D, radius, levels).numpy(),
        np.asarray(jc), **GRAD)


@pytest.mark.parametrize("D", [64, 44])
def test_lookup_fused_v2_matches_jax(rng, interpret, D):
    corr, x0 = _inputs(rng, D)
    j = np.asarray(j_fused_v2(jnp.asarray(corr), jnp.asarray(x0), 5, 3))
    p = lk.lookup_fused_v2(_t(corr), _t(x0), 5, 3).numpy()
    np.testing.assert_allclose(p, j, **V2)
    np.testing.assert_allclose(p, lk.lookup_fused(_t(corr), _t(x0)).numpy(),
                               **V2)


def test_lookup_wrappers_refuse_bad_inputs():
    corr = torch.zeros(1, 1, 4, 4, 16)
    with pytest.raises(ValueError, match="does not match"):
        lk.lookup_fused(corr, torch.zeros(1, 1, 4, 5))
    with pytest.raises(ValueError, match="D <= 128"):
        lk.lookup_fused_v2(torch.zeros(1, 1, 2, 2, 130),
                           torch.zeros(1, 1, 2, 2))
    with pytest.raises(ValueError, match="does not match"):
        lk.lookup_fused_backward(torch.zeros(1, 1, 4, 4, 32),
                                 torch.zeros(1, 1, 4, 4), 16)
    with pytest.raises(ValueError, match="num_levels"):
        lk.lookup_fused(torch.zeros(1, 1, 2, 2, 2), torch.zeros(1, 1, 2, 2),
                        5, 3)


def test_corr_lookup_pallas_reads_level0_only(rng, interpret):
    """``corr.lookup(impl="pallas")`` on a level-0 pyramid equals the banded
    lookup of the materialized one, and JAX's ``impl="pallas"``; the other
    impls refuse a pyramid that is not materialized."""
    D = 64
    vol = rng.randn(1, 1, 6, 8, D).astype(np.float32)
    origin = (rng.rand(1, 1, 6, 8) * 0.002).astype(np.float32)
    zinv = (origin + rng.uniform(-0.002, 0.004, (1, 1, 6, 8))).astype(
        np.float32)
    incre = 0.0025 / 64
    lvl0 = pcorr.CorrPyramid([_t(vol)], _t(origin), incre, D)
    full = pcorr.CorrPyramid(pcorr.build_pyramid(_t(vol)), _t(origin), incre,
                             D)
    p = pcorr.lookup(lvl0, _t(zinv), 5, "pallas").numpy()
    np.testing.assert_allclose(
        p, pcorr.lookup(full, _t(zinv), 5, "banded").numpy(), **FWD)
    jl = jcorr.CorrPyramid([jnp.asarray(vol)], jnp.asarray(origin), incre, D)
    np.testing.assert_allclose(
        p, np.asarray(jcorr.lookup(jl, jnp.asarray(zinv), 5, "pallas")),
        **FWD)
    for impl in ("banded", "gather"):
        with pytest.raises(ValueError, match="materialized"):
            pcorr.lookup(lvl0, _t(zinv), 5, impl)


def _count_levels(monkeypatch):
    """Record the pyramid depth of every lookup RAFT makes."""
    seen = []
    real = pcorr.lookup

    def spy(pyr, *a, **k):
        seen.append(len(pyr.levels))
        return real(pyr, *a, **k)

    monkeypatch.setattr(pcorr, "lookup", spy)
    return seen


def test_raft_pallas_lookup_gradients_match_jax(interpret, monkeypatch):
    """Train mode: each weight's gradient of the sequence loss, the port's
    fused lookup and its backward against ``jax.grad`` through the Pallas
    lookup's custom VJP (test_torch_train_step.py's tiny batch and damped
    weights, the exact construction)."""
    from cermvs_tpu.training.loss import sequence_loss as j_loss
    from cermvs_tpu.training.step import disp_ground_truth as j_gt

    batch = {k: np.array(v) for k, v in
             _tiny_batch(np.random.RandomState(0)).items()}
    port = RAFT(cascade=TINY, dtype=torch.float32, device="cpu",
                lookup_impl="pallas",
                generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        for i in range(len(TINY)):
            getattr(port.update_block, f"delta{i}")[2].weight.mul_(1e-3)
    params = convert_raft({k: v.numpy().copy()
                           for k, v in port.state_dict().items()})["params"]
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jmodel = JRAFT(cascade=TINY, dtype=jnp.float32, lookup_impl="pallas",
                   unroll_iters=True)
    gj = _jax_grads(jmodel, params, jbatch, 0.5)
    lj = float(j_loss(jmodel.apply({"params": params}, jbatch["images"],
                                   jbatch["poses"], jbatch["intrinsics"]),
                      j_gt(jbatch["depths"]), 0.5)[0])

    seen = _count_levels(monkeypatch)
    tb = {k: _t(v) for k, v in batch.items()}
    preds = port(tb["images"], tb["poses"], tb["intrinsics"])
    loss = sequence_loss(preds, disp_ground_truth(tb["depths"]), 0.5)[0]
    loss.backward()
    # 4 iterations' lookups, each recomputed in the backward pass under
    # RAFT.remat (the default): a level-0 slab every time
    assert seen == [1] * 8
    np.testing.assert_allclose(float(loss.detach()), lj, rtol=1e-5)
    gnorm = np.sqrt(sum(float(np.sum(a ** 2)) for _, a in _leaves(gj)))
    errs = {}
    for (path, a), (path_p, b) in zip(_leaves(gj), _leaves(_port_grads(port))):
        assert path == path_p
        if np.linalg.norm(a) < ZERO_LEAF * gnorm:
            assert np.linalg.norm(b) < ZERO_LEAF * gnorm, path
            continue
        errs["/".join(path)] = float(np.linalg.norm(b - a)
                                     / np.linalg.norm(a))
    worst = max(errs, key=errs.get)
    assert len(errs) > 40 and errs[worst] < GRAD_RTOL, (worst, errs[worst])

"""Train-mode forward of the port against the JAX package on the CPU: the
per-iteration disparity predictions (both cascade stages, four iterations)
through the exact and the rectified construction, under the weights and at
the tolerances of ``test_torch_slice.py`` (rtol 1e-3 / atol 1e-7 on
disparities of ~1e-4)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cermvs_tpu.models.raft import RAFT as JRAFT
from cermvs_tpu.ops.corr_rectified import (
    make_rectified_volume_fn as j_rect_fn)
from cermvs_tpu.ops.rectify import plan_rectification as j_plan
from cermvs_torch.ops.corr_rectified import make_rectified_volume_fn
from test_torch_slice import CASCADE, TOL, _scene, weights  # noqa: F401


@pytest.mark.parametrize("construction", ["exact", "rectified"])
def test_train_mode_predictions_match_jax(weights, construction):
    port, params = weights
    images, poses, intr = _scene(seed=1)
    args = (images[None], poses[None], intr[None])
    kw = dict(cascade=CASCADE, dtype=jnp.float32, unroll_iters=True)
    vfn_p = None
    if construction == "rectified":
        K4 = intr.copy()
        K4[:, :2] /= 4
        plan = j_plan(poses, K4, 16, 48, lambda_max=0.1)
        assert plan.ok
        kw["volume_fn"] = j_rect_fn(plan)
        vfn_p = make_rectified_volume_fn(plan)
    pj = np.asarray(JRAFT(**kw).apply(
        params, *(jnp.asarray(a) for a in args), jnp.ones(1)))
    port.test_mode = False
    try:
        with torch.no_grad():
            pp = port(*(torch.from_numpy(a) for a in args), torch.ones(1),
                      volume_fn=vfn_p).numpy()
    finally:
        port.test_mode = True
    assert pp.shape == pj.shape == (4, 1, 16, 48)
    np.testing.assert_allclose(pp, pj, **TOL)

"""RAFT's test-mode forward with ``lookup_impl="pallas"`` at full widths:
the port's fused lookup (its plain version on the CPU) against the JAX
package's Pallas lookup run in interpret mode, through the exact and the
rectified construction, under the weights, scene and tolerances of
test_torch_slice.py (rtol 1e-3 / atol 1e-7 on disparities of ~1e-4). The
lookup itself and the train-mode gradients: test_torch_lookup.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cermvs_tpu.models.raft import RAFT as JRAFT
from cermvs_tpu.ops.corr_rectified import make_rectified_volume_fn as j_rect_fn
from cermvs_tpu.ops.rectify import plan_rectification as j_plan
from cermvs_torch.ops.corr_rectified import make_rectified_volume_fn
from test_torch_lookup import _count_levels, _t, interpret  # noqa: F401
from test_torch_slice import CASCADE, TOL, _scene, weights  # noqa: F401


@pytest.mark.parametrize("construction", ["exact", "rectified"])
def test_raft_pallas_lookup_matches_jax(weights, interpret, monkeypatch,
                                        construction):
    """Test mode at full widths (test_torch_slice.py's weights and scene):
    the port's fused lookup against JAX's Pallas lookup, keeping level 0
    only."""
    port, params = weights
    images, poses, intr = _scene()
    # unrolled: the interpreted kernel's callbacks do not go through remat
    kw, vfn = dict(cascade=CASCADE, dtype=jnp.float32, lookup_impl="pallas",
                   unroll_iters=True), None
    if construction == "rectified":
        K4 = intr.copy()
        K4[:, :2] /= 4
        plan = j_plan(poses, K4, 16, 48, lambda_max=0.1)
        assert plan.ok
        kw["volume_fn"] = j_rect_fn(plan)
        vfn = make_rectified_volume_fn(plan)
    args = (images[None], poses[None], intr[None])
    dj = np.asarray(JRAFT(test_mode=True, **kw).apply(
        params, *(jnp.asarray(a) for a in args), jnp.ones(1)))
    seen = _count_levels(monkeypatch)
    port.lookup_impl, port.test_mode = "pallas", True
    try:
        with torch.no_grad():
            dp = port(*(_t(a) for a in args), torch.ones(1),
                      volume_fn=vfn).numpy()
    finally:
        port.lookup_impl, port.test_mode = "banded", False
    assert seen == [1] * 4  # 2 stages x 2 iterations, level 0 alone
    assert dp.shape == dj.shape == (1, 16, 48)
    assert np.abs(dj).max() > 1e-4
    np.testing.assert_allclose(dp, dj, **TOL)

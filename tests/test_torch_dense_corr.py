"""``ops.corr.dense_corr``, the all-pairs correlation oracle, against the
JAX package's on the CPU: fp32, rtol 1e-5 / atol 1e-5 (sums of 32 products
in another order), and against the exact construction's definition for
one pair of pixels."""

import jax.numpy as jnp
import numpy as np
import torch

from cermvs_tpu.ops.corr import dense_corr as j_dense_corr
from cermvs_torch.ops.corr import dense_corr


def test_dense_corr_matches_jax(rng):
    fmaps = rng.randn(2, 4, 5, 7, 32).astype(np.float32)
    ii, jj = np.array([0, 0, 2]), np.array([1, 3, 1])
    got = dense_corr(torch.from_numpy(fmaps), ii, jj).numpy()
    want = np.asarray(j_dense_corr(jnp.asarray(fmaps), jnp.asarray(ii),
                                   jnp.asarray(jj)))
    assert got.shape == want.shape == (2, 3, 5, 7, 5, 7)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # view 1: map 0's pixel (2, 3) against map 3's pixel (4, 1)
    pair = (fmaps[1, 0, 2, 3] / 8) @ (fmaps[1, 3, 4, 1] / 8)
    np.testing.assert_allclose(got[1, 1, 2, 3, 4, 1], pair, rtol=1e-5)

"""``norm_fn="group"`` in the port's encoders against the JAX package's on
the CPU, fp32, weights carried across with the JAX package's importer
(``convert_encoder``): the affine-free group norm itself, ``ResidualBlock``
(``planes // 8`` groups) and ``BasicEncoder`` HR and LR, whose stem norm
takes no ``planes`` and so 4 groups, as in the JAX package. RAFT builds its
encoders with the instance norm and none, so the group norm is held here,
at module level. Tolerances: the norm alone rtol 1e-5 / atol 1e-5 (fp32
sums in another order); the blocks and encoders rtol 1e-4 / atol 1e-4, as
``tests/test_torch_models.py`` holds the instance-norm encoders.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cermvs_tpu.models.extractor import BasicEncoder as JEncoder
from cermvs_tpu.models.extractor import ResidualBlock as JBlock
from cermvs_tpu.models.extractor import group_norm as j_group_norm
from cermvs_tpu.utils.torch_import import _residual_block, convert_encoder
from cermvs_torch.models.extractor import (BasicEncoder, ResidualBlock,
                                           _norm, group_norm, init_conv_)

TOL = dict(rtol=1e-4, atol=1e-4)


def _seeded(module, seed):
    """Kaiming weights and small random biases, drawn from ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    for m in module.modules():
        if isinstance(m, torch.nn.Conv2d):
            init_conv_(m, gen)
            with torch.no_grad():
                m.bias.normal_(0.0, 0.1, generator=gen)
    return module


def _sd(module, prefix):
    return {f"{prefix}.{k}": v.numpy() for k, v in module.state_dict().items()}


@pytest.mark.parametrize("shape,groups", [((2, 12, 16, 32), 4),
                                          ((1, 7, 9, 64), 8),
                                          ((3, 5, 6, 24), 3),
                                          ((1, 4, 4, 16), 1)])
def test_group_norm_matches_jax(rng, shape, groups):
    x = (rng.randn(*shape) * 3 + 1).astype(np.float32)
    got = group_norm(torch.from_numpy(x), groups).numpy()
    want = np.asarray(j_group_norm(jnp.asarray(x), groups))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # each group of each sample normalized: mean 0, variance 1
    g = got.reshape(shape[0], -1, groups, shape[-1] // groups)
    np.testing.assert_allclose(g.mean(axis=(1, 3)), 0.0, atol=1e-5)
    np.testing.assert_allclose(g.var(axis=(1, 3)), 1.0, rtol=1e-3)
    x16 = torch.from_numpy(x).to(torch.bfloat16)
    assert group_norm(x16, groups).dtype == torch.bfloat16


def test_group_norm_groups_follow_planes():
    assert _norm("group").keywords["num_groups"] == 4
    assert _norm("group", 64).keywords["num_groups"] == 8
    assert _norm("group", 4).keywords["num_groups"] == 1
    with pytest.raises(ValueError, match="instance/group/none"):
        _norm("batch")


@pytest.mark.parametrize("in_planes,planes,stride", [(32, 32, 1),
                                                     (32, 64, 2),
                                                     (16, 24, 2)])
def test_residual_block_matches_jax(rng, in_planes, planes, stride):
    block = _seeded(ResidualBlock(in_planes, planes, "group", stride), 1)
    params = _residual_block(_sd(block, "b"), "b", stride != 1)
    x = rng.randn(2, 14, 18, in_planes).astype(np.float32)
    want = JBlock(planes, "group", stride, jnp.float32).apply(
        {"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got = block(torch.from_numpy(x), torch.float32).numpy()
    assert got.shape == (2, 14 // stride, 18 // stride, planes)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


@pytest.mark.parametrize("enc_type", ["HR", "LR"])
def test_basic_encoder_matches_jax(rng, enc_type):
    enc = _seeded(BasicEncoder(96, "group", enc_type, torch.float32), 2)
    params = convert_encoder(_sd(enc, "fnet"), "fnet", enc_type)
    x = rng.randn(2, 40, 56, 3).astype(np.float32)
    want = JEncoder(96, "group", enc_type, jnp.float32).apply(
        {"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got = enc(torch.from_numpy(x)).numpy()
    f = 4 if enc_type == "HR" else 8
    assert got.shape == (2, 40 // f, 56 // f, 96)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)

"""The port's network modules against the flax modules on the CPU, under the
same weights: flax parameters initialised by the JAX package are carried into
the port by ``load_jax_params``. fp32 on both sides; rtol 1e-4 / atol 1e-4
(convolutions summed in a different order).

Also the weight bridge itself: the port's module names are the reference
``state_dict`` keys, so the JAX package's importer ``convert_raft`` maps a
port ``state_dict`` onto exactly the tree of ``cermvs_tpu`` ``RAFT().init``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cermvs_tpu.models.extractor import BasicEncoder as JEncoder
from cermvs_tpu.models.raft import RAFT as JRAFT
from cermvs_tpu.models.update import ConvGRU as JConvGRU
from cermvs_tpu.models.update import UpdateBlock as JUpdateBlock
from cermvs_tpu.models.update import disp_context as j_disp_context
from cermvs_tpu.utils.torch_import import convert_raft
from cermvs_torch.models.raft import RAFT
from cermvs_torch.models.update import disp_context
from cermvs_torch.utils.weights import (jax_params_to_state_dict,
                                        load_jax_params,
                                        load_reference_checkpoint)

CASCADE = ((8, 64, 2), (-1, 320, 2))
TOL = dict(rtol=1e-4, atol=1e-4)


def _t(a):
    return torch.from_numpy(np.array(a))


def _flax_tree(enc_type):
    """A full RAFT parameter tree, initialised submodule by submodule by the
    JAX package (fp32), as numpy arrays."""
    rng = np.random.RandomState(3)
    key = jax.random.PRNGKey(7)
    k1, k2, k3 = jax.random.split(key, 3)
    x = jnp.asarray(rng.randn(1, 32, 32, 3).astype(np.float32))
    fnet = JEncoder(64, "instance", enc_type, jnp.float32).init(k1, x)
    cnet = JEncoder(128, "none", enc_type, jnp.float32).init(k2, x)
    ub = JUpdateBlock(cascade=CASCADE, dtype=jnp.float32).init(
        k3, jnp.zeros((1, 4, 4, 64)), jnp.zeros((1, 4, 4, 64)),
        jnp.zeros((1, 4, 4, 1)), jnp.zeros((1, 1, 4, 4, 33)), 0)
    tree = {"params": {"fnet": fnet["params"], "cnet": cnet["params"],
                       "update_block": ub["params"]}}
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def hr():
    tree = _flax_tree("HR")
    port = load_jax_params(
        RAFT(cascade=CASCADE, dtype=torch.float32, device="cpu"), tree)
    return tree, port


@pytest.mark.parametrize("enc", ["fnet", "cnet"])
@pytest.mark.parametrize("enc_type", ["HR", "LR"])
def test_encoder(hr, rng, enc, enc_type):
    if enc_type == "HR":
        tree, port = hr
    else:
        tree = _flax_tree("LR")
        port = load_jax_params(RAFT(cascade=CASCADE, encoder_type="LR",
                                    dtype=torch.float32, device="cpu"), tree)
    x = rng.randn(2, 40, 56, 3).astype(np.float32)
    dim, norm = (64, "instance") if enc == "fnet" else (128, "none")
    j = JEncoder(dim, norm, enc_type, jnp.float32).apply(
        {"params": tree["params"][enc]}, jnp.asarray(x))
    with torch.no_grad():
        p = getattr(port, enc)(_t(x)).numpy()
    f = 4 if enc_type == "HR" else 8
    assert p.shape == (2, 40 // f, 56 // f, dim)
    np.testing.assert_allclose(p, np.asarray(j), **TOL)


def test_conv_gru(hr, rng):
    tree, port = hr
    gru = JConvGRU(h_planes=64, static_planes=64, dyn_planes=49 + 64,
                   dtype=jnp.float32)
    params = {"params": tree["params"]["update_block"]["gru"]}
    net = rng.randn(1, 6, 9, 64).astype(np.float32)
    inp = rng.rand(1, 6, 9, 64).astype(np.float32)
    dyn = rng.randn(1, 6, 9, 113).astype(np.float32)
    ctx_j = gru.apply(params, jnp.asarray(inp), method=JConvGRU.ctx)
    out_j = gru.apply(params, jnp.asarray(net), jnp.asarray(dyn), ctx_j)
    with torch.no_grad():
        ctx_p = port.update_block.gru.ctx(_t(inp))
        out_p = port.update_block.gru(_t(net), _t(dyn), ctx_p)
    np.testing.assert_allclose(ctx_p.numpy(), np.asarray(ctx_j), **TOL)
    np.testing.assert_allclose(out_p.numpy(), np.asarray(out_j), **TOL)


def test_disp_context(rng):
    d = rng.randn(2, 5, 9, 1).astype(np.float32)
    np.testing.assert_array_equal(disp_context(_t(d)).numpy(),
                                  np.asarray(j_disp_context(jnp.asarray(d))))


@pytest.mark.parametrize("stage", [0, 1])
@pytest.mark.parametrize("hoisted", [False, True])
def test_update_block(hr, rng, stage, hoisted):
    tree, port = hr
    ub = JUpdateBlock(cascade=CASCADE, dtype=jnp.float32)
    params = {"params": tree["params"]["update_block"]}
    net = rng.randn(1, 6, 9, 64).astype(np.float32)
    inp = rng.rand(1, 6, 9, 64).astype(np.float32)
    disp = (rng.rand(1, 6, 9, 1) * 0.01).astype(np.float32)
    corr = rng.randn(1, 3, 6, 9, 33).astype(np.float32)
    gctx_j = (ub.apply(params, jnp.asarray(inp), stage,
                       method=JUpdateBlock.gru_ctx) if hoisted else None)
    nj, dj = ub.apply(params, jnp.asarray(net), jnp.asarray(inp),
                      jnp.asarray(disp), jnp.asarray(corr), stage,
                      gru_ctx=gctx_j)
    with torch.no_grad():
        gctx_p = port.update_block.gru_ctx(_t(inp), stage) if hoisted else None
        np_, dp = port.update_block(_t(net), _t(inp), _t(disp), _t(corr),
                                    stage, gru_ctx=gctx_p)
    np.testing.assert_allclose(np_.numpy(), np.asarray(nj), **TOL)
    np.testing.assert_allclose(dp.numpy(), np.asarray(dj), rtol=1e-4,
                               atol=1e-6)


@pytest.mark.parametrize("enc_type", ["HR", "LR"])
def test_convert_raft_round_trip_tree(enc_type):
    """convert_raft(port.state_dict()) has exactly the tree and shapes of
    the JAX RAFT().init (evaluated abstractly)."""
    port = RAFT(cascade=CASCADE, encoder_type=enc_type, dtype=torch.float32,
                device="cpu")
    tree = convert_raft({k: v.numpy() for k, v in port.state_dict().items()},
                        encoder_type=enc_type)
    jm = JRAFT(cascade=CASCADE, encoder_type=enc_type, dtype=jnp.float32)
    n, H, W = 3, 32, 48
    ref = jax.eval_shape(
        jm.init, jax.random.PRNGKey(0), jnp.zeros((1, n, H, W, 3)),
        jnp.zeros((1, n, 4, 4)), jnp.zeros((1, n, 3, 3)), jnp.ones(1))
    shapes = lambda t: jax.tree_util.tree_map(lambda a: tuple(a.shape), t)
    assert (jax.tree_util.tree_structure(shapes(tree))
            == jax.tree_util.tree_structure(shapes(ref)))
    assert shapes(tree) == shapes(ref)


def test_load_jax_params_is_exact_inverse():
    port = RAFT(cascade=CASCADE, dtype=torch.float32, device="cpu",
                generator=torch.Generator().manual_seed(5))
    sd = port.state_dict()
    tree = convert_raft({k: v.numpy() for k, v in sd.items()})
    back = jax_params_to_state_dict(tree)
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k
    fresh = load_jax_params(
        RAFT(cascade=CASCADE, dtype=torch.float32, device="cpu"), tree)
    for k, v in fresh.state_dict().items():
        assert torch.equal(v, sd[k]), k


@pytest.mark.parametrize("prefix", ["", "module."])
def test_load_reference_checkpoint(tmp_path, prefix):
    src = RAFT(cascade=CASCADE, device="cpu",
               generator=torch.Generator().manual_seed(2))
    path = tmp_path / "ckpt.pth"
    torch.save({prefix + k: v for k, v in src.state_dict().items()}, path)
    dst = load_reference_checkpoint(path, RAFT(cascade=CASCADE, device="cpu"))
    for k, v in src.state_dict().items():
        assert torch.equal(dst.state_dict()[k], v), k


def test_seeded_init_is_reproducible():
    def init(seed):
        return RAFT(device="cpu",
                    generator=torch.Generator().manual_seed(seed)).state_dict()

    a, b, c = init(11), init(11), init(12)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["fnet.conv1.weight"], c["fnet.conv1.weight"])

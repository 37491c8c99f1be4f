"""``RAFT.remat`` and ``RAFT.encoder_chunk`` in training, on the CPU.

``remat=True`` (the default, as in the JAX package) recomputes the context
encoder, each feature-encoder chunk and each GRU iteration in the backward
pass (``torch.utils.checkpoint``, non-reentrant). It must change no value:
the loss and every weight's gradient equal ``remat=False``'s bit for bit,
through the exact and the rectified construction and through the banded and
the fused lookup (its plain version here). It must also take effect: the
forward keeps less for the backward (the bytes autograd saves outside the
recomputed regions).

``encoder_chunk`` (frames per feature-encoder call; None: 8 in training)
splits the frames, the last chunk shorter: one call per chunk. Against
JAX's ``jax.grad`` under the same binding (which pads its last chunk with
zero frames), loss rtol 1e-5 and each weight's gradient 1e-4 of its norm, as
``tests/test_torch_train_step.py`` holds the default.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cermvs_tpu import config as jcfg
from cermvs_tpu.models.raft import RAFT as JRAFT
from cermvs_tpu.training.loss import sequence_loss as j_sequence_loss
from cermvs_tpu.training.step import disp_ground_truth as j_disp_gt
from cermvs_tpu.utils.torch_import import convert_raft
from cermvs_torch import config as pcfg
from cermvs_torch.models.raft import RAFT
from cermvs_torch.ops import rectify as prect
from cermvs_torch.ops.corr_rectified import RectifiedVolume
from cermvs_torch.training.loss import sequence_loss
from cermvs_torch.training.step import batch_to_device, disp_ground_truth
from test_torch_train_step import (GRAD_RTOL, ZERO_LEAF, _leaves, _plan,
                                   _port_grads)
from test_train_rectified import _batches
from test_training import TINY, _tiny_batch


def _batch(construction, N=3):
    rng = np.random.RandomState(0)
    batch = (_tiny_batch(rng, N=N) if construction == "exact"
             else _batches(1)[0])
    return {k: np.array(v) for k, v in batch.items()}


def _model(**kw):
    model = RAFT(cascade=TINY, dtype=torch.float32, device="cpu",
                 generator=torch.Generator().manual_seed(0), **kw)
    with torch.no_grad():
        for i in range(len(TINY)):
            getattr(model.update_block, f"delta{i}")[2].weight.mul_(1e-3)
    return model


def _loss_and_grads(model, batch, volume_fn=None):
    """One training forward and backward: the loss, every weight's
    gradient by name, and the bytes autograd saved for the backward
    outside the recomputed regions."""
    b = batch_to_device(batch, "cpu")
    saved = []

    def pack(t):
        saved.append(t.numel() * t.element_size())
        return t

    model.train()
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        preds = model(b["images"], b["poses"], b["intrinsics"],
                      volume_fn=volume_fn)
        loss, _ = sequence_loss(preds, disp_ground_truth(b["depths"]), 0.5)
    model.zero_grad(set_to_none=True)
    loss.backward()
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    return loss.detach(), grads, sum(saved)


def _rect_volume(batch):
    plan = _plan(prect.plan_rectification, prect.plan_union, batch)
    assert plan.ok and plan.twopass
    return RectifiedVolume(plan)


@pytest.mark.parametrize("lookup_impl", ["banded", "pallas"])
@pytest.mark.parametrize("construction", ["exact", "rectified"])
def test_remat_changes_no_value(construction, lookup_impl):
    batch = _batch(construction)
    vol = _rect_volume(batch) if construction == "rectified" else None
    out = {}
    for remat in (True, False):
        model = _model(remat=remat, lookup_impl=lookup_impl)
        assert model.remat is remat
        out[remat] = _loss_and_grads(model, batch, vol)
    (la, ga, saved_remat), (lb, gb, saved_all) = out[True], out[False]
    assert torch.isfinite(la) and float(la) > 0
    assert torch.equal(la, lb)
    assert sorted(ga) == sorted(gb) and len(ga) > 40
    for name in ga:
        assert torch.equal(ga[name], gb[name]), name
    assert sum(float(g.abs().sum()) > 0 for g in ga.values()) > 40
    # the recomputed regions keep nothing for the backward pass
    assert saved_remat < 0.5 * saved_all, (saved_remat, saved_all)


@pytest.fixture
def bindings():
    pcfg.clear_config()
    yield lambda flag: pcfg.parse_config([flag])
    pcfg.clear_config()


@pytest.mark.parametrize("flag", ["RAFT.remat = False"])
def test_remat_binding_reaches_the_model(bindings, flag):
    """The binding as a gin file or ``-p`` flag gives it: the model built
    under it does not recompute, and its training loss and gradients are
    those of the default (``remat=True``) bit for bit."""
    batch = _batch("exact")
    want_loss, want, _ = _loss_and_grads(_model(), batch)
    bindings(flag)
    model = _model()
    assert model.remat is False
    loss, got, _ = _loss_and_grads(model, batch)
    assert torch.equal(loss, want_loss)
    for name in want:
        assert torch.equal(got[name], want[name]), name


def _jax_loss_and_grads(params, batch, encoder_chunk):
    jcfg.clear_config()
    if encoder_chunk is not None:
        jcfg.parse_config([f"RAFT.encoder_chunk = {encoder_chunk}"])
    try:
        model = JRAFT(cascade=TINY, dtype=jnp.float32)
    finally:
        jcfg.clear_config()
    assert model.encoder_chunk == encoder_chunk and model.remat
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(p):
        preds = model.apply({"params": p}, jb["images"], jb["poses"],
                            jb["intrinsics"])
        return j_sequence_loss(preds, j_disp_gt(jb["depths"]), 0.5)[0]

    return jax.jit(jax.value_and_grad(loss_fn))(params)


@pytest.mark.parametrize("encoder_chunk", [None, 1, 3])
def test_encoder_chunk_in_training_matches_jax(bindings, encoder_chunk):
    """8 frames (B = 2, 4 views): one feature-encoder call (None: 8),
    eight, or three of 3, 3 and 2; the port against JAX under the same
    binding."""
    batch = _batch("exact", N=4)
    if encoder_chunk is not None:
        bindings(f"RAFT.encoder_chunk = {encoder_chunk}")
    model = _model()
    assert model.encoder_chunk == encoder_chunk
    calls = []
    model.fnet.register_forward_pre_hook(
        lambda m, args: calls.append(args[0].shape[0]))
    params = convert_raft({k: v.numpy().copy()
                           for k, v in model.state_dict().items()})["params"]
    loss, _, _ = _loss_and_grads(model, batch)
    # each chunk's call, then its recomputation in the backward pass
    chunk = encoder_chunk or 8
    per_pass = [min(chunk, 8 - i) for i in range(0, 8, chunk)]
    assert calls[:len(per_pass)] == per_pass
    assert sorted(calls) == sorted(per_pass * 2)
    jloss, gj = _jax_loss_and_grads(params, batch, encoder_chunk)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    gnorm = np.sqrt(sum(float((np.asarray(g) ** 2).sum())
                        for _, g in _leaves(gj)))
    errs = {}
    for (path, a), (path_p, b) in zip(_leaves(gj),
                                      _leaves(_port_grads(model))):
        assert path == path_p
        if np.linalg.norm(a) < ZERO_LEAF * gnorm:
            assert np.linalg.norm(b) < ZERO_LEAF * gnorm, path
            continue
        errs["/".join(path)] = float(np.linalg.norm(b - a)
                                     / np.linalg.norm(a))
    worst = max(errs, key=errs.get)
    assert len(errs) > 40 and errs[worst] < GRAD_RTOL, (worst, errs[worst])

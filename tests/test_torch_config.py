"""The port's configuration surface against the JAX package's: the same gin
names and ``-p`` bindings drive both. Every configurable of the port takes
every parameter its JAX counterpart takes, with the same default (the JAX
package's jnp dtypes as their torch dtypes); ``RAFT.unroll_iters``, which
changes only how JAX traces, is accepted and changes nothing (the same
outputs, bit for bit, on the CPU); ``RAFT.encoder_chunk`` gives JAX's
forward; the bindings the port cannot honour raise, naming their ROADMAP
Queue 1 item. Held against the JAX package elsewhere:
``optimizer.clip_norm`` (test_torch_training.py,
test_torch_train_step.py), ``UpdateBlock.share_*`` (test_torch_models.py),
``random_scale_and_crop.use_native`` (test_torch_data.py,
test_torch_native.py), ``RAFT.remat`` and ``RAFT.encoder_chunk`` in training
(test_torch_remat.py).
"""

import argparse
import dataclasses
import importlib
import inspect
import pkgutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cermvs_torch
import cermvs_tpu
from cermvs_tpu import config as jcfg
from cermvs_tpu.models.raft import RAFT as JRAFT
from cermvs_tpu.pipeline.inference import InferenceRunner as JRunner
from cermvs_tpu.utils.torch_import import convert_raft
from cermvs_torch import config as pcfg
from cermvs_torch.models.raft import RAFT
from cermvs_torch.pipeline.inference import InferenceRunner, inference
from cermvs_torch.training.step import init_state
from test_torch_slice import CASCADE as SLICE_CASCADE
from test_torch_slice import TOL as SLICE_TOL
from test_torch_slice import _Loader, _scene

CASCADE = ((8, 64, 1), (-1, 320, 1))
# parallel.mesh.check_mesh's message: the three meshes the port takes
MESHES_TAKEN = r"\('data', 'view'\) or \('row',\) or \('row', 'view'\)"
FLAX_FIELDS = {"name", "parent"}  # every flax module has them


@pytest.fixture
def bindings():
    """Parse ``-p`` flags as the CLIs do; clear them afterwards."""
    pcfg.clear_config()

    def parse(*flags):
        parser = pcfg.add_cli_flags(argparse.ArgumentParser())
        args = parser.parse_args(["-p", *flags])
        pcfg.parse_cli(args)

    yield parse
    pcfg.clear_config()


def _import_all(pkg):
    for info in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
        importlib.import_module(info.name)


def _parameters(fn):
    f = fn.__init__ if inspect.isclass(fn) else fn
    fields = getattr(fn, "__dataclass_fields__", None)
    if fields is not None:  # a flax module
        return set(fields) - FLAX_FIELDS
    return set(inspect.signature(inspect.unwrap(f)).parameters) - {"self"}


def _defaults(fn):
    """Each parameter's default (``inspect.Parameter.empty`` for none)."""
    fields = getattr(fn, "__dataclass_fields__", None)
    if fields is not None:  # a flax module
        out = {}
        for name, f in fields.items():
            if name in FLAX_FIELDS:
                continue
            if f.default is not dataclasses.MISSING:
                out[name] = f.default
            elif f.default_factory is not dataclasses.MISSING:
                out[name] = f.default_factory()
            else:
                out[name] = inspect.Parameter.empty
        return out
    f = fn.__init__ if inspect.isclass(fn) else fn
    return {name: p.default for name, p in
            inspect.signature(inspect.unwrap(f)).parameters.items()
            if name != "self"}


# the JAX package's dtype defaults, as the port spells them
JAX_DTYPES = {jnp.bfloat16: torch.bfloat16, jnp.float32: torch.float32}


def _configurables(config, pkg):
    """The configurables ``pkg``'s own modules register (tests and scripts
    register others under the same registry)."""
    _import_all(pkg)
    return {name: fn for name, fn in config._REGISTRY.items()
            if fn.__module__.startswith(pkg.__name__ + ".")}


def test_port_configurables_take_every_jax_binding():
    jax_side = _configurables(jcfg, cermvs_tpu)
    port = _configurables(pcfg, cermvs_torch)
    assert set(jax_side) - set(port) == set()
    missing = {name: sorted(_parameters(fn) - _parameters(port[name]))
               for name, fn in jax_side.items() if name in port}
    assert {k: v for k, v in missing.items() if v} == {}
    differ, compared = {}, 0
    for name, fn in jax_side.items():
        mine = _defaults(port[name])
        for param, want in _defaults(fn).items():
            want = JAX_DTYPES.get(want, want)
            got = mine[param]
            compared += 1
            if not (got is want or (type(got) is type(want)
                                    and got == want)):
                differ[f"{name}.{param}"] = (want, got)
    assert differ == {}
    assert compared > 100


def _run(model):
    images, poses, intr = _scene(H=32, W=96)
    with torch.no_grad():
        return model(torch.from_numpy(images)[None],
                     torch.from_numpy(poses)[None],
                     torch.from_numpy(intr)[None]).float().numpy()


def _forward(seed=0):
    return _run(RAFT(cascade=CASCADE, dtype=torch.float32, device="cpu",
                     test_mode=True,
                     generator=torch.Generator().manual_seed(seed)))


@pytest.mark.parametrize("flag", ["RAFT.unroll_iters = True"])
def test_raft_bindings_that_shape_jax_tracing_change_nothing(bindings, flag):
    want = _forward()
    bindings(flag)
    got = _forward()
    assert np.abs(want).max() > 0
    np.testing.assert_array_equal(got, want)


def test_encoder_chunk_binding_matches_jax(bindings):
    """``RAFT.encoder_chunk = 2`` bound in both packages: the test-mode
    forward encodes two frames a call (the last one alone here; JAX pads
    it with a zero frame) and gives JAX's disparities at test_torch_slice's
    tolerance. Not bit for bit against the unbound forward: a convolution
    over fewer frames sums in another order."""
    model = RAFT(cascade=CASCADE, dtype=torch.float32, device="cpu",
                 test_mode=True, generator=torch.Generator().manual_seed(0))
    params = convert_raft({k: v.numpy().copy()
                           for k, v in model.state_dict().items()})
    images, poses, intr = _scene(H=32, W=96)
    bindings("RAFT.encoder_chunk = 2")
    jcfg.clear_config()
    jcfg.parse_config(["RAFT.encoder_chunk = 2"])
    try:
        jmodel = JRAFT(cascade=CASCADE, dtype=jnp.float32, test_mode=True)
    finally:
        jcfg.clear_config()
    assert jmodel.encoder_chunk == 2
    want = np.asarray(jmodel.apply(params, *(jnp.asarray(a)[None]
                                             for a in (images, poses, intr))))
    got = _forward()
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, **SLICE_TOL)


def test_inference_device_prefetch_changes_nothing(bindings, tmp_path):
    model = RAFT(cascade=CASCADE, dtype=torch.float32, device="cpu",
                 test_mode=True)
    out = {}
    for prefetch in (True, False):
        bindings(f"inference.device_prefetch = {prefetch}")
        inference(_Loader(), model=model,
                  output_folder=tmp_path / str(prefetch), device="cpu")
        out[prefetch] = sorted((tmp_path / str(prefetch) / "depths").iterdir())
    assert [p.name for p in out[True]] == [p.name for p in out[False]]
    for a, b in zip(out[True], out[False]):
        assert a.read_bytes() == b.read_bytes()


def test_inference_mesh_names_its_queue_item(bindings):
    """A bound mesh that is none of the three DeviceMeshes the port takes
    raises before any work, naming them."""
    bindings('inference.mesh = "views"')
    with pytest.raises(ValueError, match=MESHES_TAKEN):
        inference(_Loader(), device="cpu")


def test_clip_norm_binding_reaches_the_train_state(bindings):
    bindings("optimizer.clip_norm = 0.5")
    state = init_state(RAFT(cascade=CASCADE, device="cpu"), num_steps=10)
    assert state.clip_norm == 0.5


@pytest.mark.parametrize("flag,modules", [
    ("UpdateBlock.share_corr = False",
     ["corr_encoder0", "corr_encoder1", "delta0", "delta1", "gru"]),
    ("UpdateBlock.share_gru = False",
     ["corr_encoder", "delta0", "delta1", "gru0", "gru1"]),
    ("UpdateBlock.share_delta = True", ["corr_encoder", "delta", "gru"])])
def test_share_bindings_build_their_modules(bindings, flag, modules):
    bindings(flag)
    sd = RAFT(cascade=CASCADE, device="cpu").state_dict()
    assert sorted({k.split(".")[1] for k in sd
                   if k.startswith("update_block.")}) == modules


@pytest.mark.parametrize("name,want", [("float32", torch.float32),
                                       ("bfloat16", torch.bfloat16)])
def test_dtype_binding_by_name_reaches_every_module(bindings, name, want):
    """``RAFT.dtype`` bound by name, as the JAX package's gin files and
    flags bind it: every module that computes in a dtype holds the torch
    dtype, and the forward is the one of the model built with it."""
    bindings(f'RAFT.dtype = "{name}"')
    model = RAFT(cascade=CASCADE, device="cpu", test_mode=True)
    held = {n: m.dtype for n, m in model.named_modules()
            if hasattr(m, "dtype")}
    assert {"", "fnet", "cnet", "update_block", "update_block.gru"} <= set(
        held)
    assert set(held.values()) == {want}
    np.testing.assert_array_equal(
        _run(model), _run(RAFT(cascade=CASCADE, device="cpu", test_mode=True,
                               dtype=want)))


@pytest.mark.parametrize("name", ["float16", "fp32", "torch.float32"])
def test_dtype_binding_of_an_unknown_name_raises(bindings, name):
    bindings(f'RAFT.dtype = "{name}"')
    with pytest.raises(ValueError, match="'bfloat16', 'float32'"):
        RAFT(cascade=CASCADE, device="cpu")


def test_float32_binding_matches_jax_on_the_slice(bindings):
    """``RAFT.dtype = "float32"`` bound in both packages: the port's
    InferenceRunner, its model built from the binding, gives the JAX
    package's disparities on test_torch_slice's scene, rectified, at that
    file's tolerance (its module docstring says why)."""
    seeded = RAFT(cascade=SLICE_CASCADE, dtype=torch.float32, device="cpu",
                  generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        for i in range(len(SLICE_CASCADE)):
            getattr(seeded.update_block, f"delta{i}")[2].weight.mul_(1e-3)
    params = convert_raft({k: v.numpy()
                           for k, v in seeded.state_dict().items()})
    images, poses, intr = _scene()
    bindings('RAFT.dtype = "float32"')
    jcfg.clear_config()
    jcfg.parse_config(['RAFT.dtype = "float32"'])
    try:
        jr = JRunner(params, construction="rectified", cascade=SLICE_CASCADE,
                     rect_lambda_max=0.1)
        dj = np.asarray(jr.submit(images, poses, intr, 1.0))[0]
    finally:
        jcfg.clear_config()
    pr = InferenceRunner(params=params, construction="rectified",
                         cascade=SLICE_CASCADE, rect_lambda_max=0.1,
                         device="cpu")
    assert pr.model.dtype == torch.float32 and jr.model.dtype == "float32"
    dp = pr.submit(images, poses, intr, 1.0)[0].numpy()
    assert pr.last_path == jr._last_path == "rectified"
    assert np.abs(dj).max() > 1e-4
    np.testing.assert_allclose(dp, dj, **SLICE_TOL)


def test_runner_takes_every_jax_parameter():
    """``InferenceRunner`` is no configurable, so the registry check above
    does not see it: the port's takes every parameter of JAX's by name.
    A ``mesh`` that is none of the three DeviceMeshes it takes is refused,
    naming them."""
    assert _parameters(JRunner) - _parameters(InferenceRunner) == set()
    with pytest.raises(ValueError, match=MESHES_TAKEN):
        InferenceRunner(model=RAFT(cascade=CASCADE, device="cpu"),
                        mesh="views", device="cpu")


@pytest.mark.parametrize("with_model", [True, False])
def test_runner_gate_arguments_reach_the_runner(with_model):
    """``rect_cost_ratio_max`` and ``max_k_chunks`` by name, with or without
    a model: they no longer fall into the model's keyword arguments (a
    TypeError from RAFT without a model, dropped with one). The gate routes
    a lateral scene, which "auto" otherwise rectifies, to exact."""
    kwargs = (dict(model=RAFT(cascade=CASCADE, dtype=torch.float32,
                              device="cpu"))
              if with_model else dict(cascade=CASCADE, dtype=torch.float32))
    images, poses, intr = _scene(H=32, W=96)
    routes = {}
    for gate in (None, 1e-3):
        runner = InferenceRunner(construction="auto", rect_lambda_max=0.1,
                                 rect_cost_ratio_max=gate, max_k_chunks=1,
                                 device="cpu", **kwargs)
        assert runner.rect_cost_ratio_max == gate
        runner.submit(images, poses, intr, 1.0)
        routes[gate] = runner.last_path
    assert routes == {None: "rectified", 1e-3: "exact"}

"""The port's view axis against the JAX package's on the CPU: the packed
plans, ``view_sharded_forward`` of two gloo ranks against JAX's on a
(1, 2) device mesh, and a world of one against no mesh.

The ranks are one ``cermvs_torch.parallel.dryrun.World`` of two spawned
processes, started once for the module; they import the port alone
(``tests/torch_parallel_tasks.py``). The JAX side runs here, on two of the
eight CPU devices of ``tests/conftest.py``.

Scene and model: ``tests/test_parallel.py``'s (32x48, 6 frames: 3 + 2
views, the split its padded case pads; cascade
((8,64,2),(-1,320,2)), hyp_chunk 4, fp32), the port's seeded weights
carried to JAX with ``convert_raft`` and the delta heads damped 1e-3x
(``tests/test_torch_slice.py``), which leaves the disparities at ~1e-4.
Tolerance: rtol 1e-3, ``tests/test_parallel.py``'s, with
``tests/test_torch_slice.py``'s atol of 1e-7 for disparities of that size
(``tests/test_parallel.py``'s 1e-4 is for disparities ~1); the disparities
must reach 100x the atol. The view sums run in another order: the JAX
package pads views and widens every epiband window to the plan's
scene-wide bounds, the port builds each view in its own window.

A world of one (a gloo group of this process alone) is held bit for bit
against the port without a mesh: the runner's three routes, and a train
step with its ``all_reduce`` against one without.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from cermvs_tpu.models.raft import RAFT as JRAFT
from cermvs_tpu.ops import rectify as jrect
from cermvs_tpu.parallel.infer import view_sharded_forward as j_sharded
from cermvs_tpu.parallel.mesh import make_mesh as j_make_mesh
from cermvs_tpu.utils.torch_import import convert_raft
from cermvs_torch.ops import rectify as prect
from cermvs_torch.parallel import dryrun
from cermvs_torch.parallel.infer import (ViewShardedVolume, shard_views,
                                         view_sharded_forward)
from cermvs_torch.parallel.mesh import make_mesh
from cermvs_torch.pipeline.fusion import fusion
from cermvs_torch.pipeline.inference import InferenceRunner, inference
from cermvs_torch.training.step import (batch_to_device, init_state,
                                        train_step)
import torch_parallel_tasks as tasks

CASCADE = ((8, 64, 2), (-1, 320, 2))
MODEL = dict(cascade=CASCADE, hyp_chunk=4, dtype="float32")
DAMP = 1e-3
TOL = dict(rtol=1e-3, atol=1e-7)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread here, as in the ranks: the shapes are tiny, and
    eight threads a process under several test workers spend seconds a
    forward contending for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def world():
    w = dryrun.World(2, "cpu")
    yield w
    w.close()


@pytest.fixture
def world_of_one(tmp_path):
    """A gloo group of this process alone, destroyed after the test."""
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _scene(N=6, H=32, W=48, forward=None):
    return dryrun.lateral_scene(N, H, W, forward=forward)


def _jax_params(model=MODEL):
    port = tasks.seeded_model(model, DAMP)
    return convert_raft({k: v.numpy().copy()
                         for k, v in port.state_dict().items()})


def _feature_plan(poses, intr, H, W, sub=None):
    K4 = intr.astype(np.float64).copy()
    K4[..., :2, :] /= 4.0
    poses = poses.astype(np.float64)
    if sub is not None:
        poses, K4 = poses[sub], K4[sub]
    return jrect.plan_rectification(poses, K4, H // 4, W // 4)


@pytest.mark.parametrize("ok", [True, False])
def test_pack_plan_is_jax_vector(ok):
    """The packed vector is JAX's bit for bit, and each package unpacks the
    other's to the same plan."""
    # a neighbour on the reference's optical axis: the planner rejects
    images, poses, intr = _scene(forward=None if ok else 2)
    H, W = images.shape[1:3]
    K4 = intr.astype(np.float64).copy()
    K4[..., :2, :] /= 4.0
    pj = jrect.plan_rectification(poses.astype(np.float64), K4, H // 4,
                                  W // 4)
    pp = prect.plan_rectification(poses.astype(np.float64), K4, H // 4,
                                  W // 4)
    assert pj.ok == pp.ok == ok
    vj, vp = jrect.pack_plan(pj, 5), prect.pack_plan(pp, 5)
    assert vp.dtype == vj.dtype == np.float64
    np.testing.assert_array_equal(vp, vj)
    back_p = prect.unpack_plan(vj, 5)
    back_j = jrect.unpack_plan(vp, 5)
    assert dataclasses.asdict(back_p) == dataclasses.asdict(back_j)
    if ok:
        assert back_p == pp  # an accepted plan travels whole
        assert prect.plan_union([back_p]) == pp


def test_shard_views_deals_each_construction():
    assert shard_views(8, 2) == [[0, 2, 4, 6], [1, 3, 5, 7]]
    assert shard_views(5, 2) == [[0, 2, 4], [1, 3]]
    # rectified views first, then the exact ones, dealt on
    assert shard_views(8, 2, (0, 2, 3, 5, 6)) == [[0, 3, 4, 6],
                                                  [1, 2, 5, 7]]
    assert shard_views(2, 2, (0,)) == [[0], [1]]


CASES = [("exact", ("mean",)), ("rectified", ("mean",)),
         ("mixed", ("mean",)), ("exact", ("mean", "max", "std")),
         ("rectified", ("mean", "max", "std"))]


@pytest.mark.parametrize("construction,agg", CASES,
                         ids=[f"{c}-{'+'.join(a)}" for c, a in CASES])
def test_two_ranks_match_jax(world, construction, agg):
    images, poses, intr = _scene()
    H, W = images.shape[1:3]
    plan, rect_views = None, None
    if construction == "rectified":
        plan = _feature_plan(poses, intr, H, W)
    elif construction == "mixed":
        rect_views = (0, 2, 3)  # a rank with both constructions
        plan = _feature_plan(poses, intr, H, W,
                             sub=[0] + [v + 1 for v in rect_views])
    if plan is not None:
        assert plan.ok, plan.reason
    kw = dict(MODEL, aggregation=agg)
    scale = np.full((1,), 1.5, np.float32)
    jmodel = JRAFT(cascade=CASCADE, hyp_chunk=4, dtype=jnp.float32,
                   test_mode=True, aggregation=agg)
    mesh = j_make_mesh(n_data=1, n_view=2, devices=jax.devices()[:2])
    fn = jax.jit(lambda *a: j_sharded(jmodel, *a, mesh, plan=plan,
                                      rect_views=rect_views))
    dj = np.asarray(fn(_jax_params(kw), jnp.asarray(images[None]),
                       jnp.asarray(poses[None]), jnp.asarray(intr[None]),
                       jnp.asarray(scale)))
    vec = None if plan is None else jrect.pack_plan(plan, len(
        rect_views) if rect_views else 5)
    outs = world.run(tasks.sharded_forward, kw, DAMP, images[None],
                     poses[None], intr[None], scale, vec, rect_views)
    np.testing.assert_array_equal(outs[0], outs[1])
    assert outs[0].shape == dj.shape == (1, 8, 12)
    assert np.abs(dj).max() >= 100 * TOL["atol"]
    np.testing.assert_allclose(outs[0], dj, **TOL)


ROUTES = [("exact", "exact", None), ("rectified", "rectified", None),
          ("mixed", "auto", 2)]


@pytest.mark.parametrize("label,construction,forward", ROUTES,
                         ids=[r[0] for r in ROUTES])
def test_world_of_one_is_the_unmeshed_runner(world_of_one, label,
                                             construction, forward):
    """Each route through ``InferenceRunner(mesh=make_mesh(1, 1))``: the
    same route and the same disparities, bit for bit, as without a mesh;
    the forward takes the view-sharded construction of all the views."""
    images, poses, intr = _scene(forward=forward)
    model = tasks.seeded_model(MODEL, DAMP)
    kw = dict(construction=construction, device="cpu", rect_lambda_max=0.1)
    meshed = InferenceRunner(model=model, mesh=make_mesh(1, 1), **kw)
    plain = InferenceRunner(model=model, **kw)
    dm = meshed.submit(images, poses, intr, 1.0)
    dp = plain.submit(images, poses, intr, 1.0)
    assert meshed.last_path == plain.last_path == label
    assert not meshed.graphs and meshed.eager_reason == "a CPU runner"
    (volume,) = meshed._volumes.values()
    assert isinstance(volume, ViewShardedVolume)
    assert volume.views == list(range(5))
    assert np.abs(dp.numpy()).max() > 1e-4
    assert torch.equal(dm, dp)


class _Loader:
    """Two items of the scene, as ``inference()`` reads a loader."""

    class dataset:
        num_frames = 5

    def __iter__(self):
        for ref in range(2):
            images, poses, intr = _scene()
            yield images[::-1].copy(), poses, intr, [f"{ref:08d}"], 1.0


def test_world_of_one_inference_writes_the_same_pfms(world_of_one,
                                                     tmp_path):
    """``inference(mesh=make_mesh(1, 1))`` writes the files of
    ``inference()`` without a mesh, byte for byte."""
    model = tasks.seeded_model(MODEL, DAMP)
    inference(_Loader(), model=model, output_folder=tmp_path / "mesh",
              mesh=make_mesh(1, 1), construction="exact", device="cpu")
    inference(_Loader(), model=model, output_folder=tmp_path / "plain",
              construction="exact", device="cpu")
    names = sorted(p.name for p in (tmp_path / "plain" / "depths").iterdir())
    assert names == ["00000000_scale1_nf5.pfm", "00000001_scale1_nf5.pfm"]
    for name in names:
        assert ((tmp_path / "mesh" / "depths" / name).read_bytes()
                == (tmp_path / "plain" / "depths" / name).read_bytes())


def test_world_of_one_train_step_is_bit_for_bit(world_of_one):
    """A train step whose gradients, loss and metrics go through the
    group's ``all_reduce`` equals the step without a group."""
    batch = tasks.synth_loader(2).__iter__().__next__()
    states = []
    for group in (dist.group.WORLD, None):
        model = tasks.seeded_model(dict(cascade=((4, 64, 1),), hyp_chunk=4,
                                        dtype="float32"), test_mode=False)
        state = init_state(model, num_steps=10)
        metrics = train_step(state, batch_to_device(batch, "cpu"), 0.5,
                             group=group)
        states.append((metrics, [p.detach().clone()
                                 for p in model.parameters()]))
    (mg, wg), (mu, wu) = states
    assert mg == mu
    assert all(torch.equal(a, b) for a, b in zip(wg, wu))


def test_row_mesh_raises_naming_its_item(world_of_one, tmp_path):
    """A mesh that is none of the three the port takes, ``(data, view)``,
    ``(row,)`` and ``(row, view)``, is refused before any work, naming
    them; the view-sharded forward takes ``(data, view)`` alone, and fusion
    refuses a row mesh, whose axis shards the rows of a forward."""
    from torch.distributed.device_mesh import init_device_mesh

    from cermvs_torch.parallel.mesh import make_row_mesh

    other = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "row"))
    taken = r"\('data', 'view'\) or \('row',\) or \('row', 'view'\)"
    model = tasks.seeded_model(MODEL)
    images, poses, intr = _scene()
    with pytest.raises(ValueError, match=taken + r".*got \('data', 'row'\)"):
        InferenceRunner(model=model, mesh=other, device="cpu")
    with pytest.raises(ValueError, match=r"view-sharded forward's mesh "
                       r"must be a DeviceMesh with the axes "
                       r"\('data', 'view'\), got \('row',\)"):
        view_sharded_forward(model, torch.from_numpy(images[None]),
                             torch.from_numpy(poses[None]),
                             torch.from_numpy(intr[None]), torch.ones(1),
                             make_row_mesh())
    with pytest.raises(ValueError, match=taken):
        inference([], model=model, mesh=other, device="cpu")
    with pytest.raises(ValueError, match=r"fusion's mesh .* \('data', "
                       r"'view'\), got \('row',\)"):
        fusion([], tmp_path, mesh=make_row_mesh(), device="cpu")


def test_more_ranks_than_views_raises(world_of_one):
    with pytest.raises(ValueError, match="each needs one"):
        ViewShardedVolume(0, dist.group.WORLD)

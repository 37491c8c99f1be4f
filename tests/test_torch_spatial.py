"""The port's row sharding against the JAX package's on the CPU:
``plan_row_bands``, ``encoder_rows`` and ``row_sharded_forward`` of two
gloo ranks against JAX's on a 2-device ``("row",)`` mesh, the runner's
routing under a row mesh, ``UpdateBlock(row_mask=)``, and a world of one
against no mesh.

The ranks are one ``cermvs_torch.parallel.dryrun.World`` of two spawned
processes, started once for the module; they import the port alone
(``tests/torch_parallel_tasks.py``). The JAX side runs here, on two of the
eight CPU devices of ``tests/conftest.py``.

Scene: ``tests/test_spatial.py``'s (4 frames, neighbours along x with a y
zig-zag), cut from 256x64 to 128x48: two row ranks of 16 feature rows each
hold the rectified construction's ``GHOST_RECT`` margin, and the planner
accepts it. Model: ``tests/test_torch_parallel.py``'s (cascade
((8,64,2),(-1,320,2)), hyp_chunk 4, fp32), the port's seeded weights
carried to JAX with ``convert_raft`` and the delta heads damped 1e-3x.
Tolerances: the encoders at ``tests/test_spatial.py``'s fp32 rtol 1e-4 /
atol 1e-5 (the norm's moments in another order); the disparities at rtol
1e-3 / atol 1e-7, ``tests/test_torch_parallel.py``'s, and they must reach
100x the atol. JAX's rectified forward runs its plain epiband
(``rect_impl="oracle"``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh, PartitionSpec as P

from cermvs_tpu.models.raft import RAFT as JRAFT
from cermvs_tpu.models.update import UpdateBlock as JUpdateBlock
from cermvs_tpu.ops import rectify as jrect
from cermvs_tpu.parallel.spatial import encoder_rows as j_encoder_rows
from cermvs_tpu.parallel.spatial import row_sharded_forward as j_rows
from cermvs_tpu.pipeline.inference import InferenceRunner as JRunner
from cermvs_tpu.utils.torch_import import convert_raft
from cermvs_torch.models.update import UpdateBlock
from cermvs_torch.ops import rectify as prect
from cermvs_torch.parallel import dryrun
from cermvs_torch.parallel.mesh import make_row_mesh
from cermvs_torch.pipeline.inference import InferenceRunner
import torch_parallel_tasks as tasks

CASCADE = ((8, 64, 2), (-1, 320, 2))
MODEL = dict(cascade=CASCADE, hyp_chunk=4, dtype="float32")
DAMP = 1e-3
TOL = dict(rtol=1e-3, atol=1e-7)
ENC_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
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
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def spatial_scene(N=4, H=128, W=48, seed=0):
    """``tests/test_spatial.py``'s scene at H x W, without the batch axis."""
    rng = np.random.RandomState(seed)
    images = (rng.rand(N, H, W, 3) * 255).astype(np.float32)
    K = np.array([[80.0, 0, W / 2], [0, 80.0, H / 2], [0, 0, 1]],
                 np.float32)
    intr = np.tile(K, (N, 1, 1))
    poses = np.tile(np.eye(4, dtype=np.float32), (N, 1, 1))
    for n in range(1, N):
        poses[n, 0, 3] = 0.4 * n
        poses[n, 1, 3] = 0.2 * ((-1) ** n)
    return images, poses, intr


def feature_geometry(poses, intr, H, W):
    K4 = intr.astype(np.float64).copy()
    K4[..., :2, :] /= 4.0
    return poses.astype(np.float64), K4, H // 4, W // 4


def jax_params(model=MODEL, damp=DAMP):
    port = tasks.seeded_model(model, damp)
    return convert_raft({k: v.numpy().copy()
                         for k, v in port.state_dict().items()})


def jax_row_forward(agg, images, poses, intr, scale, n, plan=None,
                    grid=False):
    """JAX's row- (or (n/2, 2) grid-) sharded forward, jitted, on the CPU
    devices; the rectified one with its plain epiband."""
    from cermvs_tpu.parallel.spatial import grid_sharded_forward

    jm = JRAFT(cascade=CASCADE, hyp_chunk=4, dtype=jnp.float32,
               test_mode=True, aggregation=agg)
    bands = None
    if plan is not None:
        po, K4, h, w = feature_geometry(poses, intr, *images.shape[1:3])
        bands = jrect.plan_row_bands(po, K4, h, w, plan,
                                     n // 2 if grid else n, 16)
    if grid:
        mesh = Mesh(np.asarray(jax.devices()[:n]).reshape(n // 2, 2),
                    ("row", "view"))
        fn = grid_sharded_forward
    else:
        mesh = Mesh(np.asarray(jax.devices()[:n]), ("row",))
        fn = j_rows
    f = jax.jit(lambda p, a, b, c, s: fn(jm, p, a, b, c, s, mesh, plan=plan,
                                         rect_impl="oracle", bands=bands))
    return np.asarray(f(jax_params(dict(MODEL, aggregation=agg)),
                        jnp.asarray(images[None]), jnp.asarray(poses[None]),
                        jnp.asarray(intr[None]), jnp.asarray(scale)))


@pytest.mark.parametrize("n", [2, 4])
def test_plan_row_bands_is_jax(n):
    """The host band planner equals JAX's exactly: the same starts and
    height."""
    images, poses, intr = spatial_scene()
    po, K4, h, w = feature_geometry(poses, intr, *images.shape[1:3])
    plan = prect.plan_rectification(po, K4, h, w)
    assert plan.ok, plan.reason
    qj, bj = jrect.plan_row_bands(po, K4, h, w, plan, n, 16)
    qp, bp = prect.plan_row_bands(po, K4, h, w, plan, n, 16)
    assert bp == bj and 0 < bp <= plan.h_r
    assert qp.dtype == qj.dtype == np.int32 and qp.shape == (n, 3)
    np.testing.assert_array_equal(qp, qj)


@pytest.mark.parametrize("norm_fn", ["instance", "none"])
def test_encoder_rows_matches_jax(world, norm_fn):
    """The halo convolutions and the row-averaged instance norm of two
    ranks equal JAX's ``encoder_rows`` on a 2-device row mesh (the fnet's
    weights for "instance", the cnet's for "none")."""
    frames = np.random.RandomState(0).rand(2, 64, 48, 3).astype(np.float32)
    name = "fnet" if norm_fn == "instance" else "cnet"
    params = jax_params()["params"][name]
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("row",))
    out = jax.jit(jax.shard_map(
        lambda p, x: j_encoder_rows(p, x, "row", norm_fn=norm_fn,
                                    dtype=jnp.float32),
        mesh=mesh, in_specs=(P(), P(None, "row")),
        out_specs=P(None, "row"), check_vma=False))(params, frames)
    parts = world.run(tasks.encoder_rows, MODEL, frames, norm_fn)
    assert [p.shape for p in parts] == [(2, 8, 12, params["Conv_1"][
        "kernel"].shape[-1])] * 2
    np.testing.assert_allclose(np.concatenate(parts, 1), np.asarray(out),
                               **ENC_TOL)


@pytest.mark.parametrize("construction", ["exact", "rectified"])
def test_two_row_ranks_match_jax(world, construction):
    """``row_sharded_forward`` over a (row,) mesh of two ranks: the exact
    construction, and the banded rectified one (bands planned by the port)
    against JAX's on two devices."""
    images, poses, intr = spatial_scene()
    plan = None
    if construction == "rectified":
        plan = jrect.plan_rectification(*feature_geometry(
            poses, intr, *images.shape[1:3]))
        assert plan.ok, plan.reason
    scale = np.full((1,), 1.5, np.float32)
    dj = jax_row_forward(("mean",), images, poses, intr, scale, 2, plan)
    vec = None if plan is None else jrect.pack_plan(plan, 3)
    outs = world.run(tasks.row_forward, MODEL, DAMP, images[None],
                     poses[None], intr[None], scale, 1, vec)
    np.testing.assert_array_equal(outs[0], outs[1])
    assert outs[0].shape == dj.shape == (1, 32, 12)
    assert np.abs(dj).max() >= 100 * TOL["atol"]
    np.testing.assert_allclose(outs[0], dj, **TOL)


@pytest.mark.parametrize("agg", [("mean", "max"), ("mean", "max", "std")],
                         ids=["mean+max", "mean+max+std"])
def test_two_row_ranks_max_std_match_jax(world, agg):
    """Per-view aggregation on the exact construction: every rank holds all
    views of its rows, so the update block aggregates them as unsharded."""
    images, poses, intr = spatial_scene()
    scale = np.ones((1,), np.float32)
    dj = jax_row_forward(agg, images, poses, intr, scale, 2)
    outs = world.run(tasks.row_forward, dict(MODEL, aggregation=agg), DAMP,
                     images[None], poses[None], intr[None], scale)
    np.testing.assert_array_equal(outs[0], outs[1])
    assert np.abs(dj).max() >= 100 * TOL["atol"]
    np.testing.assert_allclose(outs[0], dj, **TOL)


# (label, scene H, aggregation, construction): the route JAX's _row_plan
# takes, and the port's runner with it
ROUTES = [("rectified", 128, ("mean",), "auto"),
          ("exact-construction", 128, ("mean",), "exact"),
          ("few-rows", 64, ("mean",), "rectified"),
          ("max-std", 128, ("mean", "max", "std"), "auto")]


@pytest.mark.parametrize("label,H,agg,construction", ROUTES,
                         ids=[r[0] for r in ROUTES])
def test_row_mesh_runner_routes_as_jax(world, label, H, agg, construction):
    """``InferenceRunner`` under a row mesh of two: ``shape_multiple``, the
    route and the bands are JAX's (``row_mesh``, ``shape_multiple``,
    ``_row_plan``), and its disparities are its ranks' forward's."""
    images, poses, intr = spatial_scene(H=H)
    kw = dict(cascade=CASCADE, hyp_chunk=4, aggregation=agg)
    jr = JRunner(jax_params(dict(MODEL, aggregation=agg)),
                 mesh=Mesh(np.asarray(jax.devices()[:2]), ("row",)),
                 construction=construction, dtype=jnp.float32, **kw)
    assert jr.row_mesh and not jr.grid_mesh
    j_key, j_q0 = (None, None)
    if construction != "exact":
        order = jr._neighbor_order(poses)
        j_key, j_q0 = jr._row_plan(poses[order][None], intr[order][None],
                                   [1.0], images[order][None])
    res = world.run(tasks.row_runner, dict(MODEL, aggregation=agg), DAMP,
                    images, poses, intr, construction)
    for r in res:
        assert r["shape_multiple"] == jr.shape_multiple == 16
        assert r["row_mesh"] and not r["grid_mesh"]
        assert r["path"] == ("exact" if j_key is None else "rectified")
        assert r["path"] == ("rectified" if label == "rectified"
                             else "exact")
        if j_key is not None:
            assert r["band_h"] == j_key[1]
            np.testing.assert_array_equal(r["q0"], j_q0)
            np.testing.assert_array_equal(
                r["plan"], jrect.pack_plan(j_key[0], 3))
    np.testing.assert_array_equal(res[0]["disp"], res[1]["disp"])
    assert np.abs(res[0]["disp"]).max() >= 100 * TOL["atol"]


@pytest.mark.parametrize("construction", ["exact", "rectified"])
def test_world_of_one_row_mesh_is_the_unmeshed_runner(world_of_one,
                                                      construction):
    """A (row,) mesh of one rank: the same route as without a mesh, and the
    disparities within fp32 order (the instance norm's moments and the
    convolutions' padding differ in form, not in value)."""
    images, poses, intr = spatial_scene()
    model = tasks.seeded_model(MODEL, DAMP)
    kw = dict(construction=construction, device="cpu")
    meshed = InferenceRunner(model=model, mesh=make_row_mesh(), **kw)
    plain = InferenceRunner(model=model, **kw)
    dm = meshed.submit(images, poses, intr, 1.0).numpy()
    dp = plain.submit(images, poses, intr, 1.0).numpy()
    assert meshed.last_path == plain.last_path == construction
    assert meshed.row_mesh and meshed.shape_multiple == 8
    assert not meshed.graphs and meshed.eager_reason == "a CPU runner"
    assert np.abs(dp).max() >= 100 * TOL["atol"]
    np.testing.assert_allclose(dm, dp, **TOL)


def test_world_of_one_row_mesh_inference_crops_to_its_multiple(
        world_of_one, tmp_path):
    """``inference(mesh=)`` with a (row,) mesh crops the frames to the
    runner's ``shape_multiple`` (8 for one row rank; the encoder's stride,
    4, without a mesh), and writes the depths of the cropped frames."""
    from cermvs_torch.data.augment import crop_operation
    from cermvs_torch.io.pfm import read_pfm
    from cermvs_torch.pipeline.inference import inference

    images, poses, intr = spatial_scene(H=132)

    class Loader:
        class dataset:
            num_frames = 3

        def __iter__(self):
            yield images, poses, intr, ["00000000"], 1.0

    model = tasks.seeded_model(MODEL, DAMP)
    for name, mesh in (("mesh", make_row_mesh()), ("plain", None)):
        inference(Loader(), model=model, output_folder=tmp_path / name,
                  mesh=mesh, construction="exact", device="cpu")
    pfm = "depths/00000000_scale1_nf3.pfm"
    meshed = read_pfm(tmp_path / "mesh" / pfm)
    assert meshed.shape == (32, 12)
    assert read_pfm(tmp_path / "plain" / pfm).shape == (33, 12)
    cropped, k = crop_operation(images, intr, 128, 48)
    plain = InferenceRunner(model=model, construction="exact", device="cpu")
    depth = plain(cropped, poses, k, 1.0)
    disp = [np.where(d == 0, 0, 1 / np.where(d == 0, 1, d))
            for d in (meshed, depth)]
    assert np.abs(disp[1]).max() >= 100 * TOL["atol"]
    np.testing.assert_allclose(disp[0], disp[1], **TOL)


def _update_inputs(seed=0, B=1, H=12, W=8, V=3):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, H, W, 64).astype(np.float32),
            rng.randn(B, H, W, 64).astype(np.float32),
            (rng.rand(B, H, W, 1) * 0.01).astype(np.float32),
            rng.randn(B, V, H, W, 33).astype(np.float32))


def test_row_mask_none_is_bit_for_bit():
    """``row_mask=None`` leaves the update block as it was, and a mask of
    ones changes no bit either."""
    block = UpdateBlock(CASCADE, dtype=torch.float32)
    net, inp, disp, corr = map(torch.from_numpy, _update_inputs())
    with torch.no_grad():
        plain = block(net, inp, disp, corr, 1)
        ones = block(net, inp, disp, corr, 1,
                     row_mask=torch.ones((1, 12, 1, 1)))
        masked = block(net, inp, disp, corr, 1, row_mask=torch.cat(
            [torch.zeros((1, 3, 1, 1)), torch.ones((1, 9, 1, 1))], 1))
    for a, b in zip(plain, ones):
        assert torch.equal(a, b)
    assert not torch.equal(plain[1], masked[1])
    assert torch.equal(masked[0][:, :3], torch.zeros_like(masked[0][:, :3]))


def test_row_mask_matches_jax():
    """The masked update block (ghost rows zeroed at every conv input)
    equals JAX's ``UpdateBlock(row_mask=)`` in fp32."""
    model = tasks.seeded_model(MODEL)
    block = model.update_block
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():  # nonzero biases: ghost rows turn nonzero
        for m in block.modules():
            if isinstance(m, torch.nn.Conv2d):
                m.bias.normal_(0.0, 0.1, generator=gen)
    arrays = _update_inputs(1)
    mask = np.ones((1, 12, 1, 1), np.float32)
    mask[:, :2] = 0.0
    mask[:, -3:] = 0.0
    with torch.no_grad():
        net, delta = block(*map(torch.from_numpy, arrays), 1,
                           row_mask=torch.from_numpy(mask))
    params = convert_raft({k: v.numpy().copy() for k, v in
                           model.state_dict().items()})["params"][
                               "update_block"]
    jb = JUpdateBlock(cascade=CASCADE, dtype=jnp.float32)
    jn, jd = jb.apply({"params": params}, *map(jnp.asarray, arrays), 1,
                      row_mask=jnp.asarray(mask))
    np.testing.assert_allclose(net.numpy(), np.asarray(jn), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(delta.numpy(), np.asarray(jd), rtol=1e-4,
                               atol=1e-7)

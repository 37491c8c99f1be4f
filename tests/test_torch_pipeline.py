"""The port's InferenceRunner and inference() against the JAX package's on
the CPU, and the behaviour of the port's own pipeline.

Against JAX: the partial planner and the work ratio, the mixed
construction, the runner's routes ("mixed", batched exact, batched
rectified, the cost-ratio gate) and ``inference()`` at view_batch 1 and 2.
The port's own: the pipeline writes what the runner computes view by view,
a loader's exception reaches the caller, an abandoned or failed pipeline
leaves no prep thread, a shape change flushes the batch, and each record
names its own construction.

Weights, scenes and tolerances follow test_torch_slice.py (its docstring):
fp32, damped delta heads, disparities at rtol 1e-3 / atol 1e-7 and depth
maps at rtol 1e-3. Plans compare exactly (both float64 numpy), volumes at
rtol 1e-4 / atol 1e-5 (test_torch_rectified.py). The mixed construction
combines its two means in JAX's order, ``(vol_r*|r| + vol_e*|e|)/V``, so it
is held at the same tolerances. A batch of two views against the same views
one by one in the port: rtol 1e-5 / atol 1e-8 (CPU convolutions may sum a
batch of 2N frames in another order than one of N).
"""

import dataclasses
import importlib
import threading
import time
import types
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cermvs_tpu.ops import rectify as jrect
from cermvs_tpu.ops.corr_rectified import make_mixed_volume_fn as j_mixed
from cermvs_tpu.pipeline.inference import InferenceRunner as JRunner
from cermvs_tpu.pipeline.inference import inference as j_inference
from cermvs_torch.data.augment import pad_to_multiple
from cermvs_torch.io.pfm import read_pfm
from cermvs_torch.models.raft import RAFT
from cermvs_torch.ops import corr as pcorr
from cermvs_torch.ops import rectify as prect
from cermvs_torch.ops.corr_rectified import MixedVolume
from cermvs_torch.pipeline.inference import InferenceRunner, inference
from test_torch_slice import CASCADE, TOL
from test_torch_slice import weights  # noqa: F401 (a fixture)

MIXED = ("lateral", "forward", "lateral")  # JAX's TestMixedConstruction
LATERAL = ("lateral",) * 3
FORWARD = ("forward",) * 3
SMALL_CASCADE = ((8, 64, 1), (-1, 320, 1))
BATCH_TOL = dict(rtol=1e-5, atol=1e-8)
# the module (cermvs_torch.pipeline exports the function under its name)
pinf = importlib.import_module("cermvs_torch.pipeline.inference")


def scene(kinds=MIXED, baselines=(-1.2, 1.0, 1.6), H=64, W=192, seed=0):
    """A reference and one neighbour per entry of ``kinds``: moved
    sideways by its baseline ("lateral") or along the optical axis by its
    length ("forward"). MIXED with the default baselines is JAX's
    TestMixedConstruction scene."""
    K = np.array([[80.0, 0, W / 2], [0, 80.0, H / 2], [0, 0, 1]], np.float32)
    n = len(kinds) + 1
    poses = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    for i, (kind, b) in enumerate(zip(kinds, baselines), 1):
        if kind == "lateral":
            poses[i, 0, 3] = b
        else:
            poses[i, 2, 3] = -abs(b)
    images = np.random.RandomState(seed).rand(n, H, W, 3).astype(np.float32)
    return images * 255, poses, np.tile(K, (n, 1, 1))


def feature_scene(kinds=MIXED):
    """``scene``'s poses and its intrinsics at the feature stride (4):
    float64, for the planners; the grid is 16 x 48."""
    _, poses, intr = scene(kinds)
    intr = intr.astype(np.float64)
    intr[:, :2] /= 4.0
    return poses.astype(np.float64), intr


class Loader:
    """The test loader interface inference() reads: items and
    ``.dataset.num_frames``. ``items`` is a list or a generator function."""

    def __init__(self, items, num_frames=3):
        self.items = items
        self.dataset = types.SimpleNamespace(num_frames=num_frames)

    def __iter__(self):
        return iter(self.items() if callable(self.items) else self.items)


def item(name, kinds=MIXED, H=66, W=194, seed=0, baselines=(-1.2, 1.0, 1.6)):
    images, poses, intr = scene(kinds, baselines, H, W, seed)
    return images, poses, intr, [name], 1.0


def small_model():
    return RAFT(cascade=SMALL_CASCADE, dtype=torch.float32, device="cpu",
                test_mode=True, generator=torch.Generator().manual_seed(0))


def pfms(folder):
    return {p.name: read_pfm(p) for p in sorted((folder / "depths").iterdir())}


def prep_threads():
    return [t for t in threading.enumerate() if t.name == "inference-prep"]


def assert_prep_threads_end(timeout=10.0):
    deadline = time.monotonic() + timeout
    while prep_threads() and time.monotonic() < deadline:
        time.sleep(0.02)
    assert not prep_threads()


@pytest.mark.parametrize("kinds,rect_views", [(MIXED, (0, 2)),
                                              (LATERAL, (0, 1, 2)),
                                              (FORWARD, ())])
def test_partial_plan_matches_jax(kinds, rect_views):
    poses, intr = feature_scene(kinds)
    pj, rj = jrect.plan_rectification_partial(poses, intr, 16, 48,
                                              lambda_max=0.1)
    pp, rp = prect.plan_rectification_partial(poses, intr, 16, 48,
                                              lambda_max=0.1)
    assert rp == rj == rect_views
    assert dataclasses.asdict(pp) == dataclasses.asdict(pj)
    assert pp.ok == bool(rect_views)
    assert len(pp.view_s_max) == len(rect_views)
    full = prect.plan_rectification(poses, intr, 16, 48, lambda_max=0.1)
    assert full.ok == (kinds == LATERAL)
    if full.ok:
        assert pp == full


@pytest.mark.parametrize("kinds", [MIXED, LATERAL])
@pytest.mark.parametrize("per_view", [True, False])
@pytest.mark.parametrize("d0", [64, 8])
def test_rect_cost_ratio_matches_jax(kinds, per_view, d0):
    poses, intr = feature_scene(kinds)
    plan, rect_views = prect.plan_rectification_partial(poses, intr, 16, 48,
                                                        lambda_max=0.1)
    if not per_view:  # the scene-wide band for every view
        plan = dataclasses.replace(plan, view_rates=(), view_s_max=())
    jplan = jrect.RectPlan(**dataclasses.asdict(plan))
    n = len(rect_views)
    ratio = prect.rect_cost_ratio(plan, 16, 48, n, d0=d0)
    assert ratio == jrect.rect_cost_ratio(jplan, 16, 48, n, d0=d0)
    assert ratio > 0


@pytest.mark.parametrize("stage", [0, 1])
@pytest.mark.parametrize("mean", [False, True])
def test_mixed_volume_matches_jax(stage, mean):
    poses, intr = feature_scene()
    plan, rect_views = prect.plan_rectification_partial(poses, intr, 16, 48,
                                                        lambda_max=0.1)
    assert rect_views == (0, 2)
    rng = np.random.RandomState(1)
    poses, intr = poses[None].astype(np.float32), intr[None].astype(
        np.float32)
    fm = rng.randn(1, 4, 16, 48, 8).astype(np.float32)
    ii, jj = np.zeros(3, np.int32), np.arange(1, 4, dtype=np.int32)
    n_hyp, incre = (8, 0.01) if stage == 0 else (16, 0.002)
    if stage == 0:
        origin = np.full((1, 1, 16, 48), (n_hyp // 2) * incre, np.float32)
    else:
        origin = (0.02 + 0.03 * rng.rand(1, 1, 16, 48)).astype(np.float32)
    # JAX's plain resample ("oracle"): its interpreted kernel is held
    # against the port through the runner below
    j = np.asarray(j_mixed(jrect.RectPlan(**dataclasses.asdict(plan)),
                           rect_views, impl="oracle")(
        jnp.asarray(fm), jnp.asarray(poses), jnp.asarray(intr), ii, jj,
        jnp.asarray(origin), n_hyp, incre, mean_over_views=mean,
        zero_slab=(stage == 0)))
    t = [torch.from_numpy(a) for a in (fm, poses, intr, origin)]
    ii_t, jj_t = torch.from_numpy(ii).long(), torch.from_numpy(jj).long()
    vol = MixedVolume(plan, rect_views)
    ctx = vol.prepare(t[0], t[1], t[2], ii_t, jj_t, torch.float32)
    p = vol.build(ctx, t[3], n_hyp, incre, mean_over_views=mean,
                  zero_slab=(stage == 0)).numpy()
    assert p.shape == j.shape == (1, 1 if mean else 3, 16, 48, n_hyp)
    assert np.abs(j).max() > 0.01
    np.testing.assert_allclose(p, j, rtol=1e-4, atol=1e-5)
    if not mean:
        # the forward neighbour (jj position 1) is the exact construction's
        # slice, back in its own place
        exact = pcorr.build_corr_volume(t[0], t[1], t[2], ii_t[:1],
                                        jj_t[1:2], t[3], n_hyp, incre)
        np.testing.assert_array_equal(p[:, 1], exact[:, 0].numpy())


def test_mixed_volume_refuses_a_scene_it_would_rectify_whole():
    poses, intr = feature_scene(LATERAL)
    plan = prect.plan_rectification(poses, intr, 16, 48, lambda_max=0.1)
    fm = torch.zeros(1, 4, 16, 48, 8)
    with pytest.raises(ValueError, match="all views rectifiable"):
        MixedVolume(plan, (0, 1, 2)).prepare(
            fm, torch.from_numpy(poses[None]).float(),
            torch.from_numpy(intr[None]).float(), torch.zeros(3).long(),
            torch.arange(1, 4), torch.float32)


def test_runner_auto_takes_the_mixed_route_as_jax(weights):
    port, params = weights
    images, poses, intr = scene()
    jr = JRunner(params, construction="auto", cascade=CASCADE,
                 dtype=jnp.float32, rect_lambda_max=0.1)
    pr = InferenceRunner(model=port, construction="auto", rect_lambda_max=0.1,
                         device="cpu")
    dj = np.asarray(jr.submit(images, poses, intr, 1.0))[0]
    dp = pr.submit(images, poses, intr, 1.0)[0].numpy()
    assert pr.last_path == jr._last_path == "mixed"
    # the same subset of neighbours (positions in baseline order)
    (jkey,) = jr._rect_models
    (pkey,) = pr._volumes
    assert pkey[1] == jkey[1] == (1, 2)
    assert dataclasses.asdict(pkey[0]) == dataclasses.asdict(jkey[0])
    assert dp.shape == dj.shape == (16, 48)
    assert np.abs(dj).max() > 1e-4
    np.testing.assert_allclose(dp, dj, **TOL)
    # the rectified views are lateral (lossless warps), the forward one
    # exact: the mixed route agrees with the exact construction
    exact = InferenceRunner(model=port, construction="exact", device="cpu")
    np.testing.assert_allclose(
        dp, exact.submit(images, poses, intr, 1.0)[0].numpy(), **TOL)


def test_cost_ratio_gate_routes_both_packages_to_exact(weights):
    port, params = weights
    images, poses, intr = scene(LATERAL)
    poses64, intr4 = feature_scene(LATERAL)
    plan = prect.plan_rectification(poses64, intr4, 16, 48, lambda_max=0.1)
    assert prect.rect_cost_ratio(plan, 16, 48, 3, d0=CASCADE[0][0]) == 1.0
    jr = JRunner(params, construction="auto", cascade=CASCADE,
                 dtype=jnp.float32, rect_lambda_max=0.1,
                 rect_cost_ratio_max=0.5)
    pr = InferenceRunner(model=port, construction="auto", rect_lambda_max=0.1,
                         rect_cost_ratio_max=0.5, device="cpu")
    dj = np.asarray(jr.submit(images, poses, intr, 1.0))[0]
    dp = pr.submit(images, poses, intr, 1.0)[0].numpy()
    assert pr.last_path == jr._last_path == "exact"
    np.testing.assert_allclose(dp, dj, **TOL)
    # the gate is "auto"'s alone
    rect = InferenceRunner(model=port, construction="rectified",
                           rect_lambda_max=0.1, rect_cost_ratio_max=0.5,
                           device="cpu")
    rect.submit(images, poses, intr, 1.0)
    assert rect.last_path == "rectified"


def test_batched_rectified_warns_and_matches_jax(weights):
    port, params = weights
    samples = [scene(LATERAL, (-1.2, 1.0, 1.6), seed=0),
               scene(LATERAL, (0.8, -1.5, 2.0), seed=1)]
    images, poses, intr = (np.stack(a) for a in zip(*samples))
    jr = JRunner(params, construction="rectified", cascade=CASCADE,
                 dtype=jnp.float32, rect_lambda_max=0.1)
    with pytest.warns(UserWarning, match="view_batch"):
        dj = np.asarray(jr.submit_batch(images, poses, intr, [1.0, 1.0]))
    pr = InferenceRunner(model=port, construction="rectified",
                         rect_lambda_max=0.1, device="cpu")
    with pytest.warns(UserWarning, match="view_batch > 1"):
        dp = pr.submit_batch(images, poses, intr, [1.0, 1.0]).numpy()
    assert pr.last_path == jr._last_path == "rectified"
    (jplan,) = jr._rect_models
    (pplan,) = pr._volumes
    assert dataclasses.asdict(pplan) == dataclasses.asdict(jplan)
    assert dp.shape == dj.shape == (2, 16, 48)
    np.testing.assert_allclose(dp, dj, **TOL)
    with warnings.catch_warnings():  # once per runner
        warnings.simplefilter("error")
        again = pr.submit_batch(images, poses, intr, [1.0, 1.0]).numpy()
    np.testing.assert_array_equal(again, dp)
    # "auto" runs a batch exact
    auto = InferenceRunner(model=port, construction="auto",
                           rect_lambda_max=0.1, device="cpu")
    auto.submit_batch(images, poses, intr, [1.0, 1.0])
    assert auto.last_path == "exact"


@pytest.mark.parametrize("view_batch", [1, 2])
def test_inference_view_batch_matches_jax(weights, tmp_path, view_batch):
    """view_batch 1 and 2 under "exact": the port's PFMs against JAX's at
    the same view_batch, and the batched run against the port's one view
    at a time."""
    port, params = weights
    items = [item(f"{i:08d}", LATERAL, seed=i) for i in range(4)]
    j_inference(Loader(items), params=params, output_folder=tmp_path / "jax",
                model_kwargs=dict(cascade=CASCADE, dtype=jnp.float32),
                view_batch=view_batch, construction="exact")
    records = inference(Loader(items), model=port,
                        output_folder=tmp_path / "port",
                        view_batch=view_batch, construction="exact",
                        device="cpu")
    assert [r[0] for r in records] == [f"{i:08d}" for i in range(4)]
    assert {r[2] for r in records} == {"exact"}
    want, got = pfms(tmp_path / "jax"), pfms(tmp_path / "port")
    assert sorted(got) == sorted(want) == [f"{i:08d}_scale1_nf3.pfm"
                                           for i in range(4)]
    for name in got:
        assert got[name].shape == (16, 48)
        np.testing.assert_allclose(got[name], want[name], rtol=1e-3)
    if view_batch > 1:
        inference(Loader(items), model=port, output_folder=tmp_path / "vb1",
                  construction="exact", device="cpu")
        one = pfms(tmp_path / "vb1")
        for name in got:
            np.testing.assert_allclose(got[name], one[name], **BATCH_TOL)


def test_pipeline_writes_what_the_runner_computes(tmp_path):
    model = small_model()
    items = [item("a", LATERAL, seed=0), item("b", MIXED, seed=1),
             item("c", FORWARD, seed=2), item("d", LATERAL, seed=3,
                                              baselines=(0.8, -1.5, 2.0))]
    records = inference(Loader(items), model=model, output_folder=tmp_path,
                        write_min_depth=str(tmp_path / "md"), device="cpu")
    runner = InferenceRunner(model=model, device="cpu")
    got = pfms(tmp_path)
    for (images, poses, intr, names, scale), rec in zip(items, records):
        images, intr = pad_to_multiple(images, intr, 4)
        want = runner(images, poses, intr, scale)
        np.testing.assert_array_equal(got[f"{names[0]}_scale1_nf3.pfm"], want)
        assert rec[0] == names[0] and rec[2] == runner.last_path
        assert rec[1] > 0
        valid = want[want > 0]
        md = float(np.quantile(valid, 0.1) / 2) if valid.size else 0.0
        assert float((tmp_path / "md" / f"{names[0]}.txt").read_text()) == md
    assert len(got) == len(records) == 4


def test_each_record_carries_its_own_construction(tmp_path):
    """Batch i is dispatched before batch i-1 is written, so the runner's
    last_path is the next batch's when a record is made."""
    items = [item("lat0", LATERAL), item("mix", MIXED),
             item("fwd", FORWARD), item("lat1", LATERAL, seed=1)]
    records = inference(Loader(items), model=small_model(),
                        output_folder=tmp_path, device="cpu")
    assert [(r[0], r[2]) for r in records] == [
        ("lat0", "rectified"), ("mix", "mixed"), ("fwd", "exact"),
        ("lat1", "rectified")]


@pytest.mark.parametrize("shapes,view_batch,batches", [
    ((66, 66, 74, 74, 74), 4, [(2, 64), (3, 72)]),
    ((66,) * 5, 2, [(2, 64), (2, 64), (1, 64)]),
    ((66, 74, 66), 1, [(1, 64), (1, 72), (1, 64)])])
def test_a_shape_change_flushes_the_batch(tmp_path, monkeypatch, shapes,
                                          view_batch, batches):
    seen = []
    submit = InferenceRunner.submit_batch

    def spy(self, images, *args):
        seen.append((images.shape[0], images.shape[2]))
        return submit(self, images, *args)

    monkeypatch.setattr(InferenceRunner, "submit_batch", spy)
    items = [item(f"{i}", LATERAL, H=h, seed=i) for i, h in enumerate(shapes)]
    records = inference(Loader(items), model=small_model(),
                        output_folder=tmp_path, view_batch=view_batch,
                        construction="exact", device="cpu")
    assert seen == batches
    assert [r[0] for r in records] == [f"{i}" for i in range(len(shapes))]
    got = pfms(tmp_path)
    for i, h in enumerate(shapes):
        assert got[f"{i}_scale1_nf3.pfm"].shape == ((h - 2) // 4, 48)


def test_a_loader_exception_reaches_the_caller(tmp_path):
    def items():
        yield item("first", LATERAL)
        raise RuntimeError("the loader failed")

    with pytest.raises(RuntimeError, match="the loader failed"):
        inference(Loader(items), model=small_model(), output_folder=tmp_path,
                  device="cpu")
    assert_prep_threads_end()


def test_an_abandoned_pipeline_leaves_no_prep_thread():
    def endless():
        i = 0
        while True:
            yield i
            i += 1

    gen = pinf._prefetched(endless(), lambda x: 2 * x)
    assert [next(gen), next(gen), next(gen)] == [0, 2, 4]
    assert prep_threads()
    gen.close()
    assert_prep_threads_end()


def test_a_failed_write_stops_the_prep_thread(tmp_path, monkeypatch):
    def endless():
        i = 0
        while True:
            yield item(f"{i}", LATERAL, H=34, W=98, seed=i)
            i += 1

    def fail(*args):
        raise OSError("disk full")

    monkeypatch.setattr(pinf, "write_pfm", fail)
    with pytest.raises(OSError, match="disk full"):
        inference(Loader(endless), model=small_model(),
                  output_folder=tmp_path, construction="exact", device="cpu")
    assert_prep_threads_end()


def test_upload_needs_a_cuda_runner():
    runner = InferenceRunner(model=small_model(), device="cpu")
    assert runner.upload_stream is None
    with pytest.raises(RuntimeError, match="CUDA runner"):
        runner.upload(torch.zeros(1, 2, 4, 4, 3, dtype=torch.bfloat16))


def test_to_bf16_casts_in_one_pass():
    a = np.random.RandomState(0).rand(3, 5, 7, 3).astype(np.float32) * 255
    view = a[:, 1:4, 2:6]  # a crop: not contiguous
    got = pinf.to_bf16(view)
    assert got.dtype == torch.bfloat16 and got.is_contiguous()
    torch.testing.assert_close(got, torch.from_numpy(
        np.ascontiguousarray(view)).to(torch.bfloat16), rtol=0, atol=0)

"""The port's compiled forward against the JAX package's on the CPU.

``InferenceRunner`` keeps one forward per ``(shape, dtype, construction
key)``, the counterpart of the JAX runner's compile cache: on a CUDA runner
the key's first dispatch captures a CUDA graph that later ones replay (held
on the card in ``test_torch_cuda.py``); on the CPU it keeps the same keys
and runs eagerly. Here:

  * the same dispatches through both runners give the same per-dispatch
    ``last_dispatch_compiled`` and route, and the same cache keys, over the
    three routes, two image shapes, batches and repeated keys;
  * ``inference()`` names a key's first dispatch on the record JAX's report
    marks ``[incl. Xs jit compile]``, and on no other;
  * the code made capturable (no host copies inside the forward) computes
    bit for bit what the host copies it replaced computed.

JAX's programs compile at their first call, which none of this needs: its
runner keeps ``_fn``'s bookkeeping and returns zeros of the output's shape
in place of the compiled program (``keyed_only``). The port runs its
forward. Scenes are test_torch_pipeline.py's, on which no JAX VMEM gate
fires, so "auto" routes alike in both packages.
"""

import dataclasses
import re
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cermvs_tpu.pipeline.inference import InferenceRunner as JRunner
from cermvs_tpu.pipeline.inference import inference as j_inference
from cermvs_torch.ops import corr_rectified as pcr
from cermvs_torch.ops import geometry as pgeo
from cermvs_torch.ops import rectify as prect
from cermvs_torch.pipeline.inference import InferenceRunner, inference
from test_torch_pipeline import (FORWARD, LATERAL, MIXED, SMALL_CASCADE,
                                 Loader, item, scene, small_model)

OTHER = (0.8, -1.5, 2.0)  # a second lateral rig, for batches' plan unions
WIDE = (-0.3, 1.0, 3.0)   # baselines whose src bands differ per view


@pytest.fixture
def keyed_only(monkeypatch):
    """JAX's runners keep their compile-cache bookkeeping and compile
    nothing: a program returns zeros of its output's shape."""
    fn = JRunner._fn

    def keyed(self, shape, model=None, key=None):
        fn(self, shape, model, key)
        B, _, H, W = shape
        f = self.model.stride_factor
        return lambda *args: jnp.zeros((B, H // f, W // f), jnp.float32)

    monkeypatch.setattr(JRunner, "_fn", keyed)


def dispatch(kinds, H=64, seeds=(0,), baselines=None):
    """One dispatch: a batch of one scene per seed (B = len(seeds)), the
    second sample of a batch on the OTHER rig unless ``baselines``."""
    samples = [scene(kinds, baselines or ((-1.2, 1.0, 1.6) if i == 0
                                          else OTHER), H=H, seed=s)
               for i, s in enumerate(seeds)]
    images, poses, intr = (np.stack(a) for a in zip(*samples))
    return images, poses, intr, [1.0] * len(seeds)


# per construction: the dispatches, and each one's expected route and
# whether its key is new
SEQUENCES = {
    "auto": [
        (dispatch(LATERAL), "rectified", True),
        (dispatch(MIXED), "mixed", True),
        (dispatch(FORWARD), "exact", True),
        (dispatch(LATERAL, seeds=(1,)), "rectified", False),
        (dispatch(LATERAL, H=72), "rectified", True),
        (dispatch(MIXED, H=72), "mixed", True),
        (dispatch(FORWARD, H=72), "exact", True),
        (dispatch(MIXED, seeds=(2,)), "mixed", False),
        (dispatch(FORWARD, H=72, seeds=(1,)), "exact", False),
        (dispatch(LATERAL, H=72, seeds=(3,)), "rectified", False),
        (dispatch(LATERAL, seeds=(4, 5)), "exact", True),
        (dispatch(FORWARD, seeds=(6, 7)), "exact", False),
    ],
    "rectified": [
        (dispatch(LATERAL, seeds=(0, 1)), "rectified", True),
        (dispatch(LATERAL, seeds=(2, 3)), "rectified", False),
        (dispatch(LATERAL), "rectified", True),
        (dispatch(LATERAL, H=72, seeds=(0, 1)), "rectified", True),
        (dispatch(FORWARD), "exact", True),
        (dispatch(FORWARD, seeds=(1,)), "exact", False),
        (dispatch(LATERAL, H=72, seeds=(4, 5)), "rectified", False),
    ],
    "exact": [
        (dispatch(LATERAL), "exact", True),
        (dispatch(MIXED, seeds=(1,)), "exact", False),
        (dispatch(LATERAL, H=72), "exact", True),
        (dispatch(FORWARD, seeds=(2, 3)), "exact", True),
        (dispatch(LATERAL, seeds=(4, 5)), "exact", False),
        (dispatch(FORWARD, H=72, seeds=(6,)), "exact", False),
    ],
}


def plain_key(key):
    """A construction key of either package as plain values: None, a
    plan's fields, or the mixed (plan's fields, rect_views)."""
    if key is None:
        return None
    if isinstance(key, tuple):
        return (plain_key(key[0]), key[1])
    return dataclasses.asdict(key)


@pytest.mark.parametrize("construction", list(SEQUENCES))
def test_dispatch_keys_match_jax(keyed_only, construction):
    jr = JRunner(None, construction=construction, cascade=SMALL_CASCADE,
                 dtype=jnp.float32, rect_lambda_max=0.1)
    pr = InferenceRunner(model=small_model(), construction=construction,
                         rect_lambda_max=0.1, device="cpu")
    seen = {"jax": [], "port": []}
    with warnings.catch_warnings():  # batched "rectified" warns, in both
        warnings.simplefilter("ignore", UserWarning)
        for args, _, _ in SEQUENCES[construction]:
            jr.submit_batch(*args)
            seen["jax"].append((jr._last_path, jr.last_dispatch_compiled))
            disp = pr.submit_batch(*args)
            seen["port"].append((pr.last_path, pr.last_dispatch_compiled))
            assert disp.shape == (len(args[3]), args[0].shape[2] // 4, 48)
    want = [(path, new) for _, path, new in SEQUENCES[construction]]
    assert seen["port"] == seen["jax"] == want
    # the same keys, first seen in the same order
    assert [(shape, plain_key(key)) for shape, _, key in pr._cache] == [
        (shape, plain_key(key)) for shape, key in jr._cache]
    assert {dtype for _, dtype, _ in pr._cache} == {torch.bfloat16}


def marked(text, note):
    """The names of the report lines that end in ``note``."""
    return re.findall(r"\((\w+)(?:, \w+)?\)  \[incl\. [\d.]+s " + note + r"\]",
                      text)


@pytest.mark.parametrize("view_batch", [1, 2])
def test_records_name_the_capture_where_jax_names_its_compile(
        keyed_only, tmp_path, capsys, view_batch):
    """A key's first dispatch lies in the interval of the record before
    it: that record carries the dispatch's seconds (0 on every other) and
    its report line says "[incl. Xs graph capture]" where JAX's says
    "[incl. Xs jit compile]"."""
    items = [item("lat0", LATERAL), item("lat1", LATERAL, seed=1),
             item("mix0", MIXED), item("lat2", LATERAL, seed=2),
             item("fwd0", FORWARD), item("tall0", LATERAL, H=74),
             item("tall1", LATERAL, H=74, seed=1), item("mix1", MIXED,
                                                        seed=1)]
    j_inference(Loader(items), params={}, output_folder=tmp_path / "jax",
                model_kwargs=dict(cascade=SMALL_CASCADE, dtype=jnp.float32),
                view_batch=view_batch, do_report=True)
    jax_marked = marked(capsys.readouterr().out, "jit compile")
    records = inference(Loader(items), model=small_model(),
                        output_folder=tmp_path / "port", do_report=True,
                        view_batch=view_batch, device="cpu")
    port_marked = marked(capsys.readouterr().out, "graph capture")
    want = {1: ["lat1", "lat2", "fwd0"],
            2: ["mix0", "lat2", "fwd0", "tall0", "tall1"]}[view_batch]
    assert jax_marked == port_marked == want
    assert [r[0] for r in records if r[3] > 0] == want
    assert all(0 < r[3] < r[1] for r in records if r[0] in want)
    assert all(r[3] == 0.0 for r in records if r[0] not in want)


def host_column_shift(col0, device):
    """``column_shift`` as the code before it read: a host copy."""
    return torch.tensor(
        [[1.0, 0.0, float(col0)], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]],
        dtype=torch.float32, device=device)


def host_image_corners(h, w, device):
    """``image_corners`` as the code before it read: a host copy."""
    return torch.tensor(
        [[0.0, 0.0, 1.0], [w - 1.0, 0.0, 1.0],
         [0.0, h - 1.0, 1.0], [w - 1.0, h - 1.0, 1.0]],
        dtype=torch.float32, device=device)


def host_inv_pose(pose):
    """``inv_pose`` as the code before it read: its last row a host
    copy."""
    R = pose[..., :3, :3]
    t = pose[..., :3, 3:4]
    Rt = R.transpose(-1, -2)
    top = torch.cat([Rt, -Rt @ t], dim=-1)
    bottom = pose.new_tensor([0.0, 0.0, 0.0, 1.0]).expand(
        pose.shape[:-2] + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def host_view_indices(self, n_views, device):
    """``MixedVolume.view_indices`` as the code before it read: host copies
    at every prepare."""
    ev = [v for v in range(n_views) if v not in self.rect_views]
    return (torch.tensor(self.rect_views, device=device),
            torch.tensor(ev, device=device), ev)


def test_device_made_constants_equal_the_host_copies():
    for col0 in (0, 64, 192):
        assert torch.equal(pcr.column_shift(col0, "cpu"),
                           host_column_shift(col0, "cpu"))
    for h, w in ((16, 48), (288, 400), (1, 1)):
        assert torch.equal(prect.image_corners(h, w, "cpu"),
                           host_image_corners(h, w, "cpu"))
    poses = torch.from_numpy(scene(MIXED)[1]).reshape(2, 2, 4, 4)
    assert torch.equal(pgeo.inv_pose(poses), host_inv_pose(poses))
    plan = prect.plan_rectification_partial(*feature_scene(MIXED, WIDE),
                                            16, 48, lambda_max=1.0)[0]
    vol = pcr.MixedVolume(plan, (0, 2))
    for got, want in zip(vol.view_indices(3, "cpu"),
                         host_view_indices(vol, 3, "cpu")):
        assert (torch.equal(got, want) if torch.is_tensor(got)
                else got == want)
    assert vol.view_indices(3, "cpu")[0] is vol.view_indices(3, "cpu")[0]


def feature_scene(kinds, baselines):
    """``scene``'s poses and its intrinsics at the feature stride (4),
    float64, for the planners; the grid is 16 x 48."""
    _, poses, intr = scene(kinds, baselines)
    intr = intr.astype(np.float64)
    intr[:, :2] /= 4.0
    return poses.astype(np.float64), intr


@pytest.mark.parametrize("stage", [0, 1])
@pytest.mark.parametrize("kinds", [LATERAL, MIXED], ids=["rectified",
                                                         "mixed"])
def test_volumes_equal_those_of_the_host_copies(monkeypatch, kinds, stage):
    """The rectified (two-pass, src bands of their own) and the mixed
    construction, exact views included: the same volume bit for bit with
    the device-made constants as with the host copies they replaced."""
    poses, intr = feature_scene(kinds, WIDE)
    if kinds == LATERAL:
        plan = prect.plan_rectification(poses, intr, 16, 48, lambda_max=1.0)
        vol = pcr.RectifiedVolume(plan)
    else:
        plan, rect_views = prect.plan_rectification_partial(
            poses, intr, 16, 48, lambda_max=1.0)
        assert rect_views == (0, 2)
        vol = pcr.MixedVolume(plan, rect_views)
    assert plan.twopass and min(plan.view_s_max) < plan.s_max
    rng = np.random.RandomState(stage)
    fm = torch.from_numpy(rng.randn(1, 4, 16, 48, 8).astype(np.float32))
    t_poses = torch.from_numpy(poses[None]).float()
    t_intr = torch.from_numpy(intr[None]).float()
    ii, jj = torch.zeros(3, dtype=torch.long), torch.arange(1, 4)
    n_hyp, incre = (8, 0.01) if stage == 0 else (16, 0.002)
    origin = torch.from_numpy(
        (0.02 + 0.03 * rng.rand(1, 1, 16, 48)).astype(np.float32))
    if stage == 0:
        origin = torch.full_like(origin, (n_hyp // 2) * incre)

    def volumes():
        ctx = vol.prepare(fm, t_poses, t_intr, ii, jj, torch.bfloat16)
        return [vol.build(ctx, origin, n_hyp, incre, mean_over_views=mean,
                          zero_slab=(stage == 0)) for mean in (False, True)]

    got = volumes()
    monkeypatch.setattr(pcr, "column_shift", host_column_shift)
    monkeypatch.setattr(prect, "image_corners", host_image_corners)
    monkeypatch.setattr(pgeo, "inv_pose", host_inv_pose)
    monkeypatch.setattr(pcr.MixedVolume, "view_indices", host_view_indices)
    want = volumes()
    assert np.abs(want[0].numpy()).max() > 0.01
    for g, w in zip(got, want):
        assert torch.equal(g, w)

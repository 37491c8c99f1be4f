"""The port's Tanks and Temples and BlendedMVS paths against the JAX
package's on the CPU:

* one TNT reference's depth map from ``inference()`` over the port's TNT
  loader against JAX's ``inference()`` over JAX's TNT loader, on the same
  tree and weights (fp32, the rectified construction pinned, the delta
  heads damped as in ``test_torch_slice.py``), at its tolerance;
* one port train step (exact) on a batch of the port's Blended loader
  against JAX's step on JAX's batch, at ``test_torch_train_step.py``'s
  tolerances but for one thing: on this batch the fnet weights' gradients
  (about 1e-4 of the global norm) move by 0.3-0.4% in JAX itself when the
  images change by one ulp (``images * (1 + 2**-23)``), the port's by
  3e-6, so each leaf is held to the larger of GRAD_RTOL and twice JAX's own
  movement, and the weights after AdamW's first step (g / (|g| + eps))
  only where JAX pins the gradient down;
* the BlendedMVS capture geometries of ``test_blended_construction.py``
  (orbit, sweep, forward walk, jittered orbits) through the port's
  ``plan_rectification`` / ``plan_union`` / ``PlanCache``: JAX's ``ok``,
  ``reason`` and key counts.
"""

import dataclasses

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cermvs_tpu import config as jcfg
from cermvs_tpu.data import get_test_data_loader as j_test_loader
from cermvs_tpu.data import get_train_data_loader as j_train_loader
from cermvs_tpu.models.raft import RAFT as JRAFT
from cermvs_tpu.ops import rectify as jrect
from cermvs_tpu.pipeline.inference import inference as j_inference
from cermvs_tpu.training.optim import fetch_optimizer as j_fetch
from cermvs_tpu.training.step import TrainState as JState
from cermvs_tpu.training.step import make_train_step
from cermvs_tpu.utils.torch_import import convert_raft
from cermvs_torch import config as pcfg
from cermvs_torch import data as pdata
from cermvs_torch.data.blended import TRAINING_SET
from cermvs_torch.data.cams import write_cam_file
from cermvs_torch.io.pfm import read_pfm, write_pfm
from cermvs_torch.models.raft import RAFT
from cermvs_torch.ops import rectify as prect
from cermvs_torch.pipeline.inference import inference
from cermvs_torch.training.step import batch_to_device, init_state, train_step
from test_blended_construction import (FEAT, forward_walk_poses, intr,
                                       orbit_poses, sweep_poses)
from test_torch_slice import CASCADE, TOL
from test_torch_train_step import (GRAD_RTOL, ZERO_LEAF, _jax_grads, _leaves,
                                   _plan, _port_grads)
from test_training import TINY


@pytest.fixture
def configs():
    for cfg in (jcfg, pcfg):
        cfg.clear_config()
    yield
    for cfg in (jcfg, pcfg):
        cfg.clear_config()


def _damped(cascade, seed=0):
    """The port's seeded fp32 init, delta heads damped 1e-3x, and the same
    weights as a JAX tree."""
    port = RAFT(cascade=cascade, dtype=torch.float32, device="cpu",
                generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        for i in range(len(cascade)):
            getattr(port.update_block, f"delta{i}")[2].weight.mul_(1e-3)
    params = convert_raft({k: v.numpy().copy()
                           for k, v in port.state_dict().items()})
    return port, params


def _write_cams_and_images(d, poses, K, hw, rng, aux, image_dir, cam_dir):
    for i, E in enumerate(poses):
        img = (rng.rand(*hw, 3) * 255).astype(np.uint8)
        (d / image_dir).mkdir(parents=True, exist_ok=True)
        (d / cam_dir).mkdir(parents=True, exist_ok=True)
        cv2.imwrite(str(d / image_dir / f"{i:08d}.jpg"), img)
        write_cam_file(d / cam_dir / f"{i:08d}_cam.txt", E, K, aux=aux(i))


def _write_pair(path, n, k):
    lines = [f"{n}\n"]
    for i in range(n):
        near = sorted((j for j in range(n) if j != i),
                      key=lambda j: (abs(j - i), j))[:k]
        lines += [f"{i}\n", f"{len(near)} " + " ".join(
            f"{j} {100.0 - abs(j - i):.1f}" for j in near) + "\n"]
    path.write_text("".join(lines))


def _lateral(xs):
    poses = np.tile(np.eye(4), (len(xs), 1, 1))
    poses[:, 0, 3] = -np.asarray(xs)
    return poses


# ---------------------------------------------------------------- TNT

TNT_HW = (64, 192)
TNT_AUX0 = 320.0  # scale 400 / 320


def test_tnt_depth_map_matches_jax(tmp_path):
    """The reference of view 1 (neighbours 0 and 2, then backfilled) with
    lateral baselines; scale 1.25 from its camera's aux row."""
    scene = tmp_path / "TNT" / "training_input" / "Meetingroom"
    K = np.array([[80.0, 0, TNT_HW[1] / 2], [0, 80.0, TNT_HW[0] / 2],
                  [0, 0, 1]])
    _write_cams_and_images(scene, _lateral([-1.2, 0.0, 0.9, 1.6]), K,
                           TNT_HW, np.random.RandomState(0),
                           lambda i: [TNT_AUX0, 1.0, 192, 900.0],
                           "images", "cams")
    _write_pair(scene / "pair.txt", 4, 2)
    port, params = _damped(CASCADE)
    kw = dict(datasetname="TNT", dataset_path=str(tmp_path / "TNT"),
              scan="Meetingroom", num_frames=3, subset=(1, 2, 1),
              num_workers=0)
    j_inference(j_test_loader(**kw), params=params,
                output_folder=tmp_path / "jax", construction="rectified",
                model_kwargs=dict(cascade=CASCADE, dtype=jnp.float32))
    records = inference(pdata.get_test_data_loader(**kw), model=port,
                        output_folder=tmp_path / "port",
                        construction="rectified", device="cpu")
    assert [r[0] for r in records] == ["00000001"]
    assert records[0][2] == "rectified"
    name = "00000001_scale1_nf3.pfm"
    got = read_pfm(tmp_path / "port" / "depths" / name)
    want = read_pfm(tmp_path / "jax" / "depths" / name)
    assert got.shape == want.shape == (16, 48)
    disp_got, disp_want = 1.0 / got, 1.0 / want  # the runners' disparities
    assert np.abs(disp_want).max() > 1e-4
    np.testing.assert_allclose(disp_got, disp_want, **TOL)


# ---------------------------------------------------------------- Blended

BL_HW = (40, 72)
BL_CROP = "random_scale_and_crop.crop_size = [32, 64]"


def _write_blended_scene(root):
    """One scene, five views on a lateral line, depths of a slanted plane
    around 40 with holes; median scaling takes it to 600."""
    scene = TRAINING_SET[0]
    d = root / "dataset_full_res_0-29" / scene / scene / scene
    rng = np.random.RandomState(3)
    K = np.array([[40.0, 0, BL_HW[1] / 2], [0, 40.0, BL_HW[0] / 2],
                  [0, 0, 1]])
    _write_cams_and_images(d, _lateral([0.0, 1.2, -1.6, 2.3, -2.6]), K,
                           BL_HW, rng, lambda i: [30.0, 1.0, 128, 60.0],
                           "blended_images", "cams")
    _write_pair(d / "cams" / "pair.txt", 5, 2)
    (d / "rendered_depth_maps").mkdir()
    yy, xx = np.mgrid[0:BL_HW[0], 0:BL_HW[1]]
    for i in range(5):
        depth = (40.0 + 0.1 * xx + 0.05 * yy + rng.rand(*BL_HW)).astype(
            np.float32)
        depth[rng.rand(*BL_HW) < 0.1] = 0.0
        write_pfm(d / "rendered_depth_maps" / f"{i:08d}.pfm", depth)


def test_blended_train_step_matches_jax(tmp_path, configs):
    _write_blended_scene(tmp_path)
    # both packages' defaults: the host data runtime's scale and crop
    pcfg.parse_config([BL_CROP])
    jcfg.parse_config([BL_CROP])
    kw = dict(datasetname="Blended", dataset_path=str(tmp_path),
              batch_size=2, num_frames=2, num_workers=0, seed=1)
    batch = next(iter(pdata.get_train_data_loader(**kw)))
    jbatch_np = next(iter(j_train_loader(process_shard=(0, 1), **kw)))
    for k in batch:
        np.testing.assert_array_equal(batch[k], jbatch_np[k])
    assert batch["images"].shape == (2, 3, 32, 64, 3)

    # train_BlendedMVS.gin's rectified plan of the batch is JAX's; the step
    # runs exact (the rectified step against JAX's: test_torch_train_step)
    plan_j = _plan(jrect.plan_rectification, jrect.plan_union, batch)
    plan_p = _plan(prect.plan_rectification, prect.plan_union, batch)
    assert dataclasses.asdict(plan_j) == dataclasses.asdict(plan_p)
    assert plan_p.ok and plan_p.twopass, plan_p.reason

    port, params = _damped(TINY)
    params = params["params"]
    tx, _ = j_fetch(num_steps=50)
    jmodel = JRAFT(cascade=TINY, dtype=jnp.float32)
    jbatch = {k: jnp.asarray(v) for k, v in jbatch_np.items()}
    gj = _jax_grads(jmodel, params, jbatch, 0.5)
    nudged = dict(jbatch, images=jbatch["images"] * np.float32(1 + 2**-23))
    own = {path: np.linalg.norm(b - a) / max(np.linalg.norm(a), 1e-30)
           for (path, a), (_, b) in zip(
               _leaves(gj), _leaves(_jax_grads(jmodel, params, nudged, 0.5)))}
    js, mj = make_train_step(jmodel, tx, donate=False)(
        JState(jnp.zeros((), jnp.int32), params, tx.init(params)), jbatch,
        0.5)

    state = init_state(port, num_steps=50)
    mp = train_step(state, batch_to_device(batch, "cpu"), 0.5)
    assert set(mp) == set(mj)
    for k in mp:
        tol = 1e-4 if k == "grad_norm" else 1e-5
        np.testing.assert_allclose(mp[k], float(mj[k]), rtol=tol, atol=1e-7,
                                   err_msg=k)
    gnorm = float(mj["grad_norm"])
    clip = min(1.0, 1.0 / gnorm)
    errs = {}
    for (path, a), (path_p, b) in zip(_leaves(gj), _leaves(_port_grads(port))):
        assert path == path_p
        a = a * clip
        if np.linalg.norm(a) < ZERO_LEAF * gnorm * clip:
            assert np.linalg.norm(b) < ZERO_LEAF * gnorm * clip, path
            continue
        errs["/".join(path)] = (float(np.linalg.norm(b - a)
                                      / np.linalg.norm(a)),
                                max(GRAD_RTOL, 2 * own[path]))
    bad = {k: v for k, v in errs.items() if v[0] >= v[1]}
    assert len(errs) > 40 and not bad, bad
    # most leaves are held at GRAD_RTOL itself
    assert sum(lim == GRAD_RTOL for _, lim in errs.values()) > 30
    # AdamW's first step is g / (|g| + eps): the weights of a leaf whose
    # gradient JAX itself does not pin down are held through it above
    new = convert_raft({k: v.detach().numpy().copy()
                        for k, v in port.state_dict().items()})["params"]
    for (path, a), (_, b) in zip(_leaves(js.params), _leaves(new)):
        if own.get(path, 0.0) < GRAD_RTOL:
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-6,
                                       err_msg="/".join(path))


# ------------------------------------------- BlendedMVS capture geometry

@pytest.mark.parametrize("case", ["orbit", "sweep", "forward_walk"])
def test_blended_plans_match_jax(case):
    poses = {"orbit": orbit_poses, "sweep": sweep_poses,
             "forward_walk": forward_walk_poses}[case]()
    K = intr(len(poses))
    pj = jrect.plan_rectification(poses, K, *FEAT)
    pp = prect.plan_rectification(poses, K, *FEAT)
    assert (pp.ok, pp.reason) == (pj.ok, pj.reason)
    assert dataclasses.asdict(pp) == dataclasses.asdict(pj)
    assert pp.ok == (case != "forward_walk")
    # the batch union the training loop takes: a rejecting sample rejects
    orbit = orbit_poses()
    uj = jrect.plan_union([jrect.plan_rectification(orbit, intr(8), *FEAT),
                           pj])
    up = prect.plan_union([prect.plan_rectification(orbit, intr(8), *FEAT),
                           pp])
    assert (up.ok, up.reason) == (uj.ok, uj.reason)
    assert dataclasses.asdict(up) == dataclasses.asdict(uj)


def test_jittered_orbits_fill_the_same_plan_cache_keys():
    """Orbits at the training scale jitter: the port's PlanCache takes the
    same keys as JAX's, in the same order, and stays within JAX's bound."""
    caches = {"jax": jrect.PlanCache(), "port": prect.PlanCache()}
    rng = np.random.RandomState(0)
    sizes = {"jax": [], "port": []}
    s_max = []
    for _ in range(24):
        r = 600.0 * 2 ** rng.uniform(-0.15, 0.5)
        s = rng.uniform(3.0, 5.0)
        poses = orbit_poses(radius=r, step_deg=s)
        plans = {"jax": jrect.plan_rectification(poses, intr(8), *FEAT),
                 "port": prect.plan_rectification(poses, intr(8), *FEAT)}
        assert dataclasses.asdict(plans["jax"]) == dataclasses.asdict(
            plans["port"])
        keys = {n: caches[n].key_for(p) for n, p in plans.items()}
        assert dataclasses.asdict(keys["jax"]) == dataclasses.asdict(
            keys["port"])
        for n in caches:
            sizes[n].append(len(caches[n]))
        s_max.append(plans["port"].s_max)
    assert sizes["port"] == sizes["jax"]
    assert len(caches["port"]) <= 8
    assert len(caches["port"]) - sizes["port"][11] <= 1
    assert max(s_max) > 1.9 * min(s_max)  # s_max spreads ~2x

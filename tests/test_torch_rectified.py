"""The port's rectified construction against the JAX package on the CPU:
the host planner field for field, the rect geometry, the warps, and the
rectified volume against JAX's with ``impl="pallas"`` (its epiband kernel run
interpreted).

Tolerances: plans equal exactly (both float64 numpy); homographies rtol
1e-12; rect maps and warps in float32 rtol 1e-5 / atol 1e-4 (pixel
coordinates in the hundreds); volumes rtol 1e-4 / atol 1e-5.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cermvs_tpu.ops import rectify as jrect
from cermvs_tpu.ops.corr_rectified import (
    build_corr_volume_rectified as j_build)
from cermvs_torch.ops import rectify as prect
from cermvs_torch.ops.corr_rectified import (
    build_corr_volume_rectified as p_build)


def _lookat(eye, target, up=(0, 1, 0)):
    eye = np.asarray(eye, np.float64)
    fwd = np.asarray(target, np.float64) - eye
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, np.asarray(up, np.float64))
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    P = np.eye(4)
    P[:3, :3] = np.stack([right, down, fwd], 0)
    P[:3, 3] = -P[:3, :3] @ eye
    return P


def general_scene(h=8, w=24, n=3):
    """Cameras on an arc looking at the origin (moderate rotations)."""
    K = np.array([[20.0, 0, 12.0], [0, 20.0, 4.0], [0, 0, 1]], np.float64)
    eyes = [(0.0, 0.0, -10.0), (2.0, 0.6, -9.5), (-1.8, -0.8, -9.8)][:n]
    poses = np.stack([_lookat(e, (0.1, -0.1, 0.0)) for e in eyes])
    intr = np.tile(K, (n, 1, 1))
    return poses[None].astype(np.float32), intr[None].astype(np.float32), h, w


def lateral_scene(h=8, w=24, n=3):
    """Identity rotations, x-only baselines: rectification is exact."""
    K = np.array([[20.0, 0, 12.0], [0, 20.0, 4.0], [0, 0, 1]], np.float64)
    poses = np.stack([np.eye(4) for _ in range(n)])
    for i, bx in enumerate([0.0, 1.0, -1.5]):
        poses[i, 0, 3] = -bx
    intr = np.tile(K, (n, 1, 1))
    return poses[None].astype(np.float32), intr[None].astype(np.float32), h, w


def forward_scene(h=8, w=24):
    K = np.array([[20.0, 0, 12.0], [0, 20.0, 4.0], [0, 0, 1]], np.float32)
    poses = np.stack([np.eye(4, dtype=np.float32) for _ in range(2)])
    poses[1, 2, 3] = -1.0  # src moved along +z (forward)
    return poses[None], np.tile(K, (2, 1, 1))[None], h, w


def ring_scene(h=72, w=100, n=5):
    """DTU-like ring of cameras around an object (mostly lateral)."""
    poses = []
    for i in range(n):
        ang = 0.06 * ((i + 1) // 2) * (1 if i % 2 else -1)
        elev = 0.04 * (i % 3 - 1)
        eye = 600.0 * np.array([np.sin(ang), np.sin(elev),
                                -np.cos(ang) * np.cos(elev)])
        poses.append(_lookat(eye, (0.0, 0.0, 0.0)))
    f = 2892.0 * w / 1600
    K = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]])
    return (np.stack(poses)[None].astype(np.float32),
            np.tile(K, (n, 1, 1))[None].astype(np.float32), h, w)


SCENES = {"lateral": (lateral_scene, 0.14), "general": (general_scene, 0.14),
          "forward": (forward_scene, 0.00375), "ring": (ring_scene, 0.00375)}


def _t(a):
    return torch.from_numpy(np.array(a))


def _pairs(n):
    return np.zeros(n - 1, np.int32), np.arange(1, n, dtype=np.int32)


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_plan_matches_jax(scene):
    make, lam = SCENES[scene]
    poses, intr, h, w = make()
    pj = jrect.plan_rectification(poses, intr, h, w, lambda_max=lam)
    pp = prect.plan_rectification(poses, intr, h, w, lambda_max=lam)
    assert dataclasses.asdict(pp) == dataclasses.asdict(pj)
    assert pp.ok == (scene != "forward")
    if pp.ok:
        assert pp.ws_r == pj.ws_r
        assert [pp.view_params(v) for v in range(poses.shape[1] - 1)] == [
            pj.view_params(v) for v in range(poses.shape[1] - 1)]
        for a, b in zip(prect.host_rect_homographies(
                poses, intr, h, w, pp.h_r, pp.w_r, pp.s_max),
                jrect.host_rect_homographies(
                    poses, intr, h, w, pj.h_r, pj.w_r, pj.s_max)):
            np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("scene", ["lateral", "general", "ring"])
def test_rect_geometry_matches_jax(scene):
    make, lam = SCENES[scene]
    poses, intr, h, w = make()
    plan = prect.plan_rectification(poses, intr, h, w, lambda_max=lam)
    ii, jj = _pairs(poses.shape[1])
    gj = jrect.rect_geometry(jnp.asarray(poses), jnp.asarray(intr), ii, jj,
                             h, w, plan)
    gp = prect.rect_geometry(_t(poses), _t(intr), _t(ii).long(),
                             _t(jj).long(), h, w, plan)
    for key in ("rate", "H_src_inv", "H_ref_inv", "H_fwd"):
        np.testing.assert_allclose(gp[key].numpy(), np.asarray(gj[key]),
                                   rtol=1e-5, atol=1e-4, err_msg=key)
    for key in ("ref_src_xy", "ref_ref_xy", "fwd_xy"):
        for a, b in zip(gp[key], gj[key]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                       atol=1e-4, err_msg=key)


@pytest.mark.parametrize("mode", ["zero", "clamp"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_warp_image_matches_jax(rng, mode, dtype):
    img = rng.randn(12, 17, 5).astype(np.float32)
    x = rng.uniform(-6, 23, (9, 11)).astype(np.float32)
    y = rng.uniform(-6, 18, (9, 11)).astype(np.float32)
    j = jrect.warp_image(jnp.asarray(img).astype(dtype), jnp.asarray(x),
                         jnp.asarray(y), mode=mode)
    p = prect.warp_image(_t(img).to(getattr(torch, dtype)), _t(x), _t(y),
                         mode=mode)
    assert p.dtype == torch.float32
    np.testing.assert_allclose(p.numpy(), np.asarray(j), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("mode", ["zero", "clamp"])
@pytest.mark.parametrize("scene", ["general", "ring"])
def test_warp_image_twopass_matches_jax(rng, mode, scene):
    make, lam = SCENES[scene]
    poses, intr, h, w = make()
    plan = prect.plan_rectification(poses, intr, h, w, lambda_max=lam)
    ii, jj = _pairs(poses.shape[1])
    geo = jrect.rect_geometry(jnp.asarray(poses), jnp.asarray(intr), ii, jj,
                              h, w, plan)
    img = rng.randn(h, w, 6).astype(np.float32)
    for H_inv, (oh, ow) in ((geo["H_ref_inv"][0], (plan.h_r, plan.w_r)),
                            (geo["H_src_inv"][-1], (plan.h_r, plan.ws_r))):
        j = jrect.warp_image_twopass(jnp.asarray(img), H_inv, oh, ow,
                                     mode=mode)
        p = prect.warp_image_twopass(_t(img), _t(np.asarray(H_inv)), oh, ow,
                                     mode=mode)
        assert np.abs(np.asarray(j)).max() > 0.1
        np.testing.assert_allclose(p.numpy(), np.asarray(j), rtol=1e-5,
                                   atol=1e-4)


def test_warp_image_twopass_chunked_equals_unchunked(rng, monkeypatch):
    """The plain hat resample builds its hat matrices in row chunks of at
    most ``hatwarp.HAT_BUDGET`` bytes; one row per chunk gives the same
    warp."""
    from cermvs_torch.ops import hatwarp

    poses, intr, h, w = ring_scene()
    plan = prect.plan_rectification(poses, intr, h, w)
    ii, jj = _pairs(poses.shape[1])
    geo = prect.rect_geometry(_t(poses), _t(intr), _t(ii).long(),
                              _t(jj).long(), h, w, plan)
    img = _t(rng.randn(h, w, 4).astype(np.float32))
    full = prect.warp_image_twopass(img, geo["H_src_inv"][1], plan.h_r,
                                    plan.ws_r)
    monkeypatch.setattr(hatwarp, "HAT_BUDGET", 1)
    chunked = prect.warp_image_twopass(img, geo["H_src_inv"][1], plan.h_r,
                                       plan.ws_r)
    np.testing.assert_allclose(chunked.numpy(), full.numpy(), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("stage", [0, 1])
@pytest.mark.parametrize("mean", [False, True])
@pytest.mark.parametrize("scene,warp", [("general", "twopass"),
                                        ("lateral", "twopass"),
                                        ("general", "quad")])
def test_rectified_volume_matches_jax(rng, stage, mean, scene, warp):
    make, lam = SCENES[scene]
    poses, intr, h, w = make()
    plan = prect.plan_rectification(poses, intr, h, w, lambda_max=lam)
    assert plan.ok and plan.twopass
    # the planner accepts two-pass warps here; "quad" forces the bilinear
    # gathers on both sides
    plan = dataclasses.replace(plan, twopass=(warp == "twopass"))
    N = poses.shape[1]
    ii, jj = _pairs(N)
    fm = rng.randn(1, N, h, w, 8).astype(np.float32)
    n_hyp, incre = (8, 0.01) if stage == 0 else (16, 0.002)
    if stage == 0:
        origin = np.full((1, 1, h, w), (n_hyp // 2) * incre, np.float32)
    else:
        origin = (0.02 + 0.03 * rng.rand(1, 1, h, w)).astype(np.float32)
    j = np.asarray(j_build(
        jnp.asarray(fm), jnp.asarray(poses), jnp.asarray(intr), ii, jj,
        jnp.asarray(origin), n_hyp, incre, plan, mean_over_views=mean,
        impl="pallas", zero_slab=(stage == 0)))
    p = p_build(_t(fm), _t(poses), _t(intr), _t(ii).long(), _t(jj).long(),
                _t(origin), n_hyp, incre, plan, mean_over_views=mean,
                zero_slab=(stage == 0)).numpy()
    assert p.shape == j.shape == (1, 1 if mean else N - 1, h, w, n_hyp)
    assert np.abs(j).max() > 0.01  # the slabs sample the source rows
    np.testing.assert_allclose(p, j, rtol=1e-4, atol=1e-5)


def test_rectified_volume_oracle_impl(rng):
    """impl="oracle" (the plain resample) equals the kernel route on CPU."""
    poses, intr, h, w = general_scene()
    plan = prect.plan_rectification(poses, intr, h, w, lambda_max=0.14)
    ii, jj = (_t(a).long() for a in _pairs(3))
    fm = _t(rng.randn(1, 3, h, w, 8).astype(np.float32))
    origin = _t((0.02 + 0.03 * rng.rand(1, 1, h, w)).astype(np.float32))
    args = (fm, _t(poses), _t(intr), ii, jj, origin, 16, 0.002, plan)
    torch.testing.assert_close(p_build(*args, impl="oracle"),
                               p_build(*args, impl="kernel"))

"""The port's tensor ops (cermvs_torch.ops) against the JAX package on the
CPU: the same numpy inputs, made from a seed, through both.

Tolerances: rtol 1e-5 / atol 1e-5 for geometry, sampling and lookups (float32
ops in a different summation order); the exact volume rtol 1e-4 / atol 1e-5
(C-length dot products of gathered features).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from cermvs_tpu.ops import corr as jcorr
from cermvs_tpu.ops import geometry as jgeo
from cermvs_tpu.ops import sampling as jsamp
from cermvs_torch.ops import corr as pcorr
from cermvs_torch.ops import geometry as pgeo
from cermvs_torch.ops import sampling as psamp

TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.array(a))


def _random_poses(rng, B, N, baseline=0.5):
    poses = np.tile(np.eye(4, dtype=np.float32), (B, N, 1, 1))
    for b in range(B):
        for n in range(N):
            q, _ = np.linalg.qr(rng.randn(3, 3) * 0.05 + np.eye(3))
            poses[b, n, :3, :3] = q * np.sign(np.linalg.det(q))
            poses[b, n, :3, 3] = rng.randn(3) * baseline
    return poses


def _intrinsics(B, N, h, w, f=20.0):
    K = np.array([[f, 0.3, w / 2], [0, f * 1.1, h / 2], [0, 0, 1]],
                 np.float32)
    return np.tile(K, (B, N, 1, 1))


def _scene(rng, B=1, N=3, h=12, w=20):
    poses = _random_poses(rng, B, N)
    intr = _intrinsics(B, N, h, w)
    ii = np.zeros(N - 1, np.int32)
    jj = np.arange(1, N, dtype=np.int32)
    return poses, intr, ii, jj


def test_coords_grid(rng):
    d = rng.rand(2, 3, 5, 7).astype(np.float32)
    np.testing.assert_allclose(pgeo.coords_grid(_t(d)).numpy(),
                               np.asarray(jgeo.coords_grid(jnp.asarray(d))),
                               **TOL)


def test_inv_pose(rng):
    poses = _random_poses(rng, 2, 4)
    out = pgeo.inv_pose(_t(poses)).numpy()
    np.testing.assert_allclose(out, np.asarray(jgeo.inv_pose(
        jnp.asarray(poses))), **TOL)
    np.testing.assert_allclose(out @ poses, np.tile(np.eye(4), (2, 4, 1, 1)),
                               atol=1e-5)


def test_relative_projection(rng):
    poses, intr, ii, jj = _scene(rng, B=2, N=4)
    p = pgeo.relative_projection(_t(poses), _t(intr), _t(ii).long(),
                                 _t(jj).long()).numpy()
    j = np.asarray(jgeo.relative_projection(jnp.asarray(poses),
                                            jnp.asarray(intr), ii, jj))
    np.testing.assert_allclose(p, j, rtol=1e-5, atol=1e-4)


def test_projective_transform(rng):
    poses, intr, ii, jj = _scene(rng)
    d = (rng.rand(1, 2, 12, 20) * 0.2 + 0.05).astype(np.float32)
    p = pgeo.projective_transform(_t(poses), _t(d), _t(intr), _t(ii).long(),
                                  _t(jj).long()).numpy()
    j = np.asarray(jgeo.projective_transform(
        jnp.asarray(poses), jnp.asarray(d), jnp.asarray(intr), ii, jj))
    np.testing.assert_allclose(p, j, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("n_disp_views", [1, 2])
def test_pixel_coords_of_hypotheses(rng, n_disp_views):
    poses, intr, ii, jj = _scene(rng)
    d = (rng.rand(1, n_disp_views, 4, 12, 20) * 0.2 + 0.05).astype(np.float32)
    p = pgeo.pixel_coords_of_hypotheses(_t(poses), _t(intr), _t(ii).long(),
                                        _t(jj).long(), _t(d)).numpy()
    j = np.asarray(jgeo.pixel_coords_of_hypotheses(
        jnp.asarray(poses), jnp.asarray(intr), ii, jj, jnp.asarray(d)))
    assert p.shape == j.shape == (1, 2, 4, 12, 20, 2)
    np.testing.assert_allclose(p, j, rtol=1e-5, atol=1e-4)


def test_apply_projection_clamps(rng):
    poses, intr, ii, jj = _scene(rng)
    Pij = np.asarray(jgeo.relative_projection(jnp.asarray(poses),
                                              jnp.asarray(intr), ii, jj))
    # inverse depths that put points behind / at the camera plane
    d = np.linspace(-5.0, 5.0, 2 * 12 * 20).reshape(1, 2, 12, 20).astype(
        np.float32)
    p = pgeo.apply_projection(_t(Pij), _t(d), clamp=50.0).numpy()
    j = np.asarray(jgeo.apply_projection(jnp.asarray(Pij), jnp.asarray(d),
                                         clamp=50.0))
    assert np.abs(p).max() <= 50.0
    np.testing.assert_allclose(p, j, rtol=1e-5, atol=1e-3)


def test_interp1d(rng):
    values = rng.randn(3, 4, 16).astype(np.float32)
    # positions inside, at the edges and outside [0, D-1]
    x = rng.uniform(-3.0, 19.0, (3, 4, 11)).astype(np.float32)
    x[0, 0, :4] = [0.0, 15.0, -1.0, 15.5]
    np.testing.assert_allclose(
        psamp.interp1d(_t(values), _t(x)).numpy(),
        np.asarray(jsamp.interp1d(jnp.asarray(values), jnp.asarray(x))),
        **TOL)


@pytest.mark.parametrize("with_mask", [False, True])
def test_bilinear_sample(rng, with_mask):
    img = rng.randn(9, 13, 4).astype(np.float32)
    coords = np.stack([rng.uniform(-3, 15, (5, 6)),
                       rng.uniform(-3, 11, (5, 6))], -1).astype(np.float32)
    p = psamp.bilinear_sample(_t(img), _t(coords), with_mask=with_mask)
    j = jsamp.bilinear_sample(jnp.asarray(img), jnp.asarray(coords),
                              with_mask=with_mask)
    if with_mask:
        np.testing.assert_array_equal(p[1].numpy(), np.asarray(j[1]))
        p, j = p[0], j[0]
    np.testing.assert_allclose(p.numpy(), np.asarray(j), **TOL)


@pytest.mark.parametrize("out_hw", [(7, 11), (20, 33), (1, 5)])
def test_resize_bilinear_align_corners(rng, out_hw):
    img = rng.randn(2, 10, 16).astype(np.float32)
    p = psamp.resize_bilinear_align_corners(_t(img), *out_hw).numpy()
    j = np.asarray(jsamp.resize_bilinear_align_corners(jnp.asarray(img),
                                                       *out_hw))
    np.testing.assert_allclose(p, j, **TOL)


@pytest.mark.parametrize("shift", [False, True])
def test_slab_origin(rng, shift):
    disp = (rng.rand(1, 1, 6, 8) * 0.003).astype(np.float32)
    incre = 0.0025 / 64
    np.testing.assert_array_equal(
        pcorr.slab_origin(_t(disp), 64, incre, shift).numpy(),
        np.asarray(jcorr.slab_origin(jnp.asarray(disp), 64, incre, shift)))


@pytest.mark.parametrize("mean", [False, True])
@pytest.mark.parametrize("hyp_chunk", [3, 16])
def test_exact_volume(rng, mean, hyp_chunk):
    poses, intr, ii, jj = _scene(rng, N=3, h=10, w=16)
    fm = rng.randn(1, 3, 10, 16, 8).astype(np.float32)
    origin = (rng.rand(1, 1, 10, 16) * 0.02 + 0.01).astype(np.float32)
    incre, D = 0.004, 7
    j = np.asarray(jcorr.build_corr_volume(
        jnp.asarray(fm), jnp.asarray(poses), jnp.asarray(intr), ii, jj,
        jnp.asarray(origin), D, incre, hyp_chunk=hyp_chunk,
        mean_over_views=mean))
    p = pcorr.build_corr_volume(
        _t(fm), _t(poses), _t(intr), _t(ii).long(), _t(jj).long(),
        _t(origin), D, incre, hyp_chunk=hyp_chunk,
        mean_over_views=mean).numpy()
    assert p.shape == j.shape == (1, 1 if mean else 2, 10, 16, D)
    assert np.abs(j).max() > 0.01  # samples land inside the source views
    np.testing.assert_allclose(p, j, rtol=1e-4, atol=1e-5)


def test_exact_volume_bf16_gather(rng):
    """bf16-valued features gathered in bf16 accumulate exactly in fp32."""
    poses, intr, ii, jj = _scene(rng, N=3, h=10, w=16)
    fm = rng.randn(1, 3, 10, 16, 8).astype(np.float32)
    fm = np.asarray(jnp.asarray(fm).astype(jnp.bfloat16).astype(jnp.float32))
    origin = (rng.rand(1, 1, 10, 16) * 0.02 + 0.01).astype(np.float32)
    j = np.asarray(jcorr.build_corr_volume(
        jnp.asarray(fm), jnp.asarray(poses), jnp.asarray(intr), ii, jj,
        jnp.asarray(origin), 5, 0.004, gather_dtype=jnp.bfloat16))
    p = pcorr.build_corr_volume(
        _t(fm), _t(poses), _t(intr), _t(ii).long(), _t(jj).long(),
        _t(origin), 5, 0.004, gather_dtype=torch.bfloat16).numpy()
    np.testing.assert_allclose(p, j, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("mean", [False, True])
def test_exact_volume_budget_and_recompute_change_no_value(rng, monkeypatch,
                                                          mean):
    """The backward's recomputation of each chunk gives the volume and the
    features' gradients of the recorded construction bit for bit; a gather
    budget that shrinks the chunk to one hypothesis gives the same volume
    bit for bit and the same gradients but for the order in which the
    chunks' contributions add up (fp32 rounding)."""
    poses, intr, ii, jj = _scene(rng, N=3, h=10, w=16)
    fm = rng.randn(1, 3, 10, 16, 8).astype(np.float32)
    origin = (rng.rand(1, 1, 10, 16) * 0.02 + 0.01).astype(np.float32)
    weights = _t(rng.randn(1, 1 if mean else 2, 10, 16, 7).astype(np.float32))

    def run(budget, recompute):
        monkeypatch.setattr(pcorr, "GATHER_BUDGET_BYTES", budget)
        if not recompute:
            monkeypatch.setattr(pcorr, "checkpoint",
                                lambda fn, *a, **k: fn(*a))
        f = _t(fm).requires_grad_()
        vol = pcorr.build_corr_volume(
            f, _t(poses), _t(intr), _t(ii).long(), _t(jj).long(),
            _t(origin), 7, 0.004, hyp_chunk=16, mean_over_views=mean)
        (vol * weights).sum().backward()
        monkeypatch.undo()
        return vol.detach(), f.grad

    want = run(1 << 40, recompute=False)
    got = run(1 << 40, recompute=True)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    one = run(1, recompute=True)
    assert torch.equal(one[0], want[0])
    torch.testing.assert_close(one[1], want[1], rtol=1e-6, atol=1e-7)
    with torch.no_grad():
        assert torch.equal(pcorr.build_corr_volume(
            _t(fm), _t(poses), _t(intr), _t(ii).long(), _t(jj).long(),
            _t(origin), 7, 0.004, mean_over_views=mean), want[0])


def test_build_pyramid(rng):
    vol = rng.randn(1, 2, 3, 4, 64).astype(np.float32)
    for a, b in zip(pcorr.build_pyramid(_t(vol)),
                    jcorr.build_pyramid(jnp.asarray(vol))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


@pytest.mark.parametrize("impl", ["banded", "gather"])
@pytest.mark.parametrize("D", [64, 44])
def test_lookup(rng, impl, D):
    vol = rng.randn(1, 2, 6, 8, D).astype(np.float32)
    origin = (rng.rand(1, 1, 6, 8) * 0.002).astype(np.float32)
    incre = 0.0025 / 64
    # estimates inside, below and far above the slab
    zinv = (origin + rng.uniform(-0.002, 0.004, (1, 2, 6, 8))).astype(
        np.float32)
    jl = jcorr.CorrPyramid(jcorr.build_pyramid(jnp.asarray(vol)),
                           jnp.asarray(origin), incre, D)
    pl = pcorr.CorrPyramid(pcorr.build_pyramid(_t(vol)), _t(origin), incre, D)
    j = np.asarray(jcorr.lookup(jl, jnp.asarray(zinv), 5, impl))
    p = pcorr.lookup(pl, _t(zinv), 5, impl).numpy()
    assert p.shape == (1, 2, 6, 8, 33)
    np.testing.assert_allclose(p, j, **TOL)


def test_lookup_rejects_unknown_impl(rng):
    vol = torch.zeros(1, 1, 2, 2, 8)
    pyr = pcorr.CorrPyramid(pcorr.build_pyramid(vol), torch.zeros(1, 1, 2, 2),
                            0.001, 8)
    with pytest.raises(ValueError):
        pcorr.lookup(pyr, torch.zeros(1, 1, 2, 2), 5, "no_such_impl")


@pytest.mark.parametrize("shape", [(5, 7), (4, 6, 3)])
def test_pfm_files_are_bit_identical(tmp_path, rng, shape):
    from cermvs_tpu.io.pfm import write_pfm as j_write
    from cermvs_torch.io.pfm import read_pfm, write_pfm

    img = rng.rand(*shape).astype(np.float32)
    write_pfm(tmp_path / "port.pfm", img)
    j_write(tmp_path / "jax.pfm", img)
    assert ((tmp_path / "port.pfm").read_bytes()
            == (tmp_path / "jax.pfm").read_bytes())
    np.testing.assert_array_equal(read_pfm(tmp_path / "jax.pfm"), img)


@pytest.mark.parametrize("scale,crop,multiple", [(1.0, None, 4),
                                                 (0.5, (20, 28), 8),
                                                 (2.0, None, 8)])
def test_scale_crop_pad_match_jax(rng, scale, crop, multiple):
    from cermvs_tpu.data import augment as jaug
    from cermvs_torch.data import augment as paug

    images = (rng.rand(3, 30, 42, 3) * 255).astype(np.float32)
    K = np.tile(np.array([[50.0, 0, 21], [0, 50.0, 15], [0, 0, 1]],
                         np.float32), (3, 1, 1))
    out = []
    for aug in (jaug, paug):
        im, k = aug.scale_operation(images, K, scale)
        if crop is not None:
            im, k = aug.crop_operation(im, k, *crop)
        out.append(aug.pad_to_multiple(im, k, multiple))
    (ij, kj), (ip, kp) = out
    assert ip.shape[1] % multiple == 0 and ip.shape[2] % multiple == 0
    np.testing.assert_array_equal(ip, ij)
    np.testing.assert_array_equal(kp, kj)

"""The port's multires merge, PLY files and fusion against the JAX package's
on the CPU.

* ``multires``: the merged PFMs and visualisation PNGs are byte-identical
  (both are the same host numpy and cv2 code);
* PLY: files byte-identical, and each package reads the other's;
* ``align_image_to_depth``: identical images and intrinsics;
* ``fusion`` on ``tests/test_pipeline.py``'s plane scene (6 cameras along
  x, fronto-parallel plane at z = 10) with depth maps perturbed by ~1%
  noise, so the threshold search moves both ways: the one-view path
  (``view_batch=0``), the ref-view-batched in-memory path (``view_batch=8``)
  and the streamed path. The same threshold at every search step, mask
  PNGs equal, PLY colours equal and points at rtol 1e-5 (the device side
  is fp32 torch ops against XLA's in the same order: reprojected depths and
  fused averages differ by rounding). A mask pixel could flip where its
  reprojection distance or depth ratio sits within rounding of a level's
  threshold; on this scene none does, and the test holds them to zero.
"""

import re

import cv2
import numpy as np
import pytest

from cermvs_tpu.io.ply import read_ply as j_read_ply
from cermvs_tpu.io.ply import write_ply as j_write_ply
from cermvs_tpu.pipeline.fusion import align_image_to_depth as j_align
from cermvs_tpu.pipeline.fusion import fusion as j_fusion
from cermvs_tpu.pipeline.multires import multires as j_multires
from cermvs_torch.io.pfm import write_pfm
from cermvs_torch.io.ply import read_ply, write_ply
from cermvs_torch.pipeline.fusion import align_image_to_depth, fusion
from cermvs_torch.pipeline.multires import multires
from test_pipeline import PlaneScene

N_VIEWS = 6


def _depth_dirs(tmp_path, maps, suffix):
    """The same depth maps under jax/depths and port/depths."""
    for side in ("jax", "port"):
        (tmp_path / side / "depths").mkdir(parents=True)
        for name, d in maps.items():
            write_pfm(tmp_path / side / "depths" / f"{name}{suffix}.pfm", d)
    return tmp_path / "jax", tmp_path / "port"


def test_multires_files_are_byte_identical(tmp_path, rng):
    maps = {}
    for name in ("00000000", "00000007"):
        lo = (rng.rand(12, 16) * 5 + 10).astype(np.float32)
        hi = cv2.resize(lo, (32, 24)) * (1 + rng.randn(24, 32).astype(
            np.float32) * 0.03)
        hi[:3] = 0.0  # no depth: low res wins
        maps[f"{name}_scale1_nf10"] = lo
        maps[f"{name}_scale2_nf10"] = hi.astype(np.float32)
    jdir, pdir = _depth_dirs(tmp_path, maps, "")
    kw = dict(suffix1="_nf10", suffix2="_nf10", th=0.02, visualize=True)
    j_multires(jdir, **kw)
    multires(pdir, **kw)
    written = sorted(p.name for p in (pdir / "depths").iterdir())
    assert written == sorted(p.name for p in (jdir / "depths").iterdir())
    assert "00000007_nf10_nf10_th0.02.pfm" in written
    assert "00000007.png" in written
    for name in written:
        assert ((pdir / "depths" / name).read_bytes()
                == (jdir / "depths" / name).read_bytes()), name


@pytest.mark.parametrize("n", [0, 1, 257])
def test_ply_files_are_byte_identical(tmp_path, rng, n):
    xyz = rng.randn(n, 3).astype(np.float32) * 100
    rgb = rng.randint(0, 256, (n, 3)).astype(np.uint8)
    write_ply(tmp_path / "port.ply", xyz, rgb)
    j_write_ply(tmp_path / "jax.ply", xyz, rgb)
    assert ((tmp_path / "port.ply").read_bytes()
            == (tmp_path / "jax.ply").read_bytes())
    for xyz_r, rgb_r in (read_ply(tmp_path / "jax.ply"),
                         j_read_ply(tmp_path / "port.ply")):
        np.testing.assert_array_equal(xyz_r, xyz.reshape(-1, 3))
        np.testing.assert_array_equal(rgb_r, rgb.reshape(-1, 3))


@pytest.mark.parametrize("img_hw,depth_hw", [((24, 32), (24, 32)),
                                             ((1200, 1600), (1152, 1600)),
                                             ((60, 80), (128, 160))])
def test_align_image_to_depth_matches_jax(rng, img_hw, depth_hw):
    img = rng.rand(*img_hw, 3).astype(np.float32)
    depth = np.zeros(depth_hw, np.float32)
    K = np.array([[30.0, 0, 16], [0, 30.0, 12], [0, 0, 1]])
    E = np.eye(4)
    E[0, 3] = 2.0
    for a, b in zip(align_image_to_depth(img, depth, 1, K, E),
                    j_align(img, depth, 1, K, E)):
        np.testing.assert_array_equal(a, b)


def _noisy_depths(scene, seed=0):
    rng = np.random.RandomState(seed)
    return {str(i): (scene.depth(i) * (1 + 0.01 * rng.randn(
        scene.H, scene.W))).astype(np.float32) for i in range(scene.n)}


def _iters(text):
    return re.findall(r"iter (\d+): thre=(\S+) mean_mask=(\S+)", text)


@pytest.mark.parametrize("view_batch,stream", [(0, False), (8, False),
                                               (0, True)])
def test_fusion_matches_jax(tmp_path, capsys, view_batch, stream):
    scene = PlaneScene(n=N_VIEWS, H=24, W=32, Z0=10.0, num_frames=3)
    jdir, pdir = _depth_dirs(tmp_path, _noisy_depths(scene), "_m")
    kw = dict(suffix="_m", glb=0.25, rescale=1, tot_iter=10,
              view_batch=view_batch, stream=stream)
    capsys.readouterr()
    j_out = j_fusion([scene[i] for i in range(scene.n)], jdir, **kw)
    j_log = capsys.readouterr().out
    p_out = fusion([scene[i] for i in range(scene.n)], pdir, device="cpu",
                   **kw)
    p_log = capsys.readouterr().out
    # the bisection took the same threshold at every step
    it_j, it_p = _iters(j_log), _iters(p_log)
    assert len(it_p) == len(it_j) == 10
    assert [t for _, t, _ in it_p] == [t for _, t, _ in it_j]
    assert len({t for _, t, _ in it_p}) == 10  # the search moved
    ratios = np.array([float(m) for _, _, m in it_p])
    assert ratios.min() < 0.25 < ratios.max()  # both ways
    flipped = 0
    for i in range(scene.n):
        mj = cv2.imread(str(jdir / "mask" / f"{i}_m.png"), 0)
        mp = cv2.imread(str(pdir / "mask" / f"{i}_m.png"), 0)
        assert mp.shape == mj.shape == (scene.H, scene.W)
        flipped += int((mp != mj).sum())
    assert flipped == 0, f"{flipped} mask pixels differ"
    xyz_j, rgb_j = j_read_ply(j_out)
    xyz_p, rgb_p = read_ply(p_out)
    assert 0 < len(xyz_p) == len(xyz_j) < scene.n * scene.H * scene.W
    np.testing.assert_array_equal(rgb_p, rgb_j)
    np.testing.assert_allclose(xyz_p, xyz_j, rtol=1e-5, atol=1e-5)


def test_fusion_refuses_what_is_not_ported(tmp_path):
    """A mesh that is no ``(data, view)`` DeviceMesh is refused before any
    work: fusion shards its reference views over that mesh alone, as the
    JAX package's does."""
    scene = PlaneScene(n=3, H=8, W=8, num_frames=2)
    with pytest.raises(ValueError, match=r"fusion's mesh .* must be a "
                       r"DeviceMesh with the axes \('data', 'view'\), "
                       r"got object"):
        fusion([scene[0]], tmp_path, mesh=object(), device="cpu")

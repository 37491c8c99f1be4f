"""The port's TNT, Blended and Custom datasets against the JAX package's on
the CPU. Each test writes a small synthetic tree and reads the same files
through both classes; every sample must be equal bit for bit (images,
depths, poses, intrinsics, names, scale).

BlendedMVS samples end in ``random_scale_and_crop``: with
``use_native`` unbound on both sides (the host data runtime's resize, both
packages' default) and bound to False on both (cv2's).
"""

import cv2
import numpy as np
import pytest
from scipy.spatial.transform import Rotation

from cermvs_tpu import config as jcfg
from cermvs_tpu.data.blended import Blended as JBlended
from cermvs_tpu.data.custom import Custom as JCustom
from cermvs_tpu.data.custom import quat_to_matrix as j_quat_to_matrix
from cermvs_tpu.data.pairs import window_neighbors as j_window_neighbors
from cermvs_tpu.data.tnt import TNT as JTNT
from cermvs_tpu.io import read_pfm_fast
from cermvs_torch import config as pcfg
from cermvs_torch import data as pdata
from cermvs_torch.data.blended import TRAINING_SET, Blended
from cermvs_torch.data.cams import write_cam_file
from cermvs_torch.data.custom import Custom, quat_to_matrix
from cermvs_torch.data.pairs import window_neighbors
from cermvs_torch.data.tnt import TNT
from cermvs_torch.io.pfm import read_pfm, write_pfm

HW = (24, 32)
K = np.array([[30.0, 0, 16], [0, 30.0, 12], [0, 0, 1]])


@pytest.fixture
def configs():
    """Both packages' bindings, cleared before and after."""
    for cfg in (jcfg, pcfg):
        cfg.clear_config()
    yield
    for cfg in (jcfg, pcfg):
        cfg.clear_config()


def _assert_items_equal(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
            assert a[k].dtype == b[k].dtype
        return
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, np.ndarray):
            np.testing.assert_array_equal(x, y)
            assert x.dtype == y.dtype
        else:
            assert x == y and type(x) is type(y)


def _assert_datasets_equal(p, j):
    assert len(p) == len(j)
    for i in range(len(p)):
        _assert_items_equal(p[i], j[i])


def _write_image(path, rng, hw=HW):
    path.parent.mkdir(parents=True, exist_ok=True)
    cv2.imwrite(str(path), (rng.rand(*hw, 3) * 255).astype(np.uint8))


def _pose(rng):
    E = np.eye(4)
    E[:3, :3] = Rotation.from_rotvec(rng.randn(3) * 0.1).as_matrix()
    E[:3, 3] = rng.randn(3)
    return E


def _write_pair(path, pairs):
    lines = [f"{len(pairs)}\n"]
    for i, nbrs in pairs.items():
        lines += [f"{i}\n", f"{len(nbrs)} " + " ".join(
            f"{n} {100.0 - r:.1f}" for r, n in enumerate(nbrs)) + "\n"]
    path.write_text("".join(lines))


# ---------------------------------------------------------------- TNT

TNT_LAYOUTS = {"Ignatius": "training_input/Ignatius",
               "Horse": "tankandtemples/intermediate/Horse",
               "Temple": "tankandtemples/advanced/Temple"}
TNT_VIEWS = 8
# view 1's list is short (backfilled), view 4's empty (a window instead)
TNT_PAIRS = {i: [(i + d) % TNT_VIEWS for d in (1, 2, 3)]
             for i in range(TNT_VIEWS)}
TNT_PAIRS[1] = [2]
TNT_PAIRS[4] = []


def _write_tnt(root, rel, seed):
    rng = np.random.RandomState(seed)
    scene = root / rel
    (scene / "cams").mkdir(parents=True)
    for i in range(TNT_VIEWS):
        _write_image(scene / "images" / f"{i:08d}.jpg", rng)
        write_cam_file(scene / "cams" / f"{i:08d}_cam.txt", _pose(rng), K,
                       aux=[0.5 + rng.rand(), 0.01, 192, 9.0])
    _write_pair(scene / "pair.txt", TNT_PAIRS)


@pytest.mark.parametrize("scan", sorted(TNT_LAYOUTS))
def test_tnt_layouts_match_jax(tmp_path, scan):
    _write_tnt(tmp_path, TNT_LAYOUTS[scan], seed=len(scan))
    kw = dict(dataset_path=str(tmp_path), scan=scan, num_frames=5)
    p, j = TNT(**kw), JTNT(**kw)
    assert p.root == j.root == tmp_path / TNT_LAYOUTS[scan]
    _assert_datasets_equal(p, j)


def test_tnt_backfill_window_and_aux_scale(tmp_path):
    _write_tnt(tmp_path, TNT_LAYOUTS["Ignatius"], seed=0)
    p = TNT(dataset_path=str(tmp_path), scan="Ignatius", num_frames=5)
    j = JTNT(dataset_path=str(tmp_path), scan="Ignatius", num_frames=5)
    # view 1: [2], backfilled breadth-first from the first entries of its
    # neighbours' lists (2 -> 3, 3 -> 4) until view 4's empty list stops it
    names = p[1][3]
    assert names == j[1][3] == [f"{i:08d}" for i in (1, 2, 3, 4)]
    # view 4: a sliding window of positions 2..7 without itself
    assert p[4][3] == j[4][3] == [f"{i:08d}" for i in (4, 2, 3, 5, 6, 7)]
    assert window_neighbors(list(range(8)), 4, 5) == j_window_neighbors(
        list(range(8)), 4, 5)
    for edge in (0, 7):
        assert window_neighbors(list(range(8)), edge, 5) == (
            j_window_neighbors(list(range(8)), edge, 5))
    # the scale: 400 / depth_min of the reference camera's aux row
    aux0 = float(open(tmp_path / TNT_LAYOUTS["Ignatius"] / "cams"
                      / "00000003_cam.txt").read().splitlines()[11].split()[0])
    assert p[3][4] == j[3][4] == 400.0 / aux0


def test_tnt_subset_through_the_loader(tmp_path, configs):
    _write_tnt(tmp_path, TNT_LAYOUTS["Ignatius"], seed=1)
    kw = dict(dataset_path=str(tmp_path), scan="Ignatius", num_frames=4,
              subset=(1, 8, 3), num_workers=0)
    from cermvs_tpu.data import get_test_data_loader as j_loader

    p = list(pdata.get_test_data_loader("TNT", **kw))
    j = list(j_loader("TNT", **kw))
    assert [item[3][0] for item in p] == ["00000001", "00000004",
                                          "00000007"]
    for a, b in zip(p, j):
        _assert_items_equal(a, b)


# ---------------------------------------------------------------- Blended

BL_VIEWS = 7
BL_HW = (40, 56)
BL_CROP = "random_scale_and_crop.crop_size = [32, 48]"


def _bind_blended(use_native):
    """Both packages' bindings for a Blended run: the crop, and
    ``use_native`` unbound (True, the default) or bound to False."""
    flags = [BL_CROP] + ([] if use_native else
                         ["random_scale_and_crop.use_native = False"])
    pcfg.parse_config(flags)
    jcfg.parse_config(flags)


def _write_blended(root, seed=0):
    """Two scenes in two subsets, nested three deep. Scene 0's view 2 lists
    too few pairs for num_frames 3 and is skipped; the depths have zeros."""
    rng = np.random.RandomState(seed)
    scenes = {TRAINING_SET[5]: "dataset_full_res_0-29",
              TRAINING_SET[40]: "dataset_full_res_60-89"}
    for s, (scene, subset) in enumerate(scenes.items()):
        d = root / subset / scene / scene / scene
        (d / "cams").mkdir(parents=True)
        (d / "rendered_depth_maps").mkdir(parents=True)
        pairs = {i: [(i + k) % BL_VIEWS for k in (1, 2, 3, 4)]
                 for i in range(BL_VIEWS)}
        if s == 0:
            pairs[2] = [3, 4]
        _write_pair(d / "cams" / "pair.txt", pairs)
        for i in range(BL_VIEWS):
            _write_image(d / "blended_images" / f"{i:08d}.jpg", rng, BL_HW)
            depth = (rng.rand(*BL_HW) * 300 + 200).astype(np.float32)
            depth[rng.rand(*BL_HW) < 0.2] = 0.0
            write_pfm(d / "rendered_depth_maps" / f"{i:08d}.pfm", depth)
            write_cam_file(d / "cams" / f"{i:08d}_cam.txt", _pose(rng), K,
                           aux=[150.0 + 10 * i, 0.5, 128, 700.0])
    return scenes


@pytest.mark.parametrize("use_native", [True, False])
@pytest.mark.parametrize("scaling", ["median", "aux"])
def test_blended_samples_match_jax(tmp_path, configs, scaling, use_native):
    _write_blended(tmp_path)
    _bind_blended(use_native)
    kw = dict(dataset_path=str(tmp_path), num_frames=3, scaling=scaling,
              seed=4)
    p, j = Blended(**kw), JBlended(**kw)
    # 2 scenes x 7 views, scene 0's view 2 skipped
    assert len(p) == 13 and p.index == j.index
    assert (TRAINING_SET[5], 2, [3, 4]) not in p.index
    # the samples in order, then again: the dataset's RandomState draws on
    _assert_datasets_equal(p, j)
    _assert_datasets_equal(p, j)
    s = p[0]
    assert s["images"].shape == (4, 32, 48, 3)
    assert s["depths"].shape == (4, 32, 48)


def test_blended_median_and_aux_scale(tmp_path, configs):
    """The median branch puts the sample's median valid depth at 600 (the
    crop aside), the other branch scales by 400 / depth_min of the
    reference camera; translations scale with the depths."""
    scenes = _write_blended(tmp_path)
    pcfg.parse_config([BL_CROP, "random_scale_and_crop.smin = 0.0",
                       "random_scale_and_crop.smax = 0.0"])
    scene = TRAINING_SET[5]
    d = tmp_path / scenes[scene] / scene / scene / scene
    raw = np.stack([read_pfm(d / "rendered_depth_maps" / f"{i:08d}.pfm")
                    for i in (0, 1, 2, 3)])
    med = 600.0 / np.median(raw[raw > 0])
    for scaling, scale in (("median", med), ("aux", 400.0 / 150.0)):
        s = Blended(dataset_path=str(tmp_path), num_frames=3,
                    scaling=scaling)[0]
        E = np.loadtxt(d / "cams" / "00000001_cam.txt", skiprows=1,
                       max_rows=4)
        np.testing.assert_allclose(s["poses"][1, :3, 3],
                                   (E[:3, 3] * scale).astype(np.float32),
                                   rtol=1e-6)
        crop = s["depths"][s["depths"] > 0]
        assert crop.min() >= 200 * scale * (1 - 1e-6)
        assert crop.max() <= 500 * scale * (1 + 1e-6)


@pytest.mark.parametrize("use_native", [True, False])
def test_blended_same_seed_gives_jax_crop(tmp_path, configs, use_native):
    _write_blended(tmp_path)
    _bind_blended(use_native)
    kw = dict(dataset_path=str(tmp_path), num_frames=3)
    for seed in (0, 11):
        p, j = Blended(seed=seed, **kw), JBlended(seed=seed, **kw)
        for i in (5, 0, 12):
            _assert_items_equal(p[i], j[i])
    a = Blended(seed=0, **kw)[5]["intrinsics"]
    b = Blended(seed=11, **kw)[5]["intrinsics"]
    assert not np.array_equal(a, b)


@pytest.mark.parametrize("use_native", [True, False])
def test_blended_through_the_train_loader(tmp_path, configs, use_native):
    _write_blended(tmp_path)
    _bind_blended(use_native)
    from cermvs_tpu.data import get_train_data_loader as j_loader

    kw = dict(datasetname="Blended", dataset_path=str(tmp_path),
              batch_size=2, num_frames=3, num_workers=0, seed=2)
    p = pdata.get_train_data_loader(**kw)
    j = j_loader(process_shard=(0, 1), **kw)
    assert len(p) == len(j) == 6
    for a, b in zip(p, j):
        _assert_items_equal(a, b)


def test_pfm_read_equals_jax_native_codec(tmp_path, rng):
    for shape in ((17, 23), (40, 56), (9, 11, 3)):
        img = (rng.randn(*shape) * 1e3).astype(np.float32)
        img.flat[::7] = 0.0
        f = tmp_path / f"{len(shape)}_{shape[0]}.pfm"
        write_pfm(f, img)
        a, b = read_pfm(f), read_pfm_fast(f)
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype and a.shape == b.shape == shape


# ---------------------------------------------------------------- Custom

CU_FRAMES = 9


@pytest.fixture
def custom_tree(tmp_path):
    """``images/`` (jpg, and a png that is skipped), ``cams.txt`` with
    non-unit quaternions, ``intrinsic.txt`` and ``min_depth/``."""
    rng = np.random.RandomState(5)
    root = tmp_path / "custom"
    rows = []
    for i in range(CU_FRAMES):
        _write_image(root / "images" / f"frame_{i:04d}.jpg", rng)
        q = rng.randn(4) * 1.3
        t = [0.4 * i + 0.05 * rng.randn(), 0.1 * rng.randn(), 0.0]
        rows.append([float(i)] + t + q.tolist())
    _write_image(root / "images" / "zz_other.png", rng)
    np.savetxt(root / "cams.txt", np.asarray(rows))
    np.savetxt(root / "intrinsic.txt", K)
    (root / "min_depth").mkdir()
    for i in range(CU_FRAMES):
        (root / "min_depth" / f"frame_{i:04d}.txt").write_text(
            f"{1.5 + 0.1 * i}\n")
    return root


def test_quat_to_matrix_matches_jax_and_scipy(rng):
    for _ in range(8):
        q = rng.randn(4) * rng.uniform(0.2, 3.0)
        m = quat_to_matrix(q)
        np.testing.assert_array_equal(m, j_quat_to_matrix(q))
        np.testing.assert_allclose(m, Rotation.from_quat(q).as_matrix(),
                                   atol=1e-12)
    np.testing.assert_array_equal(quat_to_matrix(np.zeros(4)),
                                  j_quat_to_matrix(np.zeros(4)))


@pytest.mark.parametrize("kw", [
    dict(num_frames=4),
    dict(num_frames=2, window_stride=3),
    dict(num_frames=3, min_dist_over_baseline=2.5),
    dict(num_frames=4, min_dist_over_baseline=None),
    dict(num_frames=2, subset=[1, 2, 4, 5, 7]),
], ids=["baseline", "stride2", "odd-window", "min-depth-files", "subset"])
def test_custom_samples_match_jax(custom_tree, kw):
    p = Custom(dataset_path=str(custom_tree), **kw)
    j = JCustom(dataset_path=str(custom_tree), **kw)
    assert p.data_index == j.data_index and p.ext == j.ext == ".jpg"
    np.testing.assert_array_equal(p.poses, j.poses)
    assert p.min_depth == j.min_depth
    _assert_datasets_equal(p, j)


def test_custom_scales_and_window_edges(custom_tree):
    rows = np.loadtxt(custom_tree / "cams.txt")[:, 1:4]
    mean_baseline = np.mean(np.linalg.norm(np.diff(rows, axis=0), axis=1))
    ds = Custom(dataset_path=str(custom_tree), num_frames=4)
    assert ds[3][4] == pytest.approx(400.0 / mean_baseline, rel=1e-12)
    # poses are world to camera: the camera centre maps to the origin
    c = np.append(rows[3], 1.0)
    np.testing.assert_allclose((ds.poses[3] @ c)[:3], 0.0, atol=1e-9)
    # windows at the ends are shifted inward: always num_frames + 1 frames
    for idx in (0, 1, CU_FRAMES - 1):
        names = ds[idx][3]
        assert len(set(names)) == 5 and names[0] == f"frame_{idx:04d}"
    assert ds[0][3] == ["frame_0000"] + [f"frame_{i:04d}" for i in (1, 2, 3,
                                                                    4)]
    md = Custom(dataset_path=str(custom_tree), num_frames=4,
                min_dist_over_baseline=None)
    assert md[6][4] == pytest.approx(400.0 / 2.1)


def test_custom_refuses_other_camera_formats(custom_tree):
    for cls in (Custom, JCustom):
        with pytest.raises(ValueError, match="cam_format"):
            cls(dataset_path=str(custom_tree), num_frames=4,
                cam_format="COLMAP")


def test_custom_through_the_test_loader(custom_tree, configs):
    from cermvs_tpu.data import get_test_data_loader as j_loader

    kw = dict(dataset_path=str(custom_tree), num_frames=4, num_workers=0)
    p = list(pdata.get_test_data_loader("Custom", **kw))
    j = list(j_loader("Custom", **kw))
    assert len(p) == CU_FRAMES
    for a, b in zip(p, j):
        _assert_items_equal(a, b)

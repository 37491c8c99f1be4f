"""The port's data layer against the JAX package's on the CPU: camera and
pair files, the loader's order and shuffle, ``random_scale_and_crop`` (both
packages' defaults, the host data runtime's resize, and their cv2 path,
``use_native=False``, with the same RandomState), and DTU training and test
samples on the synthetic tree of ``tests/test_data.py``. Both sides read
the same files and resize with the same arithmetic, so every sample
compares exactly.
"""

import threading

import numpy as np
import pytest

from cermvs_tpu import config as jcfg
from cermvs_tpu.data.augment import random_scale_and_crop as j_crop
from cermvs_tpu.data.dtu import DTU as JDTU
from cermvs_tpu.data.dtu import DTUTest as JDTUTest
from cermvs_tpu.data.loader import DataLoader as JLoader
from cermvs_torch import config as pcfg
from cermvs_torch import data as pdata
from cermvs_torch.data.augment import random_scale_and_crop
from cermvs_torch.data.cams import read_cam_file, write_cam_file
from cermvs_torch.data.dtu import DTU, DTUTest
from cermvs_torch.data.loader import DataLoader, Dataset
from cermvs_torch.data.pairs import backfill_neighbors, load_pair
from test_data import dtu_fixture  # noqa: F401


class _Idx(Dataset):
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"x": np.full((2,), i, np.int64)}


def _order(loader):
    return [b["x"][:, 0].tolist() for b in loader]


@pytest.mark.parametrize("workers", [0, 3])
def test_loader_order_matches_jax(workers):
    kw = dict(batch_size=4, shuffle=True, drop_last=True, seed=7)
    p = DataLoader(_Idx(18), num_workers=workers, **kw)
    j = JLoader(_Idx(18), num_workers=0, **kw)
    for _ in range(2):  # two epochs: the permutation follows seed + epoch
        assert _order(p) == _order(j)
    assert len(p) == len(j) == 4
    shard = DataLoader(_Idx(18), num_workers=workers, process_shard=(1, 2),
                       **kw)
    assert _order(shard) == [b[1::2] for b in _order(
        JLoader(_Idx(18), num_workers=0, **kw))]


def test_loader_raises_worker_errors():
    class Bad(Dataset):
        def __len__(self):
            return 6

        def __getitem__(self, i):
            if i == 3:
                raise ValueError("boom")
            return np.zeros(1)

    with pytest.raises(ValueError, match="boom"):
        list(DataLoader(Bad(), batch_size=None, num_workers=2))


def test_closing_the_loader_waits_for_its_workers():
    """A break leaves no worker running: a worker still inside cv2 or the
    native runtime when the interpreter exits aborts the process. The one
    worker is held in its second load for longer than a join of a second."""
    gate = threading.Event()

    class Slow(Dataset):
        def __len__(self):
            return 4

        def __getitem__(self, i):
            if i:
                gate.wait()
            return np.zeros(1)

    before = set(threading.enumerate())
    it = iter(DataLoader(Slow(), batch_size=None, num_workers=1))
    assert next(it).shape == (1,)
    timer = threading.Timer(1.5, gate.set)
    timer.start()
    it.close()
    timer.join()
    assert gate.is_set()
    assert [t for t in threading.enumerate()
            if t not in before and t is not timer] == []


def test_cams_and_pairs_roundtrip(tmp_path):
    E = np.arange(16, dtype=float).reshape(4, 4)
    K = np.array([[100.0, 0, 32], [0, 100.0, 24], [0, 0, 1]])
    write_cam_file(tmp_path / "c.txt", E, K, aux=[2.5, 0.01])
    e, k, aux = read_cam_file(tmp_path / "c.txt")
    np.testing.assert_array_equal(e, E)
    np.testing.assert_array_equal(k, K)
    np.testing.assert_array_equal(aux, [2.5, 0.01])
    (tmp_path / "pair.txt").write_text(
        "4\n0\n3 1 10.0 2 8.0 3 5.0\n1\n2 0 9.0 2 7.0\n2\n2 1 6.0 0 5.0\n"
        "3\n1 0 4.0\n")
    pairs = load_pair(tmp_path / "pair.txt")
    assert pairs[0]["pair"] == [1, 2, 3]
    assert backfill_neighbors(pairs, 3, 3) == [0, 1, 2]


def _crop_inputs(rng):
    images = (rng.rand(3, 60, 90, 3) * 255).astype(np.float32)
    depths = (rng.rand(3, 60, 90) * 5 + 1).astype(np.float32)
    K = np.tile(np.array([[50.0, 0, 45], [0, 50.0, 30], [0, 0, 1]],
                         np.float32), (3, 1, 1))
    return images, depths, K


@pytest.mark.parametrize("seed", [0, 3])
def test_random_scale_and_crop_matches_jax(rng, seed):
    """Both packages' defaults: the host data runtime's resize."""
    images, depths, K = _crop_inputs(rng)
    a = random_scale_and_crop(images, depths, K, crop_size=(48, 64),
                              rng=np.random.RandomState(seed))
    b = j_crop(images, depths, K, crop_size=(48, 64),
               rng=np.random.RandomState(seed))
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert a[0].shape == (3, 48, 64, 3) and a[1].shape == (3, 48, 64)


@pytest.mark.parametrize("seed", [0, 3])
def test_random_scale_and_crop_cv2_path_matches_jax(rng, seed):
    images, depths, K = _crop_inputs(rng)
    a = random_scale_and_crop(images, depths, K, crop_size=(48, 64),
                              rng=np.random.RandomState(seed),
                              use_native=False)
    b = j_crop(images, depths, K, crop_size=(48, 64),
               rng=np.random.RandomState(seed), use_native=False)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_native_resize_binding_matches_jax(rng):
    """``random_scale_and_crop.use_native`` bound in the port's
    configuration: True gives the JAX package's native arrays, False its
    cv2 arrays, and the two differ (float rounding), so a default that
    differed between the packages would crop other training batches."""
    images, depths, K = _crop_inputs(rng)
    out = {}
    for flag in (True, False):
        pcfg.clear_config()
        pcfg.parse_config([f"random_scale_and_crop.use_native = {flag}"])
        try:
            out[flag] = random_scale_and_crop(
                images, depths, K, crop_size=(48, 64),
                rng=np.random.RandomState(0))
        finally:
            pcfg.clear_config()
        want = j_crop(images, depths, K, crop_size=(48, 64),
                      rng=np.random.RandomState(0), use_native=flag)
        for x, y in zip(out[flag], want):
            np.testing.assert_array_equal(x, y)
    assert not np.array_equal(out[True][0], out[False][0])


def test_dtu_samples_match_jax(dtu_fixture):  # noqa: F811
    for cfg in (jcfg, pcfg):
        cfg.clear_config()
        cfg.parse_config(["random_scale_and_crop.crop_size = [24, 32]"])
    try:
        p = DTU(dataset_path=str(dtu_fixture), num_frames=3, light_number=0)
        j = JDTU(dataset_path=str(dtu_fixture), num_frames=3, light_number=0)
        assert len(p) == len(j) == 49 and p.image_depth_scale == 2
        for i in (0, 17, 48):
            sp, sj = p[i], j[i]
            assert sp["images"].shape == (4, 24, 32, 3)
            for k in sj:
                np.testing.assert_array_equal(sp[k], sj[k], err_msg=k)
    finally:
        jcfg.clear_config()
        pcfg.clear_config()


def test_dtu_test_samples_match_jax(dtu_fixture):  # noqa: F811
    kw = dict(dataset_path=str(dtu_fixture), scan="scan3", num_frames=5)
    p, j = DTUTest(**kw), JDTUTest(**kw)
    assert len(p) == len(j) == 49
    for a, b in zip(p[7], j[7]):
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b
    loader = pdata.get_test_data_loader(datasetname="DTUTest", subset=(5, 11, 5),
                                        num_workers=0, **kw_no_frames(kw))
    assert [item[3][0] for item in loader] == ["5", "10"]


def kw_no_frames(kw):
    return {k: v for k, v in kw.items() if k != "num_frames"}


def test_registry_holds_the_jax_datasets():
    from cermvs_tpu.data import dataset_dict as jax_datasets

    assert sorted(pdata.dataset_dict) == sorted(jax_datasets)
    assert len(pdata.dataset_dict) == 5
    for loader in (pdata.get_train_data_loader, pdata.get_test_data_loader):
        with pytest.raises(KeyError, match="unknown"):
            loader(datasetname="NoSuchSet")

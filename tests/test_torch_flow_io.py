"""``cermvs_torch.io.flow`` against the JAX package's ``io/flow.py`` on the
CPU: ``.flo`` and KITTI flow and disparity files round trip, the port reads
the JAX package's files and the JAX package the port's, each bit for bit,
and the files themselves are byte for byte the same."""

import cv2
import numpy as np
import pytest

from cermvs_tpu.io import flow as jflow
from cermvs_torch.io import flow
from cermvs_torch.io.pfm import write_pfm


def _flow(rng, h=13, w=21):
    return (rng.randn(h, w, 2) * 20).astype(np.float32)


def test_flo_round_trip_and_both_ways(tmp_path, rng):
    f = _flow(rng)
    flow.write_flo(tmp_path / "p.flo", f)
    jflow.write_flo(tmp_path / "j.flo", f)
    assert (tmp_path / "p.flo").read_bytes() == (
        tmp_path / "j.flo").read_bytes()
    for path in ("p.flo", "j.flo"):
        got = flow.read_flo(tmp_path / path)
        np.testing.assert_array_equal(got, f)
        np.testing.assert_array_equal(got, jflow.read_flo(tmp_path / path))
        assert got.dtype == np.float32 and got.shape == f.shape
    (tmp_path / "bad.flo").write_bytes(b"\0" * 12)
    with pytest.raises(ValueError, match="magic"):
        flow.read_flo(tmp_path / "bad.flo")
    with pytest.raises(ValueError, match=r"\(H, W, 2\)"):
        flow.write_flo(tmp_path / "x.flo", f[..., :1])


def test_kitti_flow_round_trip_and_both_ways(tmp_path, rng):
    # KITTI stores (u, v) * 64 + 2^15 as uint16: 1/64 steps within +-512
    f = np.round(_flow(rng) * 64) / 64
    flow.write_flow_kitti(tmp_path / "p.png", f)
    jflow.write_flow_kitti(tmp_path / "j.png", f)
    assert (tmp_path / "p.png").read_bytes() == (
        tmp_path / "j.png").read_bytes()
    for path in ("p.png", "j.png"):
        got, valid = flow.read_flow_kitti(tmp_path / path)
        want, jvalid = jflow.read_flow_kitti(tmp_path / path)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(valid, jvalid)
        np.testing.assert_array_equal(got, f)
        assert valid.dtype == np.float32 and (valid == 1).all()


def test_kitti_disparity_both_ways(tmp_path, rng):
    disp = (rng.rand(9, 17) * 100).astype(np.float64)
    disp[rng.rand(9, 17) < 0.3] = 0.0
    cv2.imwrite(str(tmp_path / "d.png"),
                np.round(disp * 256).astype(np.uint16))
    got, valid = flow.read_disp_kitti(tmp_path / "d.png")
    want, jvalid = jflow.read_disp_kitti(tmp_path / "d.png")
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(valid, jvalid)
    np.testing.assert_allclose(-got[..., 0], disp, atol=1 / 512)
    assert (got[..., 1] == 0).all() and (valid == (disp > 0)).all()


def test_read_gen_matches_jax(tmp_path, rng):
    f = _flow(rng)
    flow.write_flo(tmp_path / "a.flo", f)
    write_pfm(tmp_path / "b.pfm", (rng.rand(6, 8, 3) * 9).astype(np.float32))
    write_pfm(tmp_path / "c.pfm", (rng.rand(6, 8) * 9).astype(np.float32))
    cv2.imwrite(str(tmp_path / "d.png"),
                (rng.rand(6, 8, 3) * 255).astype(np.uint8))
    with open(tmp_path / "e.bin", "wb") as fh:  # a path would get .npy
        np.save(fh, f)
    for name in ("a.flo", "b.pfm", "c.pfm", "d.png", "e.bin"):
        got, want = flow.read_gen(tmp_path / name), jflow.read_gen(
            tmp_path / name)
        np.testing.assert_array_equal(got, want, err_msg=name)
        assert got.dtype == want.dtype
    assert flow.read_gen(tmp_path / "f.txt") == []
    assert flow.read_gen(tmp_path / "b.pfm").shape == (6, 8, 2)

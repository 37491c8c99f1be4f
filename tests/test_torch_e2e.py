"""The port's synthetic end-to-end example (cermvs_torch/examples/
e2e_synthetic.py) against the JAX package's (examples/e2e_synthetic.py) on
the CPU: the scan's images, and the file contract of a run at 64x96 with 3
views."""

import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from cermvs_torch.examples import e2e_synthetic as pe2e  # noqa: E402
from cermvs_torch.io.pfm import read_pfm  # noqa: E402
from examples import e2e_synthetic as je2e  # noqa: E402

HW = (64, 96)


def test_synthetic_scan_matches_jax():
    """The same texture and poses; the views warped through the plane by
    each package's projection and bilinear sampling. Their products and
    sums run in another order, so the sample positions differ by float
    rounding: the images agree within 1e-3 of their 0-255 range (2.7e-4
    measured on the CPU)."""
    j = je2e.SyntheticScan(3, *HW, num_frames=2)
    p = pe2e.SyntheticScan(3, *HW, num_frames=2)
    np.testing.assert_array_equal(p.poses, j.poses)
    np.testing.assert_array_equal(p.K, j.K)
    np.testing.assert_array_equal(p.images[0], j.images[0])
    np.testing.assert_allclose(p.images, j.images, rtol=0, atol=1e-3)
    assert np.abs(p.images[1:] - p.images[0]).max() > 10  # warped views
    for i in range(3):
        for a, b in zip(p[i], j[i]):
            if isinstance(a, np.ndarray):
                np.testing.assert_allclose(a, b, rtol=0, atol=1e-3)
            else:
                assert a == b


def test_cpu_run_writes_the_file_contract(tmp_path, capsys):
    """``main(["--cpu", ...])``: depth maps at rescale 1 and 2, the multires
    merge and its picture, fusion's masks and cloud, named as the JAX
    example names them."""
    out = tmp_path / "e2e"
    ply = pe2e.main(["--cpu", "--size", *map(str, HW), "--views", "3",
                     "--num_frames", "2", "--out", str(out)])
    assert ply == out / "result.ply"
    names = {str(p.relative_to(out)) for p in out.rglob("*") if p.is_file()}
    views = range(3)
    assert names == (
        {f"depths/{v}_scale{s}_nf2.pfm" for v in views for s in (1, 2)}
        | {f"depths/{v}_nf2_nf2_th0.02.pfm" for v in views}
        | {f"depths/{v}.png" for v in views}
        | {f"mask/{v}_nf2_nf2_th0.02.png" for v in views}
        | {"result.ply"})
    for v in views:
        assert read_pfm(out / "depths" / f"{v}_scale1_nf2.pfm").shape == (16,
                                                                         24)
        assert read_pfm(out / "depths" / f"{v}_scale2_nf2.pfm").shape == (32,
                                                                         48)
    header = ply.read_bytes().split(b"end_header")[0].decode()
    assert header.startswith("ply") and "element vertex" in header
    text = capsys.readouterr().out
    assert text.count("per view time") == 6 and "wrote" in text


def test_card_run_refuses_without_a_card(monkeypatch):
    """Without --cpu it runs on the card, and never quietly on the CPU."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        pe2e.main(["--size", *map(str, HW), "--views", "3"])

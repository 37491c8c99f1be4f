"""A CPU drill of the port's CLIs on a DTU-layout scan, as a user would run
them with ``-g inference_DTU`` once real data lands:

    python -m cermvs_torch.inference -g inference_DTU   (rescale 1 and 2)
    python -m cermvs_torch.multires  -g inference_DTU
    python -m cermvs_torch.fusion    -g inference_DTU

and the DTU loop of ``python -m cermvs_torch.demo`` on the same scan. The
scan is ``tests/test_demo_contract.py``'s (48x64 renders of a textured
plane, 49 camera files, 12 images, ``pair.txt``); the weights are a tiny
cascade ``((16, 0.5, 3),)`` from the port's seeded init, written with
``training.checkpoint.save_params`` and loaded through ``inference.ckpt``
(a path without ``.pth``). Random weights make the depths say nothing, so
the drill asserts the file contract of test_demo_contract.py: the PFM
names ``{ref}_scale{rescale}_nf10.pfm``, finite merged maps
``{ref}_nf10_nf10_th0.02.pfm``, the mask PNGs and a readable
``result.ply``; and that the demo loop writes the same files.

The demo's Tanks and Temples half (``demo.run_tnt_scan``) and
``python -m cermvs_torch.demo_custom`` run on trees of the same renders:
a TNT scan (``training_input/Ignatius``, 12 JPEGs, camera files with an aux
row, ``pair.txt``) and a TUM directory of 27 frames (the rescale-2 pass's
window needs 26). They must write the JAX package's contract:
``{ref}_scale1_nf15.pfm`` and ``{ref}_scale2_nf25.pfm`` (TNT, custom),
``{name}_scale0.5_nf10.pfm`` and ``min_depth/{name}.txt`` (custom), the
merged ``_nf15_nf25_th0.02`` maps, the masks and ``result.ply``.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from cermvs_torch import config as pconfig
from cermvs_torch import demo, demo_custom, fusion, inference, multires
from cermvs_torch.data.cams import write_cam_file
from cermvs_torch.io.pfm import read_pfm
from cermvs_torch.io.ply import read_ply
from cermvs_torch.models.raft import RAFT
from cermvs_torch.training.checkpoint import save_params
from test_demo_contract import (FOCAL, H, SPACING, W, Z_SCAN, N_IMGS,
                                _render, _texture_coefs, _write_scan)

REPO = Path(__file__).resolve().parent.parent
CASCADE = ((16, 0.5, 3),)


@pytest.fixture
def scan(tmp_path, monkeypatch):
    """The scan, the checkpoint, the bindings every CLI takes, and the
    repository as the working directory (the CLIs read ``configs/``)."""
    root = tmp_path / "DTU"
    _write_scan(root, _texture_coefs(np.random.RandomState(7)))
    ckpt = tmp_path / "pretrained" / "train_DTU"
    save_params(ckpt, RAFT(cascade=CASCADE, hyp_chunk=4, device="cpu",
                           generator=torch.Generator().manual_seed(0)))
    common = [f'DTUTest.dataset_path = "{root}"', 'DTUTest.scan = "scan3"',
              "get_test_data_loader.num_workers = 0",
              f"RAFT.cascade = {CASCADE}", "RAFT.hyp_chunk = 4",
              'inference.device = "cpu"', 'fusion.device = "cpu"']
    monkeypatch.chdir(REPO)
    yield ckpt, common, tmp_path
    pconfig.clear_config()


def _run(main, *bindings, gin=("inference_DTU",)):
    pconfig.clear_config()
    argv = ["-g", *gin]
    for b in bindings:
        argv += ["-p", b]
    return main(argv)


def _check_contract(out):
    for ref in range(N_IMGS):
        for rescale, shape in ((1, (12, 16)), (2, (24, 32))):
            f = out / "depths" / f"{ref}_scale{rescale}_nf10.pfm"
            assert read_pfm(f).shape == shape
        merged = read_pfm(out / "depths" / f"{ref}_nf10_nf10_th0.02.pfm")
        assert merged.shape == (24, 32) and np.isfinite(merged).all()
        assert (out / "mask" / f"{ref}_nf10_nf10_th0.02.png").exists()
    xyz, rgb = read_ply(out / "result.ply")
    # the threshold search keeps about glb = 25% of the pixels
    assert len(xyz) > 0 and np.isfinite(xyz).all() and rgb.dtype == np.uint8
    return xyz, rgb


def test_port_clis_write_the_demo_contract(scan):
    ckpt, common, tmp = scan
    out = tmp / "results"
    for rescale in (1, 2):
        records = _run(inference.main, *common, f'inference.ckpt = "{ckpt}"',
                       f'inference.output_folder = "{out}"',
                       f"inference.rescale = {rescale}")
        assert [r[0] for r in records] == [str(i) for i in range(N_IMGS)]
    _run(multires.main, f'multires.output_folder = "{out}"')
    ply = _run(fusion.main, *common, f'fusion.output_folder = "{out}"')
    assert ply == out / "result.ply"
    xyz, rgb = _check_contract(out)

    # the demo's DTU loop (no -g: its own arguments) writes the same files
    pconfig.clear_config()
    pconfig.parse_config(common)
    demo.run_dtu_scan("scan3", str(ckpt), tmp / "demo")
    xyz_d, rgb_d = _check_contract(tmp / "demo" / "scan3")
    np.testing.assert_array_equal(xyz_d, xyz)
    np.testing.assert_array_equal(rgb_d, rgb)


def test_inference_cli_refuses_a_missing_checkpoint(scan):
    _, common, tmp = scan
    with pytest.raises(FileNotFoundError):
        _run(inference.main, *common,
             f'inference.output_folder = "{tmp / "results"}"')


K_DEMO = np.array([[FOCAL, 0, W / 2], [0, FOCAL, H / 2], [0, 0, 1]])
CUSTOM_FRAMES = 27
CUSTOM_HW = (16, 32)
CUSTOM_STEP = 0.1  # a hand-held walk's spacing: 27 frames span 2.6, not 14


def _write_tnt_scan(root, coefs):
    """``training_input/Ignatius``: N_IMGS renders on the lateral line as
    JPEGs, their camera files with an aux row (depth_min 0.7 of the plane's
    depth), and each view's 10 nearest in ``pair.txt``."""
    import cv2

    scene = root / "training_input" / "Ignatius"
    (scene / "images").mkdir(parents=True)
    (scene / "cams").mkdir()
    for i in range(N_IMGS):
        x = SPACING * (i - N_IMGS // 2)
        E = np.eye(4)
        E[0, 3] = -x
        write_cam_file(scene / "cams" / f"{i:08d}_cam.txt", E, K_DEMO,
                       aux=[Z_SCAN * 0.7, 0.1, 192, Z_SCAN * 2])
        cv2.imwrite(str(scene / "images" / f"{i:08d}.jpg"),
                    _render(coefs, x, Z_SCAN).astype(np.uint8))
    lines = [f"{N_IMGS}\n"]
    for i in range(N_IMGS):
        nb = sorted(range(N_IMGS), key=lambda j: (abs(j - i), j))[1:11]
        lines += [f"{i}\n", f"{len(nb)} " + " ".join(
            f"{j} {100.0 - abs(j - i)}" for j in nb) + "\n"]
    (scene / "pair.txt").write_text("".join(lines))


def _write_custom(root, coefs):
    """A TUM directory: CUSTOM_FRAMES renders of CUSTOM_HW CUSTOM_STEP
    apart, camera-to-world rows with the identity rotation, one intrinsic
    matrix."""
    import cv2

    h, w = CUSTOM_HW
    (root / "images").mkdir(parents=True)
    rows = []
    for i in range(CUSTOM_FRAMES):
        x = CUSTOM_STEP * (i - CUSTOM_FRAMES // 2)
        cv2.imwrite(str(root / "images" / f"{i:06d}.jpg"),
                    _render(coefs, x, Z_SCAN, h, w).astype(np.uint8))
        rows.append([float(i), x, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0])
    np.savetxt(root / "cams.txt", np.asarray(rows))
    np.savetxt(root / "intrinsic.txt",
               [[FOCAL, 0, w / 2], [0, FOCAL, h / 2], [0, 0, 1]])


def _check_merged(out, names, points=True, hw=(H, W),
                  suffix="_nf15_nf25_th0.02"):
    """The merged maps and the fused cloud; fusion names the masks by the
    loader's position of the view, as the JAX package's does."""
    h, w = hw
    for i, name in enumerate(names):
        assert read_pfm(out / "depths" / f"{name}_scale1_nf15.pfm").shape == (
            h // 4, w // 4)
        assert read_pfm(out / "depths" / f"{name}_scale2_nf25.pfm").shape == (
            h // 2, w // 2)
        merged = read_pfm(out / "depths" / f"{name}{suffix}.pfm")
        assert merged.shape == (h // 2, w // 2) and np.isfinite(merged).all()
        assert (out / "mask" / f"{i}{suffix}.png").exists()
    xyz, rgb = read_ply(out / "result.ply")
    assert np.isfinite(xyz).all() and rgb.dtype == np.uint8
    assert len(xyz) > 0 or not points


def test_demo_tnt_half_writes_the_contract(scan):
    ckpt, common, tmp = scan
    _write_tnt_scan(tmp / "TNT", _texture_coefs(np.random.RandomState(8)))
    pconfig.clear_config()
    pconfig.parse_config(common + [f'TNT.dataset_path = "{tmp / "TNT"}"'])
    ply = demo.run_tnt_scan("Ignatius", str(ckpt), tmp / "results")
    out = tmp / "results" / "Ignatius"
    assert ply == out / "result.ply"
    names = [f"{i:08d}" for i in range(N_IMGS)]
    assert sorted(p.name for p in (out / "depths").glob("*_scale*")) == \
        sorted(f"{n}_scale{r}_nf{f}.pfm" for n in names
               for r, f in ((1, 15), (2, 25)))
    _check_merged(out, names)


def test_demo_custom_writes_the_contract(scan, monkeypatch):
    ckpt, common, tmp = scan
    data = tmp / "custom"
    _write_custom(data, _texture_coefs(np.random.RandomState(9)))
    monkeypatch.chdir(tmp)  # results/custom, as the CLI writes it
    pconfig.clear_config()
    # the random weights' 0.5x pass writes min-depths of ~1e-3, a scale
    # that widens the rectified windows past what the plain CPU epiband
    # takes in seconds: the exact construction (the contract is the files)
    bindings = common + ['inference.construction = "exact"']
    records, ply = demo_custom.main(
        ["--ckpt", str(ckpt), "--data", str(data)]
        + [a for b in bindings for a in ("-p", b)])
    out = tmp / "results" / "custom"
    assert Path(ply).resolve() == out / "result.ply"
    names = [f"{i:06d}" for i in range(CUSTOM_FRAMES)]
    assert [len(r) for r in records] == [CUSTOM_FRAMES] * 3
    assert sorted(p.name for p in (out / "depths").glob("*_scale*")) == \
        sorted(f"{n}_scale{r}_nf{f}.pfm" for n in names
               for r, f in ((0.5, 10), (1, 15), (2, 25)))
    assert read_pfm(out / "depths" / f"{names[0]}_scale0.5_nf10.pfm"
                    ).shape == (CUSTOM_HW[0] // 8, CUSTOM_HW[1] // 8)
    assert sorted(p.name for p in (data / "min_depth").iterdir()) == [
        f"{n}.txt" for n in names]
    md = [float(np.loadtxt(data / "min_depth" / f"{n}.txt")) for n in names]
    assert all(np.isfinite(md)) and min(md) > 0
    # random weights: the views need not agree, so the cloud may be empty
    _check_merged(out, names, points=False, hw=CUSTOM_HW)

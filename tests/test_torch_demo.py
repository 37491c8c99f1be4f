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
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from cermvs_torch import config as pconfig
from cermvs_torch import demo, fusion, inference, multires
from cermvs_torch.io.pfm import read_pfm
from cermvs_torch.io.ply import read_ply
from cermvs_torch.models.raft import RAFT
from cermvs_torch.training.checkpoint import save_params
from test_demo_contract import N_IMGS, _texture_coefs, _write_scan

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

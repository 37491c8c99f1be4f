"""CLI: the demo with the PyTorch port.

* DTU: for each scan, depth inference at rescale 1 and 2 (10 neighbours),
  the multires merge, and fusion at rescale 2 into
  ``results/<scan>/result.ply``, with the ``train_DTU`` weights;
* Tanks and Temples: for Ignatius and Meetingroom, inference at rescale 1
  with 15 neighbours and at rescale 2 with 25, the multires merge, and
  fusion at rescale 1, with the ``train_BlendedMVS`` weights.

    python -m cermvs_torch.demo [--dtu_ckpt pretrained/train_DTU]
        [--blended_ckpt pretrained/train_BlendedMVS]
"""

import argparse
from pathlib import Path

from cermvs_torch import config as cfg
from cermvs_torch.data import get_test_data_loader
from cermvs_torch.pipeline.fusion import fusion
from cermvs_torch.pipeline.inference import inference
from cermvs_torch.pipeline.multires import multires


def run_dtu_scan(scan, dtu_ckpt, output_folder):
    """Inference at rescale 1 and 2, multires and fusion for one scan;
    returns the fused cloud's path."""
    for rescale, num_frames in [(1, 10), (2, 10)]:
        loader = get_test_data_loader("DTUTest", scan=scan,
                                      num_frames=num_frames)
        inference(loader, ckpt=dtu_ckpt, output_folder=output_folder / scan,
                  rescale=rescale, do_report=True)
    multires(output_folder / scan, suffix1="_nf10", suffix2="_nf10",
             visualize=True)
    loader = get_test_data_loader("DTUTest", scan=scan, num_frames=10)
    return fusion(loader, output_folder / scan, rescale=2,
                  suffix="_nf10_nf10_th0.02")


def run_tnt_depths(scan, blended_ckpt, output_folder):
    """Inference at rescale 1 (15 neighbours) and 2 (25), then multires,
    for one Tanks and Temples scan; returns each pass's records."""
    records = {}
    for rescale, num_frames in [(1, 15), (2, 25)]:
        loader = get_test_data_loader("TNT", scan=scan,
                                      num_frames=num_frames)
        records[rescale] = inference(
            loader, ckpt=blended_ckpt, output_folder=output_folder / scan,
            rescale=rescale, do_report=True)
    multires(output_folder / scan, suffix1="_nf15", suffix2="_nf25",
             visualize=True)
    return records


def run_tnt_fusion(scan, output_folder):
    """Fusion at rescale 1 of one Tanks and Temples scan's merged depths;
    returns the fused cloud's path."""
    loader = get_test_data_loader("TNT", scan=scan, num_frames=10)
    return fusion(loader, output_folder / scan, rescale=1,
                  suffix="_nf15_nf25_th0.02")


def run_tnt_scan(scan, blended_ckpt, output_folder):
    """:func:`run_tnt_depths` and :func:`run_tnt_fusion` for one scan;
    returns the fused cloud's path."""
    run_tnt_depths(scan, blended_ckpt, output_folder)
    return run_tnt_fusion(scan, output_folder)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--dtu_ckpt", default="pretrained/train_DTU")
    parser.add_argument("--blended_ckpt",
                        default="pretrained/train_BlendedMVS")
    cfg.add_cli_flags(parser)
    args = parser.parse_args(argv)
    cfg.parse_cli(args)
    for scan in ["scan3"]:
        run_dtu_scan(scan, args.dtu_ckpt, Path("results"))
    for scan in ["Ignatius", "Meetingroom"]:
        run_tnt_scan(scan, args.blended_ckpt, Path("results"))


if __name__ == "__main__":
    main()

"""CLI: the DTU demo with the PyTorch port: for each scan, depth inference
at rescale 1 and 2 (10 neighbours), the multires merge, and fusion at
rescale 2 into ``results/<scan>/result.ply``:

    python -m cermvs_torch.demo [--dtu_ckpt pretrained/train_DTU]

The Tanks and Temples part of the JAX package's demo waits for the port's
TNT loader (ROADMAP Queue 1 item 2).
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


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--dtu_ckpt", default="pretrained/train_DTU")
    cfg.add_cli_flags(parser)
    args = parser.parse_args(argv)
    cfg.parse_cli(args)
    for scan in ["scan3"]:
        run_dtu_scan(scan, args.dtu_ckpt, Path("results"))


if __name__ == "__main__":
    main()

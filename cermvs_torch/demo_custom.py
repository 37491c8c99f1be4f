"""CLI: the demo on the user's own frames (a ``Custom`` TUM directory) with
the PyTorch port, in three passes:

1. rescale 0.5 with 10 neighbours, the scene scale from the cameras' mean
   baseline; each view's depth map writes ``<data>/min_depth/<name>.txt``;
2. rescale 1 with 15 neighbours and 3. rescale 2 with 25, each view's scale
   from its ``min_depth`` file;

then the multires merge of passes 2 and 3 and fusion at rescale 1 into
``results/custom/result.ply``:

    python -m cermvs_torch.demo_custom [--ckpt pretrained/train_BlendedMVS]
        [--data datasets/custom]
"""

import argparse
from pathlib import Path

from cermvs_torch import config as cfg
from cermvs_torch.data import get_test_data_loader
from cermvs_torch.pipeline.fusion import fusion
from cermvs_torch.pipeline.inference import inference
from cermvs_torch.pipeline.multires import multires

PASSES = [(0.5, 10), (1, 15), (2, 25)]  # (rescale, num_frames)


def run_custom(data, ckpt, output_folder):
    """The three passes, multires and fusion; returns each pass's records
    and the fused cloud's path."""
    records = []
    for i, (rescale, num_frames) in enumerate(PASSES):
        extra = {} if i == 0 else {"min_dist_over_baseline": None}
        loader = get_test_data_loader("Custom", dataset_path=data,
                                      num_frames=num_frames, **extra)
        records.append(inference(
            loader, ckpt=ckpt, output_folder=output_folder, rescale=rescale,
            do_report=True,
            write_min_depth=f"{data}/min_depth" if i == 0 else None))
    multires(output_folder, suffix1="_nf15", suffix2="_nf25", visualize=True)
    loader = get_test_data_loader("Custom", dataset_path=data, num_frames=10,
                                  min_dist_over_baseline=None)
    return records, fusion(loader, output_folder, rescale=1,
                           suffix="_nf15_nf25_th0.02")


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--ckpt", default="pretrained/train_BlendedMVS")
    parser.add_argument("--data", default="datasets/custom")
    cfg.add_cli_flags(parser)
    args = parser.parse_args(argv)
    cfg.parse_cli(args)
    return run_custom(args.data, args.ckpt, Path("results") / "custom")


if __name__ == "__main__":
    main()

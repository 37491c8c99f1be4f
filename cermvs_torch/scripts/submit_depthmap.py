"""Fan out one depth-map job per (scan, rescale[, view subset]):

    python -m cermvs_torch.scripts.submit_depthmap [-g submitter] [-p ...]
        [--tnt_root datasets/TanksAndTemples]

DTU validation and test scans at rescale 1 and 2 with 10 neighbours; Tanks
and Temples scans at rescale 1 with 15 neighbours and rescale 2 with 25, in
jobs of 100 views (a scan whose image folder is missing is skipped). Each
job runs ``python -m cermvs_torch.inference``.
"""

from __future__ import annotations

import argparse
import os

from cermvs_torch import config as cfg
from cermvs_torch.data.dtu import TEST_SET, VAL_SET
from cermvs_torch.data.tnt import ADVANCED_SET, INTERMEDIATE_SET, TRAINING_SET
from cermvs_torch.scripts.submitter import submitter

OUTPUT_FOLDER = "results"
INFERENCE = "python -m cermvs_torch.inference"


def main(argv=None):
    parser = cfg.add_cli_flags(argparse.ArgumentParser())
    parser.add_argument("--tnt_root", default="datasets/TanksAndTemples")
    args = parser.parse_args(argv)
    if not args.gin_config:
        args.gin_config = ["submitter"]
    cfg.parse_cli(args)

    executor = submitter()

    for scale, nf in [(1, 10), (2, 10)]:
        for scan in VAL_SET + TEST_SET:
            command = (
                f"{INFERENCE} -g inference_DTU -p "
                f"'get_test_data_loader.scan = \"scan{scan}\"' "
                f"'get_test_data_loader.num_frames = {nf}' "
                f"'inference.rescale = {scale}' "
                f"'inference.output_folder = \"{OUTPUT_FOLDER}/scan{scan}\"'"
            )
            executor.name = f"scan{scan}_{scale}_{nf}"
            executor.submit(command)

    for scale, nf in [(1, 15), (2, 25)]:
        for scan in TRAINING_SET + INTERMEDIATE_SET + ADVANCED_SET:
            if scan in TRAINING_SET:
                image_folder = f"{args.tnt_root}/training_input/{scan}/images"
            elif scan in INTERMEDIATE_SET:
                image_folder = (f"{args.tnt_root}/tankandtemples/"
                                f"intermediate/{scan}/images")
            else:
                image_folder = (f"{args.tnt_root}/tankandtemples/advanced/"
                                f"{scan}/images")
            if not os.path.isdir(image_folder):
                continue
            n = len(os.listdir(image_folder))
            for start in range(0, n, 100):
                end = min(n, start + 100)
                command = (
                    f"{INFERENCE} -g inference_TNT -p "
                    f"'get_test_data_loader.scan = \"{scan}\"' "
                    f"'get_test_data_loader.num_frames = {nf}' "
                    f"'get_test_data_loader.subset = ({start}, {end}, 1)' "
                    f"'inference.rescale = {scale}' "
                    f"'inference.output_folder = \"{OUTPUT_FOLDER}/{scan}\"'"
                )
                executor.name = f"{scan}_{scale}_{nf}_{start}"
                executor.submit(command)


if __name__ == "__main__":
    main()

"""Fan out one multires-and-fusion job per scan:

    python -m cermvs_torch.scripts.submit_fusion [-g submitter] [-p ...]

Every DTU validation and test scan and every Tanks and Temples scan: the
multi-resolution merge (``python -m cermvs_torch.multires``), then the
adaptive-threshold fusion (``python -m cermvs_torch.fusion``).
"""

from __future__ import annotations

import argparse

from cermvs_torch import config as cfg
from cermvs_torch.data.dtu import TEST_SET, VAL_SET
from cermvs_torch.data.tnt import ADVANCED_SET, INTERMEDIATE_SET, TRAINING_SET
from cermvs_torch.scripts.submitter import submitter

OUTPUT_FOLDER = "results"
MULTIRES = "python -m cermvs_torch.multires"
FUSION = "python -m cermvs_torch.fusion"


def main(argv=None):
    parser = cfg.add_cli_flags(argparse.ArgumentParser())
    args = parser.parse_args(argv)
    if not args.gin_config:
        args.gin_config = ["submitter"]
    cfg.parse_cli(args)

    executor = submitter()

    for scan in VAL_SET + TEST_SET:
        command = (
            f"{MULTIRES} -g inference_DTU -p "
            f"'multires.output_folder = \"{OUTPUT_FOLDER}/scan{scan}\"' && "
            f"{FUSION} -g inference_DTU -p "
            f"'get_test_data_loader.scan = \"scan{scan}\"' "
            f"'fusion.output_folder = \"{OUTPUT_FOLDER}/scan{scan}\"'"
        )
        executor.name = f"fusion_scan{scan}"
        executor.submit(command)

    for scan in TRAINING_SET + INTERMEDIATE_SET + ADVANCED_SET:
        command = (
            f"{MULTIRES} -g inference_TNT -p "
            f"'multires.output_folder = \"{OUTPUT_FOLDER}/{scan}\"' && "
            f"{FUSION} -g inference_TNT -p "
            f"'get_test_data_loader.scan = \"{scan}\"' "
            f"'fusion.output_folder = \"{OUTPUT_FOLDER}/{scan}\"'"
        )
        executor.name = f"fusion_{scan}"
        executor.submit(command)


if __name__ == "__main__":
    main()

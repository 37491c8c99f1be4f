"""CLI: adaptive-threshold point-cloud fusion with the PyTorch port, on the
shared ``configs/``:

    python -m cermvs_torch.fusion -g inference_DTU
    python -m cermvs_torch.fusion -g inference_DTU -p 'fusion.device = "cpu"'
"""

import argparse

from cermvs_torch import config as cfg
from cermvs_torch.data import get_test_data_loader
from cermvs_torch.pipeline.fusion import fusion


def main(argv=None):
    parser = cfg.add_cli_flags(argparse.ArgumentParser())
    cfg.parse_cli(parser.parse_args(argv))
    return fusion(get_test_data_loader())


if __name__ == "__main__":
    main()

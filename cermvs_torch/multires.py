"""CLI: the multi-resolution depth merge of the PyTorch port, on the shared
``configs/``:

    python -m cermvs_torch.multires -g inference_DTU
"""

import argparse

from cermvs_torch import config as cfg
from cermvs_torch.pipeline.multires import multires


def main(argv=None):
    parser = cfg.add_cli_flags(argparse.ArgumentParser())
    cfg.parse_cli(parser.parse_args(argv))
    return multires()


if __name__ == "__main__":
    main()

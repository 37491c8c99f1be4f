"""CLI: per-view depth inference with the PyTorch port, on the shared
``configs/`` (``-g inference_DTU`` unless ``-g`` is given):

    python -m cermvs_torch.inference -g inference_DTU
    python -m cermvs_torch.inference -p 'inference.device = "cpu"'
"""

import argparse

from cermvs_torch import config as cfg
from cermvs_torch.data import get_test_data_loader
from cermvs_torch.pipeline.inference import inference


def main(argv=None):
    parser = cfg.add_cli_flags(argparse.ArgumentParser())
    args = parser.parse_args(argv)
    if not args.gin_config:
        args.gin_config = ["inference_DTU"]
    cfg.parse_cli(args)
    return inference(get_test_data_loader())


if __name__ == "__main__":
    main()

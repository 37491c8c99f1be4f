"""CLI: train the cascaded RAFT model with the PyTorch port, on the shared
``configs/``:

    python -m cermvs_torch.train -g train_DTU -p train.num_steps=3
"""

import argparse

import numpy as np

from cermvs_torch import config as cfg
from cermvs_torch.training.train import train


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--seed", type=int, default=1234)
    cfg.add_cli_flags(parser)
    args = parser.parse_args(argv)
    cfg.parse_cli(args)
    np.random.seed(args.seed)
    return train(seed=args.seed)


if __name__ == "__main__":
    main()

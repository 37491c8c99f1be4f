"""Data-parallel training over N cards, one process a card:

    torchrun --nproc_per_node=N -m cermvs_torch.launch_distributed \\
        -g train_DTU [-p train.num_steps=3]

Each rank reads ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK`` (torchrun sets
them), takes ``cuda:LOCAL_RANK``, initialises the process group (NCCL on
the cards, gloo with ``--device cpu``), seeds numpy with ``seed + rank``
and calls ``train()``, which loads its share of every batch, exchanges the
rectification plans and averages the gradients over the ranks
(``training/train.py``). Several hosts: torchrun's ``--nnodes`` and
rendezvous flags, as for any torchrun job.
"""

import argparse
import os

import numpy as np
import torch

from cermvs_torch import config as cfg
from cermvs_torch.parallel.mesh import initialize_distributed
from cermvs_torch.training.train import train


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--seed", type=int, default=1234)
    parser.add_argument("--device", default="cuda",
                        help="cuda (this rank's card, NCCL) or cpu (gloo)")
    cfg.add_cli_flags(parser)
    args = parser.parse_args(argv)

    device = initialize_distributed(args.device)
    rank = int(os.environ.get("RANK", 0))
    world = int(os.environ.get("WORLD_SIZE", 1))
    print(f"rank {rank}/{world} on {device}", flush=True)
    cfg.parse_cli(args)
    np.random.seed(args.seed + rank)
    try:
        return train(seed=args.seed, device=device)
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()

"""The whole pipeline on a synthetic scan: inference at rescale 1 and 2,
the multires merge and adaptive fusion, through the code paths the demo
runs, with random weights from a seed (no trained checkpoint needed). It
shows the memory, the CUDA graphs per shape and the file contract at any
size.

    python -m cermvs_torch.examples.e2e_synthetic [--views 6]
        [--size 1152 1600] [--num_frames 3] [--out results/e2e_synthetic]
    python -m cermvs_torch.examples.e2e_synthetic --cpu --size 64 96 --views 3

It runs on the card unless ``--cpu`` is given, and refuses to start without
one.
"""

import argparse
import functools
import time
from pathlib import Path

import numpy as np
import torch

print = functools.partial(print, flush=True)  # a cut run keeps its lines


class SyntheticScan:
    """A dataset of the DTU test protocol: a textured plane at a known depth
    seen from ``n_views`` cameras; each view's image is the texture warped
    from view 0 through the plane."""

    def __init__(self, n_views, H, W, num_frames, Z=600.0):
        from cermvs_torch.ops.geometry import pixel_coords_of_hypotheses
        from cermvs_torch.ops.sampling import bilinear_sample

        self.num_frames = num_frames
        self.n = n_views
        rng = np.random.RandomState(0)
        K = np.array([[2892.0 * W / 1600, 0, W / 2],
                      [0, 2892.0 * W / 1600, H / 2], [0, 0, 1]], np.float32)
        self.K = K
        tex = rng.rand(H, W, 3).astype(np.float32) * 255
        for _ in range(2):
            tex = (tex + np.roll(tex, 1, 0) + np.roll(tex, -1, 0)
                   + np.roll(tex, 1, 1) + np.roll(tex, -1, 1)) / 5
        poses = np.tile(np.eye(4, dtype=np.float32), (n_views, 1, 1))
        for v in range(1, n_views):
            poses[v, 0, 3] = 15.0 * v * (1 if v % 2 else -1)
            poses[v, 1, 3] = 7.0 * (v % 3)
        self.poses = poses
        self.images = np.zeros((n_views, H, W, 3), np.float32)
        self.images[0] = tex
        for v in range(1, n_views):
            back = pixel_coords_of_hypotheses(
                torch.from_numpy(poses[None]),
                torch.from_numpy(np.tile(K, (1, n_views, 1, 1))),
                torch.tensor([v]), torch.tensor([0]),
                torch.full((1, 1, 1, H, W), 1.0 / Z))[0, 0, 0]
            self.images[v] = bilinear_sample(torch.from_numpy(tex),
                                             back).numpy()

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        ids = [i] + [j for j in range(self.n) if j != i][: self.num_frames]
        return (
            np.stack([self.images[j] for j in ids]),
            np.stack([self.poses[j] for j in ids]),
            np.tile(self.K, (len(ids), 1, 1)),
            [str(j) for j in ids],
            1.0,
        )


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--views", type=int, default=6)
    parser.add_argument("--size", type=int, nargs=2, default=[1152, 1600])
    parser.add_argument("--num_frames", type=int, default=3)
    parser.add_argument("--out", default="results/e2e_synthetic")
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU (default: the CUDA card)")
    args = parser.parse_args(argv)

    device = "cpu" if args.cpu else "cuda"
    if not args.cpu and not torch.cuda.is_available():
        raise SystemExit("e2e_synthetic: no CUDA device (--cpu runs on the "
                         "CPU)")

    from cermvs_torch.data.loader import DataLoader
    from cermvs_torch.models.raft import RAFT
    from cermvs_torch.pipeline.fusion import fusion
    from cermvs_torch.pipeline.inference import inference
    from cermvs_torch.pipeline.multires import multires

    H, W = args.size
    nf = args.num_frames
    out = Path(args.out)

    scan = SyntheticScan(args.views, H, W, nf)
    model = RAFT(test_mode=True, hyp_chunk=8, device=device,
                 generator=torch.Generator().manual_seed(0))

    for rescale in (1, 2):
        tic = time.time()
        loader = DataLoader(scan, batch_size=None, num_workers=2)
        inference(loader, model=model, output_folder=out, rescale=rescale,
                  do_report=True, device=device)
        print(f"rescale {rescale}: {time.time() - tic:.1f}s total")

    multires(out, suffix1=f"_nf{nf}", suffix2=f"_nf{nf}", visualize=True)
    loader = DataLoader(scan, batch_size=None, num_workers=2)
    ply = fusion(loader, out, rescale=2, suffix=f"_nf{nf}_nf{nf}_th0.02",
                 tot_iter=4, device=device)
    print("wrote", ply)
    return ply


if __name__ == "__main__":
    main()

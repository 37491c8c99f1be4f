"""The view-sharded forward's aggregations on two gloo ranks sharing one
card, at ``chip_smoke.py`` phase 14's size (DTU scale 1, 1152x1600, nf10,
the shipped model at full width, delta heads damped 1e-3): for each dtype,
aggregation and number of GRU iterations a stage, the disparities' and
the stage volumes' max |two ranks - one rank|, the exchange alone
(``ViewShardedVolume.aggregate`` of seeded features against the model's
aggregation), and each forward's seconds and peak memory per rank; first,
gloo's MAX and SUM ``all_reduce`` of CUDA tensors against numpy's.

    python3 chip_probe_parallel.py

Needs one card. Prints one line a case."""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from cermvs_torch.parallel import dryrun  # noqa: E402

CASES = [  # (construction, dtype, iterations a stage, aggregation)
    ("rectified", dt, it, agg)
    for dt in ("float32", "bfloat16")
    for it, agg in ((8, ("mean",)), (8, ("max",)), (8, ("std",)),
                    (8, ("mean", "max", "std")), (4, ("mean", "max", "std")),
                    (2, ("mean", "max", "std")), (1, ("mean", "max", "std")))
] + [("exact", dt, 8, ("mean", "max", "std"))
     for dt in ("float32", "bfloat16")]


def gloo_reduce_err(shape):
    """max |all_reduce - the host's| of a rank's CUDA tensor, MAX and SUM."""
    from cermvs_torch.parallel.mesh import rank, world

    x = torch.randn((2,) + shape, generator=torch.Generator().manual_seed(3))
    errs = []
    for op, ref in ((dist.ReduceOp.MAX, x.amax(0)), (dist.ReduceOp.SUM,
                                                     x.sum(0))):
        mine = x[rank(world())].cuda()
        dist.all_reduce(mine, op=op)
        errs.append(float((mine.cpu() - ref).abs().max()))
    return errs


def main():
    import chip_smoke as cs
    from cermvs_torch.ops import cudalib, epiband, hatwarp, lookup

    if not torch.cuda.is_available():
        raise SystemExit("needs a card")
    cudalib.build_all([epiband.LIB, hatwarp.LIB, lookup.LIB])
    spec = dict(scene="ring", H=cs.H, W=cs.W, N=cs.NUM_FRAMES + 1,
                rect_lambda_max=0.00375, damp=1e-3, **cs.PAR_FORWARD_TOL)
    t0 = time.perf_counter()
    with dryrun.World(2, "cuda") as world:
        print(f"gloo all_reduce of CUDA tensors, max |err| MAX, SUM by "
              f"rank: {world.run(gloo_reduce_err, (1, 288, 400, 33))}",
              flush=True)
        for case, dtype, iters, agg in CASES:
            model = dict(encoder_chunk=1, dtype=dtype,
                         cascade=((64, 64, iters), (-1, 320, iters)))
            res = world.run(dryrun.forward_task, dict(spec, model=model),
                            case, "cuda", agg)
            r0 = res[0]
            rel = r0["disp_err"] / r0["disp_max"]
            print(f"{case} {dtype} {iters} iterations a stage "
                  f"{'+'.join(agg)}: disparity {r0['disp_err']:.4e} of "
                  f"{r0['disp_max']:.4e} ({rel:.3e} relative); stage "
                  f"volumes {r0['volume_err']} of {r0['volume_max']}; the "
                  f"exchange alone by rank "
                  f"{[x.get('aggregate_err') for x in res]}; a second "
                  f"forward {[round(x['s'], 4) for x in res]} s by rank, one "
                  f"rank's {r0['plain_s']:.4f}; peak allocated by rank "
                  f"{[round(x['peak_bytes'] / 2**30, 2) for x in res]} GiB; "
                  f"{time.perf_counter() - t0:.0f} s", flush=True)


if __name__ == "__main__":
    main()

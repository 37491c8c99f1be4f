"""Readings that set a cell's limits: the plain reference against itself
in another precision (the control) or with a fault planted in it, on the
cell's own inputs at the cell's size, one JSON line a seed.

    python3 portbench/calibrate.py --workload tnt_nf15.infer_walk \\
        --seeds 11 12 13 --dtype float8
    python3 portbench/calibrate.py --workload dtu_nf10.train \\
        --seeds 11 12 13 --fault half

Inference cells compare the views a run's check would (``check_views``
visits of the traffic); training cells the first three steps. The sound
program's readings are the runs' own (``compared`` in each result).
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--dtype", default="float32")
    p.add_argument("--fault", choices=("half",), default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    import torch

    from cermvs_torch.models.raft import RAFT
    from portbench import check, harness, traffic
    from portbench.drivers.infer import model_kwargs

    bench = harness.benchmark()
    w = next(w for w in bench["workloads"] if w["name"] == args.workload)
    cell = harness.load("cells", args.workload)
    cfg = harness.load("configs", w["config"])
    mix = harness.load("traffic", w["traffic"])
    dev = torch.device(args.device)
    for seed in args.seeds:
        t = time.perf_counter()
        model = RAFT(test_mode=True, device=dev, **model_kwargs(cfg))
        weights = harness.make_weights(model, seed, dev,
                                       cfg.get("weight_scales"))
        del model
        data = traffic.make(mix, cfg, seed, dev)
        with check.precise():
            if mix["kind"] == "views":
                gaps = _view_gaps(check, cfg, cell, data, weights, seed,
                                  args.dtype, dev)
            else:
                pool = [data.batch(i) for i in range(3)]
                gws = [k / cfg["train"]["num_steps"] for k in range(3)]
                want = check.reference_steps(cfg, weights, pool, gws, dev)
                got = check.reference_steps(cfg, weights, pool, gws, dev,
                                            dtype=args.dtype,
                                            fault=args.fault)
                gaps = check.train_gaps(got, want)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "dtype": args.dtype, "fault": args.fault,
                          "gaps": gaps,
                          "seconds": time.perf_counter() - t}), flush=True)
        del data, weights
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return 0


def _view_gaps(check, cfg, cell, views, weights, seed, dtype, dev):
    """The worst gaps over ``check_views`` visits drawn from the seed."""
    from portbench import traffic

    visits = traffic.rng_of(seed, 3).choice(100, cell["check_views"],
                                            replace=False)
    ref = check.model_of(cfg, weights, "float32", True, dev)
    other = check.model_of(cfg, weights, dtype, True, dev)
    worst = {}
    for i in sorted(int(v) for v in visits):
        images, poses, intr, _, scale = views.visit(i)
        want = check.view_disparity(ref, images, poses, intr, scale, dev)
        got = check.view_disparity(other, images, poses, intr, scale, dev)
        for k, v in check.view_gaps(got, want, check.spacing(cfg)).items():
            worst[k] = max(worst.get(k, 0.0), v)
    return worst


if __name__ == "__main__":
    sys.exit(main())

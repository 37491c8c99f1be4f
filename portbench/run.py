"""Run one cell of the benchmark of the PyTorch and CUDA port on this
machine's cards and print its result as the last line of standard output.

    python3 portbench/run.py --workload tnt_nf15.infer_walk --seed 7 \\
        --seconds 30 --trace 0

``--trace 0`` measures the cell's end-to-end metrics; ``--trace 1`` runs a
traced window under ``torch.profiler`` and reports its per-layer metrics.
Every run checks what its timed path produced against the plain reference
(``portbench/check.py``) and prints each compared number beside its limit,
as the last lines of standard error and under ``compared`` in the result.
Exits non-zero, printing no result, without enough CUDA cards, without the
port beside it, or if the JAX stack or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def make_run(args, device, t_start=None):
    """The :class:`harness.Run` of the arguments on ``device``."""
    from portbench import harness

    bench = harness.benchmark()
    workload = next((w for w in bench["workloads"]
                     if w["name"] == args.workload), None)
    if workload is None:
        raise KeyError(f"no workload {args.workload!r} in BENCHMARK.json")
    e2e, layers = harness.cell_metrics(bench, args.workload)
    return harness.Run(
        workload=workload, cell=harness.load("cells", args.workload),
        config=harness.load("configs", workload["config"]),
        mix=harness.load("traffic", workload["traffic"]),
        end_to_end=e2e, per_layer=layers, seed=args.seed,
        seconds=args.seconds, trace=bool(args.trace), device=device,
        t_start=T_START if t_start is None else t_start)


def execute(run):
    """Drive the cell and return its result line (a dict)."""
    from portbench import harness

    harness.driver(run.cell["driver"]).run(run)
    result = {"correct": run.correct(), "attempted": run.attempted,
              "failed": run.failed}
    if run.trace:
        result["metrics"] = {m["name"]: run.metrics[m["name"]]
                             for m in run.per_layer
                             if m["name"] in run.metrics}
    else:
        result["metrics"] = {m["name"]: run.metrics[m["name"]]
                             for m in run.end_to_end
                             if m["name"] in run.metrics}
    result["device"] = harness.device_info(run.device,
                                           run.workload["chips"],
                                           run.peak_bytes)
    if run.trace and run.reading is not None:
        result["device"]["busy_s"] = run.reading.busy_s
        result["device"]["window_s"] = run.reading.window_s
        result["breakdown"] = run.reading.breakdown()
    result["notes"] = run.notes
    result["compared"] = {k: {"value": v, "limit": lim}
                          for k, (v, lim) in run.compared.items()}
    return result


def main(argv=None) -> int:
    args = parse(argv)
    try:
        import cermvs_torch  # noqa: F401
    except ImportError as e:
        print(f"portbench: the port is not importable here ({e})",
              file=sys.stderr)
        return 2
    import torch

    from portbench import harness

    run = make_run(args, torch.device("cuda"))
    chips = run.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    result = execute(run)
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: forbidden modules loaded: {', '.join(found)}",
              file=sys.stderr)
        return 4
    for name, c in result["compared"].items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""How the torchrun launcher of ``chip_smoke.py`` phase 14(c) ends, over
several runs: ``torchrun --nproc_per_node=1 -m
cermvs_torch.launch_distributed -g train_DTU -p train.num_steps=1`` on
phase 8's synthetic DTU tree, with phase 8's bindings. Each run prints its
return code, its seconds and whether the rank aborted at exit
(``terminate called``, a loader thread left inside native code), then one
JSON line of all runs. One card:

    python3 chip_probe_launcher.py --runs 4 [--repo PATH ...]

``--repo`` names checkouts whose ``cermvs_torch`` the ranks import (by
default this one); several are taken in turns (A, B, B, A, ...), so a
parent and a change compare in one call.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--runs", type=int, default=4)
    parser.add_argument("--repo", action="append", default=None)
    args = parser.parse_args()
    repos = [Path(r).resolve() for r in (args.repo or [HERE])]

    sys.path.insert(0, str(HERE))
    import chip_smoke as cs

    order = []
    for i in range(args.runs):
        order += repos if i % 2 == 0 else repos[::-1]
    results = {str(r): [] for r in repos}
    with tempfile.TemporaryDirectory(dir=HERE / "build") as tmp:
        tree = Path(tmp) / "dtu"
        cs.write_dtu_tree(tree, *cs.DTU_HW, cs.NUM_FRAMES)
        for n, repo in enumerate(order):
            cmd = [sys.executable, "-m", "torch.distributed.run",
                   "--standalone", "--nproc_per_node=1", "-m",
                   "cermvs_torch.launch_distributed", "-g", "train_DTU",
                   "-p", "train.num_steps=1",
                   "-p", f"DTU.dataset_path='{tree}'",
                   "-p", "DTU.light_number=0",
                   "-p", f"train.checkpoint_dir='{tmp}/ckpt{n}'",
                   "-p", f"train.run_dir='{tmp}/runs{n}'"]
            env = dict(os.environ, PYTHONPATH=str(repo))
            t0 = time.perf_counter()
            res = subprocess.run(cmd, cwd=repo, env=env, capture_output=True,
                                 text=True, timeout=300)
            run = {"rc": res.returncode,
                   "s": time.perf_counter() - t0,
                   "aborted": "terminate called" in res.stderr
                   or "exitcode  : -6" in res.stderr}
            results[str(repo)].append(run)
            print(f"{repo}: run {len(results[str(repo)])}: rc {run['rc']} "
                  f"in {run['s']:.1f} s, aborted {run['aborted']}",
                  flush=True)
            if run["rc"] != 0:
                print(res.stderr[:3000], flush=True)
    print(json.dumps(results))


if __name__ == "__main__":
    main()

"""Row sharding across cards: one NCCL rank a card, the image rows over a
``(row,)`` mesh of every rank, at ``chip_smoke.py`` phase 15(a)'s size
(phase 4's scene, 1152x1600, nf10, the shipped bf16 model at full width,
delta heads damped 1e-3). For the exact and the banded rectified route,
``InferenceRunner(mesh=)`` twice: its halo rows exchanged by send/recv
(``spatial.HALO_P2P_BACKENDS``, NCCL's default) and by the slot
all-reduce (gloo's form). Per route it prints the two forms' disparities
against each other (bit for bit: both move rows exactly), a replay against
the first dispatch (bit for bit, the collectives inside the graph), both
against the runner without a mesh on the same card (``chip_smoke``'s
``SPATIAL_ONE_TOL``), timed replays of the three in turns (the order
reversed every other round), one eager forward of each form with its
collectives timed alone, and the peaks.

    python3 chip_probe_spatial.py [--ranks N] [--replays R] [--out FILE]

Needs N cards (4 by default). Prints one JSON line a route on rank 0 and
writes every rank's figures to ``--out``, if given; exits non-zero when
a check fails or a rank fails or hangs."""

import argparse
import json
import os
import queue
import sys
import tempfile
import time
import traceback

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

FORMS = {"p2p": frozenset({"nccl"}), "slots": frozenset()}


def _form(name):
    from cermvs_torch.parallel import spatial

    spatial.HALO_P2P_BACKENDS = FORMS[name]


def route_figures(cs, model, scene, construction, device, mesh, replays):
    """One route on this rank: the checks' readings and the timings."""
    from cermvs_torch.parallel.dryrun import _timed_collectives
    from cermvs_torch.pipeline.inference import (GraphedForward,
                                                 InferenceRunner)

    images, poses, intr = scene
    kw = dict(model=model, device=device, construction=construction)
    plain = InferenceRunner(**kw)
    p_first = plain.submit(images, poses, intr, 1.0).clone()
    runners, firsts, out = {}, {}, {"peak_gib": {}}
    for name in FORMS:
        _form(name)
        torch.cuda.reset_peak_memory_stats(device)
        runners[name] = InferenceRunner(mesh=mesh, **kw)
        firsts[name] = runners[name].submit(images, poses, intr, 1.0).clone()
        replay = runners[name].submit(images, poses, intr, 1.0).clone()
        torch.cuda.synchronize(device)
        out["peak_gib"][name] = torch.cuda.max_memory_allocated(device) / 2**30
        out[f"{name}_path"] = runners[name].last_path
        out[f"{name}_graphed"] = [isinstance(f, GraphedForward)
                                  for f in runners[name]._cache.values()]
        out[f"{name}_replay_vs_first"] = float(
            (replay - firsts[name]).abs().max())
        out[f"{name}_vs_unmeshed"] = float(
            (firsts[name] - p_first).abs().max())
        r = runners[name].route(images[None], poses[None], intr[None], [1.0])
        out[f"{name}_collectives"] = _timed_collectives(
            r.volume_fn, runners[name], r.args, device)
        out["band_h"] = r.volume_fn.band_h
    out["p2p_vs_slots"] = float((firsts["p2p"] - firsts["slots"]).abs().max())
    out["disp_max"] = float(p_first.abs().max())
    out["plain_path"] = plain.last_path
    times = {k: [] for k in ("plain",) + tuple(FORMS)}
    turns = [("plain", plain)] + list(runners.items())
    for i in range(replays):  # each form first in every other round
        for name, runner in (turns if i % 2 == 0 else turns[::-1]):
            t, _ = cs.synced_s(torch, lambda: runner.submit(
                images, poses, intr, 1.0))
            times[name].append(t)
    out["replay_s"] = times
    return out


def rank_main(r, n, store_path, replays, results):
    import chip_smoke as cs
    from cermvs_torch.models.raft import RAFT
    from cermvs_torch.parallel.mesh import (initialize_distributed,
                                            make_row_mesh)

    try:
        device = initialize_distributed(
            torch.device("cuda", r), store=dist.FileStore(store_path, n),
            rank=r, world_size=n)
        model = RAFT(test_mode=True, device=device,
                     generator=torch.Generator().manual_seed(0))
        with torch.no_grad():
            for i in range(len(model.cascade)):
                getattr(model.update_block, f"delta{i}")[2].weight.mul_(1e-3)
        scene = cs.dtu_scene(cs.H, cs.W, cs.NUM_FRAMES + 1)
        mesh = make_row_mesh()
        out = {"card": torch.cuda.get_device_name(device)}
        for construction in ("exact", "rectified"):
            out[construction] = route_figures(cs, model, scene, construction,
                                              device, mesh, replays)
        results.put((r, out))
    except BaseException:
        results.put((r, {"error": traceback.format_exc()}))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def checks(cs, res):
    """The failures in every rank's figures (empty: all passed)."""
    tol = cs.SPATIAL_ONE_TOL
    bad = []
    for r, out in sorted(res.items()):
        if "error" in out:
            bad.append(f"rank {r}: {out['error']}")
            continue
        for construction in ("exact", "rectified"):
            f = out[construction]
            if f["plain_path"] != construction:
                bad.append(f"rank {r} {construction}: route {f['plain_path']}")
            if f["p2p_vs_slots"] != 0.0:
                bad.append(f"rank {r} {construction}: send/recv and slot "
                           f"halos differ by {f['p2p_vs_slots']}")
            for name in FORMS:
                if f[f"{name}_path"] != construction or \
                        f[f"{name}_graphed"] != [True]:
                    bad.append(f"rank {r} {construction} {name}: route or "
                               f"capture")
                if f[f"{name}_replay_vs_first"] != 0.0:
                    bad.append(f"rank {r} {construction} {name}: a replay "
                               f"is not the first dispatch bit for bit")
                if f[f"{name}_vs_unmeshed"] > tol["atol"] + tol["rtol"] * \
                        f["disp_max"]:
                    bad.append(f"rank {r} {construction} {name}: "
                               f"{f[f'{name}_vs_unmeshed']:.3e} off the "
                               f"unmeshed runner (of {f['disp_max']:.3e})")
    return bad


def main():
    import chip_smoke as cs
    from cermvs_torch.ops import cudalib, epiband, hatwarp, lookup

    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--replays", type=int, default=12)
    ap.add_argument("--deadline", type=float, default=420.0,
                    help="seconds the ranks may take before they are ended")
    ap.add_argument("--out", help="a JSON file for every rank's figures")
    args = ap.parse_args()
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < args.ranks:
        raise SystemExit(f"needs {args.ranks} cards")
    t0 = time.perf_counter()
    cudalib.build_all([epiband.LIB, hatwarp.LIB, lookup.LIB])
    print(f"kernels built in {time.perf_counter() - t0:.1f} s", flush=True)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(dir=cs.REPO / "build") as tmp:
        procs = [ctx.Process(target=rank_main, args=(
            r, args.ranks, os.path.join(tmp, "store"), args.replays,
            results)) for r in range(args.ranks)]
        for p in procs:
            p.start()
        res, end = {}, time.monotonic() + args.deadline
        try:
            while len(res) < args.ranks and time.monotonic() < end:
                try:
                    r, out = results.get(timeout=5)
                except queue.Empty:
                    if any(p.exitcode not in (None, 0) for p in procs):
                        break
                    continue
                res[r] = out
                if "error" in out:
                    break
        finally:
            for p in procs:
                p.join(timeout=30 if len(res) == args.ranks else 1)
                if p.is_alive():
                    p.terminate()
                    p.join()
    wall = time.perf_counter() - t0
    for r in range(args.ranks):
        res.setdefault(r, {"error": "no result (ended at the deadline or "
                                    "by a failed rank)"})
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"ranks": args.ranks, "wall_s": wall, "by_rank": res},
                      f)
    r0 = res[0]
    for construction in ("exact", "rectified"):
        if construction in r0:
            print(json.dumps({"route": construction, **r0[construction]}),
                  flush=True)
    bad = checks(cs, res)
    print(f"{args.ranks} ranks, {wall:.1f} s; "
          f"{'every check passed' if not bad else 'FAILED'}", flush=True)
    for b in bad:
        print(b, flush=True)
    if bad:
        raise SystemExit(1)


if __name__ == "__main__":
    main()

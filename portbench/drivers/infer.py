"""Inference cells: a closed loop of reference views through the port's
``inference()`` (its prep thread, pinned upload and dispatch-ahead) over an
in-memory loader, each view's depth map written to a file.

Set-up: the kernels' libraries (built into the checkout's ``build/`` on a
first run), the model with weights from the seed, the traffic's frame bank,
and one ``InferenceRunner`` that ``inference()`` is handed for every call
(its constructor is replaced by one that returns this runner, so the keys
captured in set-up stay captured, as after a scan's first views); then the
set-up's views, twice, which capture every construction key of the mix.

The window: the loader hands ``inference()`` one new view after another
(new frames every visit) until ``--seconds`` have passed, stamping each
hand-over on the host's clock; a view is complete when its depth file is
written, read from the file's modification time on the same clock.
``views_per_s`` counts the files written inside the window over the time
from its start to the last of them; ``view_p90_s`` is the 90th percentile
of every handed-over view's latency. The harness times each ``route``
call and the prep thread's resize and bf16 cast of each view's frames
(their medians in the run's ``notes``); a traced run takes
``trace_items`` views under the profiler, with those spans marked in it.

The check: ``check_views`` views of the window, drawn from the seed, each
compared with the reference's forward of the same inputs.
"""

from __future__ import annotations

import gc
import importlib
import time
import types
from pathlib import Path
from unittest import mock

import torch

from portbench import check, flops, harness, traffic, tracing


class Loader:
    """``inference()``'s loader: visits ``first``, ``first + 1``, ... of
    the traffic, ``count`` of them or until ``until`` (host clock,
    ``time.perf_counter``); ``handed`` maps each view's name to the
    hand-over's wall time (ns)."""

    def __init__(self, views: traffic.ViewTraffic, first: int,
                 count: int = None, until: float = None):
        self.views = views
        self.first = first
        self.count = count
        self.until = until
        self.handed = {}
        self.dataset = types.SimpleNamespace(num_frames=views.num_frames)

    def __iter__(self):
        i = self.first
        while ((self.count is None or i < self.first + self.count)
               and (self.until is None or time.perf_counter() < self.until)):
            item = self.views.visit(i)
            self.handed[item[3][0]] = time.time_ns()
            yield item
            i += 1


def model_kwargs(config):
    m = config["model"]
    return dict(cascade=[tuple(s) for s in m["cascade"]],
                encoder_type=m["encoder_type"], dim_fmap=m["dim_fmap"],
                dim_net=m["dim_net"], dim_inp=m["dim_inp"],
                num_levels=m["num_levels"], radius=m["radius"],
                hyp_chunk=m["hyp_chunk"], remat=m["remat"],
                lookup_impl=m["lookup_impl"], aggregation=m["aggregation"],
                dtype=m["dtype"])


def build_kernels(device):
    if device.type == "cuda":
        from cermvs_torch.ops import cudalib, epiband, hatwarp, lookup

        cudalib.build_all([epiband.LIB, hatwarp.LIB, lookup.LIB])


def depth_path(out: Path, name: str, config) -> Path:
    return (out / "depths"
            / f"{name}_scale{config['rescale']}_nf{config['num_frames']}.pfm")


def run(r: harness.Run) -> None:
    from cermvs_torch.models.raft import RAFT

    # the module (the package's ``inference`` names its function)
    infer_mod = importlib.import_module("cermvs_torch.pipeline.inference")

    cfg, mix, cell, dev = r.config, r.mix, r.cell, r.device
    build_kernels(dev)
    model = RAFT(test_mode=True, device=dev, **model_kwargs(cfg))
    weights = harness.make_weights(model, r.seed, dev,
                                   cfg.get("weight_scales"))
    views = traffic.make(mix, cfg, r.seed, dev)
    runner = infer_mod.InferenceRunner(model=model,
                                       construction=cfg["construction"],
                                       device=dev)
    out = harness.scratch_dir()
    try:
        with mock.patch.object(infer_mod, "InferenceRunner",
                               lambda **kw: runner):
            def infer(loader):
                return infer_mod.inference(
                    loader, model=model, output_folder=str(out),
                    rescale=cfg["rescale"], construction=cfg["construction"],
                    device=dev)

            warm = mix["warm"]
            for _ in range(mix["warm_rounds"]):
                infer(Loader(views, -warm, count=warm))
            spans = {"route": [], "prep": []}
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            setup_s = time.perf_counter() - r.t_start
            timed = (_timed(runner, "route", spans, "route", r.trace),
                     _timed(infer_mod, "scale_operation", spans, "prep",
                            r.trace),
                     _timed(infer_mod, "to_bf16", spans, "prep", r.trace))
            if r.trace:
                with torch.profiler.profile(activities=_activities(dev)) \
                        as prof, timed[0], timed[1], timed[2]:
                    loader = Loader(views, 0, count=cell["trace_items"])
                    records = infer(loader)
                    if dev.type == "cuda":
                        torch.cuda.synchronize(dev)
                trace_path = out / "trace.json"
                prof.export_chrome_trace(str(trace_path))
            else:
                with timed[0], timed[1], timed[2]:
                    t0_ns = time.time_ns()
                    t0 = time.perf_counter()
                    loader = Loader(views, 0, until=t0 + r.seconds)
                    records = infer(loader)
        r.peak_bytes = harness.peak_bytes(dev)
        runner = model = None
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()

        routes = {}
        captures = sum(1 for rec in records if rec[3] > 0)
        for rec in records:
            routes[rec[2]] = routes.get(rec[2], 0) + 1
        r.notes.update(routes=routes, captures_in_window=captures,
                       views=len(loader.handed))
        done = {}
        for name, handed in loader.handed.items():
            path = depth_path(out, name, cfg)
            if path.exists():
                done[name] = (path.stat().st_mtime_ns, handed)
        r.attempted = len(loader.handed)
        r.failed = r.attempted - len(done)

        if not r.trace:
            # the views completed inside the window over the time from its
            # start to the last of them
            end_ns = t0_ns + int(r.seconds * 1e9)
            inside = [m for m, _ in done.values() if t0_ns <= m <= end_ns]
            if inside:
                r.put("views_per_s",
                      len(inside) / ((max(inside) - t0_ns) * 1e-9))
            r.notes["host_ms"] = {
                k: 1e3 * harness.quantile(v, 0.5)
                for k, v in (("route", spans["route"]),
                             ("prep", _per_view(spans["prep"])))
                if v}
            if done:
                r.put("view_p90_s", harness.quantile(
                    [(m - h) * 1e-9 for m, h in done.values()], 0.90))
            r.put("peak_mem_gib", r.peak_bytes / 2**30)
            r.put("setup_s", setup_s)
        else:
            r.reading = tracing.Reading(
                trace_path, spans, "portbench.route", cell["trace_skip"],
                _view_flops(cfg), _epiband_bytes(views, loader, cfg),
                flops.peaks(torch.cuda.get_device_name(dev))
                if dev.type == "cuda" else None)
            r.read_layers()
        _check(r, views, weights, out, sorted(done))
    finally:
        harness.remove(out)


def _activities(dev):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def _timed(module, name: str, spans, span: str, mark: bool):
    """``module.name`` (a module's function or an object's method) timed
    into ``spans[span]``, and with ``mark`` marked in the trace, while the
    context lasts; ``inference()`` looks its helpers up in its module at
    each call."""
    fn = getattr(module, name)

    def timed(*args, **kwargs):
        t = time.perf_counter()
        if mark:
            with torch.profiler.record_function(f"portbench.{span}"):
                out = fn(*args, **kwargs)
        else:
            out = fn(*args, **kwargs)
        spans[span].append(time.perf_counter() - t)
        return out

    return mock.patch.object(module, name, timed)


def _per_view(prep):
    """A view's prep seconds: its resize and its cast, in the order the
    prep thread makes them."""
    return [a + b for a, b in zip(prep[0::2], prep[1::2])]


def _view_flops(cfg) -> float:
    H, W = cfg["image_hw"]
    return flops.forward_flops(cfg["model"], cfg["num_frames"] + 1, H, W)


def _epiband_bytes(views, loader, cfg):
    """The traced views' epiband bytes from their plans, which the
    reference's planner works out again (one plan a reference camera)."""
    from portbench.reference import route as ref_route

    m = cfg["model"]
    stages = [flops.hypotheses(d, m) for d, _, _ in m["cascade"]]
    per_ref, total = {}, {}
    for name in loader.handed:
        i = int(name[1:])
        ref = views.ids(i)[0]
        if ref not in per_ref:
            images, poses, intr, _, scale = views.visit(i)
            _, kind, key = ref_route.route_view(
                poses, intr, scale, images.shape[1:3], 4, m["dim_fmap"])
            if kind == "rectified":
                per_ref[ref] = flops.plan_epiband_bytes(key, m["dim_fmap"],
                                                        stages)
            elif kind == "mixed":
                plan, rect_views = key
                per_ref[ref] = flops.plan_epiband_bytes(
                    plan, m["dim_fmap"], stages,
                    views=range(len(rect_views)))
            else:
                per_ref[ref] = {}
        for k, b in per_ref[ref].items():
            total[k] = total.get(k, 0) + b
    return total


def _check(r, views, weights, out: Path, done) -> None:
    """Compare the depth maps of ``check_views`` completed views, drawn
    from the seed, with the reference's."""
    cell, cfg, dev = r.cell, r.config, r.device
    limits = cell["limits"]
    if not done:
        r.compared.update({k: (None, lim) for k, lim in limits.items()})
        return
    pick = traffic.rng_of(r.seed, 3).choice(
        len(done), min(cell["check_views"], len(done)), replace=False)
    t = time.perf_counter()
    worst = {}
    with check.precise():
        model = check.model_of(cfg, weights, "float32", True, dev)
        for k in sorted(pick):
            name = done[k]
            images, poses, intr, _, scale = views.visit(int(name[1:]))
            ref = check.view_disparity(model, images, poses, intr, scale,
                                       dev)
            prog = check.disparity_of_depth(
                check.read_pfm(depth_path(out, name, cfg)))
            for key, v in check.view_gaps(prog, ref,
                                          check.spacing(cfg)).items():
                worst[key] = max(worst.get(key, 0.0), v)
    r.notes["check_s"] = time.perf_counter() - t
    r.notes["gaps"] = worst
    r.compared.update({k: (worst[k], lim) for k, lim in limits.items()})
    del model
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

"""The port's memory and profiling utilities (cermvs_torch/utils/memory.py,
profiling.py) on the CPU: JAX's tests/test_utils.py cases for the memory
stats, with device="cpu"; a torch.profiler trace written to disk; tracing's
spans and counters, on and off, in a forward, ``inference()``, a train step
and the plan cache; and the trace readers on a hand-written Chrome trace.
The device marks run on a card: ``tests/test_torch_cuda.py``."""

import importlib
import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from cermvs_torch.models.raft import RAFT
from cermvs_torch.ops.rectify import PlanCache, RectPlan
from cermvs_torch.utils import profiling
from cermvs_torch.utils.memory import device_memory_stats, report
from cermvs_torch.utils.profiling import trace

KEYS = {"bytes_in_use_mb", "peak_bytes_in_use_mb", "bytes_limit_mb"}


def test_memory_stats_and_report(capsys):
    stats = device_memory_stats("cpu")
    assert len(stats) >= 1
    assert all(set(s) == KEYS and not any(s.values())
               for s in stats.values())
    report("cpu")
    assert "peak" in capsys.readouterr().out


def test_memory_stats_need_a_card(monkeypatch):
    """The default reads the CUDA devices and raises with none: the host
    is never reported in their place."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device_memory_stats()


@pytest.fixture
def tracing():
    """Tracing on for the test, off and cleared after it."""
    profiling.reset()
    profiling.enable()
    yield
    profiling.enable(False)
    profiling.reset()


def small_forward():
    """A small fp32 test-mode model and its inputs: three 32x64 views."""
    model = RAFT(cascade=((8, 64, 1), (-1, 320, 1)), dtype=torch.float32,
                 device="cpu", test_mode=True)
    rng = np.random.RandomState(0)
    images = torch.from_numpy(rng.rand(1, 3, 32, 64, 3).astype(np.float32)
                              * 255)
    poses = torch.eye(4).repeat(1, 3, 1, 1)
    poses[0, 1, 0, 3], poses[0, 2, 0, 3] = -1.0, 1.0
    intr = torch.tensor([[40.0, 0, 32], [0, 40.0, 16], [0, 0, 1]]).repeat(
        1, 3, 1, 1)
    return model, (images, poses, intr)


def traced_names(directory: Path):
    files = list(directory.glob("*.pt.trace.json"))
    assert len(files) == 1
    return {e.get("name") for e in json.loads(files[0].read_text())[
        "traceEvents"]}


def test_trace_writes_the_model_ranges(tmp_path, tracing):
    """A trace of a small forward with tracing on: one Chrome trace file
    under the directory, naming the model's ranges."""
    model, inputs = small_forward()
    with trace(tmp_path / "prof") as prof, torch.no_grad():
        model(*inputs)
    names = traced_names(tmp_path / "prof")
    assert {"cermvs.raft.encoders", "cermvs.raft.volume_prepare",
            "cermvs.raft.volume_stage0", "cermvs.raft.iterations_stage1"
            } <= names
    assert any(e.key == "cermvs.raft.encoders" for e in prof.key_averages())
    assert profiling.counters()["raft.encoders_s"] > 0


def test_tracing_off_records_nothing(tmp_path):
    """With tracing off a span is one shared no-op context and a count
    adds nothing: no ``cermvs.*`` range in a profiled forward, no
    counter."""
    assert not profiling.enabled()
    assert profiling.span("raft.encoders") is profiling.span("x", 3)
    profiling.count("routes.exact")
    model, inputs = small_forward()
    with trace(tmp_path / "prof"), torch.no_grad():
        model(*inputs)
    assert not any(str(n).startswith("cermvs.")
                   for n in traced_names(tmp_path / "prof"))
    assert profiling.counters() == {}


def test_tracing_leaves_the_forward_bit_for_bit():
    model, inputs = small_forward()
    with torch.no_grad():
        off = model(*inputs)
        profiling.enable()
        try:
            on = model(*inputs)
        finally:
            profiling.enable(False)
            profiling.reset()
    assert torch.equal(on, off)


def test_spans_and_counters(tracing):
    """A span adds its host seconds under ``<name>_s`` and names its
    item; counters add, copy out and reset; a CPU tensor gets no marks."""
    with profiling.span("route", item=7, on=torch.zeros(1)):
        profiling.count("routes.exact")
        profiling.count("capture_s", 0.5)
    profiling.count("routes.exact", 2)
    got = profiling.counters()
    assert got["routes.exact"] == 3 and got["capture_s"] == 0.5
    assert got["route_s"] > 0 and set(got) == {"routes.exact", "capture_s",
                                               "route_s"}
    got["routes.exact"] = 0
    assert profiling.counters()["routes.exact"] == 3
    profiling.reset()
    assert profiling.counters() == {}


def test_counters_lose_no_update_across_threads(tracing):
    """Threads counting one counter at once (the prep thread and the
    dispatching one do): no update is lost."""
    import os
    import sys
    import threading

    n_threads, per = 2 * (os.cpu_count() or 2), 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=lambda: [
            profiling.count("routes.exact") for _ in range(per)])
            for _ in range(n_threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=30)
    finally:
        sys.setswitchinterval(old)
    assert not any(w.is_alive() for w in workers)
    assert profiling.counters() == {"routes.exact": n_threads * per}


def test_mark_table_fits_the_kernels():
    """Every span that launches marks has an id below the number of mark
    kernels csrc/marks.cu defines, and each id one name."""
    src = (Path(profiling.__file__).parent.parent / "csrc" / "marks.cu"
           ).read_text()
    ids = re.search(r"#define CERMVS_MARK_IDS\(X\)(.*?)\n\n", src,
                    re.S).group(1)
    assert [int(i) for i in re.findall(r"X\((\d+)\)", ids)] == list(
        range(profiling.MAX_MARKS))
    assert len(set(profiling.MARKS)) == len(profiling.MARKS)
    assert len(profiling.MARKS) <= profiling.MAX_MARKS
    root = Path(profiling.__file__).parent.parent
    used = set()
    for rel in ("models/raft.py", "parallel/spatial.py", "training/step.py"):
        text = (root / rel).read_text()
        for name in re.findall(r'span\(f?"([^"]+)",\s*on=', text):
            used |= {name.replace("{stage}", str(s)) for s in range(2)}
    assert used and used <= set(profiling.MARKS)


def test_inference_counts_routes_and_captures(tmp_path, tracing):
    """A small ``inference()`` on the CPU counts each record's route and
    each key's first dispatch (the first one lies in no record's interval;
    the others' seconds are in the record before), every dispatch eager,
    and times its host spans."""
    from test_torch_slice import _Loader

    pinf = importlib.import_module("cermvs_torch.pipeline.inference")
    model = RAFT(cascade=((8, 64, 1), (-1, 320, 1)), dtype=torch.float32,
                 device="cpu", test_mode=True)
    records = pinf.inference(_Loader(), model=model, output_folder=tmp_path,
                             device="cpu")
    got = profiling.counters()
    routes = {}
    for rec in records:
        routes[f"routes.{rec[2]}"] = routes.get(f"routes.{rec[2]}", 0) + 1
    assert {k: v for k, v in got.items() if k.startswith("routes.")
            } == routes
    assert got["captures"] == 1 + sum(rec[3] > 0 for rec in records)
    assert got["dispatch.eager"] == len(records)
    assert "dispatch.replay" not in got
    assert all(got[f"{s}_s"] > 0 for s in ("route", "dispatch", "prep",
                                           "prep_wait", "write"))


def test_step_runner_counts_dispatches(tracing):
    """A CPU runner: a key's first step counts a capture, every step an
    eager dispatch, and the step's phases and host work are spans."""
    from cermvs_torch.training.step import (StepRunner, batch_to_device,
                                            init_state)

    model = RAFT(cascade=((4, 64, 1),), dtype=torch.float32, device="cpu")
    state = init_state(model, 10)
    state.runner = StepRunner(state)
    rng = np.random.RandomState(0)
    poses = np.tile(np.eye(4, dtype=np.float32), (1, 3, 1, 1))
    poses[0, 1, 0, 3], poses[0, 2, 0, 3] = -1.2, 1.6
    batch = {"images": (rng.rand(1, 3, 32, 64, 3) * 255).astype(np.float32),
             "depths": (rng.rand(1, 3, 32, 64) * 20 + 20).astype(np.float32),
             "poses": poses,
             "intrinsics": np.tile(np.array(
                 [[40.0, 0, 32], [0, 40.0, 16], [0, 0, 1]], np.float32),
                 (1, 3, 1, 1))}
    for gw in (0.0, 0.5):
        state.runner(batch_to_device(batch, "cpu"), gw)
    got = profiling.counters()
    assert got["captures"] == 1 and got["dispatch.eager"] == 2
    assert all(got[f"{s}_s"] > 0 for s in (
        "upload", "step.forward", "step.backward", "step.optimizer",
        "step.metrics_wait", "step.schedule", "raft.encoders"))
    assert "step.replay_s" not in got and "dispatch.replay" not in got


def plan(h_r, twopass, lo=1.0, hi=2.0):
    return RectPlan(h_r, 20, 5, 1, rate_lo=lo, rate_hi=hi,
                    view_rates=((lo, hi),), view_s_max=(5,),
                    twopass=twopass)


def test_plan_cache_counts_hits_new_and_widened(tracing):
    """A one-pass key covers a two-pass plan: that call is a hit and
    widened; a two-pass plan it does not cover is new, and a two-pass plan
    a two-pass key covers a hit that is not widened."""
    cache = PlanCache()
    one = cache.key_for(plan(10, False))
    assert cache.key_for(plan(8, True)) is one and not one.twopass
    two = cache.key_for(plan(40, True))
    assert two.twopass and cache.key_for(plan(36, True)) is two
    assert profiling.counters() == {"plan_cache.new": 2,
                                    "plan_cache.hit": 2,
                                    "plan_cache.widened": 1}


def x(name, cat, ts, dur, tid=1, pid=0, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "tid": tid, "pid": pid, "args": args}


def mark(span, end, ts, pid=0, tid=7):
    kind = "end" if end else "begin"
    return x(f"cermvs_mark_{kind}_{profiling.MARK_ID[span]}", "kernel", ts,
             1.0, tid=tid, pid=pid, correlation=1)


def hand_trace():
    """Two steps' marks (the second's on another stream, nested spans
    inside), a memcpy, host ranges on two threads and the launches that
    end each gap: device busy 0-10, 30-45, 50-52, 60-70."""
    return {"traceEvents": [
        mark("step.forward", 0, 0.0), x("conv", "kernel", 1.0, 7.0,
                                         tid=7, correlation=1),
        mark("step.forward", 1, 8.0),
        mark("step.backward", 0, 9.0),
        x("Memcpy HtoD", "gpu_memcpy", 30.0, 10.0, tid=8, correlation=2),
        mark("step.forward", 0, 40.0, tid=9),
        mark("raft.encoders", 0, 41.0, tid=9),
        mark("raft.encoders", 1, 42.0, tid=9),
        mark("step.forward", 1, 43.0, tid=9),
        mark("step.backward", 1, 44.0, tid=9),
        x("gemm", "kernel", 50.0, 2.0, tid=7, correlation=3),
        x("gemm", "kernel", 60.0, 10.0, tid=7, correlation=4),
        mark("step.optimizer", 1, 69.0),  # no begin: unpaired
        x("cudaMemcpyAsync", "cuda_runtime", 29.0, 1.0, tid=100,
          correlation=2),
        x("cudaGraphLaunch", "cuda_runtime", 49.0, 1.0, tid=100,
          correlation=3),
        x("cudaLaunchKernel", "cuda_runtime", 59.0, 1.0, tid=200,
          correlation=4),
        x("cermvs.step.schedule", "user_annotation", 8.0, 7.0, tid=100),
        x("cermvs.plan", "user_annotation", 18.0, 8.0, tid=100),
        x("cermvs.upload", "user_annotation", 28.0, 12.0, tid=100),
        x("cermvs.dispatch", "user_annotation", 44.0, 10.0, tid=100),
        x("cermvs.route", "user_annotation", 44.0, 1.0, tid=100),
        x("cermvs.prep", "user_annotation", 50.0, 20.0, tid=200),
        x("portbench.step", "user_annotation", 0.0, 70.0, tid=100),
    ]}


def test_marked_spans_pair_marks_per_device(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps(hand_trace()))
    assert profiling.marked_spans(path) == [
        ("step.forward", 0.0, 9.0), ("step.backward", 9.0, 45.0),
        ("step.forward", 40.0, 44.0), ("raft.encoders", 41.0, 43.0)]
    assert profiling.host_spans(hand_trace())[0] == (
        "step.schedule", 8.0, 15.0, 100)


def test_idle_by_span_names_each_gap_by_the_launching_thread():
    """Gap 10-30 (ended by a copy launched on thread 100): step.schedule
    10-15, other 15-18, plan 18-26, other 26-28, upload 28-30; gap 45-50
    (thread 100): dispatch 45-50; gap 52-60 (thread 200): prep."""
    got = profiling.idle_by_span(hand_trace())
    assert got == pytest.approx({"step.schedule": 5.0, "other": 5.0,
                                 "plan": 8.0, "upload": 2.0,
                                 "dispatch": 5.0, "prep": 8.0})
    assert profiling.idle_by_span(hand_trace(), 20.0, 55.0) == \
        pytest.approx({"plan": 6.0, "other": 2.0, "upload": 2.0,
                       "dispatch": 5.0, "prep": 3.0})


def test_inference_report_reads_the_memory_module(monkeypatch, capsys,
                                                 tmp_path):
    """``inference(do_report=True)``'s line takes its peak from
    utils.memory on the runner's device, as the JAX package's does."""
    from test_torch_slice import _Loader

    pinf = importlib.import_module("cermvs_torch.pipeline.inference")

    seen = []

    def stats(device=None):
        seen.append(torch.device(device))
        return {"cpu": {"bytes_in_use_mb": 0.0, "peak_bytes_in_use_mb": 7.0,
                        "bytes_limit_mb": 0.0}}

    monkeypatch.setattr(pinf, "device_memory_stats", stats)
    model = RAFT(cascade=((8, 64, 1), (-1, 320, 1)), dtype=torch.float32,
                 device="cpu", test_mode=True)
    pinf.inference(_Loader(), model=model, output_folder=tmp_path,
                   do_report=True, device="cpu")
    lines = [l for l in capsys.readouterr().out.splitlines()
             if l.startswith("per view time")]
    assert len(lines) == 2 == len(seen)
    assert all("peak device memory: 7 MB (0000000" in l for l in lines)
    assert set(seen) == {torch.device("cpu")}
    assert device_memory_stats("cpu")["cpu"]["peak_bytes_in_use_mb"] == 0.0

"""Tracing: spans and counters, off by default, and torch.profiler traces.

One switch for the process, :func:`enable`. With tracing off, :func:`span`
and :func:`count` cost one flag check and launch nothing.

**A span** (``with span("raft.encoders", on=images):``) records on the host
a ``torch.profiler.record_function`` range named ``cermvs.<name>`` (with
``item`` as its argument), which a profiler's Chrome trace puts on the
thread that ran it, on the same clock as the device's events, and adds its
host seconds to the counter ``<name>_s``. Given a CUDA tensor (``on``), a
span also launches an empty kernel of its own on that tensor's device's
current stream at entry and at exit, a begin and an end mark
(``csrc/marks.cu``: ``cermvs_mark_begin_<id>``, ``cermvs_mark_end_<id>``;
:data:`MARKS` maps each id to its span's name). A span's device time runs
from the start of its begin mark to the end of its end mark: whatever that
stream ran between them, and work of another stream only where this stream
waited for it (an NCCL collective's, which the stream waits for before the
end mark).

**How marks survive capture.** The host runs a forward or a train step
captured in a CUDA graph once, at its capture; a replay launches the graph
and runs none of its Python. So a host range inside it appears once, at the
capture, and never at a replay. The marks are kernel launches, captured
into the graph like any other, and every replay runs them: the device trace
shows each replay's spans. Tracing must be on before a graph is captured (a
graph captured with it off holds no marks), and on or off it leaves the
graph's results bit for bit as they are: the marks read and write nothing.
The marks are not counted in ``cudalib.launches``.

**Counters** (:func:`count`, read by :func:`counters`, cleared by
:func:`reset`; counted only while tracing is on): ``routes.exact``,
``routes.rectified``, ``routes.mixed`` (``InferenceRunner.route``);
``captures``, a key's first dispatch, inference or step, which on CUDA
captures its graph; ``dispatch.replay`` and ``dispatch.eager``;
``plan_cache.hit``, ``plan_cache.new`` and ``plan_cache.widened``
(``PlanCache.key_for``; widened: a two-pass plan given a one-pass key); and
every span's host seconds, ``<name>_s`` (``capture_s``: the graph
captures').

**Reading a trace.** :func:`trace` records the block under
``torch.profiler`` (CPU and, with a card, CUDA activities) and writes one
Chrome trace (``*.pt.trace.json``) under ``log_dir``, which TensorBoard's
profiler plugin, ``chrome://tracing`` and Perfetto (ui.perfetto.dev, "Open
trace file") read. In Perfetto the host ranges ``cermvs.*`` lie on the
Python threads' tracks, the port's kernels and the marks on the device's
stream tracks; select the area from a ``cermvs_mark_begin_<id>`` to the
next ``cermvs_mark_end_<id>`` on its stream to see one span's kernels and
their summed time. :func:`marked_spans` pairs the marks of a trace,
:func:`host_spans` lists its host ranges and :func:`idle_by_span` names
each gap in the device's work by the host span the dispatching thread was
in.
"""

from __future__ import annotations

import bisect
import contextlib
import ctypes
import json
import re
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

from cermvs_torch.ops import cudalib

# the spans with device marks, by id (the kernels' names carry the id);
# csrc/marks.cu instantiates MAX_MARKS ids
MARKS = (
    "raft.encoders", "raft.volume_prepare",
    *(f"raft.volume_stage{s}" for s in range(4)),
    *(f"raft.iterations_stage{s}" for s in range(4)),
    "spatial.encoders", "spatial.collective",
    *(f"spatial.volume_stage{s}" for s in range(4)),
    *(f"spatial.iterations_stage{s}" for s in range(4)),
    "step.forward", "step.backward", "step.optimizer",
)
MAX_MARKS = 32
MARK_ID = {name: i for i, name in enumerate(MARKS)}
MARK_KERNEL = re.compile(r"cermvs_mark_(begin|end)_(\d+)")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")

LIB = cudalib.KernelLibrary("marks", {
    "cermvs_mark": [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]})

_on = False
_counters: Dict[str, float] = {}
_lock = threading.Lock()
_OFF = contextlib.nullcontext()


def enable(on: bool = True) -> None:
    """Turn tracing on (or off) for the process. On a machine with a card,
    turning it on builds and loads the marks' library and runs each mark
    once on the current device, so that no capture loads them."""
    global _on
    if on and torch.cuda.is_available():
        stream = torch.cuda.current_stream().cuda_stream
        for i in range(len(MARKS)):
            LIB.call("cermvs_mark", i, 0, stream)
            LIB.call("cermvs_mark", i, 1, stream)
        torch.cuda.synchronize()
    _on = bool(on)


def enabled() -> bool:
    return _on


def count(name: str, n: float = 1) -> None:
    """Add ``n`` to counter ``name`` while tracing is on."""
    if _on:
        with _lock:
            _counters[name] = _counters.get(name, 0) + n


def counters() -> Dict[str, float]:
    """A copy of the counters: ints, and seconds under names ending in
    ``_s``."""
    with _lock:
        return dict(_counters)


def reset() -> None:
    with _lock:
        _counters.clear()


def span(name: str, item=None, on: Optional[torch.Tensor] = None):
    """A context that traces its block as span ``name`` (see the module's
    docstring): a host range, and with ``on`` a CUDA tensor, begin and end
    marks on its device's current stream (``name`` must then be one of
    :data:`MARKS`). Does nothing while tracing is off."""
    if not _on:
        return _OFF
    return _Span(name, item, on)


class _Span:
    __slots__ = ("name", "item", "on", "mark", "stream", "range", "t0")

    def __init__(self, name, item, on):
        self.name = name
        self.item = None if item is None else str(item)
        self.on = on if on is not None and on.is_cuda else None
        self.mark = None if self.on is None else MARK_ID[name]
        self.stream = None

    def _mark(self, end: int) -> None:
        with cudalib.on_device(self.on):
            LIB.call("cermvs_mark", self.mark, end, self.stream)

    def __enter__(self):
        self.range = torch.profiler.record_function(f"cermvs.{self.name}",
                                                    self.item)
        self.range.__enter__()
        if self.on is not None:
            self.stream = cudalib.stream_of(self.on)
            self._mark(0)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        seconds = time.perf_counter() - self.t0
        if self.stream is not None:
            self._mark(1)
        self.range.__exit__(*exc)
        count(f"{self.name}_s", seconds)
        return False


@contextlib.contextmanager
def trace(log_dir: str = "runs/profile"):
    """Profile the block and write its trace under ``log_dir``; yields the
    profiler (``key_averages()`` and the rest)."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(str(log_dir))) as p:
        yield p


def trace_events(trace_file) -> List[dict]:
    """The events of a Chrome trace: a file's path, its parsed dict, or the
    event list itself."""
    if isinstance(trace_file, (str, Path)):
        trace_file = json.loads(Path(trace_file).read_text())
    if isinstance(trace_file, dict):
        return trace_file["traceEvents"]
    return list(trace_file)


def _complete(events, cats) -> List[dict]:
    return sorted((e for e in events
                   if e.get("ph") == "X" and e.get("cat") in cats),
                  key=lambda e: float(e["ts"]))


def marked_spans(trace_file) -> List[Tuple[str, float, float]]:
    """``(name, start_us, end_us)`` of each span that a begin mark and the
    next end mark of its id on its device bracket in a trace, from the
    begin mark's start to the end mark's end, in order of start (a graph's
    replay may run its kernels on streams of its own)."""
    opened: Dict[tuple, List[float]] = {}
    spans = []
    for e in _complete(trace_events(trace_file), ("kernel",)):
        m = MARK_KERNEL.search(e["name"])
        if m is None:
            continue
        key = (e.get("pid"), int(m.group(2)))
        ts = float(e["ts"])
        if m.group(1) == "begin":
            opened.setdefault(key, []).append(ts)
        elif opened.get(key):
            spans.append((MARKS[key[1]], opened[key].pop(),
                          ts + float(e.get("dur", 0.0))))
    return sorted(spans, key=lambda s: s[1])


def host_spans(trace_file) -> List[Tuple[str, float, float, object]]:
    """``(name, start_us, end_us, thread)`` of each ``cermvs.*`` host range
    of a trace (the name without the prefix), in order of start."""
    return [(e["name"][len("cermvs."):], float(e["ts"]),
             float(e["ts"]) + float(e.get("dur", 0.0)), e.get("tid"))
            for e in _complete(trace_events(trace_file),
                               ("user_annotation",))
            if e["name"].startswith("cermvs.")]


def _timeline(spans) -> Dict[object, Tuple[List[float], list]]:
    """Each thread's time inside ``cermvs.*`` ranges as segments
    ``(start_us, end_us, name)`` of the innermost range open, and their
    starts, by thread (a thread's ranges nest)."""
    by_thread: Dict[object, list] = {}
    for name, s, e, tid in spans:
        by_thread.setdefault(tid, []).extend(((s, 1, name), (e, 0, name)))
    out = {}
    for tid, edges in by_thread.items():
        segments, stack, prev = [], [], None
        for t, opens, name in sorted(edges, key=lambda x: (x[0], x[1])):
            if stack and t > prev:
                segments.append((prev, t, stack[-1]))
            if opens:
                stack.append(name)
            elif name in stack:
                del stack[len(stack) - 1 - stack[::-1].index(name)]
            prev = t
        out[tid] = ([seg[0] for seg in segments], segments)
    return out


def idle_by_span(trace_file, start_us: Optional[float] = None,
                 end_us: Optional[float] = None) -> Dict[str, float]:
    """Microseconds with nothing on the device between ``start_us`` and
    ``end_us`` (default: the first and the last device activity), each
    moment of a gap put down to the innermost ``cermvs.*`` host range open
    then on the thread that launched the work ending the gap, "other"
    where none was."""
    events = trace_events(trace_file)
    device = _complete(events, DEVICE_CATS)
    if not device:
        return {}
    launcher = {e["args"]["correlation"]: e.get("tid")
                for e in _complete(events, ("cuda_runtime", "cuda_driver"))
                if "correlation" in e.get("args", {})}
    threads = _timeline(host_spans(events))
    lo = float(device[0]["ts"]) if start_us is None else start_us
    hi = (max(float(e["ts"]) + float(e.get("dur", 0.0)) for e in device)
          if end_us is None else end_us)
    out: Dict[str, float] = {}
    edge = lo
    for e in device:
        s, t = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))
        if s > edge and edge < hi:
            gap_end = min(s, hi)
            named = 0.0
            tid = launcher.get(e.get("args", {}).get("correlation"))
            starts, segments = threads.get(tid, ([], []))
            i = max(0, bisect.bisect_right(starts, edge) - 1)
            while i < len(segments) and segments[i][0] < gap_end:
                a, b, name = segments[i]
                part = min(b, gap_end) - max(a, edge)
                if part > 0:
                    out[name] = out.get(name, 0.0) + part
                    named += part
                i += 1
            if gap_end - edge > named:
                out["other"] = out.get("other", 0.0) + gap_end - edge - named
        edge = max(edge, t)
    return out

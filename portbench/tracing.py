"""What a traced run reads: the profiler's trace of the traced window
(``torch.profiler``, CPU and CUDA activities, exported as a Chrome trace)
and the host spans the harness takes around its own calls into the
program. :class:`Reading` is what every per-layer metric's reader
(``portbench/metrics/<name>.py``) gets.

The steady stretch runs from the start of the harness's span around the
window's ``skip``-th item (its route, or its step) to the end of the last
device activity: the items before it fill the pipeline. Device activity is
every kernel, copy and fill on the card; busy time is the union of their
intervals.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional, Tuple

ROOT = Path(__file__).resolve().parent
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def classes() -> Dict[str, List[str]]:
    return json.loads((ROOT / "glue.json").read_text())


def kernel_class(name: str, table: Dict[str, List[str]]) -> str:
    """"port", "library" or "glue" (``glue.json``)."""
    low = name.lower()
    if any(k in name for k in table["port"]):
        return "port"
    if any(k in low for k in table["library"]):
        return "library"
    return "glue"


def union_s(intervals: List[Tuple[float, float]]) -> float:
    """Seconds covered by (start_us, end_us) intervals."""
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total * 1e-6


class Reading:
    """A traced window: ``device`` the device events (name, category,
    start_us, end_us), ``host`` the harness's spans in the trace (name,
    start_us, end_us), ``spans`` the harness's host timings by name
    (seconds), ``items`` the window's items (views or steps),
    ``item_flops`` the model's FLOPs of one item, ``bytes`` the summed
    bound bytes of the window's launches by kernel, ``peaks`` the card's
    published peaks (None for a card the table does not know)."""

    def __init__(self, trace_path, spans: Dict[str, List[float]],
                 item_span: str, skip: int, item_flops: float,
                 bytes_by_kernel: Dict[str, int], peaks: Optional[Dict]):
        events = json.loads(Path(trace_path).read_text())["traceEvents"]
        self.device = [(e["name"], e["cat"], float(e["ts"]),
                        float(e["ts"]) + float(e.get("dur", 0.0)))
                       for e in events
                       if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
        self.host = sorted((e["name"], float(e["ts"]),
                            float(e["ts"]) + float(e.get("dur", 0.0)))
                           for e in events if e.get("ph") == "X"
                           and e.get("cat") == "user_annotation"
                           and e["name"].startswith("portbench."))
        self.spans = spans
        self.item_flops = item_flops
        self.bytes = bytes_by_kernel
        self.peaks = peaks
        self.table = classes()
        marks = [s for n, s, _ in self.host if n == item_span]
        self.items = len(marks)
        self.stretch_items = max(0, len(marks) - skip)
        end = max((e for *_, e in self.device), default=0.0)
        start = marks[skip] if len(marks) > skip else end
        self.start_us, self.end_us = start, end

    @property
    def window_s(self) -> float:
        return max(0.0, self.end_us - self.start_us) * 1e-6

    @property
    def busy_s(self) -> float:
        return union_s([(max(s, self.start_us), min(e, self.end_us))
                        for _, _, s, e in self.device
                        if e > self.start_us and s < self.end_us])

    def idle_pct(self) -> Optional[float]:
        if self.window_s <= 0 or self.stretch_items == 0:
            return None
        return 100.0 * (1.0 - self.busy_s / self.window_s)

    def mfu(self) -> Optional[float]:
        if self.peaks is None or self.window_s <= 0 or not self.stretch_items:
            return None
        rate = self.item_flops * self.stretch_items / self.window_s
        return 100.0 * rate / self.peaks["bf16_flops_s"]

    def kernel_s(self, names) -> float:
        return sum(e - s for n, c, s, e in self.device
                   if c == "kernel" and any(k in n for k in names)) * 1e-6

    def roofline_pct(self, kernel_names, work_names) -> Optional[float]:
        """Summed least time of the window's launches (their bytes over the
        card's memory rate) over their summed device time."""
        t = self.kernel_s(kernel_names)
        nbytes = sum(self.bytes.get(k, 0) for k in work_names)
        if self.peaks is None or t <= 0 or nbytes <= 0:
            return None
        return 100.0 * nbytes / self.peaks["bytes_s"] / t

    def glue_ms(self) -> Optional[float]:
        """Device ms an item of kernels that are neither the port's own nor
        library convolutions or products."""
        kernels = [(n, s, e) for n, c, s, e in self.device if c == "kernel"]
        if not self.items or not kernels:
            return None
        t = sum(e - s for n, s, e in kernels
                if kernel_class(n, self.table) == "glue")
        return t * 1e-3 / self.items

    def per_item_ms(self, span: str, items: int) -> Optional[float]:
        """Host ms an item of every call of ``span``."""
        values = self.spans.get(span) or []
        return 1e3 * sum(values) / items if values and items else None

    def mean_ms(self, span: str) -> Optional[float]:
        values = self.spans.get(span) or []
        return 1e3 * sum(values) / len(values) if values else None

    def breakdown(self, top: int = 10) -> Dict[str, list]:
        """The device operations that took most time in the stretch, and
        the longest idle gaps there, each named by the harness's span the
        host was in at the gap's start ("other" outside them)."""
        inside = [(n, s, e) for n, _, s, e in self.device
                  if e > self.start_us and s < self.end_us]
        by_name: Dict[str, float] = {}
        for n, s, e in inside:
            by_name[n] = by_name.get(n, 0.0) + (e - s) * 1e-6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps, end = [], self.start_us
        for _, s, e in sorted(inside, key=lambda t: t[1]):
            if s > end:
                gaps.append((end, s))
            end = max(end, e)
        named = []
        for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:top]:
            span = next((n for n, hs, he in self.host if hs <= s < he),
                        "other")
            named.append([span.removeprefix("portbench."), (e - s) * 1e-6])
        return {"device_ops": [[n, v] for n, v in ops], "idle_gaps": named}

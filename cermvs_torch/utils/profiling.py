"""Profiling helpers: torch.profiler traces and a per-view timer.

:func:`trace` records the host's ops and, with a card, its kernels
(``torch.profiler``, CPU and CUDA activities) and writes one Chrome trace
(``*.pt.trace.json``) under ``log_dir``, which TensorBoard's profiler plugin
and ``chrome://tracing`` / Perfetto read. The model's named ranges
(``raft.encoders``, ``raft.volume_stage0``, ...) appear in it, and the
port's kernels under their CUDA names (``epiband_mma_kernel``, ...).

:class:`ViewTimer` is ``inference(do_report=True)``'s report as a utility:
seconds per item and the device memory high-water mark.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict

import torch

from cermvs_torch.utils.memory import device_memory_stats


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


class ViewTimer:
    """Per-item latency and device memory peak (``inference()``'s
    ``do_report``). On a CUDA ``device`` each item's time ends at a device
    sync, so it covers the item's kernels; ``device="cpu"`` reads no
    device memory (zeros)."""

    def __init__(self, enabled: bool = True, device=None):
        self.enabled = enabled
        self.device = device
        self.records = []

    def _sync(self):
        if self.device is None or torch.device(self.device).type == "cuda":
            if torch.cuda.is_available():
                torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def view(self, name: str):
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        yield
        self._sync()
        dt = time.perf_counter() - t0
        peak = max((s["peak_bytes_in_use_mb"]
                    for s in device_memory_stats(self.device).values()),
                   default=0.0)
        self.records.append({"name": name, "seconds": dt, "peak_hbm_mb": peak})
        print(f"per view time: {dt:.3f}s  peak HBM: {peak:.0f} MB  ({name})")

    def summary(self) -> Dict[str, float]:
        if not self.records:
            return {}
        secs = [r["seconds"] for r in self.records]
        return {
            "views": len(secs),
            "mean_seconds": sum(secs) / len(secs),
            "max_peak_hbm_mb": max(r["peak_hbm_mb"] for r in self.records),
        }

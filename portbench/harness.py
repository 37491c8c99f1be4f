"""What every run shares: the spec files found by name, the weights made
from the seed, the device's description, the per-layer readers and the
result line.

A cell (``cells/<workload>.json``) names its driver (``drivers/<name>.py``),
the numbers its check compares with their limits, and how many items its
traced window takes; its configuration (``configs/<name>.json``) and
traffic mix (``traffic/<name>.json``) come from ``BENCHMARK.json``.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import shutil
import sys
import tempfile
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

import torch

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent
# top-level modules that no run may load: the JAX stack and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "cermvs_tpu")


def load(kind: str, name: str) -> Dict:
    return json.loads((ROOT / kind / f"{name}.json").read_text())


def benchmark() -> Dict:
    return json.loads((REPO / "BENCHMARK.json").read_text())


def reader(metric: str):
    """The ``read`` function of ``metrics/<metric>.py``, or where there is
    none, of ``metrics/<the name before its first dot>.py``: one reader
    serves a quantity that each kind of cell reports under its own name
    (``idle_pct.walk``, ``idle_pct.train``)."""
    path = ROOT / "metrics" / f"{metric}.py"
    if not path.exists():
        path = ROOT / "metrics" / f"{metric.partition('.')[0]}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + metric.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def driver(name: str):
    return importlib.import_module(f"portbench.drivers.{name}")


def forbidden_modules() -> List[str]:
    """The forbidden top-level names among the loaded modules."""
    tops = {name.partition(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def make_weights(model: torch.nn.Module, seed: int, device,
                 scales: Optional[Dict[str, float]] = None
                 ) -> Dict[str, torch.Tensor]:
    """Fresh weights of ``model`` from the seed, drawn on ``device`` in one
    call and copied into it: each convolution's weight Kaiming-normal
    (fan out), each bias normal with std 0.01, a leaf named in ``scales``
    times its factor. Returns a CPU copy by name, which the reference
    loads."""
    scales = scales or {}
    params = dict(model.named_parameters())
    total = sum(p.numel() for p in params.values())
    gen = torch.Generator(device=device).manual_seed(int(seed) % (2**63))
    flat = torch.randn(total, generator=gen, device=device)
    out, offset = {}, 0
    with torch.no_grad():
        for name, p in params.items():
            draw = flat[offset:offset + p.numel()].view_as(p)
            offset += p.numel()
            if p.dim() == 4:
                std = math.sqrt(2.0 / (p.shape[0] * p.shape[2] * p.shape[3]))
            else:
                std = 0.01
            p.copy_(draw * (std * scales.get(name, 1.0)))
            out[name] = p.detach().to("cpu", copy=True)
    return out


def scratch_dir() -> Path:
    """A fresh directory for a run's outputs (under ``TMPDIR``)."""
    return Path(tempfile.mkdtemp(prefix="portbench-"))


def remove(path: Path) -> None:
    shutil.rmtree(path, ignore_errors=True)


def device_info(device: torch.device, count: int, peak_bytes: int) -> Dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": count,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": count, "memory_peak_bytes": int(peak_bytes)}


def peak_bytes(device: torch.device) -> int:
    """The device memory the program's allocator has reserved at its
    peak (a graph replay's transients live in reserved memory)."""
    return (torch.cuda.max_memory_reserved(device) if device.type == "cuda"
            else 0)


def quantile(values: List[float], q: float) -> float:
    """The ``q`` quantile of ``values``, linear between order statistics."""
    v = sorted(values)
    pos = q * (len(v) - 1)
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


@dataclass
class Run:
    """One run of a cell: its specs, arguments and device, and what it
    has measured (``metrics``), checked (``compared``: name -> (value,
    limit)) and traced (``reading``)."""

    workload: Dict
    cell: Dict
    config: Dict
    mix: Dict
    end_to_end: List[Dict]
    per_layer: List[Dict]
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_start: float
    metrics: Dict[str, Dict] = field(default_factory=dict)
    compared: Dict[str, tuple] = field(default_factory=dict)
    attempted: int = 0
    failed: int = 0
    peak_bytes: int = 0
    reading: Optional[object] = None
    notes: Dict[str, object] = field(default_factory=dict)

    def put(self, metric: str, value: float) -> None:
        """Record ``value`` under each end-to-end metric of this cell named
        ``metric`` or ``metric.<cell's kind>`` (``views_per_s.walk``); the
        cell's other metrics are left out."""
        for m in self.end_to_end:
            if metric in (m["name"], m["name"].partition(".")[0]):
                self.metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    def read_layers(self) -> None:
        """Each per-layer metric of this cell from the traced window; a
        reader that finds nothing leaves its metric out."""
        for m in self.per_layer:
            value = reader(m["name"])(self.reading)
            if value is not None:
                self.metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    def correct(self) -> bool:
        return self.failed == 0 and all(
            v is not None and math.isfinite(v) and v <= lim
            for v, lim in self.compared.values())


def cell_metrics(bench: Dict, workload: str):
    """The end-to-end and per-layer metrics ``workload`` reports: a metric
    with a ``workloads`` list where the list names it, one without it where
    the cell reports the end-to-end metric it moves."""
    def listed(m):
        return workload in m["workloads"] if "workloads" in m else None

    e2e = [m for m in bench["end_to_end"] if listed(m) in (True, None)]
    names = {m["name"] for m in e2e}
    layers = [m for m in bench["per_layer"]
              if listed(m) or (listed(m) is None and m["moves"] in names)]
    return e2e, layers

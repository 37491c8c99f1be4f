"""FLOP counting and MFU (model-FLOPs utilization).

:func:`count_flops` runs a function once, eagerly, under torch's
``FlopCounterMode``, which counts the convolutions and matrix products that
reach the dispatcher (2 FLOPs a multiply-add; elementwise work, gathers and
reductions count nothing). The port's hand-written kernels are ctypes calls
that the counter cannot see, and on CPU tensors the same wrappers run plain
versions whose products it would see. So each wrapper reports its kernels'
work through :func:`counted`: while a count is open, the wrapper adds the
FLOPs of its kernels' ``work`` formula (``ops/epiband.py``,
``ops/hatwarp.py``, ``ops/lookup.py``: what these inputs need, taps in the
band counted from the data) and runs its launch or its plain version with
the counter paused. The same call therefore counts the same on the CPU and
on the card, but for taps that land on another side of a floor there.

What runs counts: work that ``RAFT.remat`` recomputes in the backward pass
is counted again, and a backward run inside the counted function counts
its kernels' gradients by their own formulas. The formulas read data, so a
count cannot be taken inside a CUDA graph capture (:class:`CaptureError`);
count an eager forward or step. A CUDA graph has no cost model to read, so
there is no counterpart of reading a compiled program's cost.

The peaks are NVIDIA's data-sheet figures for the H100 SXM part: 989 TFLOP/s
dense bf16 (and 67 TFLOP/s fp32 without TF32, which the kernels' bounds
use) and 3.35 TB/s of HBM3. MFU is achieved FLOP/s over the dense bf16 peak.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import torch

PEAK_BYTES_S = 3.35e12  # H100 SXM HBM3
# dense peaks of the H100 SXM part by dtype: bf16 tensor cores, and fp32
# without TF32
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
# dense bf16 FLOP/s by the card's full name without its "NVIDIA " prefix:
# the SXM part only ("H100 PCIe" and "H100 NVL" are slower parts)
_PEAK_BF16 = {"H100 80GB HBM3": 989e12, "H100 SXM": 989e12,
              "H100 SXM5 80GB": 989e12}


class CaptureError(RuntimeError):
    """A FLOP count was asked for inside a CUDA graph capture."""


@dataclass
class FlopCount:
    """One count: ``aten`` the counter's FLOPs by op name (the
    convolutions and matrix products), ``kernels`` the work formulas'
    FLOPs by kernel name and ``calls`` how many calls each added."""

    aten: Dict[str, int] = field(default_factory=dict)
    kernels: Dict[str, int] = field(default_factory=dict)
    calls: Dict[str, int] = field(default_factory=dict)

    @property
    def aten_total(self) -> int:
        return sum(self.aten.values())

    @property
    def kernel_total(self) -> int:
        return sum(self.kernels.values())

    @property
    def total(self) -> int:
        return self.aten_total + self.kernel_total


_open: List[FlopCount] = []  # the counts open now, innermost last


def counting() -> bool:
    """Whether a count is open (a wrapper then calls :func:`counted`)."""
    return bool(_open)


def _capturing() -> bool:
    return torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()


@contextlib.contextmanager
def _paused():
    """The dispatch modes (the open counter among them) off for the block."""
    from torch.utils._python_dispatch import _disable_current_modes

    with _disable_current_modes():
        yield


def counted(names: Iterable[str], work: Callable[[], Dict[str, Tuple[int, int]]],
            fn: Callable, *args):
    """``fn(*args)``, a kernel wrapper's launch or plain version, with the
    counter paused; the FLOPs of ``names`` in ``work()`` (a module's
    ``{kernel: (bytes, flops)}``) are added to the open count. Without an
    open count it is just ``fn(*args)``."""
    if not _open:
        return fn(*args)
    if _capturing():
        raise CaptureError("the kernels' FLOP formulas read data: count an "
                           "eager call, not a CUDA graph capture")
    count = _open[-1]
    with _paused():
        with torch.no_grad():
            works = work()
        for name in names:
            count.kernels[name] = count.kernels.get(name, 0) + int(
                works[name][1])
            count.calls[name] = count.calls.get(name, 0) + 1
        return fn(*args)


def count_flops(fn: Callable, *args, **kwargs) -> FlopCount:
    """Run ``fn(*args, **kwargs)`` once, eagerly, and count its FLOPs: the
    counter's convolutions and products, and the kernels' formulas (module
    docstring). Raises what ``fn`` raises, and :class:`CaptureError` inside
    a CUDA graph capture."""
    from torch.utils.flop_counter import FlopCounterMode

    if _capturing():
        raise CaptureError("count an eager call, not a CUDA graph capture")
    count = FlopCount()
    mode = FlopCounterMode(display=False)
    _open.append(count)
    try:
        with mode:
            fn(*args, **kwargs)
    finally:
        _open.remove(count)
    count.aten = {str(op): int(n) for op, n in
                  mode.get_flop_counts().get("Global", {}).items()}
    return count


def flops_of(fn: Callable, *args, **kwargs) -> Optional[float]:
    """Total FLOPs of one eager call ``fn(*args, **kwargs)``
    (:func:`count_flops`), or None where ``fn`` cannot run with these
    arguments. Raises :class:`CaptureError` inside a CUDA graph capture."""
    try:
        return float(count_flops(fn, *args, **kwargs).total)
    except CaptureError:
        raise
    except Exception:
        return None


def device_peak_flops(device=None) -> Optional[float]:
    """Dense bf16 peak FLOP/s of a CUDA ``device`` (default: the current
    one), from its full name (``torch.cuda.get_device_name``); None for a
    card not in the table, for the CPU, and with no card."""
    if device is None:
        if not torch.cuda.is_available():
            return None
        device = torch.cuda.current_device()
    if not isinstance(device, int):
        device = torch.device(device)
        if device.type != "cuda":
            return None
    name = torch.cuda.get_device_name(device)
    if name.startswith("NVIDIA "):
        name = name[len("NVIDIA "):]
    return _PEAK_BF16.get(name)


def mfu(total_flops: Optional[float], seconds: float,
        device=None) -> Optional[float]:
    """Achieved fraction of the peak for ``total_flops`` run in
    ``seconds``; None where the FLOPs or the device's peak are unknown."""
    peak = device_peak_flops(device)
    if total_flops is None or peak is None or seconds <= 0:
        return None
    return total_flops / seconds / peak

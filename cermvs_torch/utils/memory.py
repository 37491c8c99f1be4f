"""Device-memory reporting, with the JAX package's keys.

``device_memory_stats()`` gives one entry per CUDA device, in MiB: the bytes
the caching allocator has handed out now (``bytes_in_use_mb``, from
``torch.cuda.memory_allocated``), their high-water mark since the last
``torch.cuda.reset_peak_memory_stats`` (``peak_bytes_in_use_mb``,
``max_memory_allocated``) and the card's memory (``bytes_limit_mb``). The
allocator's reserve and a CUDA graph's pool are not in these counts: under a
graph replay the forward's transients live in the pool.
"""

from __future__ import annotations

from typing import Dict

import torch


def device_memory_stats(device=None) -> Dict[str, Dict[str, float]]:
    """``{device name: {bytes_in_use_mb, peak_bytes_in_use_mb,
    bytes_limit_mb}}`` for every CUDA device (default), one CUDA device, or
    the CPU (one entry of zeros: the host's memory is not tracked)."""
    if device is not None and torch.device(device).type == "cpu":
        return {"cpu": {"bytes_in_use_mb": 0.0, "peak_bytes_in_use_mb": 0.0,
                        "bytes_limit_mb": 0.0}}
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' for the host")
    if device is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    else:
        device = torch.device(device)
        devices = [torch.device("cuda", torch.cuda.current_device()
                                if device.index is None else device.index)]
    return {str(d): {
        "bytes_in_use_mb": torch.cuda.memory_allocated(d) / 2**20,
        "peak_bytes_in_use_mb": torch.cuda.max_memory_allocated(d) / 2**20,
        "bytes_limit_mb": torch.cuda.get_device_properties(d).total_memory
        / 2**20} for d in devices}


def report(device=None) -> None:
    for dev, s in device_memory_stats(device).items():
        print(f"{dev}: in_use={s['bytes_in_use_mb']:.0f}MB "
              f"peak={s['peak_bytes_in_use_mb']:.0f}MB "
              f"limit={s['bytes_limit_mb']:.0f}MB")

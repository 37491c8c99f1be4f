"""The port's memory and profiling utilities (cermvs_torch/utils/memory.py,
profiling.py) on the CPU: JAX's tests/test_utils.py cases for them, with
device="cpu", and a torch.profiler trace written to disk."""

import importlib
import json

import numpy as np
import pytest
import torch

from cermvs_torch.models.raft import RAFT
from cermvs_torch.utils.memory import device_memory_stats, report
from cermvs_torch.utils.profiling import ViewTimer, trace

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


def test_view_timer(capsys):
    t = ViewTimer(enabled=True, device="cpu")
    with t.view("v0"):
        pass
    with t.view("v1"):
        pass
    s = t.summary()
    assert s["views"] == 2
    assert s["max_peak_hbm_mb"] == 0.0
    assert [r["name"] for r in t.records] == ["v0", "v1"]
    assert "per view time" in capsys.readouterr().out

    t2 = ViewTimer(enabled=False, device="cpu")
    with t2.view("x"):
        pass
    assert t2.summary() == {}


def test_trace_writes_the_model_ranges(tmp_path):
    """A trace of a small forward: one Chrome trace file under the
    directory, naming the model's ranges."""
    model = RAFT(cascade=((8, 64, 1), (-1, 320, 1)), dtype=torch.float32,
                 device="cpu", test_mode=True)
    rng = np.random.RandomState(0)
    images = torch.from_numpy(rng.rand(1, 3, 32, 64, 3).astype(np.float32)
                              * 255)
    poses = torch.eye(4).repeat(1, 3, 1, 1)
    poses[0, 1, 0, 3], poses[0, 2, 0, 3] = -1.0, 1.0
    intr = torch.tensor([[40.0, 0, 32], [0, 40.0, 16], [0, 0, 1]]).repeat(
        1, 3, 1, 1)
    with trace(tmp_path / "prof") as prof, torch.no_grad():
        model(images, poses, intr)
    files = list((tmp_path / "prof").glob("*.pt.trace.json"))
    assert len(files) == 1
    names = {e.get("name") for e in json.loads(files[0].read_text())[
        "traceEvents"]}
    assert {"raft.encoders", "raft.volume_stage0",
            "raft.iterations_stage1"} <= names
    assert any(e.key == "raft.encoders" for e in prof.key_averages())


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

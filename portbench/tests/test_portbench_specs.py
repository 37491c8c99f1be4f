"""The benchmark's files: every configuration, traffic mix, cell and
per-layer metric loads and is found by name; no module of the benchmark
loads the JAX stack or the JAX package; the kernel classification."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import harness, tracing

ROOT = Path(harness.ROOT)
BENCH = harness.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_load(cell):
    w = next(w for w in BENCH["workloads"] if w["name"] == cell)
    spec = harness.load("cells", cell)
    config = harness.load("configs", w["config"])
    mix = harness.load("traffic", w["traffic"])
    assert (ROOT / "drivers" / f"{spec['driver']}.py").exists()
    assert config["model"]["dtype"] in ("bfloat16", "float32")
    assert mix["kind"] in ("views", "batches")
    assert spec["limits"]
    e2e, layers = harness.cell_metrics(BENCH, cell)
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2
    assert layers


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_per_layer_metric_has_its_reader(metric):
    m = next(m for m in BENCH["per_layer"] if m["name"] == metric)
    assert callable(harness.reader(metric))
    assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    for cell in m.get("workloads", []):
        assert cell in CELLS
        e2e, _ = harness.cell_metrics(BENCH, cell)
        assert m["moves"] in {e["name"] for e in e2e}


def test_every_file_is_named_by_the_benchmark():
    configs = {Path(c["file"]).stem for c in BENCH["configs"]}
    assert {p.stem for p in (ROOT / "configs").glob("*.json")} == configs
    assert {p.stem for p in (ROOT / "cells").glob("*.json")} == set(CELLS)
    mixes = {w["traffic"] for w in BENCH["workloads"]}
    assert {p.stem for p in (ROOT / "traffic").glob("*.json")} == mixes
    # one reader a quantity: ``metrics/<name>.py``, or the file of the
    # name before its first dot; every reader serves some metric
    readers = {p.name[:-3] for p in (ROOT / "metrics").glob("*.py")}
    served = {m["name"] if m["name"] in readers
              else m["name"].partition(".")[0] for m in BENCH["per_layer"]}
    assert served <= readers and readers == served
    assert len(set(METRICS)) == len(METRICS)


def _imported_tops(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.partition(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.partition(".")[0]


@pytest.mark.parametrize("path", sorted(ROOT.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_module_imports_jax(path):
    assert not set(_imported_tops(path)) & set(harness.FORBIDDEN)


def test_reference_imports_nothing_of_the_port():
    for path in (ROOT / "reference").glob("*.py"):
        assert "cermvs_torch" not in set(_imported_tops(path)), path


def test_a_run_loads_no_jax():
    """Every module of the benchmark and what it imports of the port,
    loaded in a fresh process: no top-level name is forbidden (whole
    names: the port's own name begins with the JAX package's)."""
    code = ("import sys, importlib, pkgutil; sys.path.insert(0, '.');"
            "import portbench, portbench.reference, portbench.drivers;"
            "[importlib.import_module(m.name) for p in (portbench,"
            " portbench.reference, portbench.drivers) for m in"
            " pkgutil.iter_modules(p.__path__, p.__name__ + '.')"
            " if m.name != 'portbench.tests'];"
            "import cermvs_torch.pipeline.inference, cermvs_torch.training."
            "train, cermvs_torch.training.step;"
            "from portbench import harness;"
            "print(','.join(harness.forbidden_modules()))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT.parent,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""


def test_kernel_classes():
    table = tracing.classes()
    port = ["void epiband_mma_kernel<__nv_bfloat16, 64, 8>(...)",
            "epiband_bwd_dfr_kernel", "void epiband_bwd_dfs_kernel<4>",
            "hat_rows_fwd_kernel", "void hat_rows_bwd_kernel<float>",
            "lookup_tile_kernel", "lookup_bwd_kernel"]
    for name in port:
        assert tracing.kernel_class(name, table) == "port", name
    library = ["sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc",
               "void cudnn::cnn::wgrad2d_grouped_direct_kernel<float>",
               "ampere_sgemm_128x64_nn", "nvjet_tst_128x64_64x4_h_bz_TNT",
               "void cutlass::Kernel2<cutlass_80_tensorop_s1688gemm>"]
    for name in library:
        assert tracing.kernel_class(name, table) == "library", name
    glue = ["void at::native::vectorized_elementwise_kernel<4, "
            "at::native::CUDAFunctor_add<float>>",
            "void at::native::reduce_kernel<512, 1>",
            "void at::native::index_elementwise_kernel<128, 4>"]
    for name in glue:
        assert tracing.kernel_class(name, table) == "glue", name


def test_benchmark_json_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert json.loads((ROOT.parent / "BENCHMARK.json").read_text()) == BENCH

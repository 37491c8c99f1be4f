"""The slice end to end: the port's InferenceRunner and inference() against
the JAX package's on the CPU, plus the port's isolation from the JAX package
and its config surface (the train-mode forward: test_torch_train_mode.py).

Scene: H=64, W=192, 3 views, lateral baselines; cascade ((8,64,2),(-1,320,2))
at full widths (64-channel features, context and GRU), fp32 on both sides.
The weights are the port's seeded random init, carried to JAX with
``convert_raft``, with the delta heads' last conv damped 1e-3x: undamped
random deltas (~1e-2 per iteration) throw the disparity hundreds of
hypothesis spacings (stage 1: 7.8e-6) outside the slabs, where the lookups
read zeros and the GRU amplifies float noise (measured 6.5e-4 relative
after four iterations); damped, the estimates stay inside the slabs and the
comparison exercises the volumes. Disparities compare at rtol 1e-3 and an
atol of 1e-7, the disparities themselves being ~1e-4 (the JAX package's own
full-model parity test uses rtol 1e-3 / atol 1e-4 at disparities ~1).
"""

import argparse
import os
import re
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cermvs_tpu.pipeline.inference import InferenceRunner as JRunner
from cermvs_tpu.pipeline.inference import inference as j_inference
from cermvs_tpu.utils.torch_import import convert_raft
from cermvs_torch import config as pconfig
from cermvs_torch.io.pfm import read_pfm
from cermvs_torch.models.raft import RAFT
from cermvs_torch.ops import cudalib
from cermvs_torch.pipeline.inference import InferenceRunner, inference

REPO = Path(__file__).resolve().parent.parent
CASCADE = ((8, 64, 2), (-1, 320, 2))
TOL = dict(rtol=1e-3, atol=1e-7)


def _scene(H=64, W=192, n=3, seed=0):
    K = np.array([[80.0, 0, W / 2], [0, 80.0, H / 2], [0, 0, 1]], np.float32)
    poses = np.stack([np.eye(4, dtype=np.float32) for _ in range(n)])
    for i, bx in enumerate([0.0, 1.2, -1.6]):
        poses[i, 0, 3] = -bx
    rng = np.random.RandomState(seed)
    images = rng.rand(n, H, W, 3).astype(np.float32) * 255
    return images, poses, np.tile(K, (n, 1, 1))


@pytest.fixture(scope="module")
def weights():
    port = RAFT(cascade=CASCADE, dtype=torch.float32, device="cpu",
                generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        for i in range(len(CASCADE)):
            getattr(port.update_block, f"delta{i}")[2].weight.mul_(1e-3)
    params = convert_raft({k: v.numpy() for k, v in port.state_dict().items()})
    return port, params


@pytest.mark.parametrize("construction", ["rectified", "exact"])
def test_runner_matches_jax(weights, construction):
    port, params = weights
    images, poses, intr = _scene()
    jr = JRunner(params, construction=construction, cascade=CASCADE,
                 dtype=jnp.float32, rect_lambda_max=0.1)
    pr = InferenceRunner(model=port, construction=construction,
                         rect_lambda_max=0.1, device="cpu")
    dj = np.asarray(jr.submit(images, poses, intr, 1.0))[0]
    before = dict(cudalib.launches)
    dp = pr.submit(images, poses, intr, 1.0)[0].numpy()
    assert cudalib.launches == before  # CPU tensors: the plain versions
    assert pr.last_path == jr._last_path == construction
    assert dp.shape == dj.shape == (16, 48)
    assert np.abs(dj).max() > 1e-4
    np.testing.assert_allclose(dp, dj, **TOL)
    # disparity -> depth (zero stays zero) as the JAX runner converts it
    np.testing.assert_array_equal(pr.finalize(torch.from_numpy(dp)[None]),
                                  JRunner.finalize(dp[None]))


def test_rectified_falls_back_to_exact_over_budget(weights, capsys):
    port, _ = weights
    images, poses, intr = _scene()
    pr = InferenceRunner(model=port, construction="rectified",
                         rect_lambda_max=0.1, rect_memory_budget=1.0,
                         device="cpu")
    pr.submit(images, poses, intr, 1.0)
    assert pr.last_path == "exact"
    assert "rectified construction unavailable" in capsys.readouterr().out


class _Dataset:
    num_frames = 2


class _Loader:
    dataset = _Dataset()

    def __iter__(self):
        for ref in range(2):
            images, poses, intr = _scene(H=66, W=194, seed=ref)
            yield images, poses, intr, [f"{ref:08d}"], 1.0


def test_inference_writes_same_pfms(weights, tmp_path):
    port, params = weights
    j_inference(_Loader(), params=params, output_folder=tmp_path / "jax",
                model_kwargs=dict(cascade=CASCADE, dtype=jnp.float32),
                write_min_depth=str(tmp_path / "jax_md"))
    inference(_Loader(), model=port, output_folder=tmp_path / "port",
              write_min_depth=str(tmp_path / "port_md"), device="cpu")
    names_j = sorted(os.listdir(tmp_path / "jax" / "depths"))
    names_p = sorted(os.listdir(tmp_path / "port" / "depths"))
    assert names_p == names_j == ["00000000_scale1_nf2.pfm",
                                  "00000001_scale1_nf2.pfm"]
    for name in names_p:
        dj = read_pfm(tmp_path / "jax" / "depths" / name)
        dp = read_pfm(tmp_path / "port" / "depths" / name)
        assert dp.shape == dj.shape == (16, 48)  # cropped to the stride
        np.testing.assert_allclose(dp, dj, rtol=1e-3)
    for ref in ("00000000", "00000001"):
        mj = float((tmp_path / "jax_md" / f"{ref}.txt").read_text())
        mp = float((tmp_path / "port_md" / f"{ref}.txt").read_text())
        assert mp == pytest.approx(mj, rel=1e-3)


def test_port_imports_nothing_of_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import cermvs_torch\n"
        "for m in pkgutil.walk_packages(cermvs_torch.__path__, "
        "'cermvs_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'cermvs_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")


def test_port_sources_do_not_reference_jax():
    """No file of the port mentions the JAX package or imports jax/flax;
    chip_smoke.py imports neither (it names the replaced TPU kernel's file
    only as provenance in its report)."""
    imports = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|cermvs_tpu)\b",
                         re.M)
    files = [p for p in (REPO / "cermvs_torch").rglob("*") if p.is_file()
             and p.suffix in (".py", ".cu", ".cuh")]
    assert len(files) >= 15
    for p in files:
        text = p.read_text()
        assert "cermvs_tpu" not in text, p
        assert not imports.search(text), p
    smoke = (REPO / "chip_smoke.py").read_text()
    assert not imports.search(smoke)
    assert "import jax" not in smoke


@pytest.mark.parametrize("gin", ["inference_DTU", "inference_TNT"])
def test_shipped_gin_files_bind_to_the_port(gin):
    """Every binding the shipped inference configs make to a configurable the
    port registers is accepted, and the gin names ``fusion``/``multires``
    resolve to the port's real stages."""
    import cermvs_torch.pipeline as pipeline

    pconfig.clear_config()
    try:
        parser = pconfig.add_cli_flags(argparse.ArgumentParser())
        args = parser.parse_args(["-g", gin, "-p", "inference.rescale = 2",
                                  "-p", "RAFT.radius = 5"])
        pconfig.parse_cli(args, config_dir=str(REPO / "configs"))
        assert pconfig.query_parameter("inference.rescale") == 2
        assert pconfig.query_parameter("RAFT.radius") == 5
        bound = pconfig.operative_config()
        ported = [n for n in bound if n in pconfig._REGISTRY]
        assert {"inference", "fusion", "multires"} <= set(ported)
        assert pconfig._REGISTRY["fusion"] is pipeline.fusion
        assert pconfig._REGISTRY["multires"] is pipeline.multires
        assert pipeline.fusion.__module__ == "cermvs_torch.pipeline.fusion"
        assert (pipeline.multires.__module__
                == "cermvs_torch.pipeline.multires")
        # inference.ckpt binds the port's own weights file, which the
        # repository does not hold
        assert pconfig.query_parameter("inference.ckpt") == {
            "inference_DTU": "pretrained/train_DTU",
            "inference_TNT": "pretrained/train_BlendedMVS"}[gin]
        with pytest.raises(FileNotFoundError):
            inference(_Loader(), device="cpu")
        pconfig.bind_parameter("RAFT.dim_fmap", 32)
        assert RAFT(cascade=CASCADE, device="cpu").dim_fmap == 32
        pconfig.bind_parameter("RAFT.no_such_param", 1)
        with pytest.raises(pconfig.ConfigError):
            RAFT(cascade=CASCADE, device="cpu")
    finally:
        pconfig.clear_config()

"""The port's cluster fan-out (cermvs_torch/scripts/) against the JAX
package's (scripts/): the same jobs, name for name, and the same commands
once the CLI prefix is mapped (``python inference.py`` -> ``python -m
cermvs_torch.inference``, and so for multires and fusion); and JAX's
submitter tests for the port's submitter."""

import argparse
import runpy
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))  # scripts/ of the JAX package

import scripts.submitter as jsub  # noqa: E402
from cermvs_tpu import config as jcfg  # noqa: E402
from cermvs_torch import config as pcfg  # noqa: E402
from cermvs_torch.scripts import submit_depthmap, submit_fusion  # noqa: E402
from cermvs_torch.scripts import submitter as psub  # noqa: E402

PREFIX = {"python inference.py": "python -m cermvs_torch.inference",
          "python multires.py": "python -m cermvs_torch.multires",
          "python fusion.py": "python -m cermvs_torch.fusion"}
# a Tanks and Temples tree: views a scan (Museum's folder left out)
TNT = {"training_input/Ignatius": 130, "training_input/Barn": 100,
       "tankandtemples/intermediate/Family": 7,
       "tankandtemples/advanced/Courtroom": 201}


def _recording(monkeypatch, cls):
    jobs = []
    monkeypatch.setattr(cls, "submit",
                        lambda self, command: jobs.append((self.name,
                                                           command)))
    return jobs


@pytest.fixture
def tnt_root(tmp_path):
    for scan, n in TNT.items():
        images = tmp_path / scan / "images"
        images.mkdir(parents=True)
        for i in range(n):
            (images / f"{i:08d}.jpg").touch()
    return tmp_path


@pytest.fixture
def clean_configs(monkeypatch):
    monkeypatch.chdir(REPO)  # the scripts read configs/ from here
    monkeypatch.setenv("CERMVS_COMPILE_CACHE", "0")
    yield
    jcfg.clear_config()
    pcfg.clear_config()


@pytest.mark.parametrize("script", ["submit_depthmap", "submit_fusion"])
def test_fan_out_matches_jax(script, tnt_root, monkeypatch, clean_configs):
    argv = ["--tnt_root", str(tnt_root)] if script == "submit_depthmap" \
        else []
    want = _recording(monkeypatch, jsub.submitter)
    monkeypatch.setattr(sys, "argv", [f"{script}.py"] + argv)
    runpy.run_path(str(REPO / "scripts" / f"{script}.py"),
                   run_name="__main__")
    got = _recording(monkeypatch, psub.submitter)
    {"submit_depthmap": submit_depthmap,
     "submit_fusion": submit_fusion}[script].main(argv)

    def mapped(command):
        for old, new in PREFIX.items():
            command = command.replace(old, new)
        return command

    assert [n for n, _ in got] == [n for n, _ in want]
    assert [c for _, c in got] == [mapped(c) for _, c in want]
    assert not any(old in c for _, c in got for old in PREFIX)
    if script == "submit_depthmap":
        # 40 DTU scans twice; TNT in jobs of 100 views, at both rescales
        assert len(got) == 2 * 40 + 2 * (2 + 1 + 1 + 3)
        assert "Courtroom_2_25_200" in [n for n, _ in got]
        assert not any("Museum" in n for n, _ in got)
    else:
        assert len(got) == 40 + 21


def test_submitter_binds_from_the_shipped_config(clean_configs):
    parser = pcfg.add_cli_flags(argparse.ArgumentParser())
    pcfg.parse_cli(parser.parse_args(["-g", "submitter", "-p",
                                      'submitter.backend = "local"']))
    s = psub.submitter()
    assert (s.account, s.mem_mb, s.backend) == ("YOUR_ACCOUNT", 16, "local")


def test_local_backend_runs_command(tmp_path):
    s = psub.submitter(log_dir=str(tmp_path), backend="local", name="j1")
    s.submit("echo hello-local")
    log = (tmp_path / "j1.log").read_text()
    assert "hello-local" in log


def test_slurm_script_generation(tmp_path, monkeypatch):
    calls = []
    monkeypatch.setattr(subprocess, "run",
                        lambda *a, **k: calls.append(a) or None)
    s = psub.submitter(log_dir=str(tmp_path), backend="slurm", name="j2",
                       account="acct", gres="gpu:1", mail_user="x@y",
                       cpus_per_task=4, mem_mb=16, time="00-01:00:00")
    s.submit("python -m cermvs_torch.inference -g inference_DTU")
    script = (tmp_path / "j2.sh").read_text()
    assert "#SBATCH --job-name=j2" in script
    assert "#SBATCH --account=acct" in script
    assert "#SBATCH --gres=gpu:1" in script
    assert "#SBATCH --mail-user=x@y" in script
    assert "python -m cermvs_torch.inference -g inference_DTU" in script
    assert calls and calls[0][0][0] == "sbatch"

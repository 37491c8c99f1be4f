"""Cluster job submitter: writes a batch script and submits it.

``backend="slurm"`` writes ``{log_dir}/{name}.sh`` with the ``#SBATCH``
lines of the bound parameters and runs ``sbatch`` on it; ``backend="local"``
runs each job in turn on this host, its output in ``{log_dir}/{name}.log``
(one card: one job at a time). ``configs/submitter.gin`` binds the
parameters (``-g submitter``).
"""

from __future__ import annotations

import subprocess
from pathlib import Path

from cermvs_torch.config import configurable


@configurable("submitter")
class submitter:
    def __init__(self, log_dir="logs", account="", mail_user="",
                 mail_type="FAIL", nodes=1, ntasks=1, cpus_per_task=4,
                 mem_mb=16, time="00-01:00:00", gres="", backend="slurm",
                 name="job"):
        self.log_dir = Path(log_dir)
        self.account = account
        self.mail_user = mail_user
        self.mail_type = mail_type
        self.nodes = nodes
        self.ntasks = ntasks
        self.cpus_per_task = cpus_per_task
        self.mem_mb = mem_mb
        self.time = time
        self.gres = gres
        self.backend = backend
        self.name = name

    def submit(self, command: str) -> None:
        self.log_dir.mkdir(parents=True, exist_ok=True)
        if self.backend == "local":
            print(f"[local] {self.name}: {command}")
            with open(self.log_dir / f"{self.name}.log", "w") as f:
                subprocess.run(command, shell=True, stdout=f,
                               stderr=subprocess.STDOUT, check=False)
            return

        script = self.log_dir / f"{self.name}.sh"
        lines = [
            "#!/bin/bash",
            f"#SBATCH --job-name={self.name}",
            f"#SBATCH --output={self.log_dir}/{self.name}.out",
            f"#SBATCH --nodes={self.nodes}",
            f"#SBATCH --ntasks={self.ntasks}",
            f"#SBATCH --cpus-per-task={self.cpus_per_task}",
            f"#SBATCH --mem={self.mem_mb}G",
            f"#SBATCH --time={self.time}",
        ]
        if self.account:
            lines.append(f"#SBATCH --account={self.account}")
        if self.gres:
            lines.append(f"#SBATCH --gres={self.gres}")
        if self.mail_user:
            lines += [f"#SBATCH --mail-user={self.mail_user}",
                      f"#SBATCH --mail-type={self.mail_type}"]
        lines += ["", command, ""]
        script.write_text("\n".join(lines))
        subprocess.run(["sbatch", str(script)], check=False)

"""Training metrics logger: running means every ``SUM_FREQ`` steps, to
stdout and to ``{run_dir}/{name}/metrics.jsonl``. ``is_host0=False`` (a
data-parallel rank other than 0) logs nothing."""

from __future__ import annotations

import json
import os
import time
from typing import Dict


class Logger:
    def __init__(self, name: str, run_dir: str = "runs", SUM_FREQ: int = 100,
                 lr_fn=None, is_host0: bool = True):
        self.name = name
        self.is_host0 = is_host0
        self.SUM_FREQ = SUM_FREQ
        self.total_steps = 0
        self.running: Dict[str, float] = {}
        self.lr_fn = lr_fn
        self.run_dir = os.path.join(run_dir, name)
        self._jsonl = None
        if is_host0:
            os.makedirs(self.run_dir, exist_ok=True)
            self._jsonl = open(os.path.join(self.run_dir, "metrics.jsonl"),
                               "a")

    def push(self, metrics: Dict[str, float]) -> None:
        if not self.is_host0:
            return
        self.total_steps += 1
        for k, v in metrics.items():
            self.running[k] = self.running.get(k, 0.0) + float(v)
        if self.total_steps % self.SUM_FREQ == self.SUM_FREQ - 1:
            self._flush()

    def _flush(self) -> None:
        means = {k: v / self.SUM_FREQ for k, v in sorted(self.running.items())}
        lr = float(self.lr_fn(self.total_steps)) if self.lr_fn else 0.0
        header = f"[{self.total_steps + 1:6d}, {lr:10.7f}] "
        body = ", ".join(f"{v:10.4f}" for v in means.values())
        print(f"Training Metrics ({self.total_steps}): {header}{body}")
        record = {"step": self.total_steps, "lr": lr, "time": time.time(),
                  **means}
        self._jsonl.write(json.dumps(record) + "\n")
        self._jsonl.flush()
        self.running = {}

    def close(self) -> None:
        if self._jsonl is not None:
            self._jsonl.close()

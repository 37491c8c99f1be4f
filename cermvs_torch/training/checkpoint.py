"""Checkpoints with ``torch.save``: step, model, optimizer and scheduler
state, a rolling window of the latest ``max_to_keep``, and resume.

Saves are synchronous. Cadence: every ``save_interval`` steps, at step 1,
and when forced. Files are ``step_{step:08d}.pt`` in the manager's directory, each written
to a temporary name first and renamed, so a cut run leaves no half file.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

import torch

from cermvs_torch.training.step import TrainState


def _atomic_save(obj, path: Path) -> None:
    tmp = path.with_name(path.name + f".{os.getpid()}.tmp")
    torch.save(obj, tmp)
    os.replace(tmp, path)


class CheckpointManager:
    def __init__(self, directory, max_to_keep: int = 20,
                 save_interval: int = 5000):
        self.directory = Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.save_interval = save_interval

    def _path(self, step: int) -> Path:
        return self.directory / f"step_{step:08d}.pt"

    def all_steps(self):
        return sorted(int(p.stem[5:]) for p in self.directory.glob(
            "step_*.pt"))

    def maybe_save(self, state: TrainState, force: bool = False) -> bool:
        step = int(state.step)
        if not force and not (step % self.save_interval == 0 or step == 1):
            return False
        _atomic_save({"step": step,
                      "model": state.model.state_dict(),
                      "optimizer": state.optimizer.state_dict(),
                      "scheduler": state.scheduler.state_dict()},
                     self._path(step))
        for old in self.all_steps()[:-self.max_to_keep]:
            self._path(old).unlink()
        return True

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, state: TrainState, step: Optional[int] = None
                ) -> TrainState:
        """Load a checkpoint (the latest by default) into ``state``'s model,
        optimizer and scheduler and resume its step."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.directory}")
        ckpt = torch.load(self._path(step), map_location="cpu")
        state.model.load_state_dict(ckpt["model"])
        state.optimizer.load_state_dict(ckpt["optimizer"])
        state.scheduler.load_state_dict(ckpt["scheduler"])
        state.step = int(ckpt["step"])
        return state


def save_params(path, model: torch.nn.Module) -> None:
    """Weights only (the inference handoff, like the reference's .pth)."""
    path = Path(path).absolute()
    path.parent.mkdir(parents=True, exist_ok=True)
    _atomic_save(model.state_dict(), path)


def load_params(path) -> dict:
    return torch.load(Path(path).absolute(), map_location="cpu")

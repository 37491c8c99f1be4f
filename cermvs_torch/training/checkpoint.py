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
        _atomic_save(state_dicts(state), self._path(step))
        for old in self.all_steps()[:-self.max_to_keep]:
            self._path(old).unlink()
        return True

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, state: TrainState, step: Optional[int] = None
                ) -> TrainState:
        """Load a checkpoint (the latest by default) into ``state`` in place
        (:func:`load_state`) and resume its step."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.directory}")
        return load_state(state, torch.load(self._path(step),
                                            map_location="cpu"))


def state_dicts(state: TrainState) -> dict:
    """What a checkpoint holds: the step and the model's, optimizer's and
    scheduler's state dicts (their tensors are the live ones: copy them to
    keep a snapshot)."""
    return {"step": int(state.step),
            "model": state.model.state_dict(),
            "optimizer": state.optimizer.state_dict(),
            "scheduler": state.scheduler.state_dict()}


# how an optimizer computes its step, not what it has learned: a CPU run's
# checkpoint must not make a CUDA optimizer's step uncapturable
_IMPLEMENTATION = ("capturable", "foreach", "fused")


def _load_optimizer(optimizer: torch.optim.Optimizer, saved: dict) -> None:
    """``optimizer.load_state_dict(saved)`` keeping the optimizer's own
    implementation flags (``capturable``, ``foreach``, ``fused``), then the
    loaded values copied into the tensors the optimizer held before, which
    it keeps: tensor learning rates and each parameter's moments and step
    count (zeroed, as a fresh optimizer's are, where ``saved`` has none)."""
    kept = [(g["lr"], {k: g[k] for k in _IMPLEMENTATION if k in g})
            for g in optimizer.param_groups]
    held = {p: dict(s) for p, s in optimizer.state.items()}
    optimizer.load_state_dict(saved)
    for group, (lr, flags) in zip(optimizer.param_groups, kept):
        group.update(flags)
        if torch.is_tensor(lr):
            lr.fill_(group["lr"])
            group["lr"] = lr
    for p, tensors in held.items():
        loaded = optimizer.state[p]
        for k, t in tensors.items():
            if not torch.is_tensor(t):
                continue
            if torch.is_tensor(loaded.get(k)):
                t.copy_(loaded[k])
            else:
                t.zero_()
            loaded[k] = t


def load_state(state: TrainState, ckpt: dict) -> TrainState:
    """Load :func:`state_dicts`' contents into ``state`` in place: the
    weights, AdamW's learning rate, moments and step counts are copied into
    the tensors ``state`` already holds, so the CUDA graphs of its
    ``runner`` read the loaded values at the addresses they captured. Where
    ``state`` holds no optimizer state yet, its optimizer takes the loaded
    tensors. A checkpoint saved with a float learning rate (the CPU's)
    loads into a tensor one (CUDA's)."""
    state.model.load_state_dict(ckpt["model"])
    _load_optimizer(state.optimizer, ckpt["optimizer"])
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

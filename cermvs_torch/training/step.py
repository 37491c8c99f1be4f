"""The single-device train step: forward, sequence loss, backward,
global-norm clip and the AdamW step, in place on a :class:`TrainState`.

Batches are dicts of images (B, N, H, W, 3) in [0, 255], depths
(B, N, H, W), poses (B, N, 4, 4) and intrinsics (B, N, 3, 3).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict

import torch

from cermvs_torch.training.loss import sequence_loss
from cermvs_torch.training.optim import clip_by_global_norm, fetch_optimizer

BATCH_KEYS = ("images", "depths", "poses", "intrinsics")


@dataclass
class TrainState:
    step: int
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: Any


def init_state(model: torch.nn.Module, num_steps: int) -> TrainState:
    optimizer, scheduler = fetch_optimizer(model.parameters(),
                                           num_steps=num_steps)
    return TrainState(0, model, optimizer, scheduler)


def disp_ground_truth(depths: torch.Tensor) -> torch.Tensor:
    """The reference view's inverse depth, zeros kept invalid.
    depths: (B, N, H, W) -> (B, H, W)."""
    d = depths[:, 0]
    return torch.where(d > 0, 1.0 / torch.where(d > 0, d, torch.ones_like(d)),
                       torch.zeros_like(d))


def batch_to_device(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """A loader batch (numpy or tensors) as float32 tensors on ``device``."""
    return {k: torch.as_tensor(batch[k]).to(device, torch.float32)
            for k in BATCH_KEYS}


def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
               gradual_weight: float, volume_fn=None,
               clip_norm: float = 1.0) -> Dict[str, float]:
    """One step in place; returns the metrics of the final iterate with
    ``loss`` and ``grad_norm`` (the gradients' global norm before
    clipping). ``volume_fn``: the construction for this batch (default: the
    model's own)."""
    model = state.model
    model.train()
    model.test_mode = False
    preds = model(batch["images"], batch["poses"], batch["intrinsics"],
                  volume_fn=volume_fn)
    loss, metrics = sequence_loss(preds, disp_ground_truth(batch["depths"]),
                                  gradual_weight)
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    grad_norm = clip_by_global_norm(
        [p.grad for p in model.parameters()], clip_norm)
    state.optimizer.step()
    state.scheduler.step()
    state.step += 1
    out = {k: float(v) for k, v in metrics.items()}
    out["loss"] = float(loss.detach())
    out["grad_norm"] = float(grad_norm)
    return out

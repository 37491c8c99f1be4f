"""The optimizer side of the reference train step: the learning-rate
schedule (OneCycle, linear), the global-norm clip and AdamW as
``torch.optim.AdamW`` computes it on fp32 leaves."""

from __future__ import annotations

from typing import Callable

import torch

LR = 0.00025
WEIGHT_DECAY = 0.00005
EPSILON = 1e-8
BETAS = (0.9, 0.999)
PCT_START = 0.001
CLIP_NORM = 1.0


def one_cycle_linear(max_lr: float, total_steps: int,
                     pct_start: float = PCT_START, div_factor: float = 25.0,
                     final_div_factor: float = 1e4) -> Callable[[int], float]:
    """Learning rate at step ``count`` (0-based)."""
    initial = max_lr / div_factor
    minimum = initial / final_div_factor
    end_warm = pct_start * total_steps - 1.0
    end_total = total_steps - 1.0

    def schedule(count) -> float:
        t = float(count)
        if t <= end_warm:
            pct = min(max(t / max(end_warm, 1e-9), 0.0), 1.0)
            return initial + (max_lr - initial) * pct
        pct = min(max((t - end_warm) / max(end_total - end_warm, 1e-9), 0.0),
                  1.0)
        return max_lr + (minimum - max_lr) * pct

    return schedule


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float = CLIP_NORM) -> torch.Tensor:
    """Scale every gradient by ``max_norm / norm`` where ``norm >
    max_norm``; returns the norm before the clip."""
    grads = [g for g in grads if g is not None]
    norm = torch.stack([g.float().square().sum() for g in grads]).sum().sqrt()
    if float(norm) > max_norm:
        for g in grads:
            g.div_(norm).mul_(max_norm)
    return norm


class Optimizer:
    """AdamW along the schedule over ``num_steps + 100`` steps, with the
    clip before each update: :meth:`step` is one update after the
    backward pass."""

    def __init__(self, params, num_steps: int):
        self.params = list(params)
        self.schedule = one_cycle_linear(LR, num_steps + 100)
        self.count = 0
        self.adamw = torch.optim.AdamW(self.params, lr=self.schedule(0),
                                       betas=BETAS, eps=EPSILON,
                                       weight_decay=WEIGHT_DECAY,
                                       foreach=False)

    def step(self) -> None:
        clip_by_global_norm([p.grad for p in self.params])
        for group in self.adamw.param_groups:
            group["lr"] = self.schedule(self.count)
        self.adamw.step()
        self.count += 1

"""Optimizer, learning-rate schedule and gradient clipping.

AdamW (lr 2.5e-4, weight decay 5e-5, eps 1e-8) under a OneCycle *linear*
schedule over ``num_steps + 100`` steps with ``pct_start=0.001``, and
global-norm clipping at 1.0. The schedule is torch's OneCycleLR: initial
lr ``max_lr / 25``, final ``initial / 1e4``, phase ends at the fractional
steps ``pct_start * total - 1`` and ``total - 1``.

The model computes in bf16, whose exponent range is fp32's, so there is no
loss scaler.
"""

from __future__ import annotations

from typing import Callable, Iterable, Tuple

import torch

from cermvs_torch.config import configurable


def one_cycle_linear(max_lr: float, total_steps: int,
                     pct_start: float = 0.001, div_factor: float = 25.0,
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
def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in fp32."""
    sq = [t.float().square().sum() for t in tensors]
    return torch.stack(sq).sum().sqrt()


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float) -> torch.Tensor:
    """Scale every gradient by ``max_norm / norm`` when ``norm > max_norm``
    (no epsilon in the denominator, unlike ``clip_grad_norm_``); returns
    the norm before clipping."""
    grads = [g for g in grads if g is not None]
    norm = global_norm(grads)
    if float(norm) > max_norm:
        for g in grads:
            g.div_(norm).mul_(max_norm)
    return norm


@configurable("optimizer")
def fetch_optimizer(params, num_steps: int, lr: float = 0.00025,
                    wdecay: float = 0.00005, epsilon: float = 1e-8,
                    pct_start: float = 0.001
                    ) -> Tuple[torch.optim.AdamW, torch.optim.lr_scheduler.LambdaLR]:
    """AdamW over ``params`` and a LambdaLR stepping it along
    :func:`one_cycle_linear`: the k-th ``optimizer.step()`` (0-based) runs
    at ``schedule(k)`` when the scheduler steps once after each."""
    schedule = one_cycle_linear(lr, num_steps + 100, pct_start)
    opt = torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=epsilon,
                            weight_decay=wdecay)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda count: schedule(count) / lr)
    return opt, sched

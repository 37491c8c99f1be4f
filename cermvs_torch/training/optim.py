"""Optimizer, learning-rate schedule and gradient clipping.

AdamW (lr 2.5e-4, weight decay 5e-5, eps 1e-8) under a OneCycle *linear*
schedule over ``num_steps + 100`` steps with ``pct_start=0.001``, and
global-norm clipping at ``clip_norm`` (1.0). The schedule is torch's
OneCycleLR: initial lr ``max_lr / 25``, final ``initial / 1e4``, phase ends
at the fractional steps ``pct_start * total - 1`` and ``total - 1``.

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
    the norm before clipping.

    The decision is made on the device, with no host sync, so a CUDA graph
    can capture it: each gradient is divided by ``norm`` and multiplied by
    ``max_norm`` above the limit (optax's ``(t / g_norm) * max_norm``), and
    divided and multiplied by 1 below it, which leaves it as it is."""
    grads = [g for g in grads if g is not None]
    norm = global_norm(grads)
    over = norm > max_norm
    one = torch.ones_like(norm)
    div = torch.where(over, norm, one)
    mul = torch.where(over, torch.full_like(norm, max_norm), one)
    for g in grads:
        g.div_(div).mul_(mul)
    return norm


@configurable("optimizer")
def fetch_optimizer(params, num_steps: int, lr: float = 0.00025,
                    wdecay: float = 0.00005, epsilon: float = 1e-8,
                    pct_start: float = 0.001, clip_norm: float = 1.0
                    ) -> Tuple[torch.optim.AdamW,
                               torch.optim.lr_scheduler.LambdaLR, float,
                               Callable[[int], float]]:
    """AdamW over ``params``, a LambdaLR stepping it along
    :func:`one_cycle_linear` (the k-th ``optimizer.step()``, 0-based, runs
    at ``schedule(k)`` when the scheduler steps once after each), the
    global norm the gradients are clipped to before each step
    (:func:`clip_by_global_norm`, as the JAX package chains optax's
    ``clip_by_global_norm(clip_norm)`` ahead of AdamW), and the schedule
    itself (the learning rate at a step, on the host, as the JAX package's
    ``fetch_optimizer`` returns it).

    On a CUDA device AdamW is ``capturable`` and its learning rate a 0-dim
    tensor there, which the LambdaLR fills in place: a CUDA graph of the
    step reads the schedule's value at each replay. On the CPU, where
    ``capturable`` is refused, the learning rate is a float."""
    params = list(params)
    schedule = one_cycle_linear(lr, num_steps + 100, pct_start)
    capturable = bool(params) and params[0].device.type == "cuda"
    opt = torch.optim.AdamW(
        params, lr=(torch.tensor(lr, dtype=torch.float32,
                                 device=params[0].device)
                    if capturable else lr),
        betas=(0.9, 0.999), eps=epsilon, weight_decay=wdecay,
        capturable=capturable)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda count: schedule(count) / lr)
    return opt, sched, float(clip_norm), schedule

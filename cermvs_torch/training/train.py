"""The training loop on one device.

The curriculum weight ramps 0 -> 1 over training (``step / num_steps``
unless ``fix_gradual_weight``), checkpoints carry the full state and resume,
metrics go through the running-mean logger, and the threaded loader
overlaps host loading with device work.

``construction="rectified"``: each batch is planned on the host (one
``plan_rectification`` per sample at feature stride, merged by
``plan_union``), the plan is keyed through a ``PlanCache`` so that a run
keeps a handful of plans, and the batch trains through a
``RectifiedVolume`` of its cached plan; a batch the planner rejects trains
through the exact construction.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np
import torch

from cermvs_torch.config import configurable


def plan_batch(batch, stride_factor: int):
    """The rectification plan of a host batch: ``plan_rectification`` of
    each sample at feature stride, merged by ``plan_union`` (not ok when
    the planner rejects a sample)."""
    from cermvs_torch.ops.rectify import plan_rectification, plan_union

    poses = np.asarray(batch["poses"], np.float64)
    intr = np.asarray(batch["intrinsics"], np.float64).copy()
    intr[..., :2, :] /= stride_factor
    H, W = np.asarray(batch["images"]).shape[2:4]
    return plan_union(plan_rectification(poses[b], intr[b], H // stride_factor,
                                         W // stride_factor)
                      for b in range(poses.shape[0]))


@configurable("train")
def train(name: str = "test", batch_size: int = 2, SAVE_FREQ: int = 5000,
          fix_gradual_weight: Optional[float] = None,
          num_steps: int = 100000, checkpoint_dir: str = "checkpoints",
          data_parallel: bool = True, resume: bool = True, seed: int = 1234,
          log_every: int = 100, construction: str = "exact",
          device="cuda", run_dir: str = "runs",
          on_step: Optional[Callable] = None):
    """Train RAFT (its configurable bindings) and return the final
    :class:`TrainState`. Runs ``num_steps + 1`` steps from step 0.

    ``data_parallel`` does nothing on one device; training over several
    cards is ROADMAP Queue 1 item 7. ``on_step(state, metrics, plan)`` is
    called after every step, ``plan`` being the batch's cached RectPlan or
    None for the exact construction.
    """
    from cermvs_torch import data as data_mod
    from cermvs_torch.models.raft import RAFT
    from cermvs_torch.ops.corr_rectified import RectifiedVolume
    from cermvs_torch.ops.rectify import PlanCache
    from cermvs_torch.training.checkpoint import CheckpointManager
    from cermvs_torch.training.step import (batch_to_device, init_state,
                                            train_step)
    from cermvs_torch.utils.logger import Logger

    if construction not in ("exact", "rectified"):
        raise ValueError(f"unknown construction {construction!r}")
    del data_parallel
    device = torch.device(device)
    model = RAFT(generator=torch.Generator().manual_seed(seed), device=device)
    state = init_state(model, num_steps)
    loader = data_mod.get_train_data_loader(batch_size=batch_size)

    mgr = CheckpointManager(f"{checkpoint_dir}/{name}",
                            save_interval=SAVE_FREQ)
    if resume and mgr.latest_step() is not None:
        state = mgr.restore(state)
        print(f"resumed from step {state.step}")

    volumes = {}
    plan_cache = PlanCache()

    def pick_volume(batch):
        """(volume_fn, plan) for a host batch: None, None for exact."""
        if construction != "rectified":
            return None, None
        plan = plan_batch(batch, model.stride_factor)
        if not plan.ok:
            return None, None
        plan = plan_cache.key_for(plan)
        if plan not in volumes:
            volumes[plan] = RectifiedVolume(plan)
        return volumes[plan], plan

    logger = Logger(name, run_dir=run_dir, SUM_FREQ=log_every,
                    lr_fn=lambda _: state.optimizer.param_groups[0]["lr"])

    total_steps = state.step
    initial_steps = total_steps
    tic = None
    total_time = 0.0
    while total_steps <= num_steps:
        for batch in loader:
            volume_fn, plan = pick_volume(batch)
            gw = (fix_gradual_weight if fix_gradual_weight is not None
                  else total_steps / num_steps)
            metrics = train_step(state, batch_to_device(batch, device), gw,
                                 volume_fn=volume_fn)
            total_steps += 1
            logger.push(metrics)
            mgr.maybe_save(state)
            if on_step is not None:
                on_step(state, metrics, plan)
            if tic is not None:
                total_time += time.time() - tic
                done = total_steps - initial_steps
                if done % log_every == 0:
                    per = total_time / done
                    eta_days = per * (num_steps - total_steps) / 86400
                    print(f"time per step: {per:.3f}s, eta: "
                          f"{eta_days:.2f} days")
            tic = time.time()
            if total_steps > num_steps:
                break

    mgr.maybe_save(state, force=True)
    logger.close()
    return state

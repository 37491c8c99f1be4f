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

Each step goes through the state's :class:`~cermvs_torch.training.step.
StepRunner`, keyed by the batch's shapes and that plan (None for exact), as
the JAX package's ``pick_step`` chooses a jitted step: on CUDA a key's first
step runs eagerly and is captured in a CUDA graph that later steps of the
key replay, so the ``PlanCache`` bounds the captures as it bounds JAX's
compiles; on the CPU every step runs eagerly.

Data parallel (``data_parallel`` with a process group initialised, as
``launch_distributed`` does): every rank loads its share of each global
batch (``process_shard=(rank, world)``), plans it, and the ranks all-gather
the packed plans and take the same ``plan_union`` (:func:`exchange_plan`),
so that every rank reaches the same ``PlanCache`` key and steps the same
construction in the same order; a rank on another key would wait forever in
the step's collective. The step averages the gradients over the ranks
(``training/step.py``); only rank 0 logs and writes checkpoints.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np
import torch

from cermvs_torch.config import configurable
from cermvs_torch.parallel import mesh as pmesh
from cermvs_torch.utils import profiling


def plan_batch(batch, stride_factor: int):
    """The rectification plan of a host batch: ``plan_rectification`` of
    each sample at feature stride, merged by ``plan_union`` (not ok when
    the planner rejects a sample); a ``plan`` span."""
    from cermvs_torch.ops.rectify import plan_rectification, plan_union

    with profiling.span("plan"):
        poses = np.asarray(batch["poses"], np.float64)
        intr = np.asarray(batch["intrinsics"], np.float64).copy()
        intr[..., :2, :] /= stride_factor
        H, W = np.asarray(batch["images"]).shape[2:4]
        return plan_union(plan_rectification(poses[b], intr[b],
                                             H // stride_factor,
                                             W // stride_factor)
                          for b in range(poses.shape[0]))


def exchange_plan(plan, n_views: int, group):
    """The union of every rank's plan of its local batch, the same on every
    rank: the packed plans all-gathered over ``group`` (the JAX package's
    ``process_allgather``), unpacked and merged by ``plan_union``."""
    from cermvs_torch.ops.rectify import pack_plan, plan_union, unpack_plan

    vecs = pmesh.process_allgather(pack_plan(plan, n_views), group)
    return plan_union(unpack_plan(v, n_views) for v in vecs)


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

    ``data_parallel``: with a process group initialised, train over its
    ranks, each on its share of every batch (``device`` "cuda" means this
    rank's card, ``cuda:LOCAL_RANK``); with none, train here alone, as
    without it. ``on_step(state, metrics, plan)`` is
    called after every step, ``plan`` being the batch's cached RectPlan or
    None for the exact construction. The state's ``runner`` is the
    :class:`~cermvs_torch.training.step.StepRunner` the steps went through;
    its CUDA graphs live as long as it does.
    """
    from cermvs_torch import data as data_mod
    from cermvs_torch.models.raft import RAFT
    from cermvs_torch.ops.rectify import PlanCache
    from cermvs_torch.training.checkpoint import CheckpointManager
    from cermvs_torch.training.step import (StepRunner, batch_to_device,
                                            init_state)
    from cermvs_torch.utils.logger import Logger

    if construction not in ("exact", "rectified"):
        raise ValueError(f"unknown construction {construction!r}")
    group = pmesh.world() if data_parallel else None
    rank, world = pmesh.rank(group), pmesh.world_size(group)
    host0 = rank == 0
    device = pmesh.local_device(device)
    # the same seed on every rank: the ranks start from the same weights
    model = RAFT(generator=torch.Generator().manual_seed(seed), device=device)
    state = init_state(model, num_steps)
    loader = data_mod.get_train_data_loader(
        batch_size=batch_size,
        **({"process_shard": (rank, world)} if world > 1 else {}))

    mgr = CheckpointManager(f"{checkpoint_dir}/{name}",
                            save_interval=SAVE_FREQ)
    if resume and mgr.latest_step() is not None:
        state = mgr.restore(state)
        print(f"resumed from step {state.step}")
    state.runner = StepRunner(state, group=group)

    plan_cache = PlanCache()

    def pick_plan(batch):
        """The construction key of a host batch: its cached RectPlan, or
        None for the exact construction."""
        if construction != "rectified":
            return None
        plan = plan_batch(batch, model.stride_factor)
        if world > 1:  # the union of one rank's plan is that plan
            n_views = np.asarray(batch["poses"]).shape[1] - 1
            plan = exchange_plan(plan, n_views, group)
        return plan_cache.key_for(plan) if plan.ok else None

    logger = Logger(name, run_dir=run_dir, SUM_FREQ=log_every,
                    lr_fn=state.schedule, is_host0=host0)

    total_steps = state.step
    initial_steps = total_steps
    tic = None
    total_time = 0.0
    while total_steps <= num_steps:
        for batch in loader:
            plan = pick_plan(batch)
            gw = (fix_gradual_weight if fix_gradual_weight is not None
                  else total_steps / num_steps)
            metrics = state.runner(batch_to_device(batch, device), gw, plan)
            state.step += 1
            total_steps += 1
            logger.push(metrics)
            if host0:
                mgr.maybe_save(state)
            if on_step is not None:
                on_step(state, metrics, plan)
            if tic is not None:
                total_time += time.time() - tic
                done = total_steps - initial_steps
                if host0 and done % log_every == 0:
                    per = total_time / done
                    eta_days = per * (num_steps - total_steps) / 86400
                    print(f"time per step: {per:.3f}s, eta: "
                          f"{eta_days:.2f} days")
            tic = time.time()
            if total_steps > num_steps:
                break

    if host0:
        mgr.maybe_save(state, force=True)
    logger.close()
    return state

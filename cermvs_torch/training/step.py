"""The train step: forward, sequence loss, backward, global-norm clip and
the AdamW step, in place on a :class:`TrainState`, and :class:`StepRunner`,
the step of each (batch shapes, construction key) as a CUDA graph: the
counterpart of the JAX package's ``make_train_step``, which ``train()`` jits
once for the exact construction and once per cached rectification plan.

Data parallel (``group``): each rank steps its local batch, and between the
backward pass and the clip the gradients and the loss are averaged over the
group (the JAX package's ``pmean`` over the data axis,
``training/step.py:98-99``), one ``all_reduce`` on a flat buffer, and the
metrics reweighted by the local over the global valid-pixel count
(``training/step.py:100-106``). Every rank then clips
and updates the same weights. An explicit collective, not
``DistributedDataParallel``: its reducer's autograd hooks and bucket
rebuilds in the first iterations would sit inside a captured step.

Batches are dicts of images (B, N, H, W, 3) in [0, 255], depths
(B, N, H, W), poses (B, N, 4, 4) and intrinsics (B, N, 3, 3).
"""

from __future__ import annotations

import functools
import gc
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from cermvs_torch.ops import cudalib
from cermvs_torch.parallel.mesh import collectives_capturable
from cermvs_torch.training.loss import sequence_loss
from cermvs_torch.training.optim import clip_by_global_norm, fetch_optimizer
from cermvs_torch.utils import profiling

BATCH_KEYS = ("images", "depths", "poses", "intrinsics")


@dataclass
class TrainState:
    """``clip_norm``: the global norm each step clips the gradients to, as
    the optimizer's configuration (``optimizer.clip_norm``) sets it;
    ``schedule``: the learning rate at a step, on the host; ``runner``: the
    :class:`StepRunner` that ``train()`` steps this state with."""
    step: int
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: Any
    clip_norm: float = 1.0
    schedule: Optional[Callable[[int], float]] = None
    runner: Optional["StepRunner"] = None


def init_state(model: torch.nn.Module, num_steps: int) -> TrainState:
    optimizer, scheduler, clip_norm, schedule = fetch_optimizer(
        model.parameters(), num_steps=num_steps)
    return TrainState(0, model, optimizer, scheduler, clip_norm, schedule)


def disp_ground_truth(depths: torch.Tensor) -> torch.Tensor:
    """The reference view's inverse depth, zeros kept invalid.
    depths: (B, N, H, W) -> (B, H, W)."""
    d = depths[:, 0]
    return torch.where(d > 0, 1.0 / torch.where(d > 0, d, torch.ones_like(d)),
                       torch.zeros_like(d))


def batch_to_device(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """A loader batch (numpy or tensors) as float32 tensors on ``device``
    (an ``upload`` span)."""
    with profiling.span("upload"):
        return {k: torch.as_tensor(batch[k]).to(device, torch.float32)
                for k in BATCH_KEYS}


def data_parallel_mean(params, loss: torch.Tensor,
                       metrics: Dict[str, torch.Tensor],
                       depths: torch.Tensor, group
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The gradients (in place) and the loss as their means over ``group``,
    and each metric as its global value: JAX's ``pmean`` of the gradients
    and the loss, and its ``psum`` of each metric weighted by the local
    valid-pixel count over the global count (``sequence_loss`` divides by
    the local count). Two ``all_reduce`` calls: the gradients, the loss and
    the count in one flat buffer, then the weighted metrics. In a world of
    one every value comes back bit for bit."""
    grads = [p.grad for p in params if p.grad is not None]
    n = dist.get_world_size(group)
    denom = (depths[:, 0] > 0).sum().float().clamp(min=1.0)
    flat = torch.cat([g.reshape(-1) for g in grads]
                     + [loss.detach().reshape(1), denom.reshape(1)])
    dist.all_reduce(flat, group=group)
    flat[:-1].div_(n)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()
    values = torch.stack(list(metrics.values())) * (denom / flat[-1])
    dist.all_reduce(values, group=group)
    return flat[-2], dict(zip(metrics, values.unbind()))


def step_body(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
              clip_norm: float, batch: Dict[str, torch.Tensor],
              gradual_weight, volume_fn=None, group=None
              ) -> Tuple[Tuple[str, ...], torch.Tensor]:
    """Forward, sequence loss, backward, clip and the AdamW update, with no
    host sync, so a CUDA graph can capture it. Returns the names of the
    final iterate's metrics, ``loss`` and ``grad_norm`` (the gradients'
    global norm before the clip) and their values stacked in one fp32
    tensor on the device, so that they come back in one copy.

    ``group``: the data-parallel process group (None: this process
    alone), over which :func:`data_parallel_mean` averages the gradients
    and the loss before the clip.

    The gradients are zeroed in place, not freed: after a model's first
    step they keep their addresses, outside any graph's memory pool, and a
    captured step accumulates into them.

    Its spans (``utils/profiling.py``, each with device marks):
    ``step.forward`` (the forward and the loss), ``step.backward`` (the
    gradients zeroed and ``loss.backward()``, ``RAFT.remat``'s recompute
    among it) and ``step.optimizer`` (the all-reduce, the clip and AdamW)."""
    model.train()
    model.test_mode = False
    on = batch["images"]
    with profiling.span("step.forward", on=on):
        preds = model(batch["images"], batch["poses"], batch["intrinsics"],
                      volume_fn=volume_fn)
        loss, metrics = sequence_loss(
            preds, disp_ground_truth(batch["depths"]), gradual_weight)
    with profiling.span("step.backward", on=on):
        optimizer.zero_grad(set_to_none=False)
        loss.backward()
    with profiling.span("step.optimizer", on=on):
        if group is not None:
            loss, metrics = data_parallel_mean(model.parameters(), loss,
                                               metrics, batch["depths"],
                                               group)
        grad_norm = clip_by_global_norm(
            [p.grad for p in model.parameters()], clip_norm)
        optimizer.step()
    names = tuple(metrics) + ("loss", "grad_norm")
    return names, torch.stack(list(metrics.values())
                              + [loss.detach(), grad_norm])


def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
               gradual_weight, volume_fn=None, group=None
               ) -> Dict[str, float]:
    """One eager step in place; returns the metrics of the final iterate
    with ``loss`` and ``grad_norm`` (the gradients' global norm before
    clipping to ``state.clip_norm``). ``gradual_weight``: a float or a
    0-dim tensor on the model's device. ``volume_fn``: the construction for
    this batch (default: the model's own). ``group``: the data-parallel
    process group, or None."""
    names, values = step_body(state.model, state.optimizer, state.clip_norm,
                              batch, gradual_weight, volume_fn, group)
    state.scheduler.step()
    state.step += 1
    return dict(zip(names, values.tolist()))


def _volume_of(key):
    """The construction of a step's key: None for exact, else the plan's
    rectified one."""
    if key is None:
        return None
    from cermvs_torch.ops.corr_rectified import RectifiedVolume

    return RectifiedVolume(key)


class GraphedStep:
    """A train step captured in a CUDA graph: ``inputs`` its static batch
    buffers, ``gw`` its static curriculum weight, ``names`` and ``values``
    its static output, ``launches`` the kernel launches its capture
    counted. A call copies the batch in, fills the weight, replays the
    graph on the current stream and returns ``(names, values)``, which the
    next replay of any graph of the runner may overwrite."""

    def __init__(self, graph, inputs, gw, names, values, launches):
        self.graph = graph
        self.inputs = inputs
        self.gw = gw
        self.names = names
        self.values = values
        self.launches = launches

    def __call__(self, batch, gradual_weight):
        with profiling.span("step.copy_in"):
            for k, dst in self.inputs.items():
                dst.copy_(batch[k])
            self.gw.fill_(gradual_weight)
        with profiling.span("step.replay"):
            self.graph.replay()
        cudalib.add_launches(self.launches)
        profiling.count("dispatch.replay")
        return self.names, self.values


class StepRunner:
    """The train step of a state's model, optimizer and scheduler, keyed by
    ``(the batch's shapes and dtypes, construction key)``: the key is the
    cached ``RectPlan`` of a rectified batch or None for the exact
    construction, as the JAX package's ``train()`` keeps one jitted step
    for the exact construction and one per ``PlanCache`` key.

    On CUDA the first dispatch of a batch shape is an eager step (which
    also makes the lazy loads that a capture must not make: the kernels'
    libraries, cuDNN and cuBLAS plans, AdamW's moments, the gradients),
    then the runner captures the same step in a CUDA graph; the first
    dispatch of a new plan for a shape it has stepped captures first and
    replays, because an eager step beside the graphs' pool would hold a
    second step's transients (a train_DTU.gin step's are ~33 GiB).
    Every later dispatch of the key copies the batch into the static
    buffers, fills the static curriculum weight, replays the graph and
    steps the scheduler, whose in-place fill of AdamW's learning-rate
    tensor the next replay reads. A capture that fails raises. On the CPU
    the keys are kept the same way and every step runs eagerly, with the
    weight as given.

    The graphs share one memory pool, which holds only a step's transients
    and each graph's static output: the weights, gradients, AdamW's state
    and the static inputs live outside it, and a dispatch copies the
    metrics out before the next replay. They read the weights and the
    optimizer's tensors at their addresses: load checkpoints in place
    (``training.checkpoint.load_state``). The model's attributes and the
    ``torch.backends`` flags stay as they were at capture: change those on
    a new runner. ``state.step`` is the caller's to advance.

    ``group``: the data-parallel process group (None: this process alone).
    Under NCCL each graph holds the step's ``all_reduce`` calls; a gloo
    collective cannot be captured, so under gloo every step runs eagerly on
    the same device and kernels (:attr:`graphs` False, :attr:`eager_reason`
    says why).

    Tracing (``utils/profiling.py``, while it is on): host spans
    ``step.copy_in`` and ``step.replay`` (a replay's), ``capture``,
    ``step.metrics_wait`` (the metrics' copy to the host) and
    ``step.schedule``, beside :func:`step_body`'s spans with device marks;
    counters ``captures`` (a key's first dispatch) and ``dispatch.replay``
    / ``dispatch.eager``."""

    def __init__(self, state: TrainState, group=None):
        self.model = state.model
        self.optimizer = state.optimizer
        self.scheduler = state.scheduler
        self.clip_norm = state.clip_norm
        self.group = group
        self.device = next(self.model.parameters()).device
        self._steps: Dict[tuple, Callable] = {}
        self._static: Dict[tuple, Dict[str, torch.Tensor]] = {}
        # what the last dispatch did: its key, whether the key was new, and
        # for a new key on CUDA the seconds of its eager step (0 where the
        # shape was stepped before) and of its capture
        self.last_key: Optional[tuple] = None
        self.last_dispatch_compiled = False
        self.last_eager_s = 0.0
        self.last_capture_s = 0.0
        self._pool = None
        self.graphs = (self.device.type == "cuda"
                       and collectives_capturable(group))
        self.eager_reason = (
            None if self.graphs else
            "a CPU step" if self.device.type != "cuda" else
            f"{dist.get_backend(group)} collectives cannot be captured in a "
            f"CUDA graph")
        if self.graphs:
            self._gw = torch.zeros((), dtype=torch.float32,
                                   device=self.device)
            self._capture_stream = torch.cuda.Stream(self.device)
            with torch.cuda.device(self.device):
                self._pool = torch.cuda.graph_pool_handle()

    def __call__(self, batch: Dict[str, torch.Tensor], gradual_weight,
                 key=None) -> Dict[str, float]:
        """One step on a batch on the runner's device, through the
        construction of ``key`` (a ``RectPlan``, or None for exact):
        forward to the scheduler's update. Returns the metrics (the final
        iterate's, ``loss`` and ``grad_norm``) on the host, in one copy."""
        cache_key = (tuple((tuple(batch[k].shape), batch[k].dtype)
                           for k in BATCH_KEYS), key)
        self.last_key = cache_key
        self.last_dispatch_compiled = cache_key not in self._steps
        self.last_eager_s = self.last_capture_s = 0.0
        if not self.last_dispatch_compiled:
            step = self._steps[cache_key]
            if not isinstance(step, GraphedStep):
                profiling.count("dispatch.eager")
            names, values = step(batch, gradual_weight)
        elif self._pool is None:
            profiling.count("captures")
            profiling.count("dispatch.eager")
            self._steps[cache_key] = functools.partial(
                step_body, self.model, self.optimizer, self.clip_norm,
                volume_fn=_volume_of(key), group=self.group)
            names, values = self._steps[cache_key](batch, gradual_weight)
        else:
            profiling.count("captures")
            names, values = self._first(cache_key, batch, gradual_weight)
        with profiling.span("step.metrics_wait"):
            values = values.tolist()
        with profiling.span("step.schedule"):
            self.scheduler.step()
        return dict(zip(names, values))

    def _first(self, cache_key, batch, gradual_weight):
        """A new key on CUDA: the eager step where the batch shape is new,
        then the capture; otherwise the capture, then its replay."""
        volume_fn = _volume_of(cache_key[1])
        spec = cache_key[0]
        eager = spec not in self._static
        t0 = time.perf_counter()
        if eager:
            self._gw.fill_(gradual_weight)
            profiling.count("dispatch.eager")
            names, values = step_body(self.model, self.optimizer,
                                      self.clip_norm, batch, self._gw,
                                      volume_fn, self.group)
            torch.cuda.synchronize(self.device)
            self._static[spec] = {k: torch.empty_like(batch[k])
                                  for k in BATCH_KEYS}
        t1 = time.perf_counter()
        static = self._static[spec]
        # a graph that Python's collector frees during the capture would
        # free memory there, which ends the capture: collect first; then
        # the eager step's cached blocks go back to the card before the
        # graph takes a step's transients into its pool
        gc.collect()
        torch.cuda.empty_cache()
        graph = torch.cuda.CUDAGraph()
        with profiling.span("capture"), \
                cudalib.captured_launches() as launches, \
                torch.cuda.graph(graph, pool=self._pool,
                                 stream=self._capture_stream,
                                 capture_error_mode="thread_local"):
            g_names, g_values = step_body(self.model, self.optimizer,
                                          self.clip_norm, static, self._gw,
                                          volume_fn, self.group)
        step = GraphedStep(graph, static, self._gw, g_names, g_values,
                           launches)
        self._steps[cache_key] = step
        self.last_eager_s = t1 - t0
        self.last_capture_s = time.perf_counter() - t1
        if not eager:
            names, values = step(batch, gradual_weight)
        return names, values

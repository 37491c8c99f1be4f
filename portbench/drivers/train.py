"""Training cells: ``train()``'s per-step path on a pool of batches made
from the seed: ``plan_batch``, ``PlanCache.key_for``, ``batch_to_device``
and ``state.runner(batch, gradual_weight, key)``, each step's metrics
copied back to the host as ``train()`` takes them. The loader is outside
the window.

Set-up: the kernels' libraries, the model (``RAFT.remat`` as configured)
with weights from the seed, AdamW and the step runner (``init_state``,
``StepRunner``), the batch pool; then one step on every batch of the pool,
which captures every plan key of the pool (a key's first step runs
eagerly); then the weights, AdamW's moments, step counts and learning rate
and the schedule are put back in place to where they started
(``checkpoint.load_state``, which the graphs read at their addresses), and
the runner takes three steps from there, each a replay of its key's graph.
Those three are the checked ones: the loss of each, the first gradient as
AdamW got it (its first moment after one step over ``1 - beta1``) and each
leaf's change over the three, held against the reference's three steps
from the same weights on the same batches. The same state goes on into
the window.

The window: whole cycles of the pool, until ``--seconds`` have passed at
the end of a cycle, so that every window steps the pool's mix of
constructions alike; it ends on a ``torch.cuda.synchronize()`` after the
last step, and ``step_s`` is its seconds over its steps. A traced run
takes ``trace_skip`` steps and then a whole cycle under the profiler, with
the harness's spans around each step and around its plan and upload.
"""

from __future__ import annotations

import copy
import gc
import time

import torch

from portbench import check, flops, harness, traffic, tracing
from portbench.drivers.infer import _activities, build_kernels, model_kwargs


def run(r: harness.Run) -> None:
    from cermvs_torch.models.raft import RAFT
    from cermvs_torch.ops.rectify import PlanCache
    from cermvs_torch.training.checkpoint import load_state, state_dicts
    from cermvs_torch.training.step import (StepRunner, batch_to_device,
                                            init_state)
    from cermvs_torch.training.train import plan_batch

    cfg, mix, cell, dev = r.config, r.mix, r.cell, r.device
    num_steps = cfg["train"]["num_steps"]
    rectified = cfg["train"]["construction"] == "rectified"
    build_kernels(dev)
    model = RAFT(device=dev, **model_kwargs(cfg))
    weights = harness.make_weights(model, r.seed, dev,
                                   cfg.get("weight_scales"))
    state = init_state(model, num_steps)
    state.runner = StepRunner(state)
    start = copy.deepcopy(state_dicts(state))
    plan_cache = PlanCache()
    batches = traffic.make(mix, cfg, r.seed, dev)
    P = len(batches.slots)
    pool = [batches.batch(i) for i in range(P)]
    spans = {"plan_upload": []}
    stepped = []
    counts = {"exact_steps": 0, "onepass_steps": 0, "first_dispatches": 0}

    def step(batch, trace=False):
        t = time.perf_counter()
        with torch.profiler.record_function("portbench.plan_upload"):
            key = None
            if rectified:
                plan = plan_batch(batch, model.stride_factor)
                key = plan_cache.key_for(plan) if plan.ok else None
            on_device = batch_to_device(batch, dev)
        if trace:
            spans["plan_upload"].append(time.perf_counter() - t)
        metrics = state.runner(on_device, state.step / num_steps, key)
        state.step += 1
        stepped.append(batch)
        counts["exact_steps"] += key is None
        counts["onepass_steps"] += key is not None and not key.twopass
        counts["first_dispatches"] += state.runner.last_dispatch_compiled
        return metrics

    for batch in pool:
        step(batch)
    load_state(state, start)
    r.notes["setup_counts"] = dict(counts)
    counts.update(exact_steps=0, onepass_steps=0, first_dispatches=0)
    program = {"losses": []}
    for i in range(3):
        program["losses"].append(step(pool[i])["loss"])
        if i == 0:
            beta1 = state.optimizer.param_groups[0]["betas"][0]
            program["grad1"] = {
                n: state.optimizer.state.get(p, {}).get(
                    "exp_avg", torch.zeros_like(p)).float().cpu()
                / (1.0 - beta1) for n, p in model.named_parameters()}
    program["change"] = {n: p.detach().float().cpu() - weights[n]
                         for n, p in model.named_parameters()}
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - r.t_start
    r.notes["checked"] = dict(counts, kinds=batches.kinds[:3])
    counts.update(exact_steps=0, onepass_steps=0, first_dispatches=0)
    gws = [k / num_steps for k in range(3)]

    if r.trace:
        skip = cell["trace_skip"]
        with torch.profiler.profile(activities=_activities(dev)) as prof:
            for n in range(skip + P):
                with torch.profiler.record_function("portbench.step"):
                    step(pool[(3 + n) % P], trace=True)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        out = harness.scratch_dir()
        trace_path = out / "trace.json"
        prof.export_chrome_trace(str(trace_path))
    else:
        t0 = time.perf_counter()
        n = 0
        while n % P or time.perf_counter() < t0 + r.seconds:
            step(pool[(3 + n) % P])
            n += 1
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        window_s = time.perf_counter() - t0
    r.peak_bytes = harness.peak_bytes(dev)
    r.notes["plan_keys"] = len(plan_cache)
    r.notes["kinds"] = batches.kinds
    r.notes["window_counts"] = dict(counts, steps=len(stepped) - P - 3)
    state = model = None
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    if r.trace:
        m = cfg["model"]
        H, W = cfg["crop_hw"]
        B = cfg["batch_size"]
        r.reading = tracing.Reading(
            trace_path, spans, "portbench.step", cell["trace_skip"],
            flops.step_flops(m, B, cfg["num_frames"] + 1, H, W),
            _epiband_bytes(stepped, cfg, P + 3, B),
            flops.peaks(torch.cuda.get_device_name(dev))
            if dev.type == "cuda" else None)
        r.read_layers()
        harness.remove(out)
    else:
        r.put("step_s", window_s / n)
        r.put("peak_mem_gib", r.peak_bytes / 2**30)
        r.put("setup_s", setup_s)
    r.attempted = 3
    t = time.perf_counter()
    with check.precise():
        reference = check.reference_steps(cfg, weights, pool[:3], gws, dev)
    r.notes["check_s"] = time.perf_counter() - t
    gaps = check.train_gaps(program, reference)
    r.compared.update({k: (gaps[k], lim)
                       for k, lim in cell["limits"].items()})
    r.notes["gaps"] = gaps
    r.notes["worst_leaves"] = check.worst_leaves(program, reference)
    r.notes["still_leaves"] = check.still_leaves(reference)
    r.notes["losses"] = program["losses"]
    r.notes["reference_losses"] = reference["losses"]


def _epiband_bytes(stepped, cfg, first, batch):
    """Bytes of the traced steps' epiband launches (forward and both
    gradients, a launch a sample, view and stage), from the plans that the
    reference's router keys the stepped batches to in order."""
    from portbench.reference.route import BatchRouter

    m = cfg["model"]
    stages = [flops.hypotheses(d, m) for d, _, _ in m["cascade"]]
    router = BatchRouter(4 if m["encoder_type"] == "HR" else 8)
    total = {}
    for i, b in enumerate(stepped):
        key = router.key(b)
        if i < first or key is None:
            continue
        for k, v in flops.plan_epiband_bytes(key, m["dim_fmap"],
                                             stages).items():
            total[k] = total.get(k, 0) + batch * v
    return total

"""A dry run of the port over several processes: :func:`dryrun_multiprocess`
starts ``n`` ranks of one gloo process group (:class:`World`), runs the
data-parallel train step, the view-sharded forward and sharded fusion on
them, and holds each against a world of one, that is the same work done by
one process with no group:

  * one data-parallel step (exact and rectified) on a global batch of ``n``
    samples, one a rank, against one process's step on the whole batch:
    the plan each rank made of its sample, the union they agreed on, the
    loss, the metrics and the weights, equal across the ranks;
  * the view-sharded forward through ``InferenceRunner(mesh=)`` (exact,
    rectified, and mixed on a scene the full planner rejects, with the mean
    aggregation; rectified with ``("mean", "max", "std")``) against the
    runner without a mesh: each cascade stage's volume after the
    ``all_reduce`` (with per-view volumes, rank 0's views), the
    disparities, and the kernel launches, whose sum over the ranks is the
    unsharded forward's (each view's warps and volume are built on one rank
    only); with max and std also the per-iteration exchange alone,
    ``ViewShardedVolume.aggregate`` of each rank's share of seeded features
    against the model's aggregation of all of them, on every rank;
  * ``fusion(mesh=)`` of a scene's depth maps against one process's cloud.

:func:`dryrun_spatial` does the same for the row and grid meshes
(``parallel/spatial.py``): the row-sharded forward over ``n`` row ranks
(exact, banded rectified, and exact with the mean, max and std) and the
grid-sharded one over ``n/2`` row x 2 view ranks (exact and rectified),
each through ``InferenceRunner(mesh=)`` against the runner without a mesh:
each cascade stage's volume of the owned rows, rebuilt from the unsharded
forward's origins, the disparities, and the kernel launches (every row rank
builds all of its views, so each rank's count is the unsharded forward's
under a ``(row,)`` mesh, and the view ranks of a row sum to it on a grid).

The ranks run the port alone (the children import nothing else), which is
what the CPU tests and ``chip_smoke.py`` both call: on the CPU at
:data:`SMALL`, on one card as two ranks sharing it (NCCL refuses two ranks
on one device; gloo's collectives take CUDA tensors, and the runners step
eagerly under gloo). Each rank uses a ``FileStore`` in a temporary
directory, so no TCP port is shared between concurrent runs, and
``torch.multiprocessing``'s spawn start (a fork is unsafe once CUDA is
initialised).
"""

from __future__ import annotations

import copy
import hashlib
import os
import queue
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

# the CPU tests' sizes: tests/test_parallel.py's scene and cascade for the
# forward, the multi-host training test's for the step
SMALL = {
    "forward": dict(scene="lateral", H=32, W=48, N=9,
                    model=dict(cascade=((8, 64, 2), (-1, 320, 2)),
                               hyp_chunk=4, dtype="float32"),
                    rect_lambda_max=0.1, damp=1e-3,
                    volume_tol=dict(rtol=1e-5, atol=1e-6),
                    disp_tol=dict(rtol=1e-3, atol=1e-6)),
    "train": dict(scene="lateral", B=2, N=3, H=32, W=64,
                  model=dict(cascade=((4, 64, 1),), hyp_chunk=4,
                             dtype="float32"),
                  batch_file=None, tol=dict(rtol=1e-3, atol=2e-5),
                  grad_rtol=1e-4, loss_tol=dict(rtol=1e-5, atol=1e-7)),
    "fusion": dict(n_views=8, H=24, W=32),
    # 4 row ranks of GHOST_RECT feature rows each: H = 4 x 4 x 16
    "spatial": dict(scene="lateral", H=256, W=48, N=5,
                    model=dict(cascade=((8, 64, 2), (-1, 320, 2)),
                               hyp_chunk=4, dtype="float32",
                               lookup_impl="pallas"),
                    rect_lambda_max=0.1, damp=1e-3, n_view=2,
                    # the features' norm takes its moments in another
                    # order, and the bands' translated homographies round
                    # the warps' positions otherwise: up to 3e-6 of the
                    # largest |value|
                    volume_tol=dict(rtol=1e-5, atol=1e-6),
                    # of the largest |disparity| (~3e-4 to 6e-4), from
                    # each route's readings: exact 1.0e-6 to 1.8e-6,
                    # rectified 1.7e-6 to 2.0e-6
                    disp_tol=dict(exact=dict(rtol=2e-5, atol=1e-9),
                                  rectified=dict(rtol=5e-5, atol=1e-9))),
}


# ---------------------------------------------------------------------------
# Scenes (numpy, deterministic in their seed)
# ---------------------------------------------------------------------------


def lateral_scene(N, H, W, seed=0, forward=None):
    """Neighbours along x with a small y zig-zag (the JAX package's
    ``tests/test_parallel.py`` scene). ``forward``: a neighbour moved onto
    the reference's optical axis instead, which the full planner rejects
    and the partial one leaves out (the mixed construction)."""
    rng = np.random.RandomState(seed)
    images = (rng.rand(N, H, W, 3) * 255).astype(np.float32)
    f = 60.0 * W / 48
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)
    poses = np.tile(np.eye(4, dtype=np.float32), (N, 1, 1))
    for n in range(1, N):
        poses[n, 0, 3] = 0.3 * n
        poses[n, 1, 3] = 0.1 * ((-1) ** n)
    if forward is not None:
        poses[forward] = np.eye(4, dtype=np.float32)
        poses[forward, 2, 3] = -1.0
    return images, poses, np.tile(K, (N, 1, 1))


def ring_scene(N, H, W, seed=0, forward=None):
    """A DTU-like rig: cameras on a sphere of ~600 mm looking at the origin
    (``chip_smoke.dtu_scene``). ``forward``: neighbours moved 50 and 80 mm
    along the reference's optical axis (the mixed construction)."""
    rng = np.random.RandomState(seed)
    images = (rng.rand(N, H, W, 3) * 255).astype(np.float32)
    poses = np.zeros((N, 4, 4), np.float32)
    for i in range(N):
        ang = 0.06 * ((i + 1) // 2) * (1 if i % 2 else -1)
        elev = 0.04 * (i % 3 - 1)
        eye = 600.0 * np.array(
            [np.sin(ang), np.sin(elev), -np.cos(ang) * np.cos(elev)])
        fwd = -eye / np.linalg.norm(eye)
        right = np.cross(fwd, [0.0, 1.0, 0.0])
        right /= np.linalg.norm(right)
        down = np.cross(fwd, right)
        R = np.stack([right, down, fwd]).astype(np.float32)
        poses[i, :3, :3] = R
        poses[i, :3, 3] = -R @ eye.astype(np.float32)
        poses[i, 3, 3] = 1.0
    for i, d in zip(forward or (), (50.0, 80.0)):
        poses[i] = poses[0]
        poses[i, 2, 3] -= d
    f = 2892.0 * W / 1600
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)
    return images, poses, np.tile(K, (N, 1, 1))


MIXED_FORWARD = {"lateral": 2, "ring": (3, 7)}


def forward_scene(spec, mixed: bool = False):
    make = {"lateral": lateral_scene, "ring": ring_scene}[spec["scene"]]
    return make(spec["N"], spec["H"], spec["W"],
                forward=MIXED_FORWARD[spec["scene"]] if mixed else None)


def train_batch(spec) -> Dict[str, np.ndarray]:
    """A training batch: ``spec["batch_file"]`` (an ``.npz`` of a loader
    batch) or B lateral samples whose baselines differ by sample, so the
    samples' plans differ and their union matters (the JAX package's
    multi-host training test's data)."""
    if spec.get("batch_file"):
        with np.load(spec["batch_file"]) as f:
            return {k: f[k] for k in f.files}
    B, N, H, W = spec["B"], spec["N"], spec["H"], spec["W"]
    K = np.array([[40.0, 0, W / 2], [0, 40.0, H / 2], [0, 0, 1]], np.float32)
    out = {k: [] for k in ("images", "depths", "poses", "intrinsics")}
    for i in range(B):
        rng = np.random.RandomState(100 + i)
        poses = np.tile(np.eye(4, dtype=np.float32), (N, 1, 1))
        for k, bx in enumerate([0.0, 1.2 + 0.05 * i, -1.6 - 0.03 * i][:N]):
            poses[k, 0, 3] = -bx
        out["images"].append((rng.rand(N, H, W, 3) * 255).astype(np.float32))
        out["depths"].append((rng.rand(N, H, W) * 20 + 20).astype(np.float32))
        out["poses"].append(poses)
        out["intrinsics"].append(np.tile(K, (N, 1, 1)))
    return {k: np.stack(v) for k, v in out.items()}


class FusionLoader:
    """A scene written by :func:`write_fusion_scene`, as fusion's loader:
    each view with the next two as its sources."""

    def __init__(self, root):
        with np.load(os.path.join(root, "scene.npz")) as f:
            self.data = {k: f[k] for k in f.files}
        self.n = len(self.data["images"])

    def __len__(self):
        return self.n

    def __iter__(self):
        for ref in range(self.n):
            order = [ref, (ref + 1) % self.n, (ref + 2) % self.n]
            yield (self.data["images"][order], self.data["Es"][order],
                   self.data["Ks"][order], [str(j) for j in order], 1.0)


def sphere_depths(poses, K, H, W, radius=200.0) -> np.ndarray:
    """True depth maps of a sphere of ``radius`` about the world origin
    seen by world-to-camera ``poses`` (N, 4, 4) through ``K`` (3, 3); zero
    where a ray misses it."""
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float64)
    rays = np.stack([xs, ys, np.ones_like(xs)], -1) @ np.linalg.inv(
        np.asarray(K, np.float64)).T                      # (H, W, 3), z = 1
    out = np.zeros((len(poses), H, W), np.float32)
    for i, P in enumerate(np.asarray(poses, np.float64)):
        R, t = P[:3, :3], P[:3, 3]
        c = -R.T @ t
        d = rays @ R                                     # R^T ray, per pixel
        a = (d * d).sum(-1)
        b = 2.0 * (d @ c)
        disc = b * b - 4.0 * a * (c @ c - radius ** 2)
        s = (-b - np.sqrt(np.maximum(disc, 0.0))) / (2.0 * a)
        out[i] = np.where((disc > 0) & (s > 0), s, 0.0)
    return out


def write_fusion_scene(root, n_views, H, W, kind="random",
                       folders=("sharded", "single")):
    """A fusion scene, its maps written under each of ``folders``:
    "random", random depths in [9, 11] seen by cameras along x (the JAX
    package's multi-host fusion test's scene), or "sphere", the true depths
    of a sphere seen by :func:`ring_scene`'s cameras."""
    from cermvs_torch.io.pfm import write_pfm

    rng = np.random.RandomState(3)
    if kind == "sphere":
        images, Es, Ks = ring_scene(n_views, H, W)
        depths = sphere_depths(Es, Ks[0], H, W)
    else:
        depths = (rng.rand(n_views, H, W) * 2 + 9).astype(np.float32)
        K = np.array([[40.0, 0, W / 2], [0, 40.0, H / 2], [0, 0, 1]],
                     np.float32)
        Ks = np.tile(K, (n_views, 1, 1))
        Es = np.tile(np.eye(4, dtype=np.float32), (n_views, 1, 1))
        Es[:, 0, 3] = 0.05 * np.arange(n_views)
        images = (rng.rand(n_views, H, W, 3) * 255).astype(np.float32)
    os.makedirs(root, exist_ok=True)
    np.savez(os.path.join(root, "scene.npz"), images=images, Ks=Ks, Es=Es)
    for folder in folders:
        os.makedirs(os.path.join(root, folder, "depths"), exist_ok=True)
        for i in range(n_views):
            write_pfm(os.path.join(root, folder, "depths", f"{i}.pfm"),
                      depths[i])


# ---------------------------------------------------------------------------
# A world of ranks
# ---------------------------------------------------------------------------


def _rank_main(r, n, store_path, device, threads, tasks, results):
    from cermvs_torch.parallel.mesh import initialize_distributed

    torch.set_num_threads(threads)
    store = dist.FileStore(store_path, n)
    initialize_distributed(device, backend="gloo", store=store, rank=r,
                           world_size=n)
    try:
        while True:
            task = tasks.get()
            if task is None:
                return
            fn, args, kwargs = task
            try:
                results.put((r, True, fn(*args, **kwargs)))
            except BaseException:
                results.put((r, False, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


class World:
    """``n`` spawned ranks of one gloo process group on ``device``, which
    take calls until :meth:`close`. :meth:`run` calls a module-level
    function on every rank and returns the results in rank order; a rank's
    exception is raised here with its traceback, and a rank that does not
    answer within ``timeout`` seconds ends the world."""

    def __init__(self, n: int, device: str = "cpu", threads: int = 1,
                 timeout: float = 600.0):
        import torch.multiprocessing as mp

        ctx = mp.get_context("spawn")
        self.n = n
        self.timeout = timeout
        self.dir = tempfile.mkdtemp(prefix="cermvs_world_")
        self._tasks = [ctx.Queue() for _ in range(n)]
        self._results = ctx.Queue()
        store = os.path.join(self.dir, "store")
        self._procs = [ctx.Process(
            target=_rank_main, daemon=True,
            args=(r, n, store, device, threads, self._tasks[r],
                  self._results)) for r in range(n)]
        for p in self._procs:
            p.start()

    def run(self, fn: Callable, *args, **kwargs) -> List[Any]:
        for q in self._tasks:
            q.put((fn, args, kwargs))
        out: List[Any] = [None] * self.n
        errors = []
        deadline = time.monotonic() + self.timeout
        for _ in range(self.n):
            while True:
                try:
                    r, ok, value = self._results.get(timeout=1.0)
                    break
                except queue.Empty:
                    dead = [p.exitcode for p in self._procs
                            if not p.is_alive()]
                    if dead or time.monotonic() > deadline:
                        self.close(force=True)
                        raise RuntimeError(
                            f"{fn.__name__}: a rank ended (exit codes "
                            f"{dead})" if dead else
                            f"{fn.__name__}: a rank did not answer within "
                            f"{self.timeout} s")
            if not ok:
                errors.append(f"rank {r}:\n{value}")
                if len(errors) == 1:
                    # the others may wait in a collective for this one
                    self.close(force=True)
                    raise RuntimeError(f"{fn.__name__} failed on "
                                       + errors[0])
            out[r] = value
        return out

    def close(self, force: bool = False) -> None:
        if force:
            for p in self._procs:
                if p.is_alive():
                    p.terminate()
        else:
            for q in self._tasks:
                q.put(None)
        for p in self._procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(self.dir, ignore_errors=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close(force=exc[0] is not None)


# ---------------------------------------------------------------------------
# Rank-side work
# ---------------------------------------------------------------------------


def _model(spec, test_mode: bool, device, seed: int = 0):
    from cermvs_torch.models.raft import RAFT

    model = RAFT(test_mode=test_mode, device=device,
                 generator=torch.Generator().manual_seed(seed),
                 **spec["model"])
    if spec.get("damp"):
        with torch.no_grad():
            for i in range(len(model.cascade)):
                getattr(model.update_block, f"delta{i}")[2].weight.mul_(
                    spec["damp"])
    return model


class Recording:
    """A construction that keeps its prepared context, every stage's origin
    and arguments and every stage volume it returns (the view-sharded one's
    after the ``all_reduce``); other attributes are the wrapped
    construction's. :meth:`rebuild` builds the stages again from other
    origins: two forwards' later stages start from their own estimates, so
    their volumes compare only when built from the same origins."""

    def __init__(self, inner):
        self.inner = inner
        self.ctx = None
        self.calls: List[tuple] = []
        self.volumes: List[torch.Tensor] = []

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def prepare(self, *args, **kwargs):
        self.ctx = self.inner.prepare(*args, **kwargs)
        return self.ctx

    def build(self, ctx, origin, *args, **kwargs):
        self.calls.append((origin.detach().clone(), args, kwargs))
        vol = self.inner.build(ctx, origin, *args, **kwargs)
        self.volumes.append(vol.detach().clone())
        return vol

    def rebuild(self, origins) -> List[torch.Tensor]:
        with torch.no_grad():
            return [self.inner.build(self.ctx, o, *args, **kwargs)
                    for o, (_, args, kwargs) in zip(origins, self.calls)]


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _forward(runner, images, poses, intr):
    """One routed forward of ``runner`` with its stage volumes recorded,
    then the same forward again, timed: (route, disparities, the
    Recording, launches of the first, seconds of the second)."""
    from cermvs_torch.ops import cudalib
    from cermvs_torch.ops.corr import ExactVolume

    r = runner.route(images[None], poses[None], intr[None], [1.0])
    rec = Recording(r.volume_fn or ExactVolume())
    _sync(runner.device)
    cudalib.reset_launches()
    with torch.no_grad():
        disp = runner.model(*r[:4], volume_fn=rec)
    _sync(runner.device)
    launches = dict(cudalib.launches)
    t0 = time.perf_counter()
    with torch.no_grad():
        runner.model(*r[:4], volume_fn=r.volume_fn)
    _sync(runner.device)
    return (r.path, disp.float().cpu().numpy(), rec, launches,
            time.perf_counter() - t0)


def _require(ok: bool, msg: str) -> None:
    """A check of the dry run: unlike ``assert``, kept under ``python -O``."""
    if not ok:
        raise AssertionError(msg)


def _err(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float64)
                        - np.asarray(b, np.float64)).max())


def forward_task(spec, case: str, device: str,
                 aggregation=("mean",)) -> dict:
    """The view-sharded forward of ``case`` ("exact", "rectified" or
    "mixed") with the model's ``aggregation`` on this rank, and on rank 0
    also the unsharded forward and the errors between them: the
    disparities, and each stage's volume built by both from the unsharded
    forward's origins (per-view volumes: rank 0's views of the unsharded
    ones). With per-view volumes every rank also holds the aggregation's
    exchange against the model's own (:func:`_aggregate_err`), and the
    model takes ``spec["per_view_model"]``'s bindings, if any."""
    from cermvs_torch.parallel.mesh import make_mesh, rank, world, world_size
    from cermvs_torch.pipeline.inference import InferenceRunner

    device = torch.device(device)
    bindings = dict(spec["model"], aggregation=tuple(aggregation))
    if bindings["aggregation"] != ("mean",):
        bindings.update(spec.get("per_view_model", {}))
    model = _model(dict(spec, model=bindings), True, device)
    images, poses, intr = forward_scene(spec, mixed=case == "mixed")
    construction = "auto" if case == "mixed" else case
    kw = dict(construction=construction, device=device,
              rect_lambda_max=spec["rect_lambda_max"])
    mesh = make_mesh(1, world_size(world()))
    sharded = InferenceRunner(model=model, mesh=mesh, **kw)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    path, disp, rec, launches, secs = _forward(sharded, images, poses, intr)
    out = {"path": path, "disp": disp, "launches": launches, "s": secs,
           "views": list(rec.inner.views), "graphs": sharded.graphs,
           "eager_reason": sharded.eager_reason,
           "peak_bytes": (torch.cuda.max_memory_allocated(device)
                          if device.type == "cuda" else 0)}
    # one stage-0 volume's all_reduce over the view group, alone
    vol = rec.volumes[0].clone()
    times = []
    for _ in range(3):
        _sync(device)
        t0 = time.perf_counter()
        dist.all_reduce(vol, group=rec.inner.group)
        _sync(device)
        times.append(time.perf_counter() - t0)
    out["all_reduce_s"] = times
    if not model.mean_volume:
        out["aggregate_err"] = _aggregate_err(model, rec.inner, spec, device)
    origins = [None]
    if rank(world()) == 0:
        plain = InferenceRunner(model=model, **kw)
        p_path, p_disp, p_rec, p_launches, p_secs = _forward(
            plain, images, poses, intr)
        origins = [[c[0].cpu() for c in p_rec.calls]]
        out.update(plain_path=p_path, plain_launches=p_launches,
                   plain_s=p_secs, volume_bytes=[
                       v.numel() * v.element_size() for v in p_rec.volumes],
                   plain_disp=p_disp, disp_err=_err(disp, p_disp),
                   disp_max=float(np.abs(p_disp).max()))
    dist.broadcast_object_list(origins, src=0)
    vols = rec.rebuild([o.to(device) for o in origins[0]])
    if rank(world()) == 0:
        p_vols = [v.cpu().numpy() for v in p_rec.volumes]
        if not model.mean_volume:  # (B, V, ...): this rank's views
            p_vols = [v[:, rec.inner.views] for v in p_vols]
        _require(len(vols) == len(p_vols), f"{case}: {len(vols)} stages "
                 f"rebuilt against {len(p_vols)}")
        out.update(volume_err=[_err(a.cpu().numpy(), b)
                               for a, b in zip(vols, p_vols)],
                   volume_max=[float(np.abs(b).max()) for b in p_vols])
    return out


def _aggregate_err(model, volume, spec, device) -> tuple:
    """``volume.aggregate`` (the SUM and MAX exchange of the view ranks) of
    this rank's share of seeded looked-up features (1, V, H/4, W/4, 33),
    the same on every rank, against the model's aggregation of all V:
    (max |diff|, max |reference|)."""
    g = torch.Generator().manual_seed(7)
    V = volume.n_views
    feats = torch.randn((1, V, spec["H"] // 4, spec["W"] // 4, 33),
                        generator=g).to(device)
    with torch.no_grad():
        ref = model.update_block.aggregate(feats)
        got = volume.aggregate(feats[:, volume.views].contiguous(),
                               model.aggregation)
    return (float((got - ref).abs().max()), float(ref.abs().max()))


def _flat_weights(model) -> np.ndarray:
    return torch.cat([p.detach().float().reshape(-1).cpu()
                      for p in model.parameters()]).numpy()


def _flat_grads(model) -> np.ndarray:
    return torch.cat([p.grad.detach().float().reshape(-1).cpu()
                      for p in model.parameters()
                      if p.grad is not None]).numpy()


def train_task(spec, construction: str, device: str) -> dict:
    """One data-parallel step of this rank's share of the global batch (one
    sample a rank for a batch of ``n``), through a ``StepRunner`` over the
    default group; on rank 0 also one process's step of the whole batch
    from the same weights, and the errors between them: the loss, the
    (clipped) gradients' relative error and the new weights. ``spec``'s
    ``tf32`` False turns TF32 off for the step."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    if spec.get("tf32") is False:  # fp32 products in fp32, on both sides
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    try:
        return _train_step_task(spec, construction, torch.device(device))
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


def _train_step_task(spec, construction, device) -> dict:
    from cermvs_torch.ops.rectify import PlanCache, pack_plan
    from cermvs_torch.parallel.mesh import rank, world, world_size
    from cermvs_torch.training.step import (StepRunner, _volume_of,
                                            batch_to_device, init_state,
                                            train_step)
    from cermvs_torch.training.train import exchange_plan, plan_batch

    batch = train_batch(spec)
    r, n = rank(world()), world_size(world())
    local = {k: v[r::n] for k, v in batch.items()}
    n_views = batch["poses"].shape[1] - 1
    model = _model(spec, False, device)
    ref_model = copy.deepcopy(model) if r == 0 else None
    state = init_state(model, num_steps=100)
    runner = StepRunner(state, group=dist.group.WORLD)
    key = local_plan = union = None
    if construction == "rectified":
        local_plan = plan_batch(local, model.stride_factor)
        union = exchange_plan(local_plan, n_views, dist.group.WORLD)
        key = PlanCache().key_for(union) if union.ok else None
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    _sync(device)
    metrics = runner(batch_to_device(local, device), 0.5, key)
    _sync(device)
    weights, grads = _flat_weights(model), _flat_grads(model)
    out = {"metrics": metrics, "key_ok": key is not None,
           "peak_bytes": (torch.cuda.max_memory_allocated(device)
                          if device.type == "cuda" else 0),
           "weights_sha": hashlib.sha256(weights.tobytes()).hexdigest(),
           "graphs": runner.graphs, "eager_reason": runner.eager_reason}
    if local_plan is not None:
        out.update(plan_local=pack_plan(local_plan, n_views),
                   plan_union=pack_plan(union, n_views))
    if r == 0:
        del state, runner
        ref_state = init_state(ref_model, num_steps=100)
        ref_key = None
        if construction == "rectified":
            plan = plan_batch(batch, ref_model.stride_factor)
            ref_key = PlanCache().key_for(plan) if plan.ok else None
        ref_metrics = train_step(ref_state, batch_to_device(batch, device),
                                 0.5, volume_fn=_volume_of(ref_key))
        ref_weights, ref_grads = (_flat_weights(ref_model),
                                  _flat_grads(ref_model))
        tol = spec.get("tol")
        bad = (0 if tol is None else int((~np.isclose(
            weights, ref_weights, rtol=tol["rtol"], atol=tol["atol"])).sum()))
        out.update(ref_metrics=ref_metrics, same_key=ref_key == key,
                   weights_err=_err(weights, ref_weights),
                   weights_outside_tol=bad, n_weights=int(weights.size),
                   grad_rel_err=float(np.linalg.norm(
                       grads.astype(np.float64) - ref_grads)
                       / np.linalg.norm(ref_grads.astype(np.float64))),
                   loss_err=abs(metrics["loss"] - ref_metrics["loss"]),
                   lr=float(ref_state.schedule(0)))
    return out


def fusion_task(root: str, device: str) -> dict:
    """``fusion(mesh=)`` of the scene under ``root`` on this rank; on rank
    0 also one process's fusion of the same maps and their clouds
    compared as sorted point sets."""
    from cermvs_torch.io.ply import read_ply
    from cermvs_torch.parallel.mesh import make_mesh, rank, world, world_size
    from cermvs_torch.pipeline.fusion import fusion

    loader = FusionLoader(root)
    kw = dict(suffix="", glb=0.25, rescale=1, tot_iter=4, view_batch=0,
              device=device)
    mesh = make_mesh(world_size(world()), 1)
    out_path = fusion(loader, os.path.join(root, "sharded"), mesh=mesh, **kw)
    out = {"points": len(read_ply(out_path)[0])}
    if rank(world()) == 0:
        single = fusion(loader, os.path.join(root, "single"),
                        multihost=False, **kw)
        xyz_m, rgb_m = read_ply(out_path)
        xyz_s, rgb_s = read_ply(single)
        om, os_ = np.lexsort(xyz_m.T), np.lexsort(xyz_s.T)
        out.update(single_points=len(xyz_s),
                   equal=(xyz_m.shape == xyz_s.shape
                          and np.array_equal(xyz_m[om], xyz_s[os_])
                          and np.array_equal(rgb_m[om], rgb_s[os_])))
    return out


def spatial_task(spec, kind: str, case: str, device: str,
                 aggregation=("mean",)) -> dict:
    """The ``kind`` ("row" or "grid") sharded forward of ``case`` ("exact"
    or "rectified") on this rank through ``InferenceRunner(mesh=)``, and on
    rank 0 also the runner without a mesh. Every rank rebuilds its stage
    volumes from the unsharded forward's origins (its extended rows of
    them), and the owned rows are gathered: rank 0 holds the errors of the
    volumes and the disparities. ``spec``'s ``tf32`` False turns TF32 off
    for the task (cuDNN's fp32 convolutions default to it)."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    if spec.get("tf32") is False:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    try:
        return _spatial_task(spec, kind, case, torch.device(device),
                             aggregation)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


class _TimedCollectives:
    """An observer of ``spatial.observe_collectives``: each collective (the
    halo exchanges, the gathers, the norms' moments and a grid's view sum)
    run between two device syncs, its count, seconds and bytes kept."""

    def __init__(self, device):
        self.device = device
        self.n, self.s, self.bytes = 0, 0.0, 0

    def __call__(self, nbytes: int, run) -> None:
        _sync(self.device)
        t0 = time.perf_counter()
        run()
        _sync(self.device)
        self.s += time.perf_counter() - t0
        self.n += 1
        self.bytes += nbytes


def _timed_collectives(fwd, runner, args, device) -> dict:
    """One more forward of ``fwd`` with its collectives timed alone
    (:class:`_TimedCollectives`): their count, bytes and seconds, and the
    forward's seconds."""
    from cermvs_torch.parallel.spatial import observe_collectives

    timed = _TimedCollectives(device)
    with observe_collectives(timed):
        _sync(device)
        t0 = time.perf_counter()
        fwd(runner.model, *args)
        _sync(device)
        total = time.perf_counter() - t0
    return {"n": timed.n, "bytes": timed.bytes, "s": timed.s,
            "forward_s": total}


def _stage_volumes(fwd, model, args, origins) -> List[torch.Tensor]:
    """The stage volumes of ``fwd`` on ``args`` (its extended rows), each
    built from its own origin of ``origins`` on the context that
    ``fwd.context`` returns: the construction alone, apart from the
    origins the forward computes."""
    with torch.no_grad():
        ctx = fwd.context(model, *args)
        out = []
        for stage, o in enumerate(origins):
            n_hyp, n_div, _ = model.cascade[stage]
            out.append(fwd.volume(ctx, o, model.auto_hyps(n_hyp),
                                  0.0025 / n_div, zero_slab=(stage == 0)))
        return out


def _spatial_task(spec, kind, case, device, aggregation) -> dict:
    from cermvs_torch.ops import cudalib
    from cermvs_torch.parallel.mesh import make_row_mesh, rank, world
    from cermvs_torch.parallel.spatial import gather_rows
    from cermvs_torch.pipeline.inference import InferenceRunner

    model = _model(dict(spec, model=dict(spec["model"], aggregation=tuple(
        aggregation))), True, device)
    images, poses, intr = forward_scene(spec)
    kw = dict(construction=case, device=device,
              rect_lambda_max=spec["rect_lambda_max"])
    mesh = make_row_mesh(n_view=spec["n_view"] if kind == "grid" else 1)
    runner = InferenceRunner(model=model, mesh=mesh, **kw)
    r = runner.route(images[None], poses[None], intr[None], [1.0])
    fwd = r.volume_fn
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    _sync(device)
    cudalib.reset_launches()
    disp = fwd(runner.model, *r.args)
    _sync(device)
    launches = dict(cudalib.launches)
    t0 = time.perf_counter()
    fwd(runner.model, *r.args)
    _sync(device)
    secs = time.perf_counter() - t0
    collectives = _timed_collectives(fwd, runner, r.args, device)
    out = {"collectives": collectives, "path": r.path, "disp": disp.float().cpu().numpy(),
           "launches": launches, "s": secs, "views": list(fwd.views),
           "graphs": runner.graphs, "eager_reason": runner.eager_reason,
           "band_h": fwd.band_h, "shape_multiple": runner.shape_multiple,
           "peak_bytes": (torch.cuda.max_memory_allocated(device)
                          if device.type == "cuda" else 0)}
    origins = [None]
    if rank(world()) == 0:
        plain = InferenceRunner(model=model, **kw)
        p_path, p_disp, p_rec, p_launches, p_secs = _forward(
            plain, images, poses, intr)
        origins = [[c[0].cpu() for c in p_rec.calls]]
        p_vols = [v.cpu().numpy() for v in p_rec.volumes]
        out.update(plain_path=p_path, plain_launches=p_launches,
                   plain_s=p_secs, disp_err=_err(out["disp"], p_disp),
                   disp_max=float(np.abs(p_disp).max()))
    dist.broadcast_object_list(origins, src=0)
    g, rows = fwd.ghost, images.shape[1] // 4 // fwd.n_rows
    a = rank(fwd.row_group) * rows
    # the construction alone, from the unsharded forward's origins with the
    # rows beyond the image edge-extended, as the unsharded origin warp
    # clamps its positions to the image. The forward's own ghost rows there
    # are zeros, as in the JAX package (the banded origin warp of the first
    # and last ranks reads them for rect pixels within ~2 rows of the
    # edge), so this check does not show the first and last ranks' own
    # stage volumes: the disparities do
    ext = [torch.nn.functional.pad(o, (0, 0, g, g), mode="replicate")[
        :, :, a:a + rows + 2 * g].to(device) for o in origins[0]]
    vols = [gather_rows(v[:, :, g:g + rows].contiguous(), fwd.row_group, 2)
            for v in _stage_volumes(fwd, runner.model, r.args, ext)]
    if rank(world()) == 0:
        _require(len(vols) == len(p_vols), f"{kind} {case}: {len(vols)} "
                 f"stages rebuilt against {len(p_vols)}")
        out.update(volume_err=[_err(a.cpu().numpy(), b)
                               for a, b in zip(vols, p_vols)],
                   volume_max=[float(np.abs(b).max()) for b in p_vols])
    return out


# ---------------------------------------------------------------------------
# The dry run
# ---------------------------------------------------------------------------


FORWARD_CASES = (("exact", ("mean",)), ("rectified", ("mean",)),
                 ("mixed", ("mean",)), ("rectified", ("mean", "max", "std")))


def forward_label(case: str, aggregation) -> str:
    """The report's name of a forward case: "rectified", or
    "rectified_mean_max_std" for another aggregation than the mean."""
    return (case if tuple(aggregation) == ("mean",)
            else "_".join((case,) + tuple(aggregation)))


def _close(err: float, scale: float, tol: dict) -> bool:
    return err <= tol["atol"] + tol["rtol"] * scale


def dryrun_multiprocess(n: int = 2, device: str = "cuda",
                        spec: Optional[dict] = None,
                        world: Optional[World] = None) -> dict:
    """Run the checks of the module docstring on ``n`` ranks (a ``world``
    of them, or one started here and closed at the end) on ``device``
    ("cuda": every rank on the current card; "cpu"); ``spec``: the sizes
    and tolerances (default :data:`SMALL`). Returns a report of every
    check and raises ``AssertionError`` naming the first that failed."""
    spec = spec or SMALL
    own = world is None
    world = world or World(n, device)
    try:
        report: Dict[str, Any] = {"n": n, "device": device}
        for construction in ("exact", "rectified"):
            res = world.run(train_task, spec["train"], construction, device)
            r0 = res[0]
            report[f"train_{construction}"] = {
                k: r0[k] for k in ("metrics", "ref_metrics", "weights_err",
                                   "weights_outside_tol", "n_weights",
                                   "grad_rel_err", "loss_err", "lr",
                                   "graphs", "eager_reason")}
            report[f"train_{construction}"]["peak_bytes"] = [
                x["peak_bytes"] for x in res]
            _require(len({x["weights_sha"] for x in res}) == 1,
                     f"{construction} step: the ranks' weights differ")
            _require(r0["weights_outside_tol"] == 0,
                     f"{construction} step: {r0['weights_outside_tol']} "
                     f"weights outside {spec['train']['tol']} (max |diff| "
                     f"{r0['weights_err']:.3e})")
            _require(r0["grad_rel_err"] <= spec["train"]["grad_rtol"],
                     f"{construction} step: gradients' relative error "
                     f"{r0['grad_rel_err']:.3e}")
            lt = spec["train"]["loss_tol"]
            _require(_close(r0["loss_err"], abs(r0["ref_metrics"]["loss"]),
                            lt), f"{construction} step: loss "
                     f"{r0['loss_err']}")
            if construction == "rectified":
                _require(all(x["key_ok"] for x in res) and r0["same_key"],
                         "rectified step: the ranks' plan keys differ")
                unions = [x["plan_union"] for x in res]
                _require(all(np.array_equal(u, unions[0]) for u in unions),
                         "rectified step: the ranks' plan unions differ")
                report["train_rectified"]["plans_differ"] = any(
                    not np.array_equal(x["plan_local"], res[0]["plan_local"])
                    for x in res)
        fs = spec["forward"]
        for case, aggregation in FORWARD_CASES:
            label = forward_label(case, aggregation)
            res = world.run(forward_task, fs, case, device, aggregation)
            r0 = res[0]
            launches = {}
            for x in res:
                for k, v in x["launches"].items():
                    launches[k] = launches.get(k, 0) + v
            plain = {k: v for k, v in r0["plain_launches"].items() if v}
            report[f"forward_{label}"] = {
                "path": r0["path"], "views": [x["views"] for x in res],
                "volume_err": r0["volume_err"],
                "volume_max": r0["volume_max"], "disp_err": r0["disp_err"],
                "disp_max": r0["disp_max"], "graphs": r0["graphs"],
                "s": [x["s"] for x in res], "plain_s": r0["plain_s"],
                "all_reduce_s": [x["all_reduce_s"] for x in res],
                "volume_bytes": r0["volume_bytes"],
                "eager_reason": r0["eager_reason"],
                "launches_by_rank": [x["launches"] for x in res],
                "plain_launches": plain,
                "peak_bytes": [x["peak_bytes"] for x in res],
                "aggregate_err": [x.get("aggregate_err") for x in res]}
            _require(r0["path"] == r0["plain_path"] == case,
                     f"{label}: routes {r0['path']}, {r0['plain_path']}")
            for e, m in zip(r0["volume_err"], r0["volume_max"]):
                _require(_close(e, m, fs["volume_tol"]),
                         f"{label}: stage volume |diff| {e:.3e} (max "
                         f"{m:.3e})")
            for x in res:
                if "aggregate_err" in x:
                    e, m = x["aggregate_err"]
                    _require(_close(e, m, fs["volume_tol"]),
                             f"{label}: aggregate |diff| {e:.3e} (max "
                             f"{m:.3e})")
            _require((aggregation == ("mean",)) == all(
                "aggregate_err" not in x for x in res),
                f"{label}: the aggregation's exchange was not checked")
            _require(_close(r0["disp_err"], r0["disp_max"], fs["disp_tol"]),
                     f"{label}: disparity |diff| {r0['disp_err']:.3e} (max "
                     f"{r0['disp_max']:.3e})")
            for x in res[1:]:
                _require(np.array_equal(x["disp"], r0["disp"]),
                         f"{label}: the ranks' disparities differ")
            _require({k: v for k, v in launches.items() if v} == plain,
                     f"{label}: launches {launches} against unsharded "
                     f"{plain}")
        root = os.path.join(world.dir, "fusion")
        if os.path.isdir(root):
            shutil.rmtree(root)
        write_fusion_scene(root, **spec["fusion"])
        res = world.run(fusion_task, root, device)
        report["fusion"] = res[0]
        _require(res[0]["equal"] and res[0]["points"] > 0,
                 f"sharded fusion differs from one process's: {res[0]}")
        return report
    finally:
        if own:
            world.close()


# the kernels a view's warps and volume launch: a grid's view ranks share
# them, where each runs every lookup of the iterations
PER_VIEW_KERNELS = ("epiband_fwd", "hat_rows_fwd", "quad_warp_fwd")

SPATIAL_CASES = (("row", "exact", ("mean",)), ("row", "rectified", ("mean",)),
                 ("row", "exact", ("mean", "max", "std")),
                 ("grid", "exact", ("mean",)), ("grid", "rectified",
                                                ("mean",)))


def spatial_label(kind: str, case: str, aggregation) -> str:
    """The report's name of a row or grid case: "row_rectified", or
    "row_exact_mean_max_std" for another aggregation than the mean."""
    return "_".join((kind, case) + (() if tuple(aggregation) == ("mean",)
                                    else tuple(aggregation)))


def dryrun_spatial(n: int = 4, device: str = "cuda",
                   spec: Optional[dict] = None,
                   world: Optional[World] = None,
                   cases=SPATIAL_CASES) -> dict:
    """Run the row and grid checks of the module docstring on ``n`` ranks
    (a ``world`` of them, or one started here and closed at the end) on
    ``device`` for each of ``cases`` (kind, construction, aggregation);
    ``spec``: the sizes and tolerances (default ``SMALL["spatial"]``; the
    disparities' per construction). Returns a report of every case and
    raises ``AssertionError`` naming the first check that failed."""
    spec = spec or SMALL["spatial"]
    own = world is None
    world = world or World(n, device)
    try:
        report: Dict[str, Any] = {"n": n, "device": device}
        for kind, case, aggregation in cases:
            label = spatial_label(kind, case, aggregation)
            res = world.run(spatial_task, spec, kind, case, device,
                            aggregation)
            r0 = res[0]
            plain = {k: v for k, v in r0["plain_launches"].items() if v}
            report[label] = {
                "path": r0["path"], "views": [x["views"] for x in res],
                "band_h": r0["band_h"],
                "shape_multiple": r0["shape_multiple"],
                "volume_err": r0["volume_err"],
                "volume_max": r0["volume_max"], "disp_err": r0["disp_err"],
                "disp_max": r0["disp_max"], "graphs": r0["graphs"],
                "eager_reason": r0["eager_reason"],
                "s": [x["s"] for x in res], "plain_s": r0["plain_s"],
                "launches_by_rank": [x["launches"] for x in res],
                "plain_launches": plain,
                "collectives": [x["collectives"] for x in res],
                "peak_bytes": [x["peak_bytes"] for x in res]}
            _require(r0["path"] == r0["plain_path"] == case,
                     f"{label}: routes {r0['path']}, {r0['plain_path']}")
            for e, m in zip(r0["volume_err"], r0["volume_max"]):
                _require(_close(e, m, spec["volume_tol"]),
                         f"{label}: stage volume |diff| {e:.3e} (max "
                         f"{m:.3e})")
            _require(_close(r0["disp_err"], r0["disp_max"],
                            spec["disp_tol"][case]),
                     f"{label}: disparity |diff| {r0['disp_err']:.3e} (max "
                     f"{r0['disp_max']:.3e})")
            for x in res[1:]:
                _require(np.array_equal(x["disp"], r0["disp"]),
                         f"{label}: the ranks' disparities differ")
            # a grid's ranks are row-major: the view ranks of row i are
            # i * n_view .. (i + 1) * n_view - 1; they share the views'
            # warps and volumes and each runs every lookup
            nv = spec["n_view"] if kind == "grid" else 1
            for i in range(0, n, nv):
                got: Dict[str, int] = {}
                for x in res[i:i + nv]:
                    for k, v in x["launches"].items():
                        if k in PER_VIEW_KERNELS or x is res[i]:
                            got[k] = got.get(k, 0) + v
                _require({k: v for k, v in got.items() if v} == plain,
                         f"{label}: launches of ranks {i}..{i + nv - 1} "
                         f"{[x['launches'] for x in res[i:i + nv]]} "
                         f"against unsharded {plain}")
                for x in res[i + 1:i + nv]:
                    _require(all(v == x["launches"].get(k, 0)
                                 for k, v in res[i]["launches"].items()
                                 if k not in PER_VIEW_KERNELS),
                             f"{label}: the view ranks' lookups differ")
        return report
    finally:
        if own:
            world.close()

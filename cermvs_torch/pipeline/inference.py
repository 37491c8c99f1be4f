"""Depth-map inference on one device, or sharded over the ranks of a mesh
(``mesh=``): the neighbour views over a ``(data, view)`` mesh's ``view``
axis (``parallel/infer.py``), the image rows over a ``(row,)`` mesh, or
both over a ``(row, view)`` grid (``parallel/spatial.py``).

``InferenceRunner`` owns the model and picks the cost-volume construction
per batch; ``inference()`` runs every reference view of a loader as a
software pipeline and writes ``depths/{ref}_scale{rescale}_nf{num_frames}.pfm``
(plus optional per-view min-depth files).

Construction routing, one reference view a forward:
  * "exact": the gather construction (``ops/corr.py``);
  * "rectified": the rectified construction (``ops/corr_rectified.py``) when
    the host planner accepts the scene and its warped features fit
    ``rect_memory_budget``; else the mixed construction
    (``corr_rectified.MixedVolume``) when a subset of the neighbours can be
    rectified; else exact, with a printed notice;
  * "auto": the same decision, silently, plus the optional work gate
    ``rect_cost_ratio_max``.
A batch of several reference views runs exact under "auto"; under
"rectified" the samples' plans are unioned (with a warning).

The forward of each ``(shape, dtype, construction key)`` is the JAX
package's compiled program's counterpart: on a CUDA runner the key's first
dispatch runs eagerly and then captures the same forward in a CUDA graph,
which every later dispatch of the key replays (:meth:`InferenceRunner._fn`).
Under a view mesh the same keys route through ``ViewShardedVolume``; under
a row or grid mesh through ``SpatialForward``, the exact construction or,
where the scene allows it, the banded rectified one (the JAX package's
``_row_plan``). A graph holds the NCCL collectives, and under gloo, whose
collectives cannot be captured, every forward runs eagerly.

The pipeline: a thread prepares items two ahead (scale, crop, pad, the bf16
cast) and, with ``device_prefetch`` on a CUDA runner, casts into pinned
memory and uploads on the runner's own stream; batch i is dispatched before
batch i-1 is fetched and written. A record whose interval holds the next
dispatch's capture says so, as the JAX package's report names a compile.
"""

from __future__ import annotations

import gc
import queue
import threading
import time
import warnings
from pathlib import Path
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from cermvs_torch.config import configurable
from cermvs_torch.data.augment import (crop_operation, pad_to_multiple,
                                       scale_operation)
from cermvs_torch.io.pfm import write_pfm
from cermvs_torch.models.raft import RAFT
from cermvs_torch.ops import cudalib
from cermvs_torch.ops.corr_rectified import (make_mixed_volume_fn,
                                             make_rectified_volume_fn)
from cermvs_torch.ops.rectify import (PlanCache, RectPlan,
                                      plan_rectification,
                                      plan_rectification_partial,
                                      plan_row_bands, plan_union,
                                      rect_cost_ratio)
from cermvs_torch.parallel.infer import ViewShardedVolume
from cermvs_torch.parallel.mesh import (check_mesh, collectives_capturable,
                                        rank, row_group, view_group, world,
                                        world_size)
from cermvs_torch.parallel.spatial import GHOST_RECT, SpatialForward
from cermvs_torch.utils.memory import device_memory_stats


def _prefetched(iterable, fn, depth: int = 2):
    """Apply ``fn`` to the items of ``iterable`` in one background thread,
    ``depth`` items ahead, so host preparation overlaps the device.

    Cancellation-safe: when the consumer abandons the generator (a break,
    or an exception downstream closes it), the worker sees the stop event at
    its next bounded put and exits instead of blocking on a full queue, and
    the close waits for it (a thread left in native code at interpreter
    exit aborts the process). An exception in the worker is raised in the
    consumer."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    end = object()
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in iterable:
                if not put(fn(item)):
                    return
        except BaseException as e:  # raised again in the consumer
            if not put(e):
                return
        put(end)

    thread = threading.Thread(target=worker, name="inference-prep",
                              daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is end:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        thread.join()


def to_bf16(images, pin: bool = False) -> torch.Tensor:
    """Float frames (numpy) -> a bf16 tensor on the host, in pinned memory
    when ``pin``. One pass in torch, which releases the GIL, so the cast
    overlaps the forward's dispatch when it runs in the prep thread."""
    src = torch.from_numpy(np.asarray(images, np.float32))
    return torch.empty(src.shape, dtype=torch.bfloat16,
                       pin_memory=pin).copy_(src)


class Upload(NamedTuple):
    """Frames copied to the device on the runner's upload stream; ``done``
    is recorded on that stream after the copy."""

    frames: torch.Tensor
    done: "torch.cuda.Event"

    @property
    def shape(self):
        return self.frames.shape


class Fetch(NamedTuple):
    """Disparities on their way to the host: ``disp`` is a pinned host
    tensor and ``done`` an event after its copy, or ``disp`` is the tensor
    itself and ``done`` None (CPU)."""

    disp: torch.Tensor
    done: Optional["torch.cuda.Event"]


class Routed(NamedTuple):
    """One dispatch as the forward takes it: the inputs on the device, the
    neighbours in the routed order, and the volume construction (None for
    exact; a ``SpatialForward`` under a row or grid mesh) with its cache key
    and route name; ``q0``: the band starts of the banded rectified
    construction, on the device."""

    images: torch.Tensor
    poses: torch.Tensor
    intrinsics: torch.Tensor
    scales: torch.Tensor
    volume_fn: object
    key: object
    path: str
    q0: Optional[torch.Tensor] = None

    @property
    def args(self) -> tuple:
        """The forward's inputs: the first four fields, and ``q0`` if any."""
        return tuple(self[:4]) + (() if self.q0 is None else (self.q0,))


class GraphedForward:
    """A forward captured in a CUDA graph: ``inputs`` are its static input
    buffers, ``output`` its static output, ``launches`` the kernel launches
    its capture counted. A call copies the inputs in, replays the graph and
    returns a clone of the output, all on the current stream: the next
    replay overwrites ``output``, and the driver dispatches a batch before
    it fetches the one before.

    The wrappers chose their launch geometry at capture from the pointers'
    alignment (``cudalib.pointer_alignment``). That holds on every replay:
    the static buffers and the graph's pool keep their addresses."""

    def __init__(self, graph, inputs, output, launches):
        self.graph = graph
        self.inputs = inputs
        self.output = output
        self.launches = launches

    def __call__(self, *args):
        for dst, src in zip(self.inputs, args):
            dst.copy_(src)
        self.graph.replay()
        cudalib.add_launches(self.launches)
        return self.output.clone()


class InferenceRunner:
    """Test-mode RAFT on one device with per-batch construction routing.

    ``model``: a port ``RAFT`` (its weights are used as they are); otherwise
    one is built from ``model_kwargs`` and, if given, loaded with the JAX
    parameter tree ``params`` (numpy leaves).

    On a CUDA runner each ``(shape, dtype, construction key)`` is captured
    in a CUDA graph at its first dispatch (:meth:`_fn`). A graph reads the
    weights at their addresses, so a load in place (``load_state_dict``,
    ``utils.weights``) reaches it; it keeps everything else as it was at
    capture (the model's attributes, such as ``lookup_impl``, and the
    ``torch.backends`` flags): change those on a new runner.

    ``mesh``: a ``(data, view)`` DeviceMesh (``parallel.make_mesh``): each
    forward runs view-sharded over the ranks of its ``view`` axis, every
    rank with the same inputs and the same disparities out. Routing is the
    one without a mesh, with the warped features' memory shared by the view
    ranks (the JAX package's ``mem_shards``); a batch of several views runs
    exact. A ``(row,)`` or ``(row, view)`` DeviceMesh
    (``parallel.make_row_mesh``; :attr:`row_mesh`, :attr:`grid_mesh`):
    each rank computes its rows (and on a grid its share of the views) and
    the full disparities are gathered on every rank; batch 1, H a multiple
    of :attr:`shape_multiple`, routed by :meth:`row_plan`. Under gloo the
    forwards run eagerly (:attr:`graphs` False, :attr:`eager_reason` says
    why). A mesh of another kind raises ``ValueError``.
    """

    def __init__(self, model: Optional[RAFT] = None, params=None,
                 mesh=None, construction: str = "auto",
                 rect_lambda_max: float = 0.00375,
                 rect_memory_budget: float = 6e9,
                 rect_cost_ratio_max: Optional[float] = None,
                 max_k_chunks: Optional[int] = None, device="cuda",
                 **model_kwargs):
        """``rect_cost_ratio_max``: the optional "auto" work gate: a plan
        whose epiband work per unit of exact work
        (``rectify.rect_cost_ratio``, at feature resolution) exceeds it runs
        exact. ``max_k_chunks`` is the JAX package's cap on its epiband
        kernel's hypothesis chunks, one of its Mosaic VMEM gates; it is
        accepted so that both packages take the same arguments, and changes
        nothing: the port's kernel takes any window (ROADMAP North star)."""
        del max_k_chunks
        self.mesh = None if mesh is None else check_mesh(mesh)
        self.view_group = view_group(mesh) if mesh is not None else None
        self.row_group = row_group(mesh) if mesh is not None else None
        # the ranks that share the warped features' memory: the view
        # ranks, or under a row mesh the row ranks (each holds bands)
        self.memory_shards = world_size(
            self.row_group if self.row_group is not None
            else self.view_group)
        if construction not in ("auto", "exact", "rectified"):
            raise ValueError(f"unknown construction {construction!r}")
        self.device = torch.device(device)
        if model is None:
            model = RAFT(test_mode=True, device=self.device, **model_kwargs)
        if params is not None:
            from cermvs_torch.utils.weights import load_jax_params

            load_jax_params(model, params)
        self.model = model.to(self.device).eval()
        self.model.test_mode = True
        self.construction = construction
        self.rect_lambda_max = rect_lambda_max
        # device-memory cap for the rectified path's warped feature rows
        # (shared across cascade stages): ~2*V*h_r*(w_r+ws_r)*C bytes
        self.rect_memory_budget = rect_memory_budget
        self.rect_cost_ratio_max = rect_cost_ratio_max
        self._volumes: Dict[object, object] = {}
        # batched rectified dispatch keys its constructions through a
        # PlanCache, so plans across batches stay few
        self._plan_cache = PlanCache()
        self._warned_fallback = False
        self._warned_batched_rect = False
        self.last_path = "exact"
        # the forward of each (shape, dtype, construction key): a
        # GraphedForward on CUDA, the eager forward on the CPU
        self._cache: Dict[tuple, object] = {}
        # the first dispatch of a key runs eagerly and captures (CUDA):
        # inference() reports that dispatch's seconds apart
        self.last_dispatch_compiled = False
        self.last_capture_s = 0.0
        self._static_inputs: Dict[tuple, tuple] = {}
        cuda = self.device.type == "cuda"
        group = (self.row_group if self.row_group is not None
                 else self.view_group)
        self.graphs = cuda and collectives_capturable(group)
        self.eager_reason = (
            None if self.graphs else "a CPU runner" if not cuda else
            f"{torch.distributed.get_backend(group)} collectives "
            f"cannot be captured in a CUDA graph")
        # the stream inference()'s prep thread uploads frames on
        self.upload_stream = torch.cuda.Stream(self.device) if cuda else None
        # the graphs capture on a stream of their own and share one memory
        # pool: their replays run one at a time on the forward's stream,
        # each with its inputs copied in just before and its output cloned
        # out just after, so no graph's memory is in use while another runs
        self._capture_stream = (torch.cuda.Stream(self.device) if cuda
                                else None)
        if cuda:
            with torch.cuda.device(self.device):
                self._pool = torch.cuda.graph_pool_handle()

    def _feature_geometry(self, poses, intrinsics, scale, img_shape):
        """Poses with scaled translations (RAFT scales them) and intrinsics
        at the feature stride, float64, and the feature grid (h, w)."""
        f = self.model.stride_factor
        poses = np.asarray(poses, np.float64).copy()
        poses[..., :3, 3] *= float(scale)
        intr = np.asarray(intrinsics, np.float64).copy()
        intr[..., :2, :] /= f
        return poses, intr, img_shape[0] // f, img_shape[1] // f

    def _rect_bytes(self, plan: RectPlan, n_views: int, batch: int = 1):
        """The warped features' bytes on each card: a view rank holds its
        share of the views."""
        return (2 * batch * n_views * plan.h_r * (plan.w_r + plan.ws_r)
                * self.model.dim_fmap) // self.memory_shards

    @property
    def row_mesh(self) -> bool:
        """A ``(row,)`` mesh: the image rows over its ranks."""
        return self.row_group is not None and self.view_group is None

    @property
    def grid_mesh(self) -> bool:
        """A ``(row, view)`` mesh: rows and neighbour views."""
        return self.row_group is not None and self.view_group is not None

    @property
    def shape_multiple(self) -> int:
        """The multiple of the image's H and W a forward takes
        (``inference()`` crops to it): the encoder's stride, or 8 x the row
        ranks under a row or grid mesh."""
        f = self.model.stride_factor
        if self.row_group is not None:
            return max(f, 8 * world_size(self.row_group))
        return f

    def row_plan(self, poses, intrinsics, scale, img_shape):
        """The banded rectified construction's key ``(plan, band_h)`` and
        band starts ``q0`` (n_row, V) under a row or grid mesh, or
        ``(None, None)`` for the exact one, as the JAX package's
        ``_row_plan`` decides: the mean aggregation, H a multiple of 8 x
        the row ranks with ``GHOST_RECT`` feature rows a rank, and a plan
        :meth:`plan_for` accepts."""
        if not self.model.mean_volume:
            return None, None
        n = world_size(self.row_group)
        f = self.model.stride_factor
        H, W = img_shape
        h = H // f
        if H % (8 * n) or h // n < GHOST_RECT:
            if not self._warned_fallback:
                warnings.warn(
                    f"row-mesh rectified bands unavailable (H={H} needs "
                    f"H % {8 * n} == 0 and >= {GHOST_RECT} feature rows a "
                    f"rank); using the exact row-sharded path")
                self._warned_fallback = True
            return None, None
        plan = self.plan_for(poses, intrinsics, scale, img_shape)
        if not plan.ok:
            return None, None
        intr = np.asarray(intrinsics, np.float64).copy()
        intr[..., :2, :] /= f
        # the rect homographies are scale-invariant (rotations and
        # centring), so the unscaled poses give the bands of any rescale
        q0, band_h = plan_row_bands(np.asarray(poses, np.float64), intr, h,
                                    W // f, plan, n, GHOST_RECT)
        return (plan, band_h), q0

    def plan_for(self, poses, intrinsics, scale, img_shape) -> RectPlan:
        """Host-side rectification plan on the scaled, feature-stride
        geometry (not ok when the rectified construction must not be
        used)."""
        poses, intr, h, w = self._feature_geometry(poses, intrinsics, scale,
                                                   img_shape)
        plan = plan_rectification(poses, intr, h, w,
                                  lambda_max=self.rect_lambda_max)
        if plan.ok:
            V = poses.shape[0] - 1
            rect_bytes = self._rect_bytes(plan, V)
            if rect_bytes > self.rect_memory_budget:
                plan = RectPlan(0, 0, 0, 0, False,
                                f"rect features ~{rect_bytes / 1e9:.1f} GB "
                                f"exceed budget")
            elif (self.construction == "auto"
                  and self.rect_cost_ratio_max is not None):
                ratio = rect_cost_ratio(plan, h, w, V,
                                        d0=self.model.cascade[0][0])
                if ratio > self.rect_cost_ratio_max:
                    plan = RectPlan(0, 0, 0, 0, False,
                                    f"planned epiband work ratio "
                                    f"{ratio:.1f} > "
                                    f"{self.rect_cost_ratio_max:.1f}")
        if (not plan.ok and self.construction == "rectified"
                and not self._warned_fallback):
            print(f"[inference] rectified construction unavailable "
                  f"({plan.reason}); using exact path")
            self._warned_fallback = True
        return plan

    def mixed_plan(self, poses, intrinsics, scale, img_shape):
        """The mixed construction's ``(plan, rect_views)`` over the
        neighbours that pass the per-pair gates, or ``(None, None)`` when
        the exact path must be used: none or all of them pass, or their
        warped features exceed ``rect_memory_budget``. The JAX package also
        drops views whose windows exceed its Mosaic VMEM budget; the port's
        kernel has no such budget (ROADMAP North star)."""
        poses, intr, h, w = self._feature_geometry(poses, intrinsics, scale,
                                                   img_shape)
        plan, rect_views = plan_rectification_partial(
            poses, intr, h, w, lambda_max=self.rect_lambda_max)
        if (not plan.ok or not rect_views
                or len(rect_views) == poses.shape[0] - 1
                or (self._rect_bytes(plan, len(rect_views))
                    > self.rect_memory_budget)):
            return None, None
        return plan, rect_views

    @staticmethod
    def neighbor_order(poses) -> np.ndarray:
        """[0, neighbours sorted by ascending baseline to the reference]."""
        po = np.asarray(poses, np.float64)
        rel = po[1:] @ np.linalg.inv(po[0])
        centers = -np.einsum("vji,vj->vi", rel[:, :3, :3], rel[:, :3, 3])
        return np.concatenate(
            [[0], 1 + np.argsort(np.linalg.norm(centers, axis=-1),
                                 kind="stable")])

    def _volume(self, key, n_views: int):
        """The construction of a key, made once: None for the model's exact
        one, a RectPlan's rectified one, a ``(plan, rect_views)`` mixed one;
        under a view mesh this rank's ``ViewShardedVolume`` of it, under a
        row or grid mesh its ``SpatialForward`` (key None or ``(plan,
        band_h)``)."""
        meshed = self.mesh is not None
        if not meshed and key is None:
            return None
        vkey = (key, n_views) if meshed else key
        if vkey in self._volumes:
            return self._volumes[vkey]
        if self.row_group is not None:
            plan, band_h = key if key is not None else (None, 0)
            self._volumes[vkey] = SpatialForward(
                n_views, self.row_group, self.view_group, plan, band_h)
        else:
            plan, rect_views = (key if isinstance(key, tuple)
                                else (key, None))
            if self.view_group is not None:
                self._volumes[vkey] = ViewShardedVolume(
                    n_views, self.view_group, plan, rect_views)
            elif rect_views is None:
                self._volumes[vkey] = make_rectified_volume_fn(plan)
            else:
                self._volumes[vkey] = make_mixed_volume_fn(plan, rect_views)
        return self._volumes[vkey]

    def _route_one(self, poses, intrinsics, scale, img_shape):
        """One reference view: (construction key or None, route). The key
        is the JAX package's: the plan, or the mixed ``(plan,
        rect_views)``."""
        plan = self.plan_for(poses, intrinsics, scale, img_shape)
        if plan.ok:
            return plan, "rectified"
        pplan, rect_views = self.mixed_plan(poses, intrinsics, scale,
                                            img_shape)
        if pplan is None:
            return None, "exact"
        return (pplan, rect_views), "mixed"

    def _route_batch(self, images, poses, intrinsics, scales):
        """A batch under "rectified": each sample's neighbours in baseline
        order, the union of the samples' plans under the B-scaled memory
        budget, keyed through the PlanCache. Returns (the PlanCache key or
        None for exact, images, poses, intrinsics), the arrays reordered
        either way."""
        B = images.shape[0]
        orders = [self.neighbor_order(poses[b]) for b in range(B)]
        images = torch.stack([
            images[b, torch.as_tensor(o, device=images.device)]
            for b, o in enumerate(orders)])
        poses = np.stack([poses[b][o] for b, o in enumerate(orders)])
        intrinsics = np.stack([intrinsics[b][o]
                               for b, o in enumerate(orders)])
        plans = [self.plan_for(poses[b], intrinsics[b], scales[b],
                               images.shape[2:4]) for b in range(B)]
        plan = plan_union(plans)
        if (not all(p.ok for p in plans) or not plan.ok
                or (self._rect_bytes(plan, poses.shape[1] - 1, B)
                    > self.rect_memory_budget)):
            return None, images, poses, intrinsics
        return self._plan_cache.key_for(plan), images, poses, intrinsics

    def upload(self, frames: torch.Tensor) -> Upload:
        """Copy frames from pinned host memory to the device on the runner's
        upload stream (callable from any thread). :meth:`submit_batch`
        makes the forward's stream wait for the copy. Raises rather than
        copy from pageable memory or on another stream."""
        if self.upload_stream is None:
            raise RuntimeError("upload needs a CUDA runner")
        if not frames.is_pinned():
            raise ValueError("upload copies from pinned host memory")
        with torch.cuda.stream(self.upload_stream):
            on_device = frames.to(self.device, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self.upload_stream)
        return Upload(on_device, done)

    def _take(self, upload: Upload) -> torch.Tensor:
        stream = torch.cuda.current_stream(self.device)
        stream.wait_event(upload.done)
        # the block was allocated on the upload stream: without this the
        # allocator may hand it to the next upload while the forward reads it
        upload.frames.record_stream(stream)
        return upload.frames

    def _fn(self, cache_key, volume_fn):
        """The forward of ``cache_key`` = (shape of the images' first four
        axes, their dtype, construction key), the counterpart of the JAX
        package's compile cache. Sets :attr:`last_dispatch_compiled` when
        the key is new.

        On CUDA a new key's forward runs eagerly (which also makes the lazy
        loads the capture must not make: cuBLAS and cuDNN plans, the
        kernels' libraries, the mixed construction's view indices), returns
        that result, and captures the same forward in a CUDA graph
        (:attr:`last_capture_s` its seconds); every later dispatch of the
        key replays the graph. A capture that fails raises. On the CPU the
        key is kept the same way and the forward runs eagerly."""
        self.last_dispatch_compiled = cache_key not in self._cache
        if not self.last_dispatch_compiled:
            return self._cache[cache_key]

        def eager(*args):
            with torch.no_grad():
                return self._call(args, volume_fn)

        if not self.graphs:
            self._cache[cache_key] = eager
            return eager

        def first(*args):
            out = eager(*args)
            t0 = time.perf_counter()
            self._cache[cache_key] = self._capture(args, volume_fn)
            self.last_capture_s = time.perf_counter() - t0
            return out

        return first

    def _call(self, args, volume_fn):
        """The forward of ``args`` through ``volume_fn``: the model with
        that construction, or a ``SpatialForward`` of the model."""
        if isinstance(volume_fn, SpatialForward):
            return volume_fn(self.model, *args)
        return self.model(*args, volume_fn=volume_fn)

    def _capture(self, args, volume_fn) -> GraphedForward:
        """Capture the forward on static inputs shaped as ``args``, shared
        by the keys of one shape.

        ``capture_error_mode="thread_local"`` lets the prep thread go on
        while this one captures: it casts into pinned memory and uploads on
        the upload stream, none of which touches the capture stream, and
        the allocator serves a stream that is not capturing from its own
        pool."""
        spec = tuple((tuple(a.shape), a.dtype) for a in args)
        if spec not in self._static_inputs:
            self._static_inputs[spec] = tuple(torch.empty_like(a)
                                              for a in args)
        static = self._static_inputs[spec]
        # a graph that Python's collector frees during the capture (another
        # runner's, dropped) would free memory there, which ends the
        # capture: collect first; then the eager forward's cached blocks go
        # back to the card before the graph takes its transients into the
        # pool (the train step's capture does the same)
        gc.collect()
        torch.cuda.empty_cache()
        graph = torch.cuda.CUDAGraph()
        with cudalib.captured_launches() as launches, torch.no_grad(), \
                torch.cuda.graph(graph, pool=self._pool,
                                 stream=self._capture_stream,
                                 capture_error_mode="thread_local"):
            out = self._call(static, volume_fn)
        return GraphedForward(graph, static, out, launches)

    def route(self, images, poses, intrinsics, scales) -> Routed:
        """Route a batch as :meth:`submit_batch` does and return the
        forward's inputs on the device, its construction and key
        (``runner.model(*routed[:4], volume_fn=routed.volume_fn)`` is the
        eager forward; under a row or grid mesh
        ``routed.volume_fn(runner.model, *routed.args)``)."""
        poses = np.asarray(poses, np.float32)
        intrinsics = np.asarray(intrinsics, np.float32)
        scales = [float(s) for s in scales]
        if isinstance(images, Upload):
            images = self._take(images)
        elif not torch.is_tensor(images):
            images = to_bf16(images)
        key, path, q0 = None, "exact", None
        if self.row_group is not None:
            if images.shape[0] != 1:
                raise ValueError("row and grid sharding take batch 1")
            if self.construction != "exact":
                order = self.neighbor_order(poses[0])
                images = images[:, torch.as_tensor(order,
                                                   device=images.device)]
                poses, intrinsics = poses[:, order], intrinsics[:, order]
                key, q0 = self.row_plan(poses[0], intrinsics[0], scales[0],
                                        images.shape[2:4])
                path = "exact" if key is None else "rectified"
        elif (self.construction == "rectified" and images.shape[0] > 1
                and self.view_group is None):
            if not self._warned_batched_rect:
                warnings.warn(
                    "construction='rectified' with view_batch > 1 unions the "
                    "batch's plans, which widens every view's epiband "
                    "windows, and builds the samples' volumes one after "
                    "another; construction='auto' runs batches through the "
                    "exact construction")
                self._warned_batched_rect = True
            key, images, poses, intrinsics = self._route_batch(
                images, poses, intrinsics, scales)
            path = "exact" if key is None else "rectified"
        elif self.construction != "exact" and images.shape[0] == 1:
            # neighbour order by baseline: the view aggregation is
            # permutation-invariant, and a canonical order keeps per-view
            # plans comparable across reference views
            order = self.neighbor_order(poses[0])
            images = images[:, torch.as_tensor(order, device=images.device)]
            poses, intrinsics = poses[:, order], intrinsics[:, order]
            key, path = self._route_one(poses[0], intrinsics[0], scales[0],
                                        images.shape[2:4])
        dev = self.device
        return Routed(images.to(dev), torch.from_numpy(poses).to(dev),
                      torch.from_numpy(intrinsics).to(dev),
                      torch.tensor(scales, dtype=torch.float32, device=dev),
                      self._volume(key, poses.shape[1] - 1), key, path,
                      None if q0 is None else torch.from_numpy(
                          q0.astype(np.int64)).to(dev))

    def submit_batch(self, images, poses, intrinsics, scales) -> torch.Tensor:
        """A batch of B reference views with their neighbours -> disparities
        (B, h, w) on the device.

        ``images`` (B, N, H, W, 3) in [0, 255]: a numpy array, a bf16 tensor
        on the host, or an :class:`Upload`. Frames cross to the device in
        bf16, as the encoders compute in bf16 regardless. Routing follows
        the JAX package: one view goes through :meth:`plan_for` and
        :meth:`mixed_plan` unless the construction is "exact"; a batch runs
        exact unless the construction is "rectified" (and no view mesh)."""
        r = self.route(images, poses, intrinsics, scales)
        self.last_path = r.path
        return self.forward(r)

    def forward(self, r: Routed) -> torch.Tensor:
        """The forward of a routed dispatch: its key's (:meth:`_fn`)."""
        fn = self._fn((tuple(r.images.shape[:4]), r.images.dtype, r.key),
                      r.volume_fn)
        return fn(*r.args)

    def submit(self, images, poses, intrinsics, scale) -> torch.Tensor:
        """images (N, H, W, 3) in [0, 255] -> disparity (1, h, w) on device."""
        return self.submit_batch(images[None], np.asarray(poses)[None],
                                 np.asarray(intrinsics)[None], [scale])

    @staticmethod
    def fetch(disp: torch.Tensor) -> Fetch:
        """Start copying disparities into pinned host memory behind the
        forward that made them, so :meth:`finalize_batch` waits for that
        copy alone and not for work dispatched after it."""
        if disp.device.type != "cuda":
            return Fetch(disp, None)
        host = torch.empty(disp.shape, dtype=disp.dtype, pin_memory=True)
        host.copy_(disp, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return Fetch(host, done)

    @staticmethod
    def finalize_batch(disp) -> np.ndarray:
        """Disparities (B, h, w), a tensor or a :class:`Fetch` -> depth maps
        (B, h, w) float32 on the host."""
        if isinstance(disp, Fetch):
            if disp.done is not None:
                disp.done.synchronize()
            disp = disp.disp
        d = disp.float().cpu().numpy()
        return np.where(d == 0, 0, 1.0 / np.where(d == 0, 1, d)).astype(
            np.float32)

    @classmethod
    def finalize(cls, disp) -> np.ndarray:
        """Disparity (1, h, w) -> depth map (h, w) float32 on the host."""
        return cls.finalize_batch(disp)[0]

    def __call__(self, images, poses, intrinsics, scale) -> np.ndarray:
        """images (N,H,W,3) float32 [0,255] -> depth map (h, w) float32."""
        return self.finalize(self.submit(images, poses, intrinsics, scale))


@configurable("inference")
def inference(test_loader, ckpt=None, output_folder="results",
              rescale: float = 1, crop=None, do_report: bool = False,
              write_min_depth: Optional[str] = None, params=None,
              model=None, model_kwargs: Optional[dict] = None,
              mesh=None, view_batch: int = 1, construction: str = "auto",
              device_prefetch: bool = True, device="cuda"):
    """Run depth inference for every reference view of ``test_loader``.

    ``test_loader`` yields ``(images, poses, intrinsics, image_names,
    scale)`` items and has ``.dataset.num_frames``. Weights come from
    ``model`` (a port RAFT), ``params`` (a JAX parameter tree) or ``ckpt``:
    a reference ``.pth`` (with or without a ``module.`` prefix), or else a
    weights file of the port's own (``training.checkpoint.save_params``).

    ``view_batch``: reference views per forward; consecutive items of one
    shape are batched (a shape change flushes the batch). ``device_prefetch``
    (with ``view_batch <= 1``, on a CUDA runner): the prep thread casts the
    frames into pinned memory and uploads them on the runner's upload
    stream, so the copy overlaps the previous forward; otherwise the
    forward's dispatch uploads them. ``mesh``: a ``(data, view)``,
    ``(row,)`` or ``(row, view)`` DeviceMesh: every rank reads every item
    and gets the same disparities, each forward sharded
    (``InferenceRunner``), with no pinned side-stream upload; under a row
    or grid mesh the frames are cropped to the runner's
    ``shape_multiple``; rank 0 writes the files.

    Returns one ``(name, seconds, construction, capture_s)`` record per
    view. ``seconds`` is pipeline-inclusive, as the JAX package's report is:
    from the return of the view's batch dispatch to the view's write, an
    interval that covers the next batch's dispatch. ``capture_s`` is the
    seconds of that next dispatch where it was the first of its key (an
    eager forward and the graph capture on CUDA, the eager forward alone on
    the CPU), else 0: the record JAX's report marks ``[incl. Xs jit
    compile]``, printed here with ``[incl. Xs graph capture]``. The first
    dispatch's lies in no record's interval.
    """
    if mesh is not None:
        check_mesh(mesh)  # a mesh of another kind raises before any work
    if model is None and params is None:
        if ckpt is None:
            raise ValueError("need model, params or a ckpt path")
        if str(ckpt).endswith(".pth"):
            from cermvs_torch.utils.weights import load_reference_checkpoint

            model = load_reference_checkpoint(
                ckpt, RAFT(test_mode=True, device=device,
                           **(model_kwargs or {})))
        else:
            from cermvs_torch.training.checkpoint import load_params

            state = load_params(ckpt)  # FileNotFoundError before the model
            model = RAFT(test_mode=True, device=device,
                         **(model_kwargs or {}))
            model.load_state_dict(state)
    runner = InferenceRunner(model=model, params=params, mesh=mesh,
                             construction=construction, device=device,
                             **({} if model is not None
                                else (model_kwargs or {})))

    output_folder = Path(output_folder)
    (output_folder / "depths").mkdir(exist_ok=True, parents=True)
    num_frames = test_loader.dataset.num_frames
    factor = runner.shape_multiple
    prefetch = (device_prefetch and view_batch <= 1 and mesh is None
                and runner.upload_stream is not None)
    writer = mesh is None or rank(world()) == 0
    records = []

    def prep(item):
        images, poses, intrinsics, image_names, scale = item
        images, intrinsics = scale_operation(images, intrinsics, rescale)
        if crop is not None:
            images, intrinsics = crop_operation(images, intrinsics, *crop)
        images, intrinsics = pad_to_multiple(images, intrinsics, factor)
        frames = to_bf16(images, pin=prefetch)
        if prefetch:
            frames = runner.upload(frames)
        return frames, poses, intrinsics, image_names, scale

    def emit(name, depth, tic, path, capture_s):
        seconds = time.perf_counter() - tic
        records.append((name, seconds, path, capture_s))
        if do_report:
            # the peak since the run's start (utils/memory.py), as the JAX
            # package's inference() reads it; the CPU reports none
            peak = max((s["peak_bytes_in_use_mb"] for s in
                        device_memory_stats(runner.device).values()),
                       default=0.0)
            note = (f"  [incl. {capture_s:.1f}s graph capture]"
                    if capture_s > 0 else "")
            print(f"per view time: {seconds:.3f}s  "
                  f"peak device memory: {peak:.0f} MB ({name}, {path}){note}")
        if not writer:
            return
        write_pfm(output_folder / "depths"
                  / f"{name}_scale{rescale}_nf{num_frames}.pfm", depth)
        if write_min_depth is not None:
            md_dir = Path(write_min_depth)
            md_dir.mkdir(exist_ok=True, parents=True)
            valid = depth[depth > 0]
            min_depth = (float(np.quantile(valid, 0.1) / 2) if valid.size
                         else 0.0)
            (md_dir / f"{name}.txt").write_text(f"{min_depth}\n")

    def flush(buf):
        frames = [b[1] for b in buf]
        if isinstance(frames[0], Upload):  # view_batch <= 1
            images = Upload(frames[0].frames[None], frames[0].done)
        else:
            images = (frames[0][None] if len(frames) == 1
                      else torch.stack(frames))
        t_sub = time.perf_counter()
        disp = runner.submit_batch(images, np.stack([b[2] for b in buf]),
                                   np.stack([b[3] for b in buf]),
                                   [b[4] for b in buf])
        # the first dispatch of a key runs eagerly and captures its graph:
        # the previous batch's records name those seconds
        capture_s = (time.perf_counter() - t_sub
                     if runner.last_dispatch_compiled else 0.0)
        # each batch carries its own route: at drain time runner.last_path
        # is already the next batch's
        return ([b[0] for b in buf], runner.fetch(disp), time.perf_counter(),
                runner.last_path, capture_s)

    def drain(pending, capture_s=0.0):
        names, fetched, tic, path, _ = pending
        for name, depth in zip(names, runner.finalize_batch(fetched)):
            emit(name, depth, tic, path, capture_s)

    def rotate(pending, buf):
        # dispatch batch i before fetching batch i-1: the fetch and the
        # writes of i-1 overlap batch i's device work, and batch i's capture
        # falls inside batch i-1's interval
        nxt = flush(buf)
        if pending is not None:
            drain(pending, capture_s=nxt[4])
        return nxt

    pending, buf = None, []
    items = _prefetched(test_loader, prep)
    try:
        for frames, poses, intrinsics, image_names, scale in items:
            if buf and buf[0][1].shape != frames.shape:
                pending = rotate(pending, buf)
                buf = []
            buf.append((image_names[0], frames, poses, intrinsics, scale))
            if len(buf) >= max(1, view_batch):
                pending = rotate(pending, buf)
                buf = []
    finally:
        items.close()  # an error here stops the prep thread at once
    if buf:
        pending = rotate(pending, buf)
    if pending is not None:
        drain(pending)
    return records

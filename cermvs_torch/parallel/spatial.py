"""Row- and grid-sharded inference: the image rows split over the ranks of a
mesh's ``row`` axis, and on a ``(row, view)`` grid the neighbour views over
its ``view`` axis too.

Every per-pixel tensor (features, cost volume, GRU state, lookups) lives
1/n-th on each rank, and the couplings between row blocks are explicit:

  * **encoders**: each convolution takes halo rows from the neighbouring
    ranks (zeros at the image's border, the convolution's zero padding) and
    pads only its columns; the instance norm averages its moments over the
    row ranks (:func:`encoder_rows`, on the model's own ``BasicEncoder``
    weights);
  * **cost volume**: the feature rows are gathered (the small tensor), and
    each rank builds the volume of its rows extended by ``GHOST`` rows each
    side. The row offset enters the projection (``Pij @ E(row0)``), so
    ``ops/corr.build_corr_volume_from`` builds it unchanged. With a plan,
    the rectified construction runs on a band of ``band_h`` rect rows per
    view (``rectify.plan_row_bands``), whose start enters the warps'
    homographies as a row translation;
  * **GRU iterations**: each rank carries its (net, disp) rows extended by
    the ghost rows, takes the ghost rows from its neighbours before every
    stage and iteration, and masks the rows outside the image at every
    convolution's input (``UpdateBlock(row_mask=)``). One iteration reads
    6 rows around a pixel, inside the 8 ghost rows, so the owned rows are
    those of the unsharded forward up to fp32 order;
  * **grid**: each view rank encodes and builds its share of the views
    (``infer.shard_views``), and one ``all_reduce(SUM)`` a stage over the
    view axis, divided by V, gives the view-mean volume of the row block;
    the iterations are the same on every view rank.

The collectives are the port's counterparts of the JAX package's
``ppermute``, ``pmean`` and ``all_gather`` over the row axis, and all of
them go through one site (``_collective``: a ``spatial.collective`` span
of the profiler). Under NCCL a halo exchange is one batch of sends and
receives to and from the two neighbours. The gathers, and the halos under
gloo (whose send/recv takes host tensors only), are one ``all_reduce(SUM)``
of a zero buffer in which each rank writes its own slot, summed as int32
words: exact for any dtype (adding zero words changes no bit), taken by
NCCL and by gloo on CUDA tensors alike. Under NCCL a CUDA graph holds
them all. Features go in the model's dtype (bf16 by default), half the
bytes of fp32.

Where this differs from the JAX package's ``parallel/spatial.py`` on purpose
(ROADMAP North star): the grid pads no view (JAX pads to a multiple of the
view ranks with zero-weight views), and each rank builds each of its views
in its own epiband window (``subplan``) where JAX widens every window to
the plan's scene-wide bounds; JAX's ``_pick_kc`` / ``k_chunks`` is a VMEM
gate the port's kernel does not need. The band starts are per rank and
per view data on the device (an ``index_select`` of the rate rows and a
translation built from a tensor), so one CUDA graph serves every scene of
a key ``(plan, band_h)``.

Scope, as in JAX: the test-mode forward, batch 1, the HR encoders; max and
std aggregation on the exact construction of a ``(row,)`` mesh (each rank
holds every view of its rows); the banded rectified construction and the
grid with the mean.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from cermvs_torch.ops import rectify
from cermvs_torch.ops.corr import (CorrPyramid, build_corr_volume_from,
                                   build_pyramid, lookup, slab_origin)
from cermvs_torch.ops.epiband import epiband
from cermvs_torch.ops.geometry import relative_projection
from cermvs_torch.parallel.infer import shard_views
from cermvs_torch.parallel.mesh import rank, world_size
from cermvs_torch.utils import profiling

# ghost rows (feature grid) >= one iteration's reach (6 rows)
GHOST = 8
# the rectified construction's margin: where a band row maps outside the
# rank's extended block, the slab origin's warp extends the edge, which
# spoils up to ~5 outer ghost rows of the volume; 16 keeps 6 clean ghost
# rows (one iteration's reach) between them and the owned rows
GHOST_RECT = 16


# ---------------------------------------------------------------------------
# Collectives over the row axis
# ---------------------------------------------------------------------------


# the backends whose halos go by send/recv to the two neighbours (each rank
# moves the halo rows alone); under the others, gloo here, by a slot
# all-reduce (every rank moves n + 2 slots), which gloo takes on CUDA
# tensors where its send/recv takes host tensors only
HALO_P2P_BACKENDS = frozenset({"nccl"})

# set by :func:`observe_collectives`: called as ``observer(nbytes, run)``
# in place of each collective, ``run()`` the collective itself
_observer = None


@contextlib.contextmanager
def observe_collectives(observer):
    """Within the block, every collective of this module runs as
    ``observer(nbytes, run)``: ``run()`` performs it, ``nbytes`` are the
    bytes this rank hands it (the dry run times each one alone)."""
    global _observer
    prev, _observer = _observer, observer
    try:
        yield
    finally:
        _observer = prev


def _collective(nbytes: int, run, on: torch.Tensor) -> None:
    """The one site every collective of this module goes through: ``run()``
    in a ``spatial.collective`` span (``utils/profiling.py``; its marks on
    the stream of ``on``, a tensor it moves), or through the observer of
    :func:`observe_collectives`."""
    with profiling.span("spatial.collective", on=on):
        if _observer is None:
            run()
        else:
            _observer(nbytes, run)


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` summed in place over ``group``."""
    _collective(t.numel() * t.element_size(),
                lambda: dist.all_reduce(t, group=group), t)
    return t


def _slots(shapes, dtypes, n: int, device):
    """A zero buffer of int32 words holding ``n`` slots, each slot one
    tensor of every (shape, dtype): returns the words and, per tensor, its
    view (n, *shape) in the buffer. An ``all_reduce(SUM)`` of the words, in
    which each rank wrote its own slots and left the rest zero, hands every
    slot to every rank bit for bit (adding zero words changes no bit)."""
    sizes = [math.prod(s) * torch.empty((), dtype=d).element_size()
             for s, d in zip(shapes, dtypes)]
    padded = [-(-b // 4) * 4 for b in sizes]
    words = torch.zeros((n, sum(padded) // 4), dtype=torch.int32,
                        device=device)
    raw = words.view(torch.uint8)
    views, off = [], 0
    for s, d, b, p in zip(shapes, dtypes, sizes, padded):
        views.append(raw[:, off:off + b].view(d).view((n,) + tuple(s)))
        off += p
    return words, views


def halo(xs: Sequence[torch.Tensor], up: int, down: int, group,
         dim: int = 1) -> List[torch.Tensor]:
    """Each tensor of ``xs`` (this rank's rows along ``dim``) with ``up``
    rows of the previous rank before it and ``down`` rows of the next one
    after it, zeros beyond the first and last rank (the convolutions' zero
    padding): the JAX package's ``ppermute`` pair, one exchange for all of
    ``xs``: send/recv under :data:`HALO_P2P_BACKENDS`, else a slot
    all-reduce."""
    if not (up or down):
        return list(xs)
    R = max(up, down)
    for x in xs:
        if x.shape[dim] < R:
            raise ValueError(f"{x.shape[dim]} rows cannot lend {R} halo rows")
    if dist.get_backend(group) in HALO_P2P_BACKENDS:
        return _halo_p2p(xs, up, down, group, dim)
    return _halo_slots(xs, up, down, group, dim)


def _halo_slots(xs, up, down, group, dim):
    """:func:`halo` by an all-reduce of n + 2 slots of 2 x R rows."""
    n, r = world_size(group), rank(group)
    R = max(up, down)
    shapes = []
    for x in xs:
        s = list(x.shape)
        s[dim] = R
        shapes.append((2,) + tuple(s))
    # slots 0 and n + 1 stay zero: the neighbours beyond the border
    words, views = _slots(shapes, [x.dtype for x in xs], n + 2, xs[0].device)
    for x, v in zip(xs, views):
        if down:  # my first rows: the previous rank's "down" halo
            v[r + 1, 0].narrow(dim, 0, down).copy_(x.narrow(dim, 0, down))
        if up:    # my last rows: the next rank's "up" halo
            v[r + 1, 1].narrow(dim, 0, up).copy_(
                x.narrow(dim, x.shape[dim] - up, up))
    all_reduce(words, group)
    out = []
    for x, v in zip(xs, views):
        parts = [v[r, 1].narrow(dim, 0, up)] if up else []
        parts.append(x)
        if down:
            parts.append(v[r + 2, 0].narrow(dim, 0, down))
        out.append(torch.cat(parts, dim))
    return out


def _halo_p2p(xs, up, down, group, dim):
    """:func:`halo` by one batch of sends and receives to and from the two
    neighbours (NCCL runs a batch as one group call on the group's own
    communicator, so a CUDA graph can hold it)."""
    n, r = world_size(group), rank(group)
    prev = dist.get_global_rank(group, r - 1) if r > 0 else None
    nxt = dist.get_global_rank(group, r + 1) if r < n - 1 else None
    ops, out, nbytes = [], [], 0

    def rows(x, start, k):
        return x.narrow(dim, start, k).contiguous()

    for x in xs:
        shape = list(x.shape)
        parts = []
        if up:
            shape[dim] = up
            got = torch.zeros(shape, dtype=x.dtype, device=x.device)
            if prev is not None:
                ops.append(dist.P2POp(dist.irecv, got, prev, group))
            if nxt is not None:
                sent = rows(x, x.shape[dim] - up, up)
                ops.append(dist.P2POp(dist.isend, sent, nxt, group))
                nbytes += sent.numel() * sent.element_size()
            parts.append(got)
        parts.append(x)
        if down:
            shape[dim] = down
            got = torch.zeros(shape, dtype=x.dtype, device=x.device)
            if nxt is not None:
                ops.append(dist.P2POp(dist.irecv, got, nxt, group))
            if prev is not None:
                sent = rows(x, 0, down)
                ops.append(dist.P2POp(dist.isend, sent, prev, group))
                nbytes += sent.numel() * sent.element_size()
            parts.append(got)
        out.append(parts)
    if ops:
        _collective(nbytes, lambda: [w.wait() for w in
                                     dist.batch_isend_irecv(ops)], xs[0])
    return [torch.cat(parts, dim) for parts in out]


def gather_rows(x: torch.Tensor, group, dim: int = 1) -> torch.Tensor:
    """The rows of every rank, in rank order along ``dim``, on every rank
    (the JAX package's tiled ``all_gather``), bit for bit: a slot
    all-reduce."""
    n, r = world_size(group), rank(group)
    words, (slots,) = _slots([tuple(x.shape)], [x.dtype], n, x.device)
    slots[r].copy_(x)
    all_reduce(words, group)
    shape = list(x.shape)
    shape[dim] *= n
    return slots.movedim(0, dim).reshape(shape)


def instance_norm_rows(x: torch.Tensor, group, eps: float = 1e-5
                       ) -> torch.Tensor:
    """``extractor.instance_norm`` of the whole image from this rank's rows
    of an NHWC tensor: the mean, then the mean of ``(x - mean)^2``, each
    averaged over the (equal) row blocks, in fp32."""
    n = world_size(group)
    x32 = x.float()
    mean = all_reduce(x32.mean(dim=(-3, -2), keepdim=True), group) / n
    var = all_reduce(((x32 - mean) ** 2).mean(dim=(-3, -2), keepdim=True),
                     group) / n
    return ((x32 - mean) * torch.rsqrt(var + eps)).to(x.dtype)


# ---------------------------------------------------------------------------
# The encoders on a block of rows
# ---------------------------------------------------------------------------


def halo_conv(conv: torch.nn.Conv2d, x: torch.Tensor, dtype, group
              ) -> torch.Tensor:
    """``conv`` (zero padding) of the whole image from this rank's rows of
    an NHWC tensor: halo rows from the neighbours, then the convolution
    with its column padding only. A k x k conv with padding p takes (p, p)
    halo rows at stride 1 and (p, k - 2 - p) at stride 2 (even row blocks);
    a 1 x 1 takes none."""
    k, s, p = conv.kernel_size[0], conv.stride[0], conv.padding[0]
    x = x.to(dtype)
    if k > 1:
        up, down = (p, p) if s == 1 else (p, max(k - 2 - p, 0))
        (x,) = halo([x], up, down, group)
    w = conv.weight.to(dtype)
    b = None if conv.bias is None else conv.bias.to(dtype)
    y = F.conv2d(x.permute(0, 3, 1, 2), w, b, s, (0, p))
    return y.permute(0, 2, 3, 1)


def encoder_rows(enc, x: torch.Tensor, group, norm_fn: str = "instance",
                 dtype=None) -> torch.Tensor:
    """A ``BasicEncoder`` (type "HR") on this rank's rows (F, Hloc, W, 3) of
    normalized frames -> its rows (F, Hloc/4, W/4, C) of the features, in
    ``dtype`` (the encoder's own by default). The image's H must be a
    multiple of 8 x the row ranks (even blocks through both stride-2
    convs). ``norm_fn``: the encoder's, "instance" or "none"."""
    if enc.type != "HR":
        raise ValueError("row sharding mirrors the HR encoder")
    if norm_fn == "instance":
        def norm(t):
            return instance_norm_rows(t, group)
    elif norm_fn == "none":
        def norm(t):
            return t
    else:
        raise ValueError(f"unsupported norm_fn {norm_fn!r} (instance/none)")
    dt = dtype or enc.dtype
    x = F.relu(norm(halo_conv(enc.conv1, x, dt, group)))
    for layer in (enc.layer1, enc.layer2):
        for block in layer:
            y = F.relu(norm(halo_conv(block.conv1, x, dt, group)))
            y = F.relu(norm(halo_conv(block.conv2, y, dt, group)))
            if block.downsample is not None:
                x = norm(halo_conv(block.downsample[0], x, dt, group))
            x = F.relu(x + y)
    return halo_conv(enc.conv2, x, dt, group)


# ---------------------------------------------------------------------------
# The rectified construction on bands of rect rows
# ---------------------------------------------------------------------------


def _translation(tx: float, ty, device) -> torch.Tensor:
    """The 3x3 homography translating by ``(tx, ty)``, made on ``device``:
    ``tx`` a Python number, ``ty`` a Python number or a 0-d tensor (a band
    start) copied on the device, so a CUDA graph can capture it."""
    T = torch.eye(3, dtype=torch.float32, device=device)
    T[0, 2].fill_(float(tx))
    if torch.is_tensor(ty):
        T[1, 2].copy_(ty)
    else:
        T[1, 2].fill_(float(ty))
    return T


def rect_band_warps(plan: rectify.RectPlan, band_h: int, geo, f_ref, f_src,
                    q0, fdt):
    """The stage-independent feature warps of each view onto its band of
    rect rows: ``f_ref`` (h, w, C) and ``f_src`` (V, h, w, C) are the
    1/8-scaled features, ``q0`` (V,) this rank's band starts on the
    device, ``geo`` from ``rectify.rect_geometry(need_grids=False)``.
    Returns per-view lists of (band_h, w_r, C) and (band_h, ws_r - col0, C)
    in ``fdt``, contiguous (the epiband kernel's layout)."""
    fr_bands, fs_bands = [], []
    for v in range(f_src.shape[0]):
        _, _, s_max_v = plan.view_params(v)
        col0 = plan.s_max - s_max_v
        q0v = q0[v].float()
        H_r = geo["H_ref_inv"][v] @ _translation(0.0, q0v, q0v.device)
        H_s = geo["H_src_inv"][v] @ _translation(col0, q0v, q0v.device)
        if plan.twopass:
            fr_b = rectify.warp_image_twopass(f_ref, H_r, band_h, plan.w_r)
            fs_b = rectify.warp_image_twopass(f_src[v], H_s, band_h,
                                              plan.ws_r - col0)
        else:
            fr_b = rectify.warp_image(
                f_ref, *rectify.homography_grid(H_r, band_h, plan.w_r))
            fs_b = rectify.warp_image(f_src[v], *rectify.homography_grid(
                H_s, band_h, plan.ws_r - col0))
        fr_bands.append(fr_b.to(fdt).contiguous())
        fs_bands.append(fs_b.to(fdt).contiguous())
    return fr_bands, fs_bands


def rect_banded_volume(plan: rectify.RectPlan, band_h: int, geo, fr_bands,
                       fs_bands, q0, row0: int, rows_ext: int, w: int,
                       origin_ext, n_hyp: int, incre: float,
                       zero_slab: bool, fdt) -> torch.Tensor:
    """(rows_ext, w, D) fp32: the SUM over the views of the rectified
    volume of this rank's extended rows (global rows ``row0`` on).

    Per view: the slab base and sigma on the band's rows (the origin warp
    reads ``origin_ext`` (rows_ext, w), edge-extended: see GHOST_RECT),
    the epiband construction on the band, and the back-warp into the
    block."""
    dev = origin_ext.device
    org = origin_ext[..., None]
    band = torch.arange(band_h, device=dev)
    acc = None
    for v in range(len(fr_bands)):
        _, _, s_max_v = plan.view_params(v)
        q0v = q0[v]
        q0f = q0v.float()
        rate_band = geo["rate"][v].index_select(0, q0v + band)
        sigma = (rate_band * incre).contiguous()
        base = None
        if not zero_slab:
            px, py = rectify.homography_grid(
                geo["H_ref_inv"][v] @ _translation(0.0, q0f, dev), band_h,
                plan.w_r)
            origin_band = rectify.warp_image(org, px, py - float(row0),
                                             mode="clamp")[..., 0]
            base = (rate_band * (origin_band - (n_hyp // 2) * incre)
                    ).contiguous()
        vol_band = epiband(fr_bands[v][None], fs_bands[v][None],
                           None if base is None else base[None],
                           sigma[None], n_hyp, s_max_v)[0]
        if plan.twopass:
            Hb = (_translation(0.0, -q0f, dev) @ geo["H_fwd"][v]
                  @ _translation(0.0, row0, dev))
            vol = rectify.warp_image_twopass(vol_band.to(fdt), Hb, rows_ext,
                                             w)
        else:
            wx, wy = rectify.homography_grid(
                geo["H_fwd"][v] @ _translation(0.0, row0, dev), rows_ext, w)
            vol = rectify.warp_image(vol_band.to(fdt), wx, wy - q0f)
        acc = vol if acc is None else acc + vol
    return acc


# ---------------------------------------------------------------------------
# The forward
# ---------------------------------------------------------------------------


class SpatialForward:
    """The row- or grid-sharded test-mode forward of one construction, for
    one rank: ``forward(model, images, poses, intrinsics, scale, q0)`` ->
    (1, h, w) scaled disparities on every rank, as ``model(images, poses,
    intrinsics, scale)`` returns.

    ``row_group``: the ``row`` axis through this rank; ``view_group``: the
    ``view`` axis of a grid, or None (every rank holds every view).
    ``plan`` None: the exact construction; a RectPlan (over all ``n_views``
    neighbours) with ``band_h``: the banded rectified one, whose band
    starts ``q0`` (n_row, n_views) int64 come with each call, on the
    device. The frame and view indices are made on the device at the first
    call and kept, so a CUDA graph can capture a later one."""

    def __init__(self, n_views: int, row_group, view_group=None,
                 plan: Optional[rectify.RectPlan] = None, band_h: int = 0):
        if plan is not None and not plan.ok:
            raise ValueError(f"plan not usable: {plan.reason}")
        nv = world_size(view_group)
        if n_views < nv:
            raise ValueError(f"{n_views} neighbours cannot be shared by "
                             f"{nv} view ranks: each needs one at least")
        self.n_views = n_views
        self.row_group = row_group
        self.view_group = view_group
        self.n_rows = world_size(row_group)
        self.views = (list(range(n_views)) if view_group is None
                      else shard_views(n_views, nv)[rank(view_group)])
        self.plan = None if plan is None else rectify.subplan(plan,
                                                              self.views)
        self.band_h = band_h
        self.ghost = GHOST if plan is None else GHOST_RECT
        self._index: Dict[torch.device, tuple] = {}

    def indices(self, device):
        """[0, 1 + each of this rank's views] and this rank's views, on
        ``device``."""
        device = torch.device(device)
        if device not in self._index:
            views = torch.tensor(self.views, device=device)
            ref = torch.zeros(1, dtype=views.dtype, device=device)
            self._index[device] = (torch.cat([ref, views + 1]), views)
        return self._index[device]

    def check(self, model, shape) -> None:
        """Raise if ``model`` and images of ``shape`` (B, N, H, W, 3) are
        outside the forward's scope."""
        B, N, H = shape[:3]
        n = self.n_rows
        if not model.test_mode:
            raise ValueError("the row-sharded forward is a test-mode path")
        if B != 1:
            raise ValueError("the row-sharded forward takes batch 1")
        if model.stride_factor != 4:
            raise ValueError("row sharding mirrors the HR encoder")
        if N - 1 != self.n_views:
            raise ValueError(f"{N - 1} neighbours, built for {self.n_views}")
        if H % (8 * n):
            raise ValueError(f"H={H} must be a multiple of 8 x {n} row ranks")
        if H // 4 // n < self.ghost:
            raise ValueError(f"{H // 4 // n} feature rows a rank < ghost "
                             f"margin {self.ghost}")
        if (self.plan is not None or self.view_group is not None) and \
                not model.mean_volume:
            raise ValueError("the banded rectified construction and the "
                             "grid take the mean aggregation")

    def __call__(self, model, images, poses, intrinsics, scale=None,
                 q0=None) -> torch.Tensor:
        with torch.no_grad():
            out = self.forward_rows(model, images, poses, intrinsics, scale,
                                    q0)
            return gather_rows(out, self.row_group, dim=1)

    def forward_rows(self, model, images, poses, intrinsics, scale=None,
                     q0=None) -> torch.Tensor:
        """This rank's rows (1, h/n, w) of the scaled disparities."""
        ctx = self.context(model, images, poses, intrinsics, scale, q0)
        g, rows_ext, w = self.ghost, ctx["rows_ext"], ctx["w"]
        inp, net, row_mask = ctx["inp"], ctx["net"], ctx["row_mask"]
        disp = torch.zeros((1, rows_ext, w, 1), dtype=torch.float32,
                           device=inp.device)
        for stage, (n_hyp, n_div, n_iters) in enumerate(model.cascade):
            n_hyp = model.auto_hyps(n_hyp)
            incre = 0.0025 / n_div
            # the last update changed the owned rows alone: the ghosts
            # come again from the neighbours before they set this stage's
            # slab origin (and through it the volume's ghost rows)
            disp, net = self.refresh(disp, net)
            origin = slab_origin(disp[..., 0][:, None], n_hyp, incre,
                                 shift=(stage == 0))
            with profiling.span(f"spatial.volume_stage{stage}", on=inp):
                vol = self.volume(ctx, origin, n_hyp, incre,
                                  zero_slab=(stage == 0))
            levels = (build_pyramid(vol, model.num_levels)
                      if model.lookup_impl != "pallas" else [vol])
            pyr = CorrPyramid(levels, origin, incre, n_hyp, model.num_levels)
            with profiling.span(f"spatial.iterations_stage{stage}",
                                on=inp):
                g_ctx = model.update_block.gru_ctx(inp, stage)
                Vv = vol.shape[1]
                for it in range(n_iters):
                    if it:
                        disp, net = self.refresh(disp, net)
                    zinv = disp[..., 0][:, None].expand(1, Vv, rows_ext, w)
                    corr = lookup(pyr, zinv, model.radius,
                                  impl=model.lookup_impl)
                    net, delta = model.update_block(
                        net, inp, disp, corr, stage, gru_ctx=g_ctx,
                        row_mask=row_mask)
                    disp = disp + delta
        out = disp[:, g:g + ctx["hloc"], :, 0]
        scale_t = ctx["scale"]
        return out if scale_t is None else out * scale_t

    def refresh(self, *xs) -> List[torch.Tensor]:
        """Each (1, rows_ext, ...) tensor of ``xs`` with its ghost rows
        taken again from the neighbours' owned rows."""
        g = self.ghost
        return halo([x[:, g:-g] for x in xs], g, g, self.row_group)

    def context(self, model, images, poses, intrinsics, scale=None,
                q0=None) -> dict:
        """The work before the stages on this rank: the encoders of its
        rows and the gathered features, then :meth:`prepare`'s context,
        with the GRU's ``inp`` and initial ``net`` on the extended rows,
        their ``row_mask``, this rank's ``hloc`` owned rows and the
        ``scale`` tensor (or None)."""
        self.check(model, images.shape)
        rg = self.row_group
        n, r = self.n_rows, rank(rg)
        _, _, H, W, _ = images.shape
        h, w = H // 4, W // 4
        hloc, g = h // n, self.ghost
        rows_ext, row0 = hloc + 2 * g, r * hloc - g
        dev = images.device

        frames_idx, _ = self.indices(dev)
        if self.view_group is not None:
            images, poses, intrinsics = (
                t.index_select(1, frames_idx)
                for t in (images, poses, intrinsics))
        n_frames = images.shape[1]
        poses = poses.float().clone()
        scale_t = None
        if scale is not None:
            scale_t = torch.as_tensor(scale, dtype=torch.float32,
                                      device=dev).reshape(1, 1, 1)
            poses[..., :3, 3] = poses[..., :3, 3] * scale_t
        intrinsics = intrinsics.float().clone()
        intrinsics[:, :, :2] = intrinsics[:, :, :2] / 4.0
        Hloc = H // n
        frames = (images[0, :, r * Hloc:(r + 1) * Hloc].float()
                  * (2.0 / 255.0) - 1.0)

        with profiling.span("spatial.encoders", on=frames):
            net_inp = encoder_rows(model.cnet, frames[:1], rg, "none")
            net = torch.tanh(net_inp[..., :model.dim_net])
            inp = torch.relu(net_inp[..., model.dim_net:])
            chunk = model.encoder_chunk or n_frames
            fmaps = torch.cat([
                encoder_rows(model.fnet, frames[i:i + chunk], rg, "instance")
                for i in range(0, n_frames, chunk)], 0)
            # the whole image's features: each rank's rows in the model's
            # dtype, then fp32 and 1/8, as the unsharded forward scales them
            fmaps = gather_rows(fmaps, rg, dim=1).float() / 8.0

        ctx = self.prepare(model, fmaps, poses, intrinsics, q0, row0,
                           rows_ext, h, w)
        gr = torch.arange(rows_ext, device=dev) + row0
        inp, net = halo([inp, net], g, g, rg)
        ctx.update(inp=inp, net=net, hloc=hloc, scale=scale_t,
                   row_mask=((gr >= 0) & (gr < h)).to(torch.float32)[
                       None, :, None, None])
        return ctx

    def prepare(self, model, fmaps, poses, intrinsics, q0, row0: int,
                rows_ext: int, h: int, w: int):
        """The stage-independent work: the reference's extended rows and the
        offset projections (exact), or the band warps (rectified)."""
        dev = fmaps.device
        n_frames = fmaps.shape[0]
        Vl = n_frames - 1
        ii = torch.zeros(Vl, dtype=torch.int64, device=dev)
        jj = torch.arange(1, n_frames, dtype=torch.int64, device=dev)
        ctx = dict(model=model, row0=row0, rows_ext=rows_ext, w=w)
        if self.plan is None:
            g = self.ghost
            a = row0 + g
            f_ref = F.pad(fmaps[0], (0, 0, 0, 0, g, g))[a:a + rows_ext]
            Pij = relative_projection(poses, intrinsics, ii, jj)
            # global rows: [x, y + row0, 1, d] = E(row0) [x, y, 1, d]
            E = torch.eye(4, dtype=Pij.dtype, device=dev)
            E[1, 2].fill_(float(row0))
            ctx.update(f_ref=f_ref[None, None].expand((1, Vl) + f_ref.shape),
                       f_src=fmaps[1:][None], Pij=Pij @ E)
        else:
            if q0 is None:
                raise ValueError("the banded rectified forward needs q0")
            _, views_idx = self.indices(dev)
            q0_loc = q0[rank(self.row_group)].to(dev).index_select(
                0, views_idx)
            geo = rectify.rect_geometry(poses, intrinsics, ii, jj, h, w,
                                        self.plan, need_grids=False)
            fr, fs = rect_band_warps(self.plan, self.band_h, geo,
                                     fmaps[0].to(model.dtype),
                                     fmaps[1:].to(model.dtype), q0_loc,
                                     model.dtype)
            ctx.update(geo=geo, fr=fr, fs=fs, q0=q0_loc)
        return ctx

    def volume(self, ctx, origin, n_hyp: int, incre: float,
               zero_slab: bool = False) -> torch.Tensor:
        """One stage's volume of the extended rows: (1, 1, rows_ext, w, D)
        with the mean over every view, or (1, V, rows_ext, w, D) per view
        (an exact ``(row,)`` forward of a model that keeps them)."""
        model = ctx["model"]
        grid = self.view_group is not None
        if self.plan is None:
            vol = build_corr_volume_from(
                ctx["f_ref"], ctx["f_src"], ctx["Pij"], origin, n_hyp,
                incre, model.hyp_chunk, mean_over_views=model.mean_volume,
                gather_dtype=model.dtype, view_sum=grid)
        else:
            vol = rect_banded_volume(
                self.plan, self.band_h, ctx["geo"], ctx["fr"], ctx["fs"],
                ctx["q0"], ctx["row0"], ctx["rows_ext"], ctx["w"],
                origin[0, 0], n_hyp, incre, zero_slab, model.dtype
                )[None, None]
            if not grid:
                vol = vol / len(self.views)
        if grid:
            vol = all_reduce(vol.contiguous(), self.view_group) / self.n_views
        return vol


def row_sharded_forward(model, images, poses, intrinsics, scale, mesh,
                        plan: Optional[rectify.RectPlan] = None,
                        bands=None) -> torch.Tensor:
    """The test-mode forward with the image rows over ``mesh``'s ``row``
    axis, and on a ``(row, view)`` grid the neighbours over its ``view``
    axis: (1, h, w) scaled disparities on every rank. ``plan``: a RectPlan
    selects the banded rectified construction, with ``bands`` = (q0,
    band_h) from ``rectify.plan_row_bands`` (made here from the poses when
    None)."""
    from cermvs_torch.parallel.mesh import row_group, view_group

    rg = row_group(mesh)
    if rg is None:
        raise ValueError("row_sharded_forward needs a mesh with a row axis")
    V = images.shape[1] - 1
    q0, band_h = None, 0
    if plan is not None:
        if bands is None:
            intr = intrinsics[0].double().cpu().numpy().copy()
            intr[..., :2, :] /= 4.0
            bands = rectify.plan_row_bands(
                poses[0].double().cpu().numpy(), intr, images.shape[2] // 4,
                images.shape[3] // 4, plan, world_size(rg), GHOST_RECT)
        q0, band_h = bands
        q0 = torch.as_tensor(q0, dtype=torch.int64, device=images.device)
    fwd = SpatialForward(V, rg, view_group(mesh), plan, band_h)
    return fwd(model, images, poses, intrinsics, scale, q0)

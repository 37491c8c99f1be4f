"""Rank-side work of tests/test_torch_parallel.py and
tests/test_torch_multiprocess.py, not a test module: the ranks of a
``cermvs_torch.parallel.dryrun.World`` call these functions, so this module
imports the port alone (the spawned ranks never import JAX).

Every function returns numpy arrays or plain Python values.
"""

import os

import numpy as np
import torch
import torch.distributed as dist

from cermvs_torch import config as pcfg
from cermvs_torch.models.raft import RAFT
from cermvs_torch.ops.rectify import pack_plan, unpack_plan
from cermvs_torch.parallel.infer import view_sharded_forward
from cermvs_torch.parallel.mesh import make_mesh, rank, world, world_size

# tests/multihost_worker.py's synthetic training set
SYNTH_HW, SYNTH_N, SYNTH_LEN = (32, 64), 3, 8


def seeded_model(model_kwargs, damp=None, test_mode=True, seed=0):
    """The port's RAFT from a seeded init, the delta heads' last conv
    damped ``damp``-fold (tests/test_torch_slice.py)."""
    model = RAFT(test_mode=test_mode, device="cpu",
                 generator=torch.Generator().manual_seed(seed),
                 **model_kwargs)
    if damp:
        with torch.no_grad():
            for i in range(len(model.cascade)):
                getattr(model.update_block, f"delta{i}")[2].weight.mul_(damp)
    return model


def row_forward(model_kwargs, damp, images, poses, intr, scale, n_view=1,
                plan_vec=None):
    """``spatial.row_sharded_forward`` of the port's seeded model over a
    ``(row,)`` mesh of the world, or a ``(row, view)`` grid with ``n_view``
    view ranks: the disparities, each rank's rows and views. ``plan_vec``:
    a packed plan selecting the banded rectified construction (its bands
    planned by the port)."""
    from cermvs_torch.parallel.mesh import make_row_mesh
    from cermvs_torch.parallel.spatial import row_sharded_forward

    model = seeded_model(model_kwargs, damp)
    plan = (None if plan_vec is None
            else unpack_plan(plan_vec, images.shape[1] - 1))
    mesh = make_row_mesh(n_view=n_view)
    out = row_sharded_forward(model, torch.from_numpy(images),
                              torch.from_numpy(poses),
                              torch.from_numpy(intr),
                              torch.as_tensor(scale, dtype=torch.float32),
                              mesh, plan=plan)
    return out.numpy()


def row_runner(model_kwargs, damp, images, poses, intr, construction):
    """``InferenceRunner`` of the seeded model under a ``(row,)`` mesh of
    the world: its mesh flags, ``shape_multiple``, the route of one
    ``submit`` with the band height, starts and packed plan of a banded
    rectified one, and the disparities."""
    from cermvs_torch.parallel.mesh import make_row_mesh
    from cermvs_torch.pipeline.inference import InferenceRunner

    runner = InferenceRunner(model=seeded_model(model_kwargs, damp),
                             mesh=make_row_mesh(), construction=construction,
                             device="cpu")
    r = runner.route(images[None], poses[None], intr[None], [1.0])
    disp = runner.forward(r)
    out = {"row_mesh": runner.row_mesh, "grid_mesh": runner.grid_mesh,
           "shape_multiple": runner.shape_multiple, "path": r.path,
           "disp": disp.numpy()}
    if r.key is not None:
        plan, band_h = r.key
        out.update(band_h=band_h, q0=r.q0.numpy(),
                   plan=pack_plan(plan, images.shape[0] - 1))
    return out


def encoder_rows(model_kwargs, frames, norm_fn):
    """``spatial.encoder_rows`` of the seeded model's fnet ("instance") or
    cnet ("none") on this rank's rows of ``frames`` (F, H, W, 3): its rows
    of the features."""
    from cermvs_torch.parallel.spatial import encoder_rows as enc_rows

    model = seeded_model(model_kwargs)
    n, r = world_size(world()), rank(world())
    rows = frames.shape[1] // n
    x = torch.from_numpy(frames[:, r * rows:(r + 1) * rows])
    enc = model.fnet if norm_fn == "instance" else model.cnet
    with torch.no_grad():
        return enc_rows(enc, x, world(), norm_fn).numpy()


def sharded_forward(model_kwargs, damp, images, poses, intr, scale,
                    plan_vec=None, rect_views=None):
    """``view_sharded_forward`` over a (1, world) mesh of the port's seeded
    model: the disparities and this rank's views. ``plan_vec``: a packed
    plan (either package's ``pack_plan``)."""
    model = seeded_model(model_kwargs, damp)
    n_plan = images.shape[1] - 1 if rect_views is None else len(rect_views)
    plan = None if plan_vec is None else unpack_plan(plan_vec, n_plan)
    mesh = make_mesh(1, world_size(world()))
    out = view_sharded_forward(model, torch.from_numpy(images),
                               torch.from_numpy(poses),
                               torch.from_numpy(intr),
                               torch.as_tensor(scale, dtype=torch.float32),
                               mesh, plan=plan, rect_views=rect_views)
    return out.numpy()


class Synth:
    """Deterministic-by-index scenes with per-sample baseline jitter, so
    the ranks' local plans differ (tests/multihost_worker.py's)."""

    def __len__(self):
        return SYNTH_LEN

    def __getitem__(self, i):
        H, W = SYNTH_HW
        rng = np.random.RandomState(100 + i)
        K = np.array([[40.0, 0, W / 2], [0, 40.0, H / 2], [0, 0, 1]],
                     np.float32)
        poses = np.tile(np.eye(4, dtype=np.float32), (SYNTH_N, 1, 1))
        for k, bx in enumerate([0.0, 1.2 + 0.05 * i, -1.6 - 0.03 * i]):
            poses[k, 0, 3] = -bx
        return {
            "images": (rng.rand(SYNTH_N, H, W, 3) * 255).astype(np.float32),
            "depths": (rng.rand(SYNTH_N, H, W) * 20 + 20).astype(np.float32),
            "poses": poses,
            "intrinsics": np.tile(K, (SYNTH_N, 1, 1)),
        }


def synth_loader(batch_size=4, process_shard=None, **kw):
    from cermvs_torch.data.loader import DataLoader

    return DataLoader(Synth(), batch_size=batch_size, shuffle=True,
                      drop_last=True, num_workers=0, seed=0,
                      process_shard=process_shard)


def train_synth(outdir, data_parallel=True, num_steps=3):
    """``train()`` on the synthetic set (batch 4, rectified, fp32, the
    cascade of tests/multihost_worker.py), data parallel over the default
    group or alone; also the plan of this rank's share of the first batch
    and the union the ranks exchange for it. Returns the final weights,
    flat, and the packed plans."""
    import cermvs_torch.data as data_mod
    from cermvs_torch.training.train import (exchange_plan, plan_batch,
                                             train)

    pcfg.clear_config()
    pcfg.bind_parameter("RAFT.cascade", ((4, 64, 1),))
    pcfg.bind_parameter("RAFT.dtype", "float32")
    pcfg.bind_parameter("RAFT.hyp_chunk", 4)
    loader_fn = data_mod.get_train_data_loader
    data_mod.get_train_data_loader = synth_loader
    r, n = rank(world()), world_size(world())
    out = {}
    try:
        if data_parallel:
            first = next(iter(synth_loader(4, process_shard=(r, n))))
            local = plan_batch(first, 4)
            out["plan_local"] = pack_plan(local, SYNTH_N - 1)
            out["plan_union"] = pack_plan(
                exchange_plan(local, SYNTH_N - 1, world()), SYNTH_N - 1)
        state = train(name=f"mp{r}", batch_size=4, num_steps=num_steps,
                      SAVE_FREQ=10 ** 6, resume=False, log_every=1000,
                      checkpoint_dir=os.path.join(outdir, f"ckpt{r}"),
                      run_dir=os.path.join(outdir, f"runs{r}"),
                      data_parallel=data_parallel, construction="rectified",
                      device="cpu")
    finally:
        data_mod.get_train_data_loader = loader_fn
        pcfg.clear_config()
    out["weights"] = torch.cat([p.detach().reshape(-1)
                                for p in state.model.parameters()]).numpy()
    out["step"] = state.step
    out["graphs"] = state.runner.graphs
    out["grouped"] = state.runner.group is not None
    return out


def dp_step(model_kwargs, damp, batch, num_steps):
    """One data-parallel train step of the port's seeded model on this
    rank's share of ``batch`` (sample ``rank`` of each ``world``), exact:
    the metrics and the new weights as a state dict of numpy arrays."""
    from cermvs_torch.training.step import (batch_to_device, init_state,
                                            train_step)

    model = seeded_model(model_kwargs, damp, test_mode=False)
    state = init_state(model, num_steps=num_steps)
    r, n = rank(world()), world_size(world())
    local = {k: v[r::n] for k, v in batch.items()}
    metrics = train_step(state, batch_to_device(local, "cpu"), 0.5,
                         group=dist.group.WORLD)
    return metrics, {k: v.numpy().copy()
                     for k, v in model.state_dict().items()}


def fusion_two_ranks(loader_dir, out_dir):
    """``fusion()`` of the scene under ``loader_dir`` with ``multihost``
    over the default group; the path of the merged cloud."""
    from cermvs_torch.parallel.dryrun import FusionLoader
    from cermvs_torch.pipeline.fusion import fusion

    return str(fusion(FusionLoader(loader_dir), out_dir, suffix="", glb=0.25,
                      rescale=1, tot_iter=4, view_batch=0, device="cpu"))


def skip_ghost_refresh(skip):
    """A planted fault, on this rank until called with ``skip`` False: the
    row-sharded forward keeps its stale ghost rows where it should take
    them again from its neighbours before each stage and iteration."""
    from cermvs_torch.parallel.spatial import SpatialForward

    if skip:
        _PLANTED.setdefault("refresh", SpatialForward.refresh)
        SpatialForward.refresh = lambda self, *xs: list(xs)
    elif "refresh" in _PLANTED:
        SpatialForward.refresh = _PLANTED.pop("refresh")


# what skip_ghost_refresh replaced, to put back
_PLANTED = {}


def halo_both_ways(seed):
    """``spatial.halo``'s two forms on the default group (gloo, host
    tensors): each rank's seeded rows of an fp32 and a bf16 tensor, with
    (up, down) halos of (1, 1), (1, 0), (0, 2) and (3, 1) rows, through the
    send/recv batch and through the slot all-reduce: a list of (p2p, slots)
    pairs of numpy arrays (bf16 as fp32)."""
    from cermvs_torch.parallel.spatial import _halo_p2p, _halo_slots

    g = torch.Generator().manual_seed(seed + rank(world()))
    xs = [torch.randn((1, 5, 3, 2), generator=g),
          torch.randn((1, 5, 4), generator=g).to(torch.bfloat16)]
    out = []
    for up, down in ((1, 1), (1, 0), (0, 2), (3, 1)):
        p2p = _halo_p2p(xs, up, down, dist.group.WORLD, 1)
        slots = _halo_slots(xs, up, down, dist.group.WORLD, 1)
        out += [(a.float().numpy(), b.float().numpy())
                for a, b in zip(p2p, slots)]
    return out

"""Process groups and device meshes.

The JAX package runs one process that owns a mesh of devices with the axes
``("data", "view")``. PyTorch runs one process per device: a rank of a
process group, with collectives between ranks. A mesh here is a
``torch.distributed.device_mesh.DeviceMesh`` with the same axis names over
the ranks of the default group, and wherever the JAX package reduces over a
mesh axis, the port reduces over that axis's process group:

  * ``psum`` / ``pmean``: ``all_reduce(SUM)``, then a division;
  * ``pmax``: ``all_reduce(MAX)``;
  * ``multihost_utils.process_allgather``: :func:`process_allgather`.

``data`` carries data-parallel training (``training/train.py``), ``view``
the neighbour views of view-sharded inference (``parallel/infer.py``),
``row`` the image rows of row-sharded inference (``parallel/spatial.py``):
a ``(row,)`` mesh (:func:`make_row_mesh`), or a ``(row, view)`` grid with
the views over its second axis. With no process group initialised every
entry point runs on its own, as it always did.

CUDA graphs: an NCCL collective can be captured once its communicator
exists (:func:`initialize_distributed` makes it eagerly); a gloo collective
cannot (:func:`collectives_capturable`), so the runners step eagerly under a
gloo group.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

AXES = ("data", "view")
ROW_AXES = ("row",)
GRID_AXES = ("row", "view")
MESHES = (AXES, ROW_AXES, GRID_AXES)


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank(group=None) -> int:
    """This process's rank in ``group``; 0 for None (this process alone)."""
    return 0 if group is None else dist.get_rank(group)


def world_size(group=None) -> int:
    """The ranks in ``group``; 1 for None (this process alone)."""
    return 1 if group is None else dist.get_world_size(group)


def world():
    """The default group, or None when no process group is initialised."""
    return dist.group.WORLD if is_initialized() else None


def local_device(device="cuda") -> torch.device:
    """``device`` with this process's card: ``cuda:LOCAL_RANK`` for a bare
    "cuda" (torchrun sets ``LOCAL_RANK``; the current card without it)."""
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None:
        return device
    if "LOCAL_RANK" in os.environ:
        return torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    return torch.device("cuda", torch.cuda.current_device())


def initialize_distributed(device="cuda", backend: Optional[str] = None,
                           store=None, rank: Optional[int] = None,
                           world_size: Optional[int] = None,
                           init_method: Optional[str] = None
                           ) -> torch.device:
    """Initialise the default process group and return this rank's device.

    Under ``torchrun`` (``RANK`` and ``WORLD_SIZE`` in the environment) the
    group comes from ``env://``; otherwise from ``store`` or ``init_method``
    with ``rank`` and ``world_size``. With none of these, and no group yet,
    nothing is initialised (one process, as the JAX package's counterpart
    does nothing on one host). ``backend``: NCCL for a CUDA device, gloo on
    the CPU. Under NCCL the card is made current and passed as
    ``device_id``, so the communicator is made now, before any graph
    capture. Returns at once when a group exists."""
    device = local_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if is_initialized():
        return device
    env = "RANK" in os.environ and "WORLD_SIZE" in os.environ
    if store is None and init_method is None and not env:
        return device
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    kwargs = {}
    if store is not None:
        kwargs.update(store=store, rank=rank, world_size=world_size)
    else:
        kwargs.update(init_method=init_method or "env://")
        if rank is not None:
            kwargs.update(rank=rank, world_size=world_size)
    if backend == "nccl":
        kwargs["device_id"] = device
    dist.init_process_group(backend, **kwargs)
    return device


def make_mesh(n_data: Optional[int] = None, n_view: int = 1):
    """A ``(data, view)`` DeviceMesh over every rank of the default group:
    ``n_data`` defaults to the world size over ``n_view``. A "cuda" mesh
    under NCCL, a "cpu" one under gloo (whose collectives take CUDA tensors
    all the same)."""
    from torch.distributed.device_mesh import init_device_mesh

    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    n = world_size(world())
    if n_data is None:
        n_data = n // n_view
    if n_data * n_view != n:
        raise ValueError(f"mesh {n_data}x{n_view} != {n} ranks")
    return init_device_mesh(device_type, (n_data, n_view),
                            mesh_dim_names=AXES)


def make_row_mesh(n_row: Optional[int] = None, n_view: int = 1):
    """A ``(row,)`` DeviceMesh over every rank of the default group, or with
    ``n_view`` > 1 a ``(row, view)`` grid (``n_row`` defaults to the world
    size over ``n_view``): the meshes the JAX package's ``InferenceRunner``
    takes as ``row_mesh`` and ``grid_mesh``."""
    from torch.distributed.device_mesh import init_device_mesh

    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    n = world_size(world())
    if n_row is None:
        n_row = n // n_view
    if n_row * n_view != n:
        raise ValueError(f"mesh {n_row}x{n_view} != {n} ranks")
    if n_view == 1:
        return init_device_mesh(device_type, (n_row,),
                                mesh_dim_names=ROW_AXES)
    return init_device_mesh(device_type, (n_row, n_view),
                            mesh_dim_names=GRID_AXES)


def check_mesh(mesh, kinds=MESHES, what: str = "a mesh"):
    """``mesh`` if it is a DeviceMesh over every rank whose axes are one of
    ``kinds``; else a ValueError naming the meshes taken (``what``: the
    mesh's role, for the message)."""
    from torch.distributed.device_mesh import DeviceMesh

    names = mesh.mesh_dim_names if isinstance(mesh, DeviceMesh) else None
    if names not in kinds:
        raise ValueError(
            f"{what} must be a DeviceMesh with the axes "
            f"{' or '.join(map(str, kinds))}, got "
            f"{names or type(mesh).__name__} (parallel.make_mesh and "
            f"make_row_mesh make them)")
    if mesh.size() != world_size(world()):
        raise ValueError(f"the mesh spans {mesh.size()} of "
                         f"{world_size(world())} ranks")
    return mesh


def view_group(mesh):
    """The process group of the mesh's ``view`` axis through this rank;
    None for a ``(row,)`` mesh, whose ranks each hold every view."""
    if check_mesh(mesh).mesh_dim_names == ROW_AXES:
        return None
    return mesh.get_group("view")


def row_group(mesh):
    """The process group of the mesh's ``row`` axis through this rank; None
    for a ``(data, view)`` mesh, whose ranks each hold every row."""
    if check_mesh(mesh).mesh_dim_names == AXES:
        return None
    return mesh.get_group("row")


def mesh_group(mesh):
    """The process group of every rank of a ``(data, view)`` mesh (the
    default group). Fusion shards its reference views over those ranks, as
    the JAX package's does over ``(data, view)``; a mesh with a ``row``
    axis shards rows of a forward, and fusion has none to shard."""
    check_mesh(mesh, (AXES,), "fusion's mesh (reference views are sharded "
               "over (data, view) only, as in the JAX package)")
    return dist.group.WORLD


def collectives_capturable(group) -> bool:
    """Whether a CUDA graph can hold the collectives of ``group`` (None: no
    collectives): NCCL's can, once its communicator exists; gloo's cannot."""
    return group is None or dist.get_backend(group) == "nccl"


def process_allgather(x, group) -> np.ndarray:
    """Each rank's host array ``x``, stacked in rank order on every rank of
    ``group``: the JAX package's ``multihost_utils.process_allgather``.
    Through ``all_gather_object``, which takes host data under NCCL
    (through this rank's card) and gloo alike."""
    x = np.asarray(x)
    out = [None] * world_size(group)
    dist.all_gather_object(out, x, group=group)
    return np.stack(out)


def barrier(group) -> None:
    """Wait for every rank of ``group``: a tiny all-gather, which works
    under NCCL and gloo without a device to name."""
    process_allgather(np.zeros(1), group)

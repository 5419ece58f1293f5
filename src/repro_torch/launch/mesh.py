"""DP and TP process groups; counterpart of ``repro.launch.mesh``.

Where the reference builds a ``jax`` mesh, the port starts a
``torch.distributed`` group per process and builds one process group per
mesh axis from it: :func:`mesh_axes` lays the ranks out as
``jax.make_mesh((dp, tp), ("data", "model"))`` does, ``model`` innermost,
so rank = dp_idx * tp + tp_idx.  :func:`make_production_mesh` gives the
reference's production layouts, and :func:`fake_world` joins a
process-local fake group of a layout's world size, which the dry run
(``launch/dryrun.py``) builds its groups in without a card or a socket.
Nothing here runs when the module is imported.
"""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import math
import os

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Layout:
    """A mesh without devices: its axis sizes, outermost first, and the
    reference's axis names (the last is always ``model``, the TP axis)."""
    shape: tuple
    axis_names: tuple

    @property
    def axis_sizes(self) -> dict:
        return dict(zip(self.axis_names, self.shape))


def layout(mesh) -> Layout:
    """A :class:`Layout` of ``mesh``: a Layout, or a ``(dp..., tp)`` tuple
    named as the reference names its meshes (``("data", "model")``,
    ``("pod", "data", "model")``)."""
    if isinstance(mesh, Layout):
        return mesh
    shape = tuple(int(v) for v in mesh)
    names = {2: ("data", "model"), 3: ("pod", "data", "model")}.get(
        len(shape))
    if names is None:
        raise ValueError(f"a mesh layout is (data, model) or (pod, data, "
                         f"model), got {shape}")
    return Layout(shape, names)


def make_production_mesh(*, multi_pod: bool = False) -> Layout:
    """The reference's production layout: 16 x 16 (``data``, ``model``),
    or 2 x 16 x 16 (``pod``, ``data``, ``model``) with ``multi_pod``."""
    return layout((2, 16, 16) if multi_pod else (16, 16))


@contextlib.contextmanager
def fake_world(world: int, rank: int = 0):
    """Join a process-local fake group of ``world`` ranks as ``rank`` for
    the duration of the block, then leave it.  Its collectives move no
    data and touch no card and no socket; ``new_group`` and so
    :func:`mesh_axes` work in it as in a real group.  It serves CPU and
    ``meta`` tensors (a coalesced send and receive asks its device's
    backend).  The fake backend is a torch-internal module, imported here
    and nowhere else."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized")
    dist.init_process_group("cpu:fake,meta:fake", store=FakeStore(),
                            rank=rank, world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def backend_for(world: int, device: str = "cuda") -> str:
    """gloo when ranks share a card (NCCL refuses that) or run on the CPU;
    NCCL with one rank per card."""
    if device == "cpu" or world > torch.cuda.device_count():
        return "gloo"
    return "nccl"


def init_process(rank: int, world: int, addr: str, *, device: str = "cuda",
                 timeout_s: float = 600.0) -> str:
    """Join the default group at ``addr`` (``tcp://host:port``); returns
    the backend.  With one rank per card, rank r uses card r; when ranks
    share, every rank uses card 0.  On the CPU the ranks share the host's
    cores, each taking its share of the threads."""
    backend = backend_for(world, device)
    if device == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    else:
        torch.cuda.set_device(rank if backend == "nccl" else 0)
    dist.init_process_group(backend, init_method=addr, world_size=world,
                            rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return backend


def make_groups(shape: "tuple[int, ...]") -> tuple:
    """The DP process groups of a ``shape = (outer, ..., inner)`` layout of
    the default group's ranks (rank = (outer, ..., inner)-major index),
    outermost first, as ``ShardCtx.dp_axes`` takes them.  A single axis is
    the default group itself.  Every rank must call this, in the same
    order, with the same shape."""
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"layout {shape} needs {math.prod(shape)} ranks, "
                         f"the group has {world}")
    if len(shape) == 1:
        return (None,)
    return _axis_groups(shape)


def _axis_groups(shape: "tuple[int, ...]") -> tuple:
    """One process group per axis of ``shape`` (every rank's own group of
    that axis), outermost first."""
    world = dist.get_world_size()
    rank = dist.get_rank()
    groups = []
    strides = [math.prod(shape[i + 1:]) for i in range(len(shape))]
    for ax, (n, stride) in enumerate(zip(shape, strides)):
        mine = None
        # one group per combination of the other axes' indices
        for base in range(world):
            if (base // stride) % n:
                continue                  # not the axis-0 member
            members = [base + j * stride for j in range(n)]
            g = dist.new_group(members)
            if rank in members:
                mine = g
        groups.append(mine)
    return tuple(groups)


def mesh_axes(shape: "tuple[int, ...]") -> "tuple[tuple, object]":
    """(dp_axes, tp_axis) of a ``shape = (dp..., tp)`` layout of the
    default group's ranks, the TP axis innermost (the reference's
    ``mesh_axes`` contract: the last axis is ``model``): the DP process
    groups outermost first, as ``ShardCtx.dp_axes`` takes them, and the TP
    process group, as ``ShardCtx.tp_axis`` takes it.  With tp = 1 the DP
    groups are :func:`make_groups`' and the TP group is ``None`` (no
    collective runs over it).  Every rank must call this, in the same
    order, with the same shape."""
    shape = tuple(int(v) for v in shape)
    if len(shape) < 2:
        raise ValueError(f"a mesh layout is (dp..., tp), got {shape}")
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"layout {shape} needs {math.prod(shape)} ranks, "
                         f"the group has {world}")
    if shape[-1] == 1:
        return make_groups(shape[:-1]), None
    groups = _axis_groups(shape)
    return tuple(groups[:-1]), groups[-1]

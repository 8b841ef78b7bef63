"""Device meshes over ``torch.distributed`` (twin of
``ganode_tpu/parallel/mesh.py``): the process group, the mesh and the
placements of batches and parameters.

JAX runs one program over a mesh of devices and GSPMD inserts the
collectives. Here each rank is a process with a device of its own (or, over
gloo, a share of one card), and a JAX mesh becomes a
``torch.distributed.device_mesh.DeviceMesh`` over the initialised process
group, with JAX's axis names: ``"data"``, ``"seq"``, ``"model"``,
``"expert"``, ``"pipe"``. A placement is a ``DTensor`` over that mesh whose
local tensor is this rank's shard (``Sharding`` keeps JAX's
``PartitionSpec`` beside it). The computation reads the local shards; the
training step that makes the per-rank work add up to the single-device
step on the global batch is ``parallel/step.py``.

Transport rule (``init_distributed``): NCCL where each rank has a card of
its own; more ranks than cards only when the caller names
``backend="gloo"``. The port never picks gloo on its own. A rank's device is
``cuda:{local_rank}`` under NCCL; under gloo it is the device the caller
asked for (``cpu``, or the card ``local_rank`` modulo the cards present).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .. import resolve_device
from . import comm

AXES = ("data", "seq", "model", "expert", "pipe")
_RANK_DEVICE: dict = {}


def rank_device(device="cuda", backend: str = "nccl",
                local_rank: Optional[int] = None) -> torch.device:
    """The device of this rank under the transport rule."""
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', not {backend!r}")
    dev = resolve_device(device)
    if local_rank is None:
        local_rank = int(os.environ.get("LOCAL_RANK", 0))
    if dev.type == "cpu":
        if backend == "nccl":
            raise ValueError("NCCL needs a card per rank; on the CPU name "
                             "backend='gloo'")
        return dev
    count = torch.cuda.device_count()
    if backend == "nccl":
        if local_rank >= count:
            raise RuntimeError(
                f"NCCL needs a card per rank: local rank {local_rank} on a "
                f"host with {count} card(s); name backend='gloo' to share "
                "cards between ranks")
        return torch.device("cuda", local_rank)
    return torch.device("cuda", local_rank % count)


def init_distributed(backend: str, device="cuda", *,
                     init_method: Optional[str] = None,
                     rank: Optional[int] = None,
                     world_size: Optional[int] = None) -> torch.device:
    """Initialise the default process group and return this rank's device
    (``rank_device``). Under ``torch.distributed.run`` the rank, the world
    size and the rendezvous come from the environment; otherwise pass
    ``init_method`` (``file://...`` or ``tcp://localhost:<port>``),
    ``rank`` and ``world_size``."""
    dev = rank_device(device, backend)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        torch.zeros((), device=dev)  # the context exists before the mesh
    kw = {}
    if init_method is not None:
        kw = {"init_method": init_method, "rank": rank,
              "world_size": world_size}
    if backend == "nccl":
        kw["device_id"] = dev
    dist.init_process_group(backend, **kw)
    _RANK_DEVICE["device"] = dev
    return dev


def current_device() -> torch.device:
    """The device ``init_distributed`` gave this rank (the CPU if the group
    was initialised otherwise)."""
    return _RANK_DEVICE.get("device", torch.device("cpu"))


def make_mesh(n_devices: Optional[int] = None,
              axis_names: Sequence[str] = ("data",),
              shape: Optional[Sequence[int]] = None):
    """A ``DeviceMesh`` over the initialised process group: 1-D
    (``("data",)``, all ranks) by default; pass ``shape=(d, m)`` with two
    axis names for a 2-D mesh. Raises without a process group, or when the
    mesh's size is not the group's."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs an initialised process group "
            "(parallel.init_distributed, or torch.distributed.run)")
    unknown = [a for a in axis_names if a not in AXES]
    if unknown or len(set(axis_names)) != len(axis_names):
        raise ValueError(f"mesh axes {list(axis_names)}: each one of {AXES}")
    world = dist.get_world_size()
    if shape is None:
        if len(axis_names) != 1:
            raise ValueError("shape required for multi-axis meshes")
        shape = (n_devices or world,)
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axis_names):
        raise ValueError(f"shape {shape} for axes {list(axis_names)}")
    if int(np.prod(shape)) != world or (n_devices and n_devices != world):
        raise ValueError(
            f"a mesh of {int(np.prod(shape))} ranks {dict(zip(axis_names, shape))}"
            f" over a process group of {world}")
    return init_device_mesh(current_device().type, shape,
                            mesh_dim_names=tuple(axis_names))


def axis_size(mesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_index(mesh, axis: str) -> int:
    return mesh.get_local_rank(axis)


# ----------------------------------------------------------------- placements

@dataclasses.dataclass(frozen=True)
class Sharding:
    """JAX's ``NamedSharding(mesh, PartitionSpec(*spec))``: ``spec[d]`` names
    the mesh axis that splits tensor dim ``d`` (None: not split)."""

    mesh: object
    spec: Tuple[Optional[str], ...]

    @property
    def placements(self):
        from torch.distributed.tensor import Replicate, Shard

        out = []
        for axis in self.mesh.mesh_dim_names:
            dims = [d for d, a in enumerate(self.spec) if a == axis]
            out.append(Shard(dims[0]) if dims else Replicate())
        return out

    def local_slice(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's shard of the global ``x``."""
        for d, axis in enumerate(self.spec):
            if axis is not None:
                n = axis_size(self.mesh, axis)
                if x.shape[d] % n:
                    raise ValueError(f"dim {d} of {tuple(x.shape)} does not "
                                     f"split over {axis!r} of size {n}")
                k = x.shape[d] // n
                x = x.narrow(d, axis_index(self.mesh, axis) * k, k)
        return x


def _as_tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.ascontiguousarray(x))


def _dtensor(local: torch.Tensor, sharding: Sharding, shape):
    from torch.distributed.tensor import DTensor

    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(local, sharding.mesh, sharding.placements,
                              run_check=False, shape=torch.Size(shape),
                              stride=stride)


def place(x, sharding: Sharding):
    """The global host array or tensor ``x`` as a DTensor whose local part
    (on this rank's device) is this rank's shard; no communication."""
    x = _as_tensor(x)
    local = sharding.local_slice(x).contiguous().to(current_device())
    return _dtensor(local, sharding, x.shape)


def from_process_local(local, sharding: Sharding):
    """The multi-host feeding path: ``local`` is this rank's stripe along the
    ``"data"``-split dim (ranks contribute in ``"data"`` order); dims split
    over other axes are cut here. -> the rank's shard of the global
    array."""
    local = _as_tensor(local)
    shape = list(local.shape)
    cut = Sharding(sharding.mesh, tuple(
        None if a == "data" else a for a in sharding.spec))
    for d, a in enumerate(sharding.spec):
        if a == "data":
            shape[d] *= axis_size(sharding.mesh, "data")
    part = cut.local_slice(local).contiguous().to(current_device())
    return _dtensor(part, sharding, shape)


def _tree_map(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def data_sharding(mesh, batch_axis: int = 0, ndim: int = 2) -> Sharding:
    """``batch_axis`` split over 'data', the rest replicated."""
    spec = [None] * ndim
    spec[batch_axis] = "data"
    return Sharding(mesh, tuple(spec))


def shard_batch(batch, mesh, batch_axis: int = 0):
    """Place (a tree of) global host arrays with the batch axis split over
    'data'."""
    return _tree_map(lambda _, x: place(
        x, data_sharding(mesh, batch_axis, np.ndim(x))), batch)


def shard_batch_seq(videos, mesh, *, batch_axis: int = 1, time_axis: int = 2,
                    data_axis: str = "data", seq_axis: str = "seq"):
    """Clips split over the batch ('data') and frame ('seq') axes: the
    sequence-parallel layout for long clips (the frame axis plays the role
    of context parallelism in this model family)."""
    def one(_, x):
        spec = [None] * np.ndim(x)
        spec[batch_axis] = data_axis
        spec[time_axis] = seq_axis
        return place(x, Sharding(mesh, tuple(spec)))
    return _tree_map(one, videos)


def replicate(tree, mesh):
    """Every tensor of ``tree`` made equal to rank 0's (a broadcast over the
    mesh's ranks) and placed replicated."""
    def one(_, x):
        t = _as_tensor(x).to(current_device()).contiguous().clone()
        comm.broadcast_(t, 0)
        return _dtensor(t, Sharding(mesh, (None,) * t.ndim), t.shape)
    return _tree_map(one, tree)


def shard_params_tp(params, mesh, *, axis: str = "model",
                    min_elements: int = 1 << 16):
    """Tensor-parallel placement: the last (output-feature) dim of every
    parameter with at least ``min_elements`` elements whose last dim divides
    the axis' size is split over ``axis``; everything else is replicated. A
    placement only: the runner computes nothing with TP, as in JAX."""
    size = axis_size(mesh, axis)

    def one(_, x):
        x = _as_tensor(x)
        spec = [None] * x.ndim
        if x.ndim >= 2 and x.numel() >= min_elements and x.shape[-1] % size == 0:
            spec[-1] = axis
        return place(x, Sharding(mesh, tuple(spec)))
    return _tree_map(one, params)


def is_expert_leaf(name: str) -> bool:
    """A stacked expert parameter (``nn/moe.py``'s ``expert_*``), by the
    last component of its (dotted) name."""
    return str(name).rsplit(".", 1)[-1].startswith("expert_")


def shard_params_ep(params, mesh, *, axis: str = "expert"):
    """Expert-parallel placement: leaves named ``expert_*`` with a leading
    expert axis that divides the mesh axis are split over ``axis``;
    everything else is replicated. Apply to the Adam moments too: EP's
    payoff is that each rank holds only its experts' weights and moments
    (``step.shard_state_ep`` does both for a training state)."""
    size = axis_size(mesh, axis)

    def one(path, x):
        x = _as_tensor(x)
        spec = [None] * x.ndim
        if (path and is_expert_leaf(path[-1]) and x.ndim >= 1
                and x.shape[0] % size == 0):
            spec[0] = axis
        return place(x, Sharding(mesh, tuple(spec)))
    return _tree_map(one, params)


def data_parallel_apply(fn, x: torch.Tensor, mesh, axis: str = "data"):
    """``fn(x)`` as one device computes it, each rank of ``axis`` on its
    stripe of ``x``'s leading axis: batch statistics (train-mode BatchNorm,
    the int8 trunk's dynamic activation scales) over the whole batch, the
    stripes gathered back in order. For pure per-sample maps, such as the
    int8 serving trunk (``ops.quant.int8_trunk_apply``), that JAX shards
    over a data mesh by placing its input."""
    group = mesh.get_group(axis)
    n = comm.group_size(group)
    if x.shape[0] % n:
        raise ValueError(f"batch {x.shape[0]} does not split over {axis}={n}")
    k = x.shape[0] // n
    local = x.narrow(0, axis_index(mesh, axis) * k, k)
    with comm.batch_stats_over(group):
        y = fn(local)
    return comm.all_gather(y, group, dim=0)


def make_parallel_step(trainer, mesh):
    """The trainer's step for the mesh -> ``(step_fn, place_state,
    place_batch)``: ``metrics = step_fn(place_state(state),
    *place_batch(images, videos), generator=g)`` computes on this rank's
    shards what the single-device step computes on the global batch
    (``parallel/step.py``)."""
    from .step import make_parallel_step as make

    return make(trainer, mesh)

"""Multi-process execution on ``torch.distributed``.

Port of ``sydr_tpu.parallel.distributed``. JAX runs one controller over a
``Mesh`` of devices and inserts collectives from the arrays' shardings.
Here every rank is one OS process that owns one device (``cuda:<local
rank>``, or the CPU), every rank runs the same program over the same
replicated sample stream, and a rank's local tensor *is* its shard: there
is no global array and no sharding spec. The JAX ``Mesh`` becomes
:class:`Mesh`: named axes laid over the ranks in row-major order, with one
process sub-group per line of each axis, and the collectives below take an
axis name as ``jax.lax`` collectives do.

The backend is the caller's choice and is never sniffed: ``"nccl"`` for
CUDA tensors (one card per rank: NCCL refuses two ranks on one card),
``"gloo"`` for CPU tensors, or ``"gloo"`` with CUDA tensors for several
ranks that share a card (PyTorch's gloo backend takes CUDA tensors in
``broadcast``, ``all_reduce`` and ``all_gather``, the three collectives
used here, and copies them through the host itself).

A step that holds NCCL collectives can be captured in a CUDA graph
(``Mesh.captures``; ``ops.step_graph``) with no setting at
:func:`initialize`: on PyTorch 2.11 with NCCL 2.28, capture in the
default (global) mode holds while the process group's watchdog thread
polls, with ``TORCH_NCCL_ASYNC_ERROR_HANDLING`` as found, and eager
collectives between replays on the same communicator
(``tools/torch_nccl_capture_probe.py`` checks this on a machine). The
communicator is created at a group's first collective, which must come
before a capture: the graph runner's eager warm-up makes it. gloo's
collectives cannot be captured.

A 2-process channel-sharded session, the same script in each process::

    from sydr_tpu_torch.parallel import distributed, mesh as pmesh

    distributed.initialize("nccl")   # RANK, WORLD_SIZE, MASTER_ADDR/_PORT
    mesh = pmesh.make_mesh(distributed.world_size(), 1)
    session = TrackingSession(cfg, prns, device=f"cuda:{local_rank}",
                              mesh=mesh)
"""

from __future__ import annotations

import datetime
import math
import os

import numpy as np
import torch
import torch.distributed as dist

from sydr_tpu_torch.ops import native

BACKENDS = ("nccl", "gloo")
_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}
# Every call into the backend, counted as the kernels' launches are (a
# call captured into a CUDA graph counts once per replay).
COLLECTIVES = {name: native.LaunchCounter(name)
               for name in ("all_gather", "all_reduce", "broadcast")}


def _count(name: str, tensor: torch.Tensor) -> None:
    COLLECTIVES[name].count(
        tensor.is_cuda and torch.cuda.is_current_stream_capturing())


def initialize(backend: str, rank: int | None = None,
               world_size: int | None = None, init_method: str | None = None,
               timeout_s: float | None = None) -> None:
    """Join the process group (a no-op for one process with no
    environment, as ``jax.distributed.initialize`` is).

    ``rank`` and ``world_size`` default to ``RANK`` / ``WORLD_SIZE``, and
    ``init_method`` to ``tcp://$MASTER_ADDR:$MASTER_PORT``.
    """
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    env = os.environ
    if rank is None and "RANK" in env:
        rank = int(env["RANK"])
    if world_size is None and "WORLD_SIZE" in env:
        world_size = int(env["WORLD_SIZE"])
    if rank is None and world_size is None and init_method is None:
        return
    if rank is None or world_size is None:
        raise ValueError("a process group needs both a rank and a world size")
    if init_method is None:
        if "MASTER_ADDR" not in env or "MASTER_PORT" not in env:
            raise ValueError("no init_method and no MASTER_ADDR/MASTER_PORT")
        init_method = f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    kwargs = {}
    if timeout_s is not None:
        kwargs["timeout"] = datetime.timedelta(seconds=timeout_s)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size, **kwargs)


def shutdown() -> None:
    """Leave the process group, if this process joined one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


class Mesh:
    """Named axes over every rank of the process group, row-major (the
    layout of ``np.asarray(devices).reshape(shape)`` in JAX).

    ``shape``: ``{axis: size}``; ``coords``: this rank's ``{axis: index}``.
    Each line of an axis (the ranks that differ only in that coordinate)
    is one process sub-group. ``torch.distributed.new_group`` must be
    entered by every rank for every group in the same order, so every
    rank builds the whole mesh; a line of every rank is the default group,
    and a line of one rank in a larger group needs none: its collectives
    return their input. In a process group of one rank the collectives do
    run, so that a one-card run drives its backend.
    """

    def __init__(self, axis_names, shape):
        axis_names = tuple(axis_names)
        shape = tuple(int(n) for n in shape)
        if len(axis_names) != len(shape):
            raise ValueError(f"axes {axis_names} and shape {shape} differ "
                             f"in length")
        world = world_size()
        if math.prod(shape) != world:
            raise ValueError(f"a mesh of shape {shape} needs "
                             f"{math.prod(shape)} ranks, the process group "
                             f"has {world}")
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, shape))
        # The backend the process group was started with (the caller's
        # choice); None without a process group.
        self.backend = dist.get_backend() if dist.is_initialized() else None
        self.rank = rank()
        self.coords = {a: int(c) for a, c in zip(
            axis_names, np.unravel_index(self.rank, shape))}
        grid = np.arange(world).reshape(shape)
        self._lines = {}
        for ax, name in enumerate(axis_names):
            for line in np.moveaxis(grid, ax, -1).reshape(-1, shape[ax]):
                ranks = [int(r) for r in line]
                group = None
                if 1 < len(ranks) < world:
                    group = dist.new_group(ranks)
                if self.rank in ranks:
                    self._lines[name] = (group, ranks)
        self._talks = {name: dist.is_initialized()
                       and (self.shape[name] > 1 or world == 1)
                       for name in axis_names}

    def group(self, axis: str):
        """This rank's process group along ``axis`` (None: the default)."""
        return self._lines[axis][0]

    def talks(self, axis: str) -> bool:
        """Whether a collective along ``axis`` goes through the backend."""
        return self._talks[axis]

    @property
    def captures(self) -> bool:
        """Whether a step that holds this mesh's collectives can be
        captured in a CUDA graph: NCCL's collectives are stream work and
        can; gloo's copy through the host and cannot. Without a process
        group no collective goes through a backend."""
        return self.backend in (None, "nccl")

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank {self.rank} at {self.coords})"


def global_mesh(axis_names=("ch",), shape=None) -> Mesh:
    """Mesh over every rank of the process group (every rank on the first
    axis unless ``shape`` says otherwise)."""
    if shape is None:
        shape = (world_size(),) + (1,) * (len(axis_names) - 1)
    return Mesh(axis_names, shape)


def all_reduce(mesh: Mesh, axis: str, tensor: torch.Tensor,
               op: str = "sum") -> torch.Tensor:
    """``op`` ("sum" or "max") of ``tensor`` over ``axis``: a new tensor
    on ``tensor``'s device, equal on every rank of the line."""
    if not mesh.talks(axis):
        return tensor
    buf = tensor.detach().clone()
    dist.all_reduce(buf, op=_OPS[op], group=mesh.group(axis))
    _count("all_reduce", buf)
    return buf


def all_gather(mesh: Mesh, axis: str, tensor: torch.Tensor) -> list:
    """Every rank's ``tensor`` along ``axis``, in axis order (each rank's
    tensor must have the same shape and dtype)."""
    if not mesh.talks(axis):
        return [tensor]
    src = tensor.detach().contiguous()
    parts = [torch.empty_like(src) for _ in range(mesh.shape[axis])]
    dist.all_gather(parts, src, group=mesh.group(axis))
    _count("all_gather", src)
    return parts


def gather_axis(mesh: Mesh, axis_name: str, tensor: torch.Tensor,
                dim: int = 0) -> torch.Tensor:
    """The tensor whose shards along ``dim`` the ranks of ``axis_name``
    hold: their ``tensor`` concatenated in axis order."""
    parts = all_gather(mesh, axis_name, tensor)
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=dim)


def replicate_from_host(mesh: Mesh, array, device, broadcast: bool = False):
    """A copy of host ``array`` on this rank's ``device``.

    Ranks that read the same stream hold identical data and need no
    collective. ``broadcast=True``, for data that differ between ranks,
    sends rank 0's copy to every rank of the mesh.
    """
    t = torch.tensor(np.asarray(array), device=device)
    if broadcast and world_size() > 1:
        dist.broadcast(t, src=0)
        _count("broadcast", t)
    return t


def shard_from_hosts(mesh: Mesh, axis: str, local_array, device):
    """This rank's shard along ``axis`` (for the channel axis, the rows of
    the channels it owns; for the time axis, its sub-window) on
    ``device``. The rank's tensor is its shard: nothing is exchanged."""
    if axis not in mesh.shape:
        raise ValueError(f"no axis {axis!r} in {mesh}")
    return torch.tensor(np.asarray(local_array), device=device)

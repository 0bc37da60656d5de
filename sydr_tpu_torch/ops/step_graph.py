"""A device step as one captured CUDA graph per key.

The port's counterpart of the JAX package's jitted steps: the session's
(``sydr_tpu.receiver.session._make_packed_run``) and the multi-device
ones (``receiver.session``'s channel-sharded step,
``parallel.timeshard.TimeShardGraph``). Where XLA compiles a step into
one executable, :class:`StepGraph` captures it into a
``torch.cuda.CUDAGraph`` and replays it. The step is a pure function of
tensors, ``fn(*args) -> outputs`` (the session's ``inner``), and a graph
replays the same kernels in the same order on the same inputs, so its
outputs equal the eager step's bit for bit. It lives beside the kernels'
launch counters (``ops.native``), below both the receiver and the
parallel layers that use it.

One graph per key (the session's ``(cfg, input length, input dtype)``):

- The first call for a key copies the arguments into static input buffers
  that the graph owns, runs ``fn`` on them once eagerly on a side stream
  (the warm-up that capture requires; it builds every kernel, since a
  build happens at a kernel's first launch and never inside a capture)
  and returns that run's outputs; then it captures ``fn`` on the same
  buffers.
- Every later call copies the arguments into the buffers and replays. It
  returns the graph's static output tensors, which the next replay of
  the same graph overwrites: the caller copies what it keeps.

A capture that fails raises: a CUDA tensor never runs the step eagerly in
its stead. Tensors that ``fn`` reads from its closure (code tables) are
captured by address and must stay alive and unchanged while the graph
lives. The kernels' launch counters count a replay as the launches the
graph holds (``ops.native.count_replay``).

A step whose body calls NCCL collectives (a channel- or time-sharded
step on an NCCL ``parallel.distributed.Mesh``) is captured the same way,
its collectives graph nodes (at one rank, device-to-device copies): the
warm-up reaches every collective first, which creates the communicator
(never created inside a capture), and the collectives' counters
(``distributed.COLLECTIVES``) count a replay as the kernels' do. Every
rank must make the same calls, so that all capture at the same call and
replay in the same order. gloo's collectives copy through the host and
cannot be captured; :func:`use_graph` is the rule that decides.

``capture=False`` is the CPU tests' stand-in for the graph: the same
static buffers and copies, with ``fn`` run eagerly on the buffers where a
replay would run, writing into static outputs. A CUDA device refuses it.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import gc
import time

import torch

from sydr_tpu_torch.ops import native
from sydr_tpu_torch.utils.metrics import count, span


@dataclasses.dataclass
class Captured:
    """One key's graph: its static buffers and what its capture cost."""

    inputs: tuple
    outputs: tuple
    replay: object                 # () -> None
    launches: dict                 # kernel -> launches a replay makes
    capture_s: float = 0.0         # host time of the capture
    instantiate_s: float = 0.0     # cudaGraphInstantiate
    node_kinds: dict | None = None  # the graph's nodes by kind
    replays: int = 0

    @functools.cached_property
    def nodes(self) -> int | None:
        """The graph's node count."""
        return None if self.node_kinds is None else sum(
            self.node_kinds.values())


def use_graph(graph: bool | None, device, mesh=None) -> bool:
    """Whether a step on ``device`` whose collectives go over ``mesh``
    (None: no collective) runs as a captured graph: ``graph`` True or
    False, or the default (None), which is True on a CUDA device when no
    mesh's backend stands in the way (``Mesh.captures``: NCCL can be
    captured, gloo cannot). ``graph=True`` where a graph cannot run
    raises a ``ValueError`` naming the device or the backend."""
    device = torch.device(device)
    if graph is False:
        return False
    why = None
    if device.type != "cuda":
        why = f"a CUDA graph needs a CUDA device, got {device}"
    elif mesh is not None and not mesh.captures:
        why = (f"the mesh's {mesh.backend} backend copies its collectives "
               f"through the host and cannot be captured in a CUDA graph "
               f"(nccl can)")
    if why is not None and graph:
        raise ValueError(why)
    return why is None


class StepGraph:
    """Captured steps of one caller, by key (see the module note)."""

    def __init__(self, device, *, capture: bool = True):
        self.device = torch.device(device)
        if capture and self.device.type != "cuda":
            raise ValueError(f"a CUDA graph needs a CUDA device, got "
                             f"{self.device}")
        if not capture and self.device.type == "cuda":
            raise ValueError("the eager stand-in for a graph is for CPU "
                             "tensors only: a CUDA step is captured")
        self.capture = capture
        self.graphs: dict = {}

    def run(self, key, fn, args) -> tuple:
        """``fn(*args)`` through the graph of ``key``, captured on the
        first call (which returns its warm-up's outputs), replayed on every
        later one (which returns the static outputs).

        Spans (``utils.metrics``): ``sydr.step`` a call (request id: the
        call's index for ``key``), and under it ``sydr.step.capture`` on
        the first call (warm-up, capture, instantiation; the counter
        ``sydr.step.captures``), else ``.copy_in`` (the input buffers'
        copies) and ``.replay`` (the graph's launch; ``nodes``)."""
        entry = self.graphs.get(key)
        with span("sydr.step", request=0 if entry is None
                  else entry.replays + 1):
            if entry is None:
                with span("sydr.step.capture"):
                    count("sydr.step.captures")
                    entry, outs = self._make(fn, args)
                self.graphs[key] = entry
                return outs
            with span("sydr.step.copy_in"):
                for buf, arg in zip(entry.inputs, args):
                    buf.copy_(arg)
            with span("sydr.step.replay", nodes=entry.nodes):
                entry.replay()
            entry.replays += 1
            native.count_replay(entry.launches)
            return entry.outputs

    def _make(self, fn, args):
        inputs = tuple(torch.empty_like(a).copy_(a) for a in args)
        if not self.capture:
            outs = fn(*inputs)
            static = tuple(torch.empty_like(o) for o in outs)

            def replay():
                for buf, out in zip(static, fn(*inputs)):
                    buf.copy_(out)

            return Captured(inputs, static, replay, {}), outs

        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            outs = fn(*inputs)
        current = torch.cuda.current_stream(self.device)
        current.wait_stream(side)
        for out in outs:
            out.record_stream(current)

        # keep_graph: instantiated apart (and timed apart), and its nodes
        # can be counted.
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        before = native.captured_counts()
        # No garbage collection inside the capture: a collected graph's
        # destructor calls the CUDA API, which invalidates a capture under
        # way. (torch.cuda.graph collects just before it begins.)
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph):
                t0 = time.perf_counter()
                static = fn(*inputs)
                capture_s = time.perf_counter() - t0
        finally:
            if collecting:
                gc.enable()
        launches = native.graph_launches(before, native.captured_counts())
        t0 = time.perf_counter()
        graph.instantiate()
        entry = Captured(inputs, tuple(static), graph.replay, launches,
                         capture_s, time.perf_counter() - t0,
                         node_kinds(graph))
        return entry, outs


# ``CUgraphNodeType``, in ``cuda.h``'s order.
NODE_KINDS = ("kernel", "memcpy", "memset", "host", "graph", "empty",
              "wait_event", "event_record", "ext_semas_signal",
              "ext_semas_wait", "mem_alloc", "mem_free", "batch_mem_op",
              "conditional")


def node_kinds(graph) -> dict | None:
    """The nodes of a kept graph by kind (``NODE_KINDS``), through
    ``cuGraphGetNodes`` and ``cuGraphNodeGetType`` of ``libcuda`` (None if
    a call fails)."""
    cuda = ctypes.CDLL("libcuda.so.1")
    get_nodes, get_type = cuda.cuGraphGetNodes, cuda.cuGraphNodeGetType
    get_nodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                          ctypes.POINTER(ctypes.c_size_t)]
    get_type.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
    raw = ctypes.c_void_p(int(graph.raw_cuda_graph()))
    count = ctypes.c_size_t(0)
    if get_nodes(raw, None, ctypes.byref(count)):
        return None
    nodes = (ctypes.c_void_p * count.value)()
    if count.value and get_nodes(raw, nodes, ctypes.byref(count)):
        return None
    kinds: dict = {}
    kind = ctypes.c_int(0)
    for node in nodes[:count.value]:
        if get_type(ctypes.c_void_p(node), ctypes.byref(kind)):
            return None
        name = NODE_KINDS[kind.value] if kind.value < len(NODE_KINDS) \
            else str(kind.value)
        kinds[name] = kinds.get(name, 0) + 1
    return kinds

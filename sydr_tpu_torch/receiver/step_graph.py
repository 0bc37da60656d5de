"""The session's device step as one captured CUDA graph per configuration.

The port's counterpart of the JAX session's jitted step
(``sydr_tpu.receiver.session._make_packed_run``): where XLA compiles the
step into one executable, :class:`StepGraph` captures it into a
``torch.cuda.CUDAGraph`` and replays it. The step is a pure function of
tensors, ``fn(*args) -> outputs`` (the session's ``inner``), and a graph
replays the same kernels in the same order on the same inputs, so its
outputs equal the eager step's bit for bit.

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

``capture=False`` is the CPU tests' stand-in for the graph: the same
static buffers and copies, with ``fn`` run eagerly on the buffers where a
replay would run, writing into static outputs. A CUDA device refuses it.
"""

from __future__ import annotations

import ctypes
import dataclasses
import gc
import time

import torch

from sydr_tpu_torch.ops import native


@dataclasses.dataclass
class Captured:
    """One key's graph: its static buffers and what its capture cost."""

    inputs: tuple
    outputs: tuple
    replay: object                 # () -> None
    launches: dict                 # kernel -> launches a replay makes
    capture_s: float = 0.0         # host time of the capture
    instantiate_s: float = 0.0     # cudaGraphInstantiate
    nodes: int | None = None       # the graph's node count
    replays: int = 0


class StepGraph:
    """Captured steps of one session, by key (see the module note)."""

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
        later one (which returns the static outputs)."""
        entry = self.graphs.get(key)
        if entry is None:
            entry, outs = self._make(fn, args)
            self.graphs[key] = entry
            return outs
        for buf, arg in zip(entry.inputs, args):
            buf.copy_(arg)
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
                         _node_count(graph))
        return entry, outs


def _node_count(graph) -> int | None:
    """The nodes of a kept graph, through ``cuGraphGetNodes`` of
    ``libcuda`` (None if the call fails)."""
    get_nodes = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes
    get_nodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                          ctypes.POINTER(ctypes.c_size_t)]
    get_nodes.restype = ctypes.c_int
    count = ctypes.c_size_t(0)
    if get_nodes(int(graph.raw_cuda_graph()), None, ctypes.byref(count)):
        return None
    return int(count.value)

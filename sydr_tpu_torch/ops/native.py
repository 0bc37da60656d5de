"""Build the package's CUDA C++ kernels with ``nvcc`` and load them by ctypes.

Each kernel source in ``csrc/`` is a ``.cu`` file with a plain C entry
point (no PyTorch headers; shared device code lives in ``csrc/*.cuh``),
compiled at first use for Hopper (``sm_90a``) into a shared library under
``_build/`` (git-ignored; the file name carries a hash of the source, the
headers and the flags, so an edited source or header is rebuilt).
:func:`build_all` compiles several kernels at once, one ``nvcc`` each.
The C entry point returns ``cudaGetLastError()`` after its launch;
:meth:`CudaKernel.launch` raises when that is not ``cudaSuccess`` and
counts each launch it makes. A launch made while the current stream is
capturing a CUDA graph runs only when the graph is replayed: it counts
in ``captured`` instead, and :func:`count_replay` adds a graph's captured
launches (:func:`captured_counts` before and after its capture) to
``launches`` at each replay.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
import weakref
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)
# Every counter made (each kernel's, each collective's), so that a
# graph's captured launches can be read across all of them.
_KERNELS: "weakref.WeakSet[LaunchCounter]" = weakref.WeakSet()


def find_nvcc() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else under PyTorch's CUDA_HOME."""
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


class LaunchCounter:
    """The launch counters of one thing that puts work on the device (a
    kernel, or a collective of ``parallel.distributed``), named by
    ``source``: ``launches``, incremented once per launch (a launch into a
    CUDA graph once per replay of the graph), and ``captured``, the
    launches recorded into graphs while they were captured."""

    def __init__(self, source: str):
        self.source = source
        self.launches = 0
        self.captured = 0
        _KERNELS.add(self)

    def count(self, capturing: bool) -> None:
        """Count one launch, into ``captured`` while a graph captures."""
        if capturing:
            self.captured += 1
        else:
            self.launches += 1


class CudaKernel(LaunchCounter):
    """One ``csrc/<source>`` kernel: its build, its C entry point and its
    launch counters (:class:`LaunchCounter`). ``csrc_dir`` builds the
    source of another tree instead (into that tree's ``_build/``), as a
    tool that compares two versions does; ``flags`` are more ``nvcc``
    flags (a checking build's ``-D``).
    """

    def __init__(self, source: str, symbol: str, argtypes: list,
                 csrc_dir: Path = CSRC_DIR, flags: tuple = ()):
        super().__init__(source)
        self.symbol = symbol
        self.argtypes = argtypes
        self.csrc_dir = Path(csrc_dir)
        self.flags = tuple(flags)
        self.build_seconds: float | None = None
        self.build_log = ""
        self._lib = None
        self._fn = None

    def library_path(self) -> Path:
        src = self.csrc_dir / self.source
        text = src.read_bytes() + b"".join(
            h.read_bytes() for h in sorted(self.csrc_dir.glob("*.cuh")))
        digest = hashlib.sha256(
            text + " ".join(NVCC_FLAGS + self.flags).encode()).hexdigest()
        return self.csrc_dir.parent / "_build" / \
            f"{src.stem}-{digest[:16]}.so"

    def build(self) -> Path:
        """Compile the source unless its library exists; return its path."""
        out = self.library_path()
        if out.exists():
            return out
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [find_nvcc(), *NVCC_FLAGS, *self.flags, "-o", str(tmp),
               str(self.csrc_dir / self.source)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        self.build_seconds = time.perf_counter() - t0
        self.build_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed for {self.source} (rc {proc.returncode}):\n"
                f"{self.build_log}")
        os.replace(tmp, out)
        return out

    def function(self):
        """The C entry point, building and loading the library once."""
        if self._fn is None:
            self._lib = ctypes.CDLL(str(self.build()))
            fn = getattr(self._lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            err_str = self._lib.sydr_cuda_error_string
            err_str.argtypes = [ctypes.c_int]
            err_str.restype = ctypes.c_char_p
            self._fn = fn
        return self._fn

    def entry(self, symbol: str, argtypes: list):
        """Another C function of the same library (an ``int``-returning
        query that launches nothing, so it is not counted)."""
        self.function()
        fn = getattr(self._lib, symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        return fn

    def error_string(self, err: int) -> str:
        return self._lib.sydr_cuda_error_string(err).decode()

    def launch(self, *args) -> None:
        """Call the entry point; raise on a CUDA error, else count it (in
        ``captured`` while the current stream captures a graph)."""
        err = self.function()(*args)
        if err != 0:
            raise RuntimeError(f"{self.symbol}: CUDA error {err}: "
                               f"{self.error_string(err)}")
        self.count(stream_capturing())


def stream_capturing() -> bool:
    """Whether PyTorch's current CUDA stream is capturing a graph."""
    import torch

    return torch.cuda.is_current_stream_capturing()


def captured_counts() -> dict:
    """``{counter: captured launches}`` of every counter made so far."""
    return {kern: kern.captured for kern in _KERNELS}


def graph_launches(before: dict, after: dict) -> dict:
    """The launches a graph holds, per kernel with any: ``after`` minus
    ``before``, two :func:`captured_counts` around its capture."""
    return {kern: n - before.get(kern, 0) for kern, n in after.items()
            if n != before.get(kern, 0)}


def count_replay(graph_counts: dict) -> None:
    """Count one replay of a graph that holds ``graph_counts``
    (:func:`graph_launches`)."""
    for kern, n in graph_counts.items():
        kern.launches += n


# An empty kernel (one thread, no work): the per-launch floor that the
# device times of microsecond-scale kernels are read against.
EMPTY_LAUNCH = CudaKernel("empty_launch.cu", "empty_launch",
                          [ctypes.c_void_p])


def build_all(kernels) -> None:
    """Build ``kernels`` concurrently (one ``nvcc`` process each) and load
    them; raise the first build error."""
    with ThreadPoolExecutor(max_workers=max(1, len(kernels))) as pool:
        list(pool.map(lambda k: k.function(), kernels))


def ptr(t) -> int:
    """A tensor's device pointer, as the integer a ``c_void_p`` argument
    takes."""
    return t.data_ptr()


def stream_of(t) -> int:
    """PyTorch's current CUDA stream on ``t``'s device, as the integer a
    ``c_void_p`` argument takes."""
    import torch

    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:      # no Stream object per launch
        index = t.device.index
        return raw(torch.cuda.current_device() if index is None else index)
    return torch.cuda.current_stream(t.device).cuda_stream


def check_all(device, specs) -> None:
    """:func:`check` for every ``(tensor, name, dtype, shape)`` of
    ``specs``, in one pass: the common case costs one comparison per
    tensor, and only a mismatch goes on to name its fault."""
    for t, name, dtype, shape in specs:
        if not (t.device == device and t.dtype == dtype
                and t.shape == shape and t.is_contiguous()):
            check(t, name, dtype, shape, device)


def check(t, name: str, dtype, shape: tuple, device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device``."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")

"""sydr_tpu_torch: the sydr_tpu GNSS receiver's device path on PyTorch + CUDA.

A port of ``sydr_tpu`` (JAX/XLA/Pallas) that mirrors its module paths:
PCPS acquisition, the batched two-pass tracking runtime and the
pull-in -> cruise :class:`~sydr_tpu_torch.receiver.session.TrackingSession`.
The two Pallas kernels on that path are hand-written CUDA C++ for Hopper
(``csrc/``), built with ``nvcc`` at first use; on CPU tensors every kernel
wrapper runs its plain PyTorch version instead.

Importing this package imports no submodule, so ``import sydr_tpu_torch``
stays cheap; import the modules you need.
"""

__version__ = "0.1.0"

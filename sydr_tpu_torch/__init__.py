"""sydr_tpu_torch: the sydr_tpu GNSS receiver on PyTorch + CUDA.

A port of ``sydr_tpu`` (JAX/XLA/Pallas) that mirrors its module paths:
PCPS acquisition, the batched two-pass tracking runtime, the pull-in ->
cruise :class:`~sydr_tpu_torch.receiver.session.TrackingSession`, and the
host half on top of it: the :class:`~sydr_tpu_torch.receiver.receiver.Receiver`
(LNAV decode, measurements, PVT), configuration loading, I/O and the CLI
(``python -m sydr_tpu_torch --demo``). The three Pallas kernels of the JAX
package are hand-written CUDA C++ for Hopper (``csrc/``), built with
``nvcc`` at first use: K1 ``epoch_correlate`` and K3
``block_cumsum_streams`` (the two boundary forms of pass B) and K2
``pcps_bins`` (acquisition). On CPU tensors every kernel wrapper runs its
plain PyTorch version instead.

Importing this package imports no submodule, so ``import sydr_tpu_torch``
stays cheap; import the modules you need.
"""

__version__ = "0.1.0"

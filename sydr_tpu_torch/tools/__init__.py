"""The receiver's measuring tools on the port, one module per JAX tool of
``tools/`` (same file names)::

    python -m sydr_tpu_torch.tools.soak --seconds 300 --pallas
    python -m sydr_tpu_torch.tools.soak_debug --seconds 90
    python -m sydr_tpu_torch.tools.false_lock_probe --seconds 8
    python -m sydr_tpu_torch.tools.acq_benchmark --cn0 30 33 --trials 32
    python -m sydr_tpu_torch.tools.track_benchmark --trials 3
    python -m sydr_tpu_torch.tools.trace_profile prefix rowsum
    python -m sydr_tpu_torch.tools.scaling_bench --chip
    python -m sydr_tpu_torch.tools.acq_profile

Every tool runs on the card (``--device cuda``, the default) and exits 2
when CUDA is missing, unless ``--cpu`` asks for the CPU; there is no silent
fallback. Importing a module does no work.
"""

from __future__ import annotations

import sys


def add_device_args(parser) -> None:
    """``--cpu`` and ``--device``, the receiver CLI's pair."""
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU (development machines)")
    parser.add_argument("--device", default="cuda",
                        help="torch device of the run (--cpu means --device "
                             "cpu)")


def device_of(args):
    """The ``torch.device`` that ``args`` name, or None (after a message on
    stderr) when it is a CUDA device and CUDA is not available: the caller
    then exits 2."""
    import torch

    name = "cpu" if args.cpu else args.device
    if name.startswith("cuda") and not torch.cuda.is_available():
        print(f"--device {name}: CUDA is not available (use --cpu to run on "
              f"the CPU)", file=sys.stderr)
        return None
    return torch.device(name)


def sync(device) -> None:
    """Wait for the work queued on ``device`` (a no-op on the CPU)."""
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def device_name(device) -> str:
    """The name a result is labelled with: the card's, or ``cpu``."""
    import torch

    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type

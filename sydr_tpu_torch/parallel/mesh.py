"""Channel and Doppler sharding of the receiver over ranks.

Port of ``sydr_tpu.parallel.mesh``. The mesh has two axes:

* ``ch``, the channel axis: the tracking runtimes are elementwise over
  channels, so a rank runs the port's unchanged runtime on its channel
  slice with the sample window replicated, and no collective runs inside
  the step (the JAX ``shard_map`` with ``P("ch")`` specs);
* ``dop``, the Doppler axis of acquisition: each rank searches its slab of
  Doppler bins for its channel rows, and only the per-channel peak crosses
  ranks (:func:`sharded_pcps`).

Time-axis sharding of one block is ``parallel.timeshard``. The JAX helpers
``channel_sharding``, ``shard_session_state`` and ``batch_shardings`` only
placed global arrays; :func:`channel_slice` takes their place.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from sydr_tpu_torch.channels import batch_runtime as br
from sydr_tpu_torch.channels import runtime
from sydr_tpu_torch.constants import GPS_L1CA_CODE_FREQ
from sydr_tpu_torch.ops import acquisition as acq
from sydr_tpu_torch.parallel import distributed
from sydr_tpu_torch.parallel.distributed import Mesh


def make_mesh(n_ch_shards: int | None = None, n_dop_shards: int = 1) -> Mesh:
    """A ``(ch, dop)`` mesh over every rank of the process group."""
    n = distributed.world_size()
    if n_ch_shards is None:
        n_ch_shards = n // n_dop_shards
    return Mesh(("ch", "dop"), (n_ch_shards, n_dop_shards))


def channel_slice(mesh: Mesh, n_channels: int) -> slice:
    """The rows of ``n_channels`` that this rank owns along ``ch``."""
    n_shards = mesh.shape["ch"]
    assert n_channels % n_shards == 0, (
        f"{n_channels} channels do not divide over {n_shards} 'ch' shards; "
        f"pad prns with 0")
    per = n_channels // n_shards
    lo = mesh.coords["ch"] * per
    return slice(lo, lo + per)


def make_sharded_batch_step(cfg: runtime.TrackingConfig, mesh: Mesh,
                            k_blocks: int = 1):
    """The tracking step on this rank's channel shard.

    Returns ``step(tables, state, window_re, window_im) -> (state,
    outputs)``: ``tables`` (the ``tiled_code_bits`` rows, or the scan
    runtime's code rows) and ``state`` are this rank's rows, the window is
    replicated, and the returned state and ``[k_blocks * block_ms, rows]``
    outputs are this rank's rows. The batch runtime's kernels take the
    launch shape of the whole channel count (``grid_ch``), so a shard sums
    its rows in the same order as the unsharded step.
    """
    n_shards = mesh.shape["ch"]

    def step(tables, state, window_re, window_im):
        if cfg.runtime != "batch":
            return runtime.run_block(cfg, tables, state, window_re,
                                     window_im)
        grid_ch = state.mode.shape[0] * n_shards
        if k_blocks > 1:
            return br.run_superblock(cfg, k_blocks, tables, state, window_re,
                                     window_im, grid_ch=grid_ch)
        return br.run_block_batched(cfg, tables, state, window_re,
                                    window_im, grid_ch=grid_ch)

    return step


def make_sharded_run_block(cfg: runtime.TrackingConfig, mesh: Mesh):
    """The scan runtime's ``run_block`` on this rank's channel shard:
    ``run(codes, state, window_re, window_im)`` with this rank's code and
    state rows."""
    def run(codes, state, window_re, window_im):
        return runtime.run_block(cfg, codes, state, window_re, window_im)

    return run


def sharded_pcps(mesh: Mesh, iq_re, iq_im, code_k, bins, *,
                 sampling_frequency: float,
                 intermediate_frequency: float = 0.0, coherent: int = 5,
                 non_coherent: int = 10, doppler_chunk: int = 4):
    """PCPS with the (channel x Doppler) grid sharded over the mesh.

    Arguments as ``acquisition.pcps_map`` for every channel (each rank
    takes its ``ch`` rows) and ``bins`` a host array. The bins are padded
    to the ``dop`` size by repeating the last and each rank maps its slab
    with the direct map; ``doppler_chunk`` bounds its working set and does
    not change the map. The peak follows ``acquisition.peak_metric``
    exactly, with the peak exchanged across ``dop`` instead of the map:
    each rank's ``(peak, global flat index)`` is gathered, the largest
    wins (the lowest flat index on a tie, as ``torch.argmax``), the rank
    that owns the winning Doppler row takes the second peak outside +/-1
    chip, and a ``max`` over ``dop`` hands it to every rank.

    Returns (doppler_hz, code_index int32, metric), ``[n_ch]`` each, on
    every rank.
    """
    n_ch, n = code_k.shape
    rows = channel_slice(mesh, n_ch)
    n_dop = len(bins)
    n_slabs = mesh.shape["dop"]
    d = mesh.coords["dop"]
    per = -(-n_dop // n_slabs)
    bins = np.asarray(bins, np.float32)
    bins_p = np.concatenate(
        [bins, np.repeat(bins[-1:], per * n_slabs - n_dop)])
    dev = iq_re.device
    slab = torch.from_numpy(bins_p[d * per:(d + 1) * per].copy()).to(dev)
    corr = acq.pcps_map(
        iq_re[rows], iq_im[rows], code_k[rows], slab,
        sampling_frequency=sampling_frequency,
        intermediate_frequency=intermediate_frequency, coherent=coherent,
        non_coherent=non_coherent, doppler_chunk=doppler_chunk)
    # The padding bins never win.
    real = torch.arange(d * per, (d + 1) * per, device=dev) < n_dop
    corr = torch.where(real[None, :, None], corr, -math.inf)
    n_loc = corr.shape[0]
    flat = corr.reshape(n_loc, -1)
    local_idx = torch.argmax(flat, dim=-1)
    peak1 = flat.gather(1, local_idx[:, None])[:, 0]
    flat_idx = local_idx + d * per * n                     # global flat index
    peaks = torch.stack(distributed.all_gather(mesh, "dop", peak1))
    idxs = torch.stack(distributed.all_gather(mesh, "dop", flat_idx))
    win = torch.argmax(peaks, dim=0)                 # lowest slab on a tie
    take = torch.arange(n_loc, device=dev)
    peak1 = peaks[win, take]
    flat_idx = idxs[win, take]
    fi = flat_idx // n
    ci = flat_idx % n
    # The second peak, on the owner of the winning row.
    samples_per_chip = round(sampling_frequency / GPS_L1CA_CODE_FREQ)
    own = win == d
    row_l = torch.clamp(fi - d * per, 0, per - 1)
    row = corr[take, row_l]
    idx = torch.arange(n, device=dev)[None, :]
    excluded = (idx > ci[:, None] - samples_per_chip) & (
        idx < ci[:, None] + samples_per_chip)
    peak2 = torch.where(excluded, -math.inf, row).amax(dim=-1)
    peak2 = distributed.all_reduce(
        mesh, "dop", torch.where(own, peak2, -math.inf), op="max")
    doppler = torch.from_numpy(bins).to(dev)[fi]
    metric = peak1 / peak2
    return (distributed.gather_axis(mesh, "ch", doppler),
            distributed.gather_axis(mesh, "ch", ci.to(torch.int32)),
            distributed.gather_axis(mesh, "ch", metric))

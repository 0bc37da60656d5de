"""Time-axis (``sp``) sharding of one block's correlation.

Port of ``sydr_tpu.parallel.timeshard``. Rank ``d`` of the ``sp`` axis
owns the millisecond-aligned sub-window ``[d * L, (d + 1) * L)`` of the
block's ``tail_ms + block_ms`` milliseconds (``L`` of them each, which
must divide). Pass A and pass C run replicated on every rank; pass B runs
the port's kernels on the rank's sub-window, in the form the
configuration picks (``batch_runtime.prefix_form``):

* row sums (K1, ``epoch_correlate``): per-epoch sums are additive over
  sample ranges, so each rank sums the part of every epoch inside its
  sub-window (``bounds`` shifted and clipped to it; an epoch outside it
  sums to zero) and one ``all_reduce(SUM)`` of ``[block_ms, n_ch,
  n_streams]`` adds the parts;
* prefix (K3, ``block_cumsum_streams``): the prefix at a window position
  ``b`` is ``below(d) + P_local(b - d * L * spms)``, ``below`` the sum of
  the shard totals of the ranks before ``d`` (one ``all_gather``); each
  epoch bound is owned by one rank, and one ``all_reduce(SUM)`` hands
  every bound to every rank before the epoch differences.

A sample's chip index reads the anchors of the millisecond its tap sample
``m + k`` falls in, clamped to the last anchor column. A rank whose
sub-window ends before the block does is therefore given one more anchor
column and one more millisecond of window than it owns (the window is
replicated), so that a positively shifted tap at its edge reads the next
millisecond's anchors exactly as the unsharded kernel does, not the
clamped continuation of its last one. Every per-sample stream value is
then the unsharded one; only the order of the sums differs.

The JAX package has a second variant, ``run_block_batched_timesharded_
pallas``, for its production row-sum kernel: it exists for the packed
words and ``_rowsum_boundary_prefix`` that its TPU kernel needs. K1 reads
chips from the code table and sums exact epochs, so it has no counterpart
here, and :func:`run_superblock_timesharded` is the plain block loop
without the JAX word-pack grouping.
"""

from __future__ import annotations

import torch

from sydr_tpu_torch.channels import batch_runtime as br
from sydr_tpu_torch.channels.runtime import TrackingConfig, _slew_anchor
from sydr_tpu_torch.channels.state import ChannelState
from sydr_tpu_torch.ops import correlator_kernel as ck
from sydr_tpu_torch.parallel import distributed
from sydr_tpu_torch.parallel.distributed import Mesh


def make_sp_mesh(n_devices: int | None = None) -> Mesh:
    """An ``sp`` mesh over every rank of the process group (``n_devices``,
    when given, must be the group's size). A mesh with more axes serves
    as well: the functions here use only its ``sp`` lines."""
    n = distributed.world_size() if n_devices is None else n_devices
    return Mesh(("sp",), (n,))


def shard_inputs(cfg: TrackingConfig, n_sp: int, d: int, window_re,
                 window_im, fb_q, phic_q):
    """Shard ``d`` of ``n_sp``'s window planes and anchor columns, and the
    first window sample it owns: ``(win_re, win_im, fb_q, phic_q, m0)``.
    The window and anchors run one millisecond past the owned ``L`` where
    the block goes on (see the module note)."""
    n_ms = cfg.tail_ms + cfg.block_ms
    assert n_ms % n_sp == 0, (
        f"tail_ms + block_ms = {n_ms} must divide over {n_sp} shards")
    spms = cfg.samples_per_ms
    n_ms_l = n_ms // n_sp
    q0 = d * n_ms_l
    q1 = min(n_ms, q0 + n_ms_l + 1)
    return (window_re[q0 * spms:q1 * spms], window_im[q0 * spms:q1 * spms],
            fb_q[:, q0:q1].contiguous(), phic_q[:, q0:q1].contiguous(),
            q0 * spms)


def pass_b_timesharded(cfg: TrackingConfig, mesh: Mesh, bits3x,
                       state: ChannelState, geo, window_re, window_im):
    """Correlators ``[block_ms, n_ch, 2 * n_taps]`` of the block, equal on
    every rank of the ``sp`` line, from this rank's sub-window."""
    inputs, bounds = br.pass_b_inputs(cfg, bits3x, state, geo)
    code_bits, c_int, omega, code_step, fb_q, phic_q = inputs
    win_re, win_im, fb_l, ph_l, m0 = shard_inputs(
        cfg, mesh.shape["sp"], mesh.coords["sp"], window_re, window_im, fb_q,
        phic_q)
    shard_len = (cfg.tail_ms + cfg.block_ms) // mesh.shape["sp"] \
        * cfg.samples_per_ms
    args = (win_re, win_im, code_bits, c_int, omega, code_step, fb_l, ph_l)
    taps, spms = br.taps_for(cfg), cfg.samples_per_ms
    if not br.prefix_form(cfg):
        local = torch.clamp(bounds - m0, 0, shard_len).to(torch.int32)
        part = ck.epoch_correlate(*args, local.contiguous(), taps, spms)
        return distributed.all_reduce(mesh, "sp", part)

    prefix = ck.block_cumsum_streams(*args, taps, spms)
    totals = prefix[:, :, shard_len - 1]                     # [n_ch, S]
    d = mesh.coords["sp"]
    below = torch.zeros_like(totals)
    for part in distributed.all_gather(mesh, "sp", totals)[:d]:
        below = below + part
    ends = bounds.to(torch.int64).t() - 1                    # [n_ch, E+1]
    owner = (ends >= m0) & (ends < m0 + shard_len)
    local = torch.clamp(ends - m0, 0, shard_len - 1)
    vals = br.prefix_at(prefix, local) + below[:, :, None]
    picked = torch.where(owner[:, None, :], vals, 0.0)
    picked = distributed.all_reduce(mesh, "sp", picked)
    return br.boundary_differences(picked)


def run_block_batched_timesharded(cfg: TrackingConfig, mesh: Mesh, bits3x,
                                  state: ChannelState, window_re, window_im):
    """``batch_runtime.run_block_batched`` with pass B sharded over the
    mesh's ``sp`` axis; every rank holds the whole window and returns the
    same state and outputs. Requires ``(tail_ms + block_ms) %
    mesh.shape["sp"] == 0`` (:func:`shard_inputs` asserts it)."""
    geo = br._pass_a(cfg, state)
    corr = pass_b_timesharded(cfg, mesh, bits3x, state, geo, window_re,
                              window_im)
    new_state, outputs = br._pass_c(cfg, state, geo, corr)
    return _slew_anchor(cfg, new_state), outputs


def run_superblock_timesharded(cfg: TrackingConfig, mesh: Mesh,
                               k_blocks: int, bits3x, state: ChannelState,
                               samples_re, samples_im):
    """``batch_runtime.run_superblock`` with every block's pass B sharded
    over ``sp`` (:func:`run_block_batched_timesharded`)."""
    return br.superblock_loop(
        cfg, k_blocks, state, samples_re, samples_im,
        lambda st, wre, wim: run_block_batched_timesharded(
            cfg, mesh, bits3x, st, wre, wim))

"""Host-side orchestration of the device tracking runtime.

Port of ``sydr_tpu.receiver.session``. :class:`TrackingSession` owns the
channel state on its device, assembles the sliding sample window per
block (host boxcar decimation and int8 upload), runs acquisition (PCPS
from a device-resident sample ring, or the time-domain serial search from
the host sample history), hands acquired channels to tracking in either
runtime (``TrackingConfig.runtime``: the batched runtime or the per-ms
scan runtime), and promotes from the pull-in loop shape to the cruise
shape (:class:`CruisePolicy`).

The device step (dequantise the window, roll the acquisition ring, run
the block or superblock, pack the outputs) is a pure function of tensors,
built per configuration by :meth:`TrackingSession._make_packed_run`, the
JAX session's jitted step. On a CUDA device the session captures it as
one CUDA graph per configuration and input and replays it
(``ops.step_graph.StepGraph``; ``graph=``), with a mesh too when its
backend is NCCL; on the CPU, and with a gloo mesh, it runs eagerly.

Sample accounting: the session counts the samples fed
(``total_samples``); each channel's read position is
``total_samples - unread``. Tracking starts at the last code boundary
inside the acquisition window, ``unread = samples_per_code - code_index -
1`` (the reference's alignment).

Channel sharding (``mesh=``, ``parallel.mesh.make_mesh``): every rank of
the process group runs the same session over the same samples. Code
tables, state, acquisition and its hand-off stay whole and replicated on
every rank; each tracking step runs on this rank's channel rows
(``parallel.mesh.make_sharded_batch_step``, in either runtime), and the
new state and the packed outputs are gathered over ``ch`` in one float32
and one int32 ``all_gather``. On an NCCL mesh the step and its two
gathers are one captured graph, the counterpart of the JAX session's
jitted sharded step (``jax.jit`` of ``make_sharded_batch_step`` with its
collectives). Every rank captures at the same call and replays in the
same order: a graph's key (configuration, input length and dtype) and
promotion are decided from data that every rank holds alike (the
gathered outputs), and acquisition and its hand-off, between steps, run
eagerly in the same order on every rank.
"""

from __future__ import annotations

import dataclasses
import functools
import logging

import numpy as np
import torch

from sydr_tpu_torch.channels import batch_runtime, runtime
from sydr_tpu_torch.channels.state import (
    FLAG_BIT_SYNC,
    MODE_ACQUIRING,
    MODE_IDLE,
    MODE_TRACKING,
    FIELDS,
    ChannelState,
    code_table,
    init_state,
    pack_state,
    unpack_state,
)
from sydr_tpu_torch.constants import (
    GPS_L1CA_CARRIER_FREQ,
    GPS_L1CA_CODE_FREQ,
    GPS_L1CA_CODE_LENGTH,
)
from sydr_tpu_torch.ops import acquisition as acq
from sydr_tpu_torch.parallel import distributed
from sydr_tpu_torch.parallel import mesh as pmesh
from sydr_tpu_torch.ops.step_graph import StepGraph, use_graph
from sydr_tpu_torch.utils.metrics import count, span

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class CruisePolicy:
    """When to promote from the pull-in step to the cruise step.

    Pull-in runs the Kaplan FLL-assisted loops at short blocks (the
    delayed-feedback stability rule ``loop_bandwidth * block_length <
    ~0.15``); cruise is the throughput shape (20 ms blocks, long
    superblocks). Promotion happens once every tracking channel holds bit
    sync and a minimum PLL lock indicator for ``stable_blocks`` calls.
    """

    # consecutive qualifying process_block calls before promoting
    stable_blocks: int = 2
    # every TRACKING channel must hold at least this PLL lock indicator
    # (deliberately low: the pull-in shape's block-boundary phase steps
    # degrade it; bit sync is the real convergence signal)
    min_pll_lock: float = 0.3
    # ... and have declared bit sync (20 ms epoch grid pinned)
    require_bit_sync: bool = True


@dataclasses.dataclass
class AcquisitionConfig:
    doppler_range: float = 5000.0
    doppler_step: float = 100.0
    coherent: int = 5
    non_coherent: int = 10
    threshold: float = 1.5
    # "pcps" (FFT circular correlation) or "serial" (time-domain
    # matrix-product search, the reference's SerialSearch channel variant).
    method: str = "pcps"
    # A below-threshold search re-arms after this much fresh signal
    # (0 disables retry).
    retry_backoff_ms: int = 200

    @property
    def required_ms(self) -> int:
        if self.method == "serial":
            return 1
        return self.coherent * self.non_coherent


class TrackingSession:
    """Drives the channel runtime over a streamed IQ signal."""

    _BOOL_KEYS = frozenset({"active", "bit_ready"})

    def __init__(
        self,
        cfg: runtime.TrackingConfig,
        prns: list[int],
        acq_cfg: AcquisitionConfig | None = None,
        cruise: runtime.TrackingConfig | None = None,
        cruise_policy: CruisePolicy | None = None,
        *,
        device,
        mesh=None,
        graph: bool | None = None,
    ):
        """``cruise``: optional throughput-optimal TrackingConfig to promote
        to once every channel is stable (:class:`CruisePolicy`); ``cfg`` is
        then the pull-in configuration. Both must share sampling rate,
        decimation, IF and tail length. ``device``: where the channel state,
        code tables, sample ring and all tracking/acquisition work live.
        ``mesh``: optional ``parallel.mesh.make_mesh`` mesh; tracking then
        runs channel-sharded over its ``ch`` axis, and the channel count
        must divide over ``mesh.shape['ch']`` (pad ``prns`` with 0); a
        configuration of the scan runtime with ``superblock > 1`` raises
        there (the sharded step runs one scan block a call). ``graph``:
        replay the device step as a captured CUDA graph (True),
        run it eagerly (False), or the default (None): graphed on a CUDA
        device without a mesh or with an NCCL mesh (its collectives
        captured with the step), else eager
        (``ops.step_graph.use_graph``). True on the CPU, or with a
        gloo mesh, raises.
        """
        for c in (cfg, cruise):
            if (mesh is not None and c is not None and c.runtime != "batch"
                    and c.superblock != 1):
                raise ValueError("a superblock under a mesh requires the "
                                 "batch runtime")
        self.acq_cfg = acq_cfg or AcquisitionConfig()
        if cruise is not None and not (
                cruise.tail_ms == cfg.tail_ms
                and cruise.samples_per_ms == cfg.samples_per_ms
                and cruise.input_decimate == cfg.input_decimate
                and cruise.intermediate_frequency
                == cfg.intermediate_frequency):
            raise ValueError("cruise and pull-in configs must share rate, "
                             "decimation, IF and tail length")
        self.device = torch.device(device)
        self.graph = (StepGraph(self.device)
                      if use_graph(graph, self.device, mesh) else None)
        self._packed_runs: dict = {}
        self.cfg = cfg
        self._pullin_cfg = cfg
        self.prns = list(prns)
        self.cruise_cfg = cruise
        self.cruise_policy = cruise_policy or CruisePolicy()
        self.promoted = False
        self._stable_blocks = 0
        self.n_channels = len(prns)
        self.mesh = mesh
        if mesh is not None:
            self._rows = pmesh.channel_slice(mesh, self.n_channels)
        # Code tables of the two runtimes: padded chips (scan) and tiled
        # code bits (batch).
        self.codes = torch.from_numpy(code_table(prns)).to(self.device)
        self.bits3x = torch.from_numpy(
            batch_runtime.tiled_code_bits(prns)).to(self.device)
        self.mode_host = np.where(
            np.asarray([p > 0 for p in self.prns]), MODE_ACQUIRING, MODE_IDLE
        ).astype(np.int32)
        self.state: ChannelState = dataclasses.replace(
            init_state(self.n_channels, self.device),
            mode=torch.tensor(self.mode_host, device=self.device))
        spms = cfg.samples_per_ms
        self.total_samples = 0
        # Host history (the last required_ms of IQ): the serial search
        # reads it and a checkpoint stores it.
        hist = self.acq_cfg.required_ms * spms
        self._hist_re = np.zeros(hist, dtype=np.float32)
        self._hist_im = np.zeros(hist, dtype=np.float32)
        # Device-resident acquisition ring: the PCPS search reads the last
        # required_ms of samples straight from device memory (kept by the
        # block step from the samples already uploaded for tracking), so a
        # search re-uploads nothing.
        self._ring_re = torch.zeros(hist, dtype=torch.float32,
                                    device=self.device)
        self._ring_im = torch.zeros_like(self._ring_re)
        # Window tail (previous block's last tail_ms milliseconds), host.
        tail = cfg.tail_ms * spms
        self._tail_re = np.zeros(tail, dtype=np.float32)
        self._tail_im = np.zeros(tail, dtype=np.float32)
        self._code_ffts: dict[int, np.ndarray] | None = None
        self._shift_matrices: dict[int, np.ndarray] = {}
        self.acq_results: dict[int, dict] = {}
        # Earliest total_samples at which a failed channel may retry.
        self._acq_retry_at: dict[int, int] = {}

    # ------------------------------------------------------------------
    def _update_hist(self, block_re, block_im):
        h = len(self._hist_re)
        n = len(block_re)
        if n >= h:
            self._hist_re[:] = block_re[-h:]
            self._hist_im[:] = block_im[-h:]
        else:
            self._hist_re = np.roll(self._hist_re, -n)
            self._hist_im = np.roll(self._hist_im, -n)
            self._hist_re[-n:] = block_re
            self._hist_im[-n:] = block_im

    # ------------------------------------------------------------------
    def _maybe_acquire(self) -> int:
        """Search for channels in ACQUIRING mode once enough history;
        returns the number of channels searched."""
        pending = [
            i for i in range(self.n_channels)
            if self.mode_host[i] == MODE_ACQUIRING
            and self.total_samples >= self._acq_retry_at.get(i, 0)
        ]
        need = self.acq_cfg.required_ms * self.cfg.samples_per_ms
        if not pending or self.total_samples < need:
            return 0
        if self.acq_cfg.method == "serial":
            self._acquire_serial(pending)
            return len(pending)
        if self._code_ffts is None:
            self._code_ffts = {
                i: acq.code_fft_conj(self.prns[i],
                                     self.cfg.sampling_frequency)
                for i in range(self.n_channels) if self.prns[i] > 0
            }
        code_k = np.stack([self._code_ffts[i] for i in pending])
        bins = acq.doppler_bins(self.acq_cfg.doppler_range,
                                self.acq_cfg.doppler_step)
        iq_re = self._ring_re[None, :].expand(len(pending), need)
        iq_im = self._ring_im[None, :].expand(len(pending), need)
        doppler, code_idx, metric, cmap = acq.acquire(
            (iq_re, iq_im), code_k, bins,
            sampling_frequency=self.cfg.sampling_frequency,
            intermediate_frequency=self.cfg.intermediate_frequency,
            coherent=self.acq_cfg.coherent,
            non_coherent=self.acq_cfg.non_coherent,
        )
        # Chip-resolution correlation map for diagnostics/report, reduced
        # on the device before the copy.
        spc = max(1, round(self.cfg.sampling_frequency / GPS_L1CA_CODE_FREQ))
        n_chip = cmap.shape[-1] // spc
        cmap_dec = cmap[:, :, :n_chip * spc].reshape(
            cmap.shape[0], cmap.shape[1], n_chip, spc).amax(dim=-1).cpu()
        doppler = doppler.cpu().numpy()
        code_idx = code_idx.cpu().numpy()
        metric = metric.cpu().numpy()

        for j, i in enumerate(pending):
            self.acq_results[i] = {
                "prn": self.prns[i],
                "doppler": float(doppler[j]),
                "code_index": int(code_idx[j]),
                "metric": float(metric[j]),
                "corr_map": cmap_dec[j].numpy(),
                "corr_dopplers": np.asarray(bins, np.float32),
            }
        self._hand_off(pending)
        return len(pending)

    def _acquire_serial(self, pending) -> None:
        """Time-domain serial-search acquisition (one code period)."""
        spms = self.cfg.samples_per_ms
        bins = acq.doppler_bins(self.acq_cfg.doppler_range,
                                self.acq_cfg.doppler_step)
        bins_dev = torch.from_numpy(bins).to(self.device)
        iq_re = torch.from_numpy(self._hist_re[-spms:].copy()).to(self.device)
        iq_im = torch.from_numpy(self._hist_im[-spms:].copy()).to(self.device)
        samples_per_chip = self.cfg.sampling_frequency / GPS_L1CA_CODE_FREQ
        for i in pending:
            # One shift matrix on the device at a time (40 MB at 10 Msps);
            # the host keeps a PRN's matrix only while its search may retry.
            if i not in self._shift_matrices:
                self._shift_matrices[i] = acq.code_shift_matrix(
                    self.prns[i], self.cfg.sampling_frequency)
            shift = torch.from_numpy(self._shift_matrices[i]).to(self.device)
            cmap = acq.serial_search(
                iq_re, iq_im, shift, bins_dev,
                sampling_frequency=self.cfg.sampling_frequency,
                intermediate_frequency=self.cfg.intermediate_frequency)
            (fi, ci_chips), metric = acq.peak_metric_ss(cmap)
            # Chip-shift k peaks when the stream phase is 1023 - k chips;
            # convert to the PCPS sample-index convention.
            code_idx = int(round(float(ci_chips) * samples_per_chip)) % spms
            self.acq_results[i] = {
                "prn": self.prns[i],
                "doppler": float(bins[int(fi)]),
                "code_index": code_idx,
                "metric": float(metric),
            }
            if float(metric) >= self.acq_cfg.threshold:
                del self._shift_matrices[i]
        self._hand_off(pending)

    def _hand_off(self, searched) -> None:
        """Acquisition -> tracking handoff of the channels just searched,
        from their ``acq_results``: above the threshold a channel starts
        tracking at the found Doppler, at the last code boundary of the
        acquisition window; below it the channel re-arms or goes idle."""
        samples_per_code = round(
            self.cfg.sampling_frequency * GPS_L1CA_CODE_LENGTH
            / GPS_L1CA_CODE_FREQ)
        mode = np.array(self.mode_host)
        # Host copies (np.array copies: .numpy() of a CPU tensor aliases it).
        carrier = np.array(self.state.carrier_freq.cpu())
        anchor = np.array(self.state.freq_anchor.cpu())
        code_off = np.array(self.state.code_freq_offset.cpu())
        unread = np.array(self.state.unread.cpu())
        for i in searched:
            res = self.acq_results[i]
            if np.float32(res["metric"]) < self.acq_cfg.threshold:
                mode[i] = self._acq_fail_mode(i)
                continue
            self._acq_retry_at.pop(i, None)
            mode[i] = MODE_TRACKING
            doppler = np.float32(res["doppler"])
            carrier[i] = self.cfg.intermediate_frequency + doppler
            anchor[i] = carrier[i]
            if not self.cfg.carrier_aiding:
                code_off[i] = doppler * (
                    GPS_L1CA_CODE_FREQ / GPS_L1CA_CARRIER_FREQ)
            # Start at the last code boundary of the acquisition window.
            unread[i] = samples_per_code - res["code_index"] - 1
        self.mode_host = mode

        def dev(x):
            return torch.tensor(x, device=self.device)

        self.state = dataclasses.replace(
            self.state, mode=dev(mode), carrier_freq=dev(carrier),
            freq_anchor=dev(anchor), code_freq_offset=dev(code_off),
            unread=dev(unread))

    # ------------------------------------------------------------------
    @property
    def block_input_samples(self) -> int:
        """Raw input samples one ``process_block`` call consumes (callers
        must re-read this every block: promotion changes the block shape)."""
        return (self.cfg.superblock * self.cfg.block_ms
                * self.cfg.samples_per_ms * self.cfg.input_decimate)

    def _maybe_promote(self, out) -> None:
        """Pull-in -> cruise handoff (see :class:`CruisePolicy`)."""
        if self.cruise_cfg is None or self.promoted:
            return
        tracking = self.mode_host == MODE_TRACKING
        if not tracking.any():
            return
        # Channels on their FIRST acquisition attempt hold promotion;
        # channels in retry backoff (already searched once) do not.
        for i in range(self.n_channels):
            if (self.mode_host[i] == MODE_ACQUIRING
                    and i not in self.acq_results):
                return
        flags = out["flags"][-1]
        pll = out["pll_lock"][-1]
        pol = self.cruise_policy
        ok = all(
            (not pol.require_bit_sync or int(flags[i]) & FLAG_BIT_SYNC)
            and pll[i] >= pol.min_pll_lock
            for i in np.nonzero(tracking)[0])
        self._stable_blocks = self._stable_blocks + 1 if ok else 0
        if self._stable_blocks >= pol.stable_blocks:
            self._promote()

    def _zero_filters(self) -> None:
        # One tensor per field: reset_channel writes fields in place.
        names = ("dll_memory", "pll_memory", "fll_memory", "fll_vel",
                 "fll_acc")
        self.state = dataclasses.replace(self.state, **{
            n: torch.zeros_like(self.state.dll_memory) for n in names})

    def _promote(self) -> None:
        """Swap to the cruise configuration at this block boundary.

        The channel state is runtime-independent and carries over; only the
        loop-filter memories are zeroed (the two shapes' filters hold
        differently-scaled internal states).
        """
        old = (f"{self.cfg.profile}/{self.cfg.block_ms}ms"
               f"/sb{self.cfg.superblock}")
        self._zero_filters()
        self.cfg = self.cruise_cfg
        self.promoted = True
        logger.info(
            "promoted %s -> %s/%dms/sb%d (all channels stable)", old,
            self.cfg.profile, self.cfg.block_ms, self.cfg.superblock)

    # ------------------------------------------------------------------
    def _acq_fail_mode(self, i: int) -> int:
        """Mode after a below-threshold search: re-arm with backoff."""
        if self.acq_cfg.retry_backoff_ms <= 0:
            return MODE_IDLE
        self._acq_retry_at[i] = self.total_samples + (
            self.acq_cfg.retry_backoff_ms * self.cfg.samples_per_ms)
        return MODE_ACQUIRING

    # ------------------------------------------------------------------
    def process_block(self, block_re: np.ndarray, block_im: np.ndarray):
        """Process ``superblock * block_ms`` milliseconds of IQ.

        Returns host outputs ``[superblock * block_ms, n_ch]``.

        Spans (``utils.metrics``): ``sydr.session.block`` a call, and under
        it, in turn, ``.boxcar`` (the host's decimation), ``.quantise``
        (the window and its int8 form), ``.upload`` (to the device),
        ``.step`` (the device step: ``sydr.step.*`` under it when graphed),
        ``.history`` (the tail and the acquisition history), ``.acquire``
        (``searches``; ``sydr.acq.*`` under it), ``.copy_back`` (the
        outputs to the host: waits for the step) and ``.promote``.
        """
        cfg = self.cfg
        expect = cfg.superblock * cfg.block_ms * cfg.samples_per_ms
        dec = cfg.input_decimate
        if len(block_re) != expect * dec or len(block_im) != expect * dec:
            raise ValueError(
                f"block of {len(block_re)} samples, expected {expect * dec}")
        with span("sydr.session.block"):
            with span("sydr.session.block.boxcar"):
                if dec > 1:
                    # Boxcar pre-correlation decimation (cfg.input_decimate),
                    # on the host so the upload also shrinks by the factor.
                    block_re = np.float32(block_re).reshape(-1, dec).sum(1)
                    block_im = np.float32(block_im).reshape(-1, dec).sum(1)
            with span("sydr.session.block.quantise"):
                window_re = np.concatenate([self._tail_re, block_re])
                window_im = np.concatenate([self._tail_im, block_im])
                if cfg.upload_int8:
                    peak = max(
                        float(np.max(np.abs(window_re))),
                        float(np.max(np.abs(window_im))), 1e-12,
                    )
                    scale = 120.0 / peak
                    up_re = np.clip(np.rint(window_re * scale), -127, 127
                                    ).astype(np.int8)
                    up_im = np.clip(np.rint(window_im * scale), -127, 127
                                    ).astype(np.int8)
                    inv_scale = np.float32(1.0 / scale)
                else:
                    up_re, up_im = window_re, window_im
                    inv_scale = np.float32(1.0)
            with span("sydr.session.block.upload"):
                up_re = torch.from_numpy(up_re).to(self.device)
                up_im = torch.from_numpy(up_im).to(self.device)
            with span("sydr.session.block.step"):
                packed_f, packed_i, keys_f, keys_i = self._step(
                    up_re, up_im, inv_scale)
            self.total_samples += expect
            with span("sydr.session.block.history"):
                tail = cfg.tail_ms * cfg.samples_per_ms
                self._tail_re = window_re[-tail:]
                self._tail_im = window_im[-tail:]
                self._update_hist(block_re, block_im)
            with span("sydr.session.block.acquire") as acquiring:
                acquiring.set(searches=self._maybe_acquire())
            with span("sydr.session.block.copy_back"):
                # Two bulk copies instead of one per output key (copies on
                # the CPU too: a graph's packed outputs are its static
                # tensors).
                host_f = packed_f.to("cpu", copy=True).numpy()
                host_i = packed_i.to("cpu", copy=True).numpy()
            out = {k: host_f[..., j] for j, k in enumerate(keys_f)}
            for j, k in enumerate(keys_i):
                col = host_i[..., j]
                out[k] = col.astype(bool) if k in self._BOOL_KEYS else col
            with span("sydr.session.block.promote"):
                self._maybe_promote(out)
            return out

    def _step(self, up_re, up_im, inv_scale):
        """One device step of the current configuration: the packed run's
        ``inner`` (:meth:`_make_packed_run`) on the packed state, eagerly
        or through the session's graph. Sets the state and the ring (copies
        the next replay cannot overwrite) and returns (packed_f, packed_i,
        float keys, int keys); the packed outputs of a replay are the
        graph's, valid until its next replay."""
        cfg = self.cfg
        if cfg not in self._packed_runs:
            self._packed_runs[cfg] = self._make_packed_run(cfg)
        inner, keys = self._packed_runs[cfg]
        state_f, state_i = pack_state(self.state)
        args = (state_f, state_i, up_re, up_im,
                torch.full((), float(inv_scale), dtype=torch.float32,
                           device=self.device),
                self._ring_re, self._ring_im)
        if self.graph is None:
            outs = inner(*args)
        else:
            outs = self.graph.run((cfg, up_re.shape[0], up_re.dtype), inner,
                                  args)
        state_f, state_i, packed_f, packed_i, ring_re, ring_im = outs
        self.state = unpack_state(state_f, state_i)
        self._ring_re = ring_re.clone()
        self._ring_im = ring_im.clone()
        return packed_f, packed_i, keys["f"], keys["i"]

    def _make_packed_run(self, cfg):
        """The device step of ``cfg`` as a pure function of tensors, the
        JAX session's ``inner``: ``inner(state_f, state_i, up_re, up_im,
        inv_scale, ring_re, ring_im) -> (state_f, state_i, packed_f,
        packed_i, ring_re, ring_im)`` with the state packed
        (``channels.state.pack_state``), ``inv_scale`` a 0-dim float32
        tensor, the outputs ``[T, n_ch]`` packed into ``[T, n_ch, k]``
        float32 and int32 tensors. Dequantise the window, append its fresh
        samples to the acquisition ring, run the block (or superblock) and
        pack. Returns ``(inner, keys)``; ``keys["f"]``/``keys["i"]`` are the
        sorted output names of each packed tensor, set by ``inner``'s first
        run (as the JAX function sets them while tracing)."""
        # ``inner`` holds no reference to the session: a graph captured from
        # it is freed with the session, not at a later garbage collection.
        bits3x, codes = self.bits3x, self.codes
        hist_n = self._ring_re.shape[0]
        tail_n = cfg.tail_ms * cfg.samples_per_ms
        keys: dict[str, tuple] = {}
        pack_outputs = self._pack_outputs
        sharded_step = None
        if self.mesh is not None:
            sharded_step = functools.partial(
                _sharded_step,
                pmesh.make_sharded_batch_step(
                    cfg, self.mesh,
                    k_blocks=cfg.superblock if cfg.runtime == "batch" else 1),
                self.mesh, self._rows, self.n_channels,
                (bits3x if cfg.runtime == "batch" else codes)[self._rows])

        def roll_ring(ring, fresh):
            if fresh.shape[0] >= hist_n:
                return fresh[fresh.shape[0] - hist_n:]
            return torch.cat([ring[fresh.shape[0]:], fresh])

        def inner(state_f, state_i, up_re, up_im, inv_scale, ring_re,
                  ring_im):
            wre = up_re.to(torch.float32) * inv_scale
            wim = up_im.to(torch.float32) * inv_scale
            ring_re = roll_ring(ring_re, wre[tail_n:])
            ring_im = roll_ring(ring_im, wim[tail_n:])
            if sharded_step is not None:
                state_f, state_i, packed_f, packed_i = sharded_step(
                    keys, state_f, state_i, wre, wim)
                return state_f, state_i, packed_f, packed_i, ring_re, ring_im
            state = unpack_state(state_f, state_i)
            if cfg.runtime != "batch":
                state, outputs = runtime.run_superblock(
                    cfg, cfg.superblock, codes, state, wre, wim)
            elif cfg.superblock > 1:
                state, outputs = batch_runtime.run_superblock(
                    cfg, cfg.superblock, bits3x, state, wre, wim)
            else:
                state, outputs = batch_runtime.run_block_batched(
                    cfg, bits3x, state, wre, wim)
            packed_f, packed_i = pack_outputs(outputs, keys)
            state_f, state_i = pack_state(state)
            return state_f, state_i, packed_f, packed_i, ring_re, ring_im

        return inner, keys

    @staticmethod
    def _pack_outputs(outputs, keys):
        """Outputs ``[T, n_ch]`` packed into ``[T, n_ch, k]`` float32 and
        int32 tensors; their sorted key tuples go into ``keys``."""
        keys["f"] = tuple(sorted(
            k for k, v in outputs.items() if v.dtype == torch.float32))
        keys["i"] = tuple(sorted(
            k for k, v in outputs.items() if v.dtype != torch.float32))
        packed_f = torch.stack([outputs[k] for k in keys["f"]], dim=-1)
        packed_i = torch.stack(
            [outputs[k].to(torch.int32) for k in keys["i"]], dim=-1)
        return packed_f, packed_i

    # ------------------------------------------------------------------
    def or_flags(self, i: int, mask: int) -> None:
        """OR decode-progress bits (SUBFRAME_SYNC/TOW_DECODED/EPH_DECODED)
        into channel ``i``'s device flags."""
        # In place, where the JAX session rebuilds the array (.at[i].set).
        self.state.flags[i] |= mask

    # ------------------------------------------------------------------
    def reset_channel(self, i: int) -> None:
        """Reset channel ``i`` to ACQUIRING (lock-loss reacquisition).

        A promoted session DEMOTES to the pull-in configuration first: a
        freshly-acquired channel carries up to half a Doppler bin of
        carrier error, outside the cruise loop's pull range.
        :meth:`_maybe_promote` restores cruise once every channel is stable
        again.
        """
        count("sydr.session.resets")
        self._demote()
        fresh = init_state(self.n_channels, self.device)
        fresh.mode.fill_(MODE_ACQUIRING)
        # In place, where the JAX session rebuilds every leaf (.at[i].set).
        for name in FIELDS:
            getattr(self.state, name)[i] = getattr(fresh, name)[i]
        self.mode_host[i] = MODE_ACQUIRING
        self.acq_results.pop(i, None)
        self._acq_retry_at.pop(i, None)

    def _demote(self) -> None:
        """Swap back from cruise to the pull-in configuration."""
        if not self.promoted:
            return
        old = (f"{self.cfg.profile}/{self.cfg.block_ms}ms"
               f"/sb{self.cfg.superblock}")
        self._zero_filters()
        self.cfg = self._pullin_cfg
        self.promoted = False
        self._stable_blocks = 0
        logger.info(
            "demoted %s -> %s/%dms/sb%d (channel reacquisition)", old,
            self.cfg.profile, self.cfg.block_ms, self.cfg.superblock)


def _sharded_step(step, mesh, rows, n_channels, tables, keys, state_f,
                  state_i, wre, wim):
    """The block (or superblock) on this rank's channel ``rows`` (with their
    ``tables``); the new state and the outputs of every rank are gathered
    over ``ch``: one row-major float32 and one int32 tensor each way, state
    columns first, then the outputs ``[T, rows, k]`` as ``T * k`` columns.
    Returns the packed state and outputs of every channel."""
    local, outputs = step(
        tables, unpack_state(state_f[rows], state_i[rows]), wre, wim)
    out_f, out_i = TrackingSession._pack_outputs(outputs, keys)
    st_f, st_i = pack_state(local)
    n_t, n_rows = out_f.shape[:2]

    def gather(state_cols, out):
        cols = out.permute(1, 0, 2).reshape(n_rows, -1)
        both = distributed.gather_axis(
            mesh, "ch", torch.cat([state_cols, cols], dim=1))
        n_st = state_cols.shape[1]
        return both[:, :n_st], both[:, n_st:].reshape(
            n_channels, n_t, -1).permute(1, 0, 2)

    st_f, packed_f = gather(st_f, out_f)
    st_i, packed_i = gather(st_i, out_i)
    return st_f, st_i, packed_f, packed_i

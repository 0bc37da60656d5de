"""Scan-runtime tracking of a stream already on the card: the
``scan_stream`` engine.

Set-up renders a sky (``sky``: visible satellites among the
configuration's PRNs, C/N0, Doppler and its rate) on the device: a pull-in
segment, copied to the host, and after it a pool of ``pool_s`` seconds
that stays on the device as float32. A ``TrackingSession`` (acquisition,
then the scan runtime's per-millisecond loops at one 20 ms block a call)
runs ``process_block`` over the pull-in segment until it promotes to its
cruise configuration: the same loops, ``superblock`` blocks a call. The
window then takes the session's configuration, state and code table and
runs ``runtime.run_superblock`` (one ``csrc/scan_block.cu`` launch a
block) through ``ops.step_graph.StepGraph`` (the state packed by
``channels.state.pack_state``) on consecutive windows of the pool,
superblocks dispatched back to back with up to ``in_flight`` whose outputs
have not reached pinned host memory yet. At the pool's end the stream
restarts from the state saved at promotion, as the next pass over a
recording.

``correct``: the start (at promotion every visible satellite tracked and
no absent PRN), and a sample of the window's superblocks, drawn from the
seed, against the plain scan block (``reference/scan_block.py``) run from
each one's input state over the same samples on the same device, on its
own and step by step along the program's path (``numbers``).
"""

from __future__ import annotations

import collections
import dataclasses
import time

import numpy as np
import torch

from benchmark import sky
from benchmark.engines import Reservoir
from benchmark.reference import scan_block as ref

CORR_KEYS = ("i_early", "q_early", "i_prompt", "q_prompt", "i_late",
             "q_late")
# Integers that no rounding moves once the loops are locked: activity,
# flags, lock state, bit sync and its counters.
COUNTER_OUTPUTS = ("active", "flags", "lock_state", "bit_ready")
COUNTER_FIELDS = ("mode", "flags", "code_counter", "ms_counter", "edge_hist",
                  "bit_edge", "accum_count", "lock_state")
STEP_INTS = ("active", "flags", "unread", "required", "lock_state",
             "bit_ready")
# The program's outputs that the reference runs along step by step (the
# reference's ``follow=``).
FOLLOW_KEYS = ("active", "rem_code", "unread", "carrier_freq", "code_freq",
               "dll_error", "pll_error", "i_prompt", "q_prompt", "pll_lock",
               "fll_lock", "flags", "lock_state", "cn0")


def _as_np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _gap(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float64)
                               - np.asarray(b, np.float64)), initial=0))


def _mismatch(a, b) -> int:
    return int(np.sum(np.asarray(a).astype(np.int64)
                      != np.asarray(b).astype(np.int64)))


def _taps(out):
    """The three correlators (E, P, L) as ``[T, n_ch, 3]`` real and
    imaginary float64 parts."""
    return tuple(np.stack([out[f"{c}_{t}"].astype(np.float64)
                           for t in ("early", "prompt", "late")], axis=-1)
                 for c in "iq")


def _rotation_gap(prog, ref_out) -> np.ndarray:
    """``[T, n_ch]``: the distance between the program's (E, P, L) and the
    reference's after the carrier rotation of the program's that brings
    them closest (the phase of their inner product; none where it is 0).
    Real arithmetic, each product rounded apart, so equal taps read 0."""
    (ar, ai), (br, bi) = _taps(prog), _taps(ref_out)
    re = np.sum(ar * br + ai * bi, axis=-1, keepdims=True)
    im = np.sum(ar * bi - ai * br, axis=-1, keepdims=True)
    size = np.hypot(re, im)
    c = np.where(size > 0, re / np.where(size > 0, size, 1.0), 1.0)
    s = np.where(size > 0, im / np.where(size > 0, size, 1.0), 0.0)
    return np.sqrt(np.sum((c * ar - s * ai - br) ** 2
                          + (s * ar + c * ai - bi) ** 2, axis=-1))


def numbers(prog_out, prog_state, ref_out, ref_state, step_out,
            block_ms) -> dict:
    """The compared numbers of one superblock (``{name: array}`` dicts of
    outputs ``[T, n_ch]`` and new states), from the same input state over
    the same samples: the program's against the reference's own run
    (``ref_out``, ``ref_state``) and against the reference run step by
    step along the program's path (``step_out``, the reference's
    ``follow=``). Correlators are taken over the median tracking channel's
    prompt RMS in the reference's first block (``scale``).

    Step by step: each epoch of the reference starts from the program's
    state after its previous epoch and correlates at its code rate, so both
    read the same samples at the same chips, and every epoch of every
    block parts only by that epoch's arithmetic: the six correlators
    (``stepwise.corr_gap``); the carrier frequency and the code phase that
    the epoch's loops and phase advance hand on, over the active
    channel-epochs (``stepwise.carrier_gap_hz``,
    ``stepwise.code_gap_chips``); the integer outputs, equal
    (``stepwise.int_mismatch``).

    The reference's own run: the first epoch reads the same state and
    samples, so its six correlators part only by their sums' order
    (``first_epoch.corr_gap``). From the second epoch on, one
    ulp of a correlator moves the next epoch's code phase, and a chip
    boundary somewhere in the superblock can take another sample (a tie:
    one sound run read a code phase 1.4e-5 chip apart within the first
    block), so the two runs are compared where such a parting does not
    show. A weak channel's two Costas loops can part by half a cycle and
    more (the loops are blind to it, as to a data bit), so the correlators
    are held up to one carrier rotation an epoch and channel: the distance
    between the program's and the reference's (E, P, L) after the rotation
    that brings them closest, a rotation the Costas loops cannot see; a
    wrong correlator, a tap against the others, does not rotate away
    (``all_blocks.corr_gap``). With it each tracking channel's mean prompt
    power over the superblock, relative (``all_blocks.power_gap``), and the
    integers no rounding moves, every epoch and the new state
    (``counter_mismatch``)."""
    po = {k: _as_np(v) for k, v in prog_out.items()}
    ro = {k: _as_np(v) for k, v in ref_out.items()}
    ps = {k: _as_np(v) for k, v in prog_state.items()}
    rs = {k: _as_np(v) for k, v in ref_state.items()}
    first = slice(0, block_ms)
    active = ro["active"].astype(bool)
    tracking = active.any(axis=0)
    p_ref = (ro["i_prompt"].astype(np.float64) ** 2
             + ro["q_prompt"].astype(np.float64) ** 2)
    p_prog = (po["i_prompt"].astype(np.float64) ** 2
              + po["q_prompt"].astype(np.float64) ** 2)
    rms = np.sqrt(np.mean(p_ref[first], axis=0))
    scale = float(np.median(rms[tracking])) if tracking.any() else 1.0
    power_gap = 0.0
    for c in np.nonzero(tracking)[0]:
        on = active[:, c]
        mean_ref = float(np.mean(p_ref[on, c]))
        power_gap = max(power_gap, abs(float(np.mean(p_prog[on, c]))
                                       - mean_ref) / mean_ref)
    so = {k: _as_np(v) for k, v in step_out.items()}
    stepped = po["active"].astype(bool) | so["active"].astype(bool)
    resid = _rotation_gap(po, ro)
    return {
        "first_epoch.corr_gap": max(
            _gap(po[k][:1], ro[k][:1]) for k in CORR_KEYS) / scale,
        "stepwise.corr_gap": max(
            _gap(po[k], so[k]) for k in CORR_KEYS) / scale,
        "stepwise.carrier_gap_hz": _gap(po["carrier_freq"][stepped],
                                        so["carrier_freq"][stepped]),
        "stepwise.code_gap_chips": _gap(po["rem_code"][stepped],
                                        so["rem_code"][stepped]),
        "stepwise.int_mismatch": float(sum(
            _mismatch(po[k], so[k]) for k in STEP_INTS)),
        "all_blocks.corr_gap": float(resid.max(initial=0)) / scale,
        "all_blocks.power_gap": power_gap,
        "counter_mismatch": float(
            sum(_mismatch(po[k], ro[k]) for k in COUNTER_OUTPUTS)
            + sum(_mismatch(ps[k], rs[k]) for k in COUNTER_FIELDS)),
    }


def plant(kind: str, out: dict, ref_out: dict, block_ms: int) -> dict:
    """The program's outputs with a fault planted past the superblock's
    first block, for the faults' readings: ``late_answer``, the prompt of
    the strongest tracking channel negated (a data bit flipped) at one
    epoch of the last block; ``late_scaled``, the six correlators 3% low
    from the second block on."""
    out = {k: np.array(_as_np(v), copy=True) for k, v in out.items()}
    if kind == "late_answer":
        ref_p = np.abs(_as_np(ref_out["i_prompt"])).mean(axis=0)
        c = int(np.argmax(ref_p))
        e = out["i_prompt"].shape[0] - block_ms // 2
        out["i_prompt"][e, c] *= -1
        out["q_prompt"][e, c] *= -1
    elif kind == "late_scaled":
        for k in CORR_KEYS:
            out[k][block_ms:] *= np.float32(0.97)
    else:
        raise ValueError(f"no fault {kind!r}")
    return out


FAULTS = ("late_answer", "late_scaled")


class Engine:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.cfg, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        self.fs = float(config["sampling_frequency"])
        self.f_if = float(config["intermediate_frequency"])
        self.spms = round(self.fs * 1e-3)
        self.prns = list(config["prns"])
        self.in_flight = int(traffic["in_flight"])
        trk, cru = config["tracking"], config["cruise"]
        self.tail_n = trk["tail_ms"] * self.spms
        self.sb_n = cru["superblock"] * cru["block_ms"] * self.spms
        self.sb_s = self.sb_n / self.fs
        self.passes = int(round(traffic["pool_s"] * self.fs)) // self.sb_n
        self.sample = None
        self.phases: dict = {}
        self.start_numbers: dict = {}
        self.resets: list = []          # PRNs reset in pull-in

    # -- set-up ---------------------------------------------------------
    def _tracking_configs(self):
        from sydr_tpu_torch.channels.runtime import TrackingConfig

        names = {f.name for f in dataclasses.fields(TrackingConfig)}
        common = {k: tuple(v) if isinstance(v, list) else v
                  for k, v in self.cfg["tracking"].items() if k in names}
        common.update(sampling_frequency=self.fs,
                      intermediate_frequency=self.f_if,
                      window_size=self.spms
                      + self.cfg["tracking"]["window_extra_samples"])
        return (TrackingConfig(**dict(common, **self.cfg["pull_in"])),
                TrackingConfig(**dict(common, **self.cfg["cruise"])))

    def setup(self) -> None:
        t_import = time.perf_counter()
        from sydr_tpu_torch.channels import runtime
        from sydr_tpu_torch.channels.state import pack_state, unpack_state
        from sydr_tpu_torch.ops.step_graph import StepGraph
        from sydr_tpu_torch.receiver.session import (
            AcquisitionConfig, CruisePolicy, TrackingSession)

        t0 = time.perf_counter()
        rng = sky.seed_rng(self.seed)
        gen = sky.torch_generator(self.seed, self.device)
        self.sats = sky.draw_sky(rng, self.prns, **self.traffic["sky"])
        pull_n = int(round(self.traffic["pullin_max_s"] * self.fs))
        total = pull_n + self.passes * self.sb_n
        self.signal = sky.render(self.sats, self.fs, self.f_if, 0, total,
                                 self.device, gen)
        host_re = self.signal[0][:pull_n].cpu().numpy()
        host_im = self.signal[1][:pull_n].cpu().numpy()
        self.sample_rng = np.random.default_rng(
            [self.seed % (1 << 64), 0x57EA])

        t1 = time.perf_counter()
        pull_in, cruise = self._tracking_configs()
        a = {k: v for k, v in self.cfg["acquisition"].items()
             if k in {f.name for f in dataclasses.fields(AcquisitionConfig)}}
        session = TrackingSession(
            pull_in, self.prns, AcquisitionConfig(**a), cruise=cruise,
            cruise_policy=CruisePolicy(**self.cfg["cruise_policy"]),
            device=self.device)
        pos = 0
        out = None
        while not session.promoted:
            n_in = session.block_input_samples
            if pos + n_in > pull_n:
                raise RuntimeError(
                    f"no promotion to cruise within {pull_n / self.fs:g} s "
                    f"of pull-in; channels:\n"
                    + self._channels_table(session, out, pos))
            out = session.process_block(host_re[pos:pos + n_in],
                                        host_im[pos:pos + n_in])
            pos += n_in
            self._recover(session, out)
        self.t_promote = pos
        t2 = time.perf_counter()
        self._start_check(session.mode_host)

        # What the window takes over from the session.
        self.cruise = session.cfg
        self.codes = session.codes
        self.state0 = pack_state(session.state)
        del session
        self.pool = (self.signal[0][pos - self.tail_n:
                                    pos + self.passes * self.sb_n],
                     self.signal[1][pos - self.tail_n:
                                    pos + self.passes * self.sb_n])
        cfg, codes, keys = self.cruise, self.codes, {}

        def step(state_f, state_i, win_re, win_im):
            state = unpack_state(state_f, state_i)
            state, outputs = runtime.run_superblock(
                cfg, cfg.superblock, codes, state, win_re, win_im)
            keys["f"] = tuple(sorted(k for k, v in outputs.items()
                                     if v.dtype == torch.float32))
            keys["i"] = tuple(sorted(k for k, v in outputs.items()
                                     if v.dtype != torch.float32))
            packed_f = torch.stack([outputs[k] for k in keys["f"]], dim=-1)
            packed_i = torch.stack(
                [outputs[k].to(torch.int32) for k in keys["i"]], dim=-1)
            sf, si = pack_state(state)
            return sf, si, packed_f, packed_i

        self.keys = keys
        self.step = step
        cuda = self.device.type == "cuda"
        self.graph = StepGraph(self.device, capture=cuda)
        # Warm-up: the capture and two replays of the window's one shape.
        state = self.state0
        for j in range(3):
            outs = self.graph.run("scan", step, (*state, *self._window(j)))
            state = outs[:2]
        pin = cuda
        self.slots = [tuple(torch.empty(t.shape, dtype=t.dtype, pin_memory=pin)
                            for t in (*self.state0, *outs))
                      for _ in range(self.in_flight)]
        if cuda:
            torch.cuda.synchronize()
        self.phases = {"imports": t0 - t_import, "sky": t1 - t0,
                       "pull_in": t2 - t1,
                       "capture": time.perf_counter() - t2}

    def _recover(self, session, out) -> None:
        """Reset, to reacquire, a tracking channel that pull-in left unfit
        for cruise: the ``Receiver``'s lock-loss rule with its defaults
        (``ReceiverConfig.reacq_no_bitsync_*``: no bit sync after the budget
        of code periods with a weak PLL lock, or after the hard budget);
        and a channel that holds bit sync but not the PLL lock promotion
        asks for (``cruise_policy.min_pll_lock``) after the budget, a
        clause of the benchmark's own (the ``stream`` engine's)."""
        from sydr_tpu_torch.receiver.receiver import ReceiverConfig

        rule = {f.name: f.default for f in dataclasses.fields(ReceiverConfig)}
        budget = rule["reacq_no_bitsync_epochs"]
        min_lock = self.cfg["cruise_policy"]["min_pll_lock"]
        codes = session.state.code_counter.cpu().numpy()
        for i in np.nonzero(session.mode_host == ref.MODE_TRACKING)[0]:
            synced = int(out["flags"][-1, i]) & ref.FLAG_BIT_SYNC
            weak = float(out["pll_lock"][-1, i]) < (
                min_lock if synced else rule["reacq_no_bitsync_pll"])
            hard = not synced and \
                codes[i] > budget * rule["reacq_no_bitsync_hard_factor"]
            if hard or (codes[i] > budget and weak):
                session.reset_channel(int(i))
                self.resets.append(self.prns[i])

    def _channels_table(self, session, out, pos) -> str:
        """What each channel did in pull-in, against the sky's truth."""
        visible = {s.prn: s for s in self.sats}
        rows = []
        for i, prn in enumerate(self.prns):
            s = visible.get(prn)
            acq = session.acq_results.get(i, {})
            truth = (f"cn0 {s.cn0_dbhz:.1f} doppler "
                     f"{s.doppler_at(pos / self.fs):.1f} code_index "
                     f"{s.code_index(self.fs)}" if s else "absent")
            last = "" if out is None else (
                f" flags {int(out['flags'][-1, i])} pll_lock "
                f"{float(out['pll_lock'][-1, i]):.3f} carrier "
                f"{float(out['carrier_freq'][-1, i]):.1f}")
            rows.append(
                f"PRN {prn:2d} {truth} | acq doppler "
                f"{acq.get('doppler', float('nan')):.1f} code_index "
                f"{acq.get('code_index', -1)} metric "
                f"{acq.get('metric', float('nan')):.3f} | mode "
                f"{int(session.mode_host[i])}{last}")
        return "\n".join(rows)

    def _window(self, p: int):
        lo = p * self.sb_n
        hi = lo + self.tail_n + self.sb_n
        return self.pool[0][lo:hi], self.pool[1][lo:hi]

    def _start_check(self, mode) -> None:
        """The stage the comparison does not follow, by itself: at
        promotion every visible satellite is tracking and no absent PRN
        is."""
        visible = {s.prn for s in self.sats}
        wrong = sum((int(mode[i]) == ref.MODE_TRACKING) != (prn in visible)
                    for i, prn in enumerate(self.prns))
        self.start_numbers = {"start_wrong_channels": float(wrong)}

    # -- the window -----------------------------------------------------
    def _dispatch(self, j: int, state, tracer):
        p = j % self.passes
        if p == 0:
            state = self.state0
        slot = self.slots[j % self.in_flight]
        with tracer.span("bench.step"):
            # The input state first: the replay overwrites the outputs that
            # hold it.
            slot[0].copy_(state[0], non_blocking=True)
            slot[1].copy_(state[1], non_blocking=True)
            outs = self.graph.run("scan", self.step,
                                  (*state, *self._window(p)))
        with tracer.span("bench.copy"):
            for dst, src in zip(slot[2:], outs):
                dst.copy_(src, non_blocking=True)
            done = None
            if self.device.type == "cuda":
                done = torch.cuda.Event()
                done.record()
        return outs[:2], {"j": j, "slot": slot, "done": done}

    def window(self, seconds: float, tracer) -> dict:
        trace_units = int(self.traffic["trace_units"])
        from sydr_tpu_torch.channels.state import unpack_state

        tracking = int(np.sum(_as_np(unpack_state(*self.state0).mode)
                              == ref.MODE_TRACKING))
        cru = self.cfg["cruise"]
        tracer.counters.update(
            tracking_channels=tracking, channels=len(self.prns),
            blocks=cru["superblock"], block_ms=cru["block_ms"],
            spms=self.spms, taps=len(self.cfg["tracking"]["spacings"]),
            window_samples=(self.cfg["tracking"]["tail_ms"]
                            + cru["block_ms"]) * self.spms)
        keep = Reservoir(int(self.traffic["compare"]), self.sample_rng)
        pending = collections.deque()
        state = self.state0
        j = done = 0
        traced_from = None
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        window_s = None
        while window_s is None:
            while len(pending) < self.in_flight:
                if traced_from is None and tracer.enabled:
                    tracer.start()
                    traced_from = j
                state, rec = self._dispatch(j, state, tracer)
                pending.append(rec)
                j += 1
            rec = pending.popleft()
            with tracer.span("bench.wait"):
                if rec["done"] is not None:
                    rec["done"].synchronize()
            t_done = time.perf_counter()
            done += 1
            keep.offer(lambda: (rec["j"],
                                tuple(t.numpy().copy() for t in rec["slot"])))
            if traced_from is not None and tracer.active and \
                    rec["j"] + 1 - traced_from >= trace_units:
                # Every superblock dispatched since the start ends inside
                # the stretch (the tracer waits for the device).
                tracer.stop(j - traced_from)
            if t_done - t0 >= seconds:
                window_s = t_done - t0
        if tracer.active:       # the window closed first
            tracer.stop(j - traced_from)
        while pending:          # due after the close: not counted
            rec = pending.popleft()
            if rec["done"] is not None:
                rec["done"].synchronize()
        self.sample = keep.sample()
        rtf = done * self.sb_s / window_s
        active = [int(self._named(h[4], h[5], state=False)["active"].sum())
                  for _, (_, h) in self.sample]
        return {"attempted": j, "failed": 0, "metrics": {"rtf": rtf},
                "lines": [f"superblocks {done} of {self.sb_s:g} s in "
                          f"{window_s:.4f} s (rtf {rtf:.4f}); "
                          f"{tracking} channels tracking; promotion after "
                          f"{self.t_promote / self.fs:.3f} s of pull-in, "
                          f"channels reset in pull-in: PRN {self.resets}; "
                          f"active channel-epochs in the sampled "
                          f"superblocks {active}"]}

    def release(self) -> None:
        self.graph = None
        self.step = None

    # -- correct ------------------------------------------------------------
    def _named(self, packed_f, packed_i, state=True):
        from sydr_tpu_torch.channels.state import (
            FIELDS, state_to_numpy, unpack_state)

        if state:
            st = state_to_numpy(unpack_state(torch.from_numpy(packed_f),
                                             torch.from_numpy(packed_i)))
            return {k: st[k] for k in FIELDS}
        out = {k: packed_f[..., n] for n, k in enumerate(self.keys["f"])}
        out.update({k: packed_i[..., n]
                    for n, k in enumerate(self.keys["i"])})
        return out

    def compare(self, control: bool = False, faults=()) -> dict:
        """The worst of each number over the sample: the program's (or,
        ``control``, the reference in bfloat16 in its place), and, for each
        of ``faults``, the program's outputs with it planted
        (``fault.<kind>.<number>``)."""
        params = ref.Params(self.cfg)
        codes = torch.from_numpy(ref.code_table(self.prns)).to(self.device)
        worst = {} if control else dict(self.start_numbers)

        def keep(nums, prefix=""):
            for name, v in nums.items():
                worst[prefix + name] = max(worst.get(prefix + name, 0.0), v)

        for _, (j, host) in self.sample:
            sf_in, si_in, sf, si, pf, pi = host
            state_in = {k: torch.from_numpy(np.ascontiguousarray(v)).to(
                self.device) for k, v in self._named(sf_in, si_in).items()}
            win = self._window(j % self.passes)
            ref_state, ref_out = ref.run_superblock(params, codes, state_in,
                                                    *win)
            if control:
                got_state, got_out = ref.run_superblock(
                    params, codes, state_in, *win, precision="bfloat16")
            else:
                got_state = self._named(sf, si)
                got_out = self._named(pf, pi, state=False)
            follow = {k: torch.from_numpy(np.ascontiguousarray(
                _as_np(got_out[k]))).to(self.device) for k in FOLLOW_KEYS}
            _, step_out = ref.run_superblock(params, codes, state_in, *win,
                                             follow=follow)
            keep(numbers(got_out, got_state, ref_out, ref_state, step_out,
                         params.block_ms))
            # A fault planted in the answer leaves the path it followed.
            for kind in faults:
                keep(numbers(plant(kind, got_out, ref_out, params.block_ms),
                             got_state, ref_out, ref_state, step_out,
                             params.block_ms), f"fault.{kind}.")
        return worst

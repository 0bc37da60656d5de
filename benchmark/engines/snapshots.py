"""Cold-start acquisition of snapshots: the ``snapshots`` engine.

A request is one receiver's snapshot (``coherent * non_coherent`` ms of
IQ), searched for every PRN of the configuration over the full Doppler
grid by one call of ``sydr_tpu_torch.ops.acquisition.acquire``: the
snapshot is uploaded from pinned host memory and expanded over the PRN
rows, as ``TrackingSession._maybe_acquire`` expands its ring. Set-up
renders a pool of skies (``sky``: visible count, C/N0, Doppler ranges) on
the device into pinned host memory; the window cycles through it, closed
loop with ``in_flight`` requests sent before the oldest one's results
are read to the host.

``correct``: the maps, Dopplers, code indices and metrics of a sample of
the completed requests, drawn from the seed, against the plain reference
(``reference/acquisition.py``, float64, mixed per bin) on the same
snapshots.
"""

from __future__ import annotations

import collections
import contextlib
import statistics
import time

import numpy as np
import torch

from benchmark import sky
from benchmark.engines import Reservoir
from benchmark.reference import acquisition as ref_acq


def numbers(prog_map, fi, ci, metric, ref_map, fs) -> dict:
    """The compared numbers of one request, worst row: ``map_gap`` (the
    map's widest gap over the row's peak), ``cell_gap`` (how far the
    reference's map at the receiver's chosen Doppler bin and code index
    lies below its peak, over the peak: 0 where the receiver chose the
    reference's peak, small where two cells all but tie in a row of noise;
    1 where the Doppler is no bin) and ``metric_gap`` (the receiver's
    two-peak metric against the reference's at the receiver's chosen
    cell, relative; 1 where the Doppler is no bin)."""
    peak = ref_map.amax(dim=(1, 2))
    gap = (prog_map.to(torch.float64) - ref_map).abs().amax(dim=(1, 2))
    bad = fi < 0
    fi_ok = torch.where(bad, 0, fi)
    rows = torch.arange(ref_map.shape[0], device=ref_map.device)
    chosen = ref_map[rows, fi_ok, ci]
    cell_gap = torch.where(bad, 1.0, (peak - chosen) / peak)
    m_ref = ref_acq.metric_at(ref_map, fi_ok, ci, fs)
    metric_gap = torch.where(bad, 1.0, (metric.to(torch.float64) - m_ref).abs()
                             / m_ref)
    return {"map_gap": float((gap / peak).max()),
            "cell_gap": float(cell_gap.max()),
            "metric_gap": float(metric_gap.max())}


def plant(kind: str, ci, metric):
    """The receiver's code indices with a fault planted, for the faults'
    readings: ``answer_altered``, the code index of the row with the
    highest metric one sample off."""
    if kind != "answer_altered":
        raise ValueError(f"no fault {kind!r}")
    ci = ci.clone()
    ci[torch.argmax(metric)] += 1
    return ci


FAULTS = ("answer_altered",)


class Engine:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.cfg, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        acq = config["acquisition"]
        self.fs = float(config["sampling_frequency"])
        self.f_if = float(config["intermediate_frequency"])
        self.n = round(self.fs * 1e-3)
        self.coh, self.nc = acq["coherent"], acq["non_coherent"]
        self.n_snap = self.coh * self.nc * self.n
        self.prns = list(config["prns"])
        self.in_flight = int(traffic["in_flight"])
        self.sample = None
        self.phases: dict = {}

    # -- set-up ---------------------------------------------------------
    def setup(self) -> None:
        t_import = time.perf_counter()
        from sydr_tpu_torch.ops import acquisition as acq

        t0 = time.perf_counter()
        a = self.cfg["acquisition"]
        rng = sky.seed_rng(self.seed)
        gen = sky.torch_generator(self.seed, self.device)
        pool = int(self.traffic["pool"])
        pin = self.device.type == "cuda"
        self.pool_re = torch.empty((pool, self.n_snap), dtype=torch.float32,
                                   pin_memory=pin)
        self.pool_im = torch.empty((pool, self.n_snap), dtype=torch.float32,
                                   pin_memory=pin)
        for k in range(pool):
            sats = sky.draw_sky(rng, self.prns, **self.traffic["sky"])
            re, im = sky.render(sats, self.fs, self.f_if, 0, self.n_snap,
                                self.device, gen)
            self.pool_re[k].copy_(re)
            self.pool_im[k].copy_(im)
        self.sample_rng = np.random.default_rng(
            [self.seed % (1 << 64), 0x5A17])
        # The receiver's inputs: the conjugate code spectra on the device,
        # the bins on the host (acquire takes both as the session does).
        self.code_k = torch.as_tensor(np.stack(
            [acq.code_fft_conj(p, self.fs) for p in self.prns])).to(
                device=self.device, dtype=torch.complex64)
        self.bins = acq.doppler_bins(a["doppler_range"], a["doppler_step"])
        self.up = [(torch.empty(self.n_snap, device=self.device),
                    torch.empty(self.n_snap, device=self.device))
                   for _ in range(self.in_flight)]
        rows = len(self.prns)
        self.host = [(torch.empty(rows, pin_memory=pin),
                      torch.empty(rows, dtype=torch.int32, pin_memory=pin),
                      torch.empty(rows, pin_memory=pin))
                     for _ in range(self.in_flight)]
        # Warm-up: every shape of the window (one request shape), and the
        # kernels built at their first launch.
        t1 = time.perf_counter()
        for k in range(self.in_flight + 1):
            rec = self._send(k, k % self.in_flight, None)
            self._wait(rec)
        self.phases = {"imports": t0 - t_import, "sky": t1 - t0,
                       "warm_up": time.perf_counter() - t1}

    # -- one request ----------------------------------------------------
    def _send(self, k: int, slot: int, tracer):
        from sydr_tpu_torch.ops import acquisition as acq

        span = tracer.span if tracer is not None \
            else (lambda name: contextlib.nullcontext())
        p = k % self.pool_re.shape[0]
        t_sent = time.perf_counter()
        up_re, up_im = self.up[slot]
        rows = len(self.prns)
        with span("bench.upload"):
            up_re.copy_(self.pool_re[p], non_blocking=True)
            up_im.copy_(self.pool_im[p], non_blocking=True)
        with span("bench.acquire"):
            doppler, code_idx, metric, cmap = acq.acquire(
                (up_re[None].expand(rows, self.n_snap),
                 up_im[None].expand(rows, self.n_snap)),
                self.code_k, self.bins, sampling_frequency=self.fs,
                intermediate_frequency=self.f_if, coherent=self.coh,
                non_coherent=self.nc)
        h_d, h_c, h_m = self.host[slot]
        with span("bench.results"):
            h_d.copy_(doppler, non_blocking=True)
            h_c.copy_(code_idx, non_blocking=True)
            h_m.copy_(metric, non_blocking=True)
            done = None
            if self.device.type == "cuda":
                done = torch.cuda.Event()
                done.record()
        return {"k": k, "p": p, "slot": slot, "t": t_sent, "done": done,
                "map": cmap}

    def _wait(self, rec) -> dict:
        if rec["done"] is not None:
            rec["done"].synchronize()
        h_d, h_c, h_m = self.host[rec["slot"]]
        return {"p": rec["p"], "map": rec["map"],
                "doppler": h_d.numpy().copy(),
                "code_index": h_c.numpy().copy(), "metric": h_m.numpy().copy()}

    # -- the window -----------------------------------------------------
    def window(self, seconds: float, tracer) -> dict:
        rows = len(self.prns)
        trace_units = int(self.traffic["trace_units"])
        f_bin = self.fs / self.n
        tracer.counters.update(
            rows=rows, bins=len(self.bins), non_coherent=self.nc, n=self.n,
            phases=len({round(float(b) % f_bin, 6) for b in self.bins}))
        keep = Reservoir(int(self.traffic["compare"]), self.sample_rng)
        pending = collections.deque()
        latencies = []
        k = sent = 0
        traced_from = None
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        window_s = None
        while window_s is None:
            while len(pending) < self.in_flight:
                if traced_from is None and tracer.enabled:
                    tracer.start()
                    traced_from = k
                pending.append(self._send(k, k % self.in_flight, tracer))
                k += 1
                sent += 1
            rec = pending.popleft()
            with tracer.span("bench.wait"):
                got = self._wait(rec)
            t_done = time.perf_counter()
            latencies.append(t_done - rec["t"])
            keep.offer(lambda: got)
            if traced_from is not None and tracer.active and \
                    rec["k"] + 1 - traced_from >= trace_units:
                # Every request sent since the start ends inside the
                # stretch (the tracer waits for the device).
                tracer.stop(k - traced_from)
            if t_done - t0 >= seconds:
                window_s = t_done - t0
        if tracer.active:       # the window closed first
            tracer.stop(k - traced_from)
        while pending:              # due after the close: not counted
            self._wait(pending.popleft())
        self.sample = keep.sample()
        done = len(latencies)
        p95 = float(np.percentile(np.asarray(latencies) * 1e3, 95))
        med = statistics.median(latencies) * 1e3
        return {
            "attempted": sent, "failed": 0,
            "metrics": {"searches_per_s": done * rows / window_s,
                        "search_p95_ms": p95},
            "lines": [f"requests {done} in {window_s:.4f} s, {rows} searches "
                      f"each; latency median {med:.4f} ms, p95 {p95:.4f} "
                      f"ms over {done} requests"],
        }

    def release(self) -> None:
        self.up = None
        self.code_k = None

    # -- correct ------------------------------------------------------------
    def compare(self, control: bool = False, faults=()) -> dict:
        """The worst of each number over the sample: the receiver's (or,
        ``control``, the reference in bfloat16 in its place), and, for each
        of ``faults``, the receiver's answers with it planted
        (``fault.<kind>.<number>``)."""
        a = self.cfg["acquisition"]
        bins = ref_acq.doppler_bins(a["doppler_range"], a["doppler_step"])
        worst: dict = {}

        def keep(nums, prefix=""):
            for name, v in nums.items():
                worst[prefix + name] = max(worst.get(prefix + name, 0.0), v)

        for _, got in self.sample:
            p = got["p"]
            snap = (self.pool_re[p].to(self.device),
                    self.pool_im[p].to(self.device))
            kw = dict(fs=self.fs, f_if=self.f_if, bins=bins,
                      coherent=self.coh, non_coherent=self.nc)
            ref = ref_acq.pcps_map(*snap, self.prns, **kw)
            if control:
                ctl = ref_acq.pcps_map(*snap, self.prns, precision="bfloat16",
                                       **kw)
                fi, ci, m = ref_acq.peak_metric(ctl, self.fs)
                keep(numbers(ctl, fi, ci, m, ref, self.fs))
                del ctl
            else:
                fi = _bin_index(got["doppler"], bins, self.device)
                ci = torch.from_numpy(got["code_index"].astype(np.int64)).to(
                    self.device)
                m = torch.from_numpy(got["metric"]).to(self.device)
                keep(numbers(got["map"], fi, ci, m, ref, self.fs))
                for kind in faults:
                    keep(numbers(got["map"], fi, plant(kind, ci, m), m, ref,
                                 self.fs), f"fault.{kind}.")
            del ref
        return worst


def _bin_index(doppler, bins, device):
    """The bin of each Doppler the receiver returned, -1 where it is no
    bin of the grid."""
    fi = np.rint((doppler.astype(np.float64) - bins[0])
                 / (bins[1] - bins[0])).astype(np.int64)
    ok = (fi >= 0) & (fi < len(bins))
    ok[ok] &= np.float32(bins[fi[ok]]) == doppler[ok]
    return torch.from_numpy(np.where(ok, fi, -1)).to(device)


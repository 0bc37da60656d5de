"""Seeded GPS L1 C/A skies, made on the device: the benchmark's generator.

A torch copy of the signal model of the receiver's synthetic generator
(``sydr_tpu_torch/signal/synthetic.py``, ``IQGenerator``), with a Doppler
that drifts linearly in time. Satellite ``s`` at sample ``k`` (``t = k /
fs``)::

    x_s = A * D(phi) * C(phi) * exp(j * (2 pi (f_if t + cyc(t)) + theta0))
    cyc(t) = fd * t + rate * t^2 / 2                    (Doppler cycles)
    phi(t) = phi0 + CODE_FREQ * (t + cyc(t) / CARRIER_FREQ)   (chips)

``C`` is chip ``floor(phi) mod 1023``, ``D`` the +/-1 nav bit
``floor(phi / 20460)`` (cycled), ``A = sqrt(10^(cn0 / 10) / fs)`` against
unit-power complex noise. Phases are float64 on the device; samples are
float32. One traffic file's parameters (``draw_sky``) and the seed fix
every sample.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from benchmark.cacode import CARRIER_FREQ, CODE_FREQ, CODE_LENGTH, code

CHIPS_PER_BIT = CODE_LENGTH * 20
CHUNK = 1 << 22                 # samples rendered at once


@dataclasses.dataclass
class Satellite:
    prn: int
    cn0_dbhz: float
    doppler_hz: float           # at t = 0
    doppler_rate_hz_s: float
    code_phase_chips: float     # absolute chips since data bit 0 at t = 0
    carrier_phase_rad: float
    nav_bits: np.ndarray        # +/-1, cycled

    def doppler_at(self, t: float) -> float:
        return self.doppler_hz + self.doppler_rate_hz_s * t

    def code_index(self, fs: float) -> int:
        """The sample of the first code start at or after sample 0 within
        one code period: where acquisition finds this satellite's peak."""
        n = round(fs * 1e-3)
        chips = self.code_phase_chips % CODE_LENGTH
        return round((CODE_LENGTH - chips) * fs / CODE_FREQ) % n


def seed_rng(seed: int) -> np.random.Generator:
    return np.random.default_rng(seed % (1 << 64))


def torch_generator(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (1 << 63))
    return gen


def uniform(rng, lo_hi) -> float:
    lo, hi = lo_hi
    return float(rng.uniform(lo, hi)) if hi > lo else float(lo)


def draw_sky(rng, prns, visible, cn0_dbhz, doppler_hz,
             doppler_rate_hz_s=(0.0, 0.0), n_bits=600) -> list[Satellite]:
    """``visible``: [lo, hi] satellites (inclusive) drawn among ``prns``,
    or a dict ``{"prns": [...]}`` naming them. Each has C/N0, Doppler and
    its rate uniform in their ranges, a uniform code phase, a random bit
    phase (whole code periods, which move the bit grid and not the
    correlation peak), a uniform carrier phase and random nav bits."""
    if isinstance(visible, dict):
        chosen = sorted(int(p) for p in visible["prns"])
    else:
        n_vis = int(rng.integers(visible[0], visible[1] + 1))
        chosen = sorted(int(p) for p in rng.choice(prns, n_vis,
                                                   replace=False))
    sats = []
    for prn in chosen:
        sats.append(Satellite(
            prn=prn, cn0_dbhz=uniform(rng, cn0_dbhz),
            doppler_hz=uniform(rng, doppler_hz),
            doppler_rate_hz_s=uniform(rng, doppler_rate_hz_s),
            code_phase_chips=float(rng.uniform(0.0, CODE_LENGTH))
            + CODE_LENGTH * int(rng.integers(0, 20)),
            carrier_phase_rad=float(rng.uniform(0.0, 2.0 * math.pi)),
            nav_bits=rng.integers(0, 2, n_bits) * 2 - 1))
    return sats


def render(sats, fs: float, f_if: float, start: int, n: int, device,
           noise: torch.Generator | None):
    """Samples ``[start, start + n)`` of the sky as float32 ``(re, im)`` on
    ``device``, with unit-power complex noise drawn from ``noise`` (None:
    no noise)."""
    re = torch.empty(n, dtype=torch.float32, device=device)
    im = torch.empty(n, dtype=torch.float32, device=device)
    codes = [torch.from_numpy(code(s.prn)).to(device) for s in sats]
    bits = [torch.from_numpy(np.asarray(s.nav_bits, np.float64)).to(device)
            for s in sats]
    for c0 in range(0, n, CHUNK):
        m = min(CHUNK, n - c0)
        k = torch.arange(start + c0, start + c0 + m, dtype=torch.float64,
                         device=device)
        t = k / fs
        acc_re = torch.zeros(m, dtype=torch.float64, device=device)
        acc_im = torch.zeros_like(acc_re)
        for s, chips, nav in zip(sats, codes, bits):
            cyc = s.doppler_hz * t + 0.5 * s.doppler_rate_hz_s * t * t
            turns = cyc + f_if * t
            phase = 2.0 * math.pi * (turns - torch.floor(turns)) \
                + s.carrier_phase_rad
            phi = s.code_phase_chips + CODE_FREQ * (t + cyc / CARRIER_FREQ)
            chip = torch.floor(phi).to(torch.int64)
            sym = chips[torch.remainder(chip, CODE_LENGTH)] * nav[
                torch.remainder(torch.div(chip, CHIPS_PER_BIT,
                                          rounding_mode="floor"), len(nav))]
            amp = math.sqrt(10.0 ** (s.cn0_dbhz / 10.0) / fs)
            acc_re += amp * sym * torch.cos(phase)
            acc_im += amp * sym * torch.sin(phase)
        if noise is not None:
            w = torch.randn(2, m, generator=noise, dtype=torch.float32,
                            device=device) * math.sqrt(0.5)
            acc_re += w[0]
            acc_im += w[1]
        re[c0:c0 + m] = acc_re
        im[c0:c0 + m] = acc_im
    return re, im

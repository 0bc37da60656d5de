"""States for pass A and pass B's geometry, made with numpy from a seed,
shared by ``tests/test_torch_cuda.py`` (the geometry kernel against its
plain version on the card) and ``chip_smoke.py`` (its phase 3); this
module imports no JAX.

:func:`geometry_state` gives a state of one of :data:`KINDS`: random
tracking, acquiring and idle channels (``"random"``); code phases at
chip-boundary ties, a zero code-rate offset and Doppler with code phases
at whole multiples of the code step and one float32 ulp beside them, so
that the epoch boundaries' ceil lands on or next to an integer
(``"ties"``); carrier phases at 0 and 2 pi and just inside
(``"carrier-edges"``); sample deficits that defer whole blocks
(``"deficit"``).
"""

from __future__ import annotations

import numpy as np

from sydr_tpu_torch.channels.state import (
    MODE_ACQUIRING,
    MODE_IDLE,
    MODE_TRACKING,
    init_state,
    state_from_numpy,
    state_to_numpy,
)

KINDS = ("random", "ties", "carrier-edges", "deficit")


def geometry_state(cfg, n_ch: int, kind: str, rng, device):
    """A ``ChannelState`` of ``n_ch`` channels of ``kind`` (module note)
    on ``device``, for ``cfg``'s rate and IF."""
    import torch

    spms = cfg.samples_per_ms
    if_hz = cfg.intermediate_frequency
    lv = state_to_numpy(init_state(n_ch, torch.device("cpu")))
    lv["mode"][:] = rng.choice([MODE_TRACKING] * 6 + [MODE_IDLE,
                                                     MODE_ACQUIRING], n_ch)
    lv["carrier_freq"] = np.float32(rng.uniform(-5000, 5000, n_ch) + if_hz)
    lv["rem_code"] = np.float32(rng.uniform(-0.5, 1.5, n_ch))
    lv["rem_carrier"] = np.float32(rng.uniform(0, 2 * np.pi, n_ch))
    lv["code_freq_offset"] = np.float32(rng.uniform(-6, 6, n_ch))
    lv["unread"] = np.int32(rng.integers(spms // 2, (cfg.tail_ms + 1) * spms,
                                         n_ch))
    if kind == "ties":
        lv["code_freq_offset"][:] = 0.0
        lv["carrier_freq"][:] = np.float32(if_hz)
        step = np.float32(np.float32(1.023e6) * np.float32(
            1.0 / cfg.sampling_frequency))
        lv["rem_code"] = np.float32(
            -rng.integers(0, 3, n_ch) * step
            * rng.choice([1.0, 1.0 + 2 ** -23, 1.0 - 2 ** -23], n_ch))
    elif kind == "carrier-edges":
        two_pi = np.float32(2 * np.pi)
        lv["rem_carrier"] = rng.choice(np.float32(
            [0.0, -0.0, 1e-7, two_pi, np.nextafter(two_pi, np.float32(0)),
             -1e-7]), n_ch)
    elif kind == "deficit":
        lv["unread"] = np.int32(rng.integers(-2, 3, n_ch))
        lv["rem_code"][::2] = 0.001
        lv["code_freq_offset"][::2] = -6.0
    elif kind != "random":
        raise ValueError(f"kind: {kind!r}, one of {KINDS}")
    return state_from_numpy(lv, device)

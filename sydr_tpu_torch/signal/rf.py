"""RF sample file ingestion: typed binary IQ readers.

Covers the reference ``RFSignal`` file front-end
(``sydr/signal/rfsignal.py``): int8/int16 samples, real or
interleaved-complex layouts, chunked millisecond reads, and position seeking.
The hot demux/convert path (interleaved int8 -> float32 planes) is done by
the native C++ reader (``native/rf_reader.cpp``) when built, with a numpy
fallback — mirroring the reference's C layer split, but feeding the TPU's
(re, im) float32 planes directly.
"""

from __future__ import annotations

import ctypes
import dataclasses
import os

import numpy as np

_LIB = None
_LIB_TRIED = False


def _native_lib():
    global _LIB, _LIB_TRIED
    if _LIB_TRIED:
        return _LIB
    _LIB_TRIED = True
    native_dir = os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))),
        "native",
    )
    path = os.path.join(native_dir, "librfreader.so")
    if not os.path.exists(path):
        # Build on demand (the .so is not committed); numpy fallback below.
        import subprocess

        try:
            subprocess.run(
                ["make", "-C", native_dir], check=True,
                capture_output=True, timeout=120,
            )
        except (OSError, subprocess.SubprocessError):
            return None
    if not os.path.exists(path):
        return None
    try:
        lib = ctypes.CDLL(path)
        lib.demux_int8_complex.argtypes = [
            ctypes.POINTER(ctypes.c_int8), ctypes.c_long,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ]
        lib.demux_int16_complex.argtypes = [
            ctypes.POINTER(ctypes.c_int16), ctypes.c_long,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ]
        lib.convert_int8_real.argtypes = [
            ctypes.POINTER(ctypes.c_int8), ctypes.c_long,
            ctypes.POINTER(ctypes.c_float),
        ]
        lib.convert_int16_real.argtypes = [
            ctypes.POINTER(ctypes.c_int16), ctypes.c_long,
            ctypes.POINTER(ctypes.c_float),
        ]
        _LIB = lib
    except OSError:
        _LIB = None
    return _LIB


@dataclasses.dataclass
class RFConfig:
    filepath: str
    sampling_frequency: float
    intermediate_frequency: float = 0.0
    data_size: int = 8            # bits per sample component (8 or 16)
    is_complex: bool = True       # interleaved I/Q vs real-only


class RFFileSource:
    """Streaming reader over a recorded IQ file.

    Yields (re, im) float32 plane pairs in whole-millisecond chunks; tracks
    absolute sample position; supports seeking (``skip_ms``).
    """

    def __init__(self, cfg: RFConfig):
        if cfg.data_size not in (8, 16):
            raise ValueError(f"unsupported data_size {cfg.data_size}")
        self.cfg = cfg
        self.samples_per_ms = round(cfg.sampling_frequency * 1e-3)
        self._dtype = np.int8 if cfg.data_size == 8 else np.int16
        self._comps = 2 if cfg.is_complex else 1
        self._bytes_per_sample = (cfg.data_size // 8) * self._comps
        self._fh = open(cfg.filepath, "rb")
        self.sample_position = 0
        size = os.path.getsize(cfg.filepath)
        self.total_samples = size // self._bytes_per_sample

    @property
    def remaining_ms(self) -> int:
        return (self.total_samples - self.sample_position) \
            // self.samples_per_ms

    def skip_ms(self, n_ms: int) -> None:
        n = n_ms * self.samples_per_ms
        self._fh.seek(n * self._bytes_per_sample, os.SEEK_CUR)
        self.sample_position += n

    def read_ms(self, n_ms: int):
        """Read ``n_ms`` milliseconds; returns (re, im) float32 arrays.

        Raises EOFError on a short read (end of file).
        """
        n = n_ms * self.samples_per_ms
        raw = np.frombuffer(
            self._fh.read(n * self._bytes_per_sample), dtype=self._dtype
        )
        if len(raw) < n * self._comps:
            raise EOFError(
                f"requested {n} samples, file has "
                f"{len(raw) // self._comps}"
            )
        self.sample_position += n
        lib = _native_lib()
        if self.cfg.is_complex:
            re = np.empty(n, dtype=np.float32)
            im = np.empty(n, dtype=np.float32)
            if lib is not None:
                fn = (lib.demux_int8_complex if self.cfg.data_size == 8
                      else lib.demux_int16_complex)
                ptr_t = (ctypes.c_int8 if self.cfg.data_size == 8
                         else ctypes.c_int16)
                fn(
                    raw.ctypes.data_as(ctypes.POINTER(ptr_t)), n,
                    re.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                    im.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                )
            else:
                re[:] = raw[0::2].astype(np.float32)
                im[:] = raw[1::2].astype(np.float32)
            return re, im
        if lib is not None:
            re = np.empty(n, dtype=np.float32)
            fn = (lib.convert_int8_real if self.cfg.data_size == 8
                  else lib.convert_int16_real)
            ptr_t = (ctypes.c_int8 if self.cfg.data_size == 8
                     else ctypes.c_int16)
            fn(raw.ctypes.data_as(ctypes.POINTER(ptr_t)), n,
               re.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        else:
            re = raw.astype(np.float32)
        return re, np.zeros_like(re)

    def close(self):
        self._fh.close()


class SyntheticSource:
    """Adapter exposing a Scenario/IQGenerator with the RF source API."""

    def __init__(self, generator):
        self.generator = generator
        self.samples_per_ms = generator.spms if hasattr(generator, "spms") \
            else generator.samples_per_ms
        self.sample_position = 0

    def read_ms(self, n_ms: int):
        iq = self.generator.generate_ms(n_ms)
        self.sample_position += len(iq)
        return (
            np.ascontiguousarray(iq.real, dtype=np.float32),
            np.ascontiguousarray(iq.imag, dtype=np.float32),
        )

    def close(self):
        pass

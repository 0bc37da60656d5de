"""The benchmark of ``sydr_tpu_torch``, the PyTorch and CUDA receiver.

Run one cell of ``BENCHMARK.json`` once::

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Everything a cell names lives in files of its own, found by name:
``configs/<config>.json`` (a deployment's sizes and settings),
``traffic/<traffic>.json`` (the parameters of one traffic mix, read by the
engine it names under ``engines/``), ``metrics/<metric>.py`` (one reader
per per-layer metric) and ``limits/<cell>.json`` (the limits of the
numbers that decide ``correct``). The yardstick (``sky.py``,
``cacode.py``, ``roofline.py`` and the plain references under
``reference/``) imports nothing of the receiver.
"""

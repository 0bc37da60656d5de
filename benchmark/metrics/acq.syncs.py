"""``acq.syncs``: the host's waits on the device in one ``acquire`` call:
the median over the traced requests of the ``syncs`` of each ``sydr.acq``
span and every span under it (the program's recorder, which records while
the profiler runs)."""

import statistics


def read(trace):
    try:
        from sydr_tpu_torch.utils.metrics import RECORDER
    except ImportError:         # a program without the recorder
        return None
    trees = RECORDER.trees("sydr.acq")
    if not trees:
        return None
    return statistics.median(sum(s.syncs for s in tree) for tree in trees)

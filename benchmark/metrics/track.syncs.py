"""``track.syncs``: the host's waits on the device in one
``StepGraph.run``: the median over the traced superblocks of the
``syncs`` of each ``sydr.step`` span and every span under it (the
program's recorder, which records while the profiler runs)."""

import statistics


def read(trace):
    try:
        from sydr_tpu_torch.utils.metrics import RECORDER
    except ImportError:         # a program without the recorder
        return None
    trees = RECORDER.trees("sydr.step")
    if not trees:
        return None
    return statistics.median(sum(s.syncs for s in tree) for tree in trees)

"""``scan.graph_nodes``: the node count of the graph that the traced scan
superblocks replayed (the ``nodes`` of their ``sydr.step.replay`` spans,
``Captured.nodes``; the median, should they differ): one scan kernel
launch a block and the packing."""

import statistics


def read(trace):
    try:
        from sydr_tpu_torch.utils.metrics import RECORDER
    except ImportError:         # a program without the recorder
        return None
    nodes = [s.attrs.get("nodes") for s in RECORDER.find("sydr.step.replay")]
    nodes = [n for n in nodes if n is not None]
    return statistics.median(nodes) if nodes else None

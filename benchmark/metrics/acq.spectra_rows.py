"""``acq.spectra_rows``: the rows that a traced request's forward spectra
mixed and transformed: the median ``rows`` of ``acquire``'s
``sydr.acq.spectra`` spans (1 where every PRN row is one snapshot, the
rows otherwise; the program's recorder). A program whose spans carry no
``rows`` reads ``None``."""

import statistics


def read(trace):
    try:
        from sydr_tpu_torch.utils.metrics import RECORDER
    except ImportError:         # a program without the recorder
        return None
    rows = [s.attrs.get("rows") for s in RECORDER.find("sydr.acq.spectra")]
    rows = [r for r in rows if r is not None]
    return statistics.median(rows) if rows else None

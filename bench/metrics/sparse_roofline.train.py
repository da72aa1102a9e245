"""Kernels B1-B4 in a training step: the sum of every launch's least time
(``bench/work/bounds.py`` at the cell's sizes; counts from the program's
launch counters) over those kernels' device time in the traced slice, in
%."""
from bench.metrics import _common as C
from bench.work import bounds

UNIT = "%"


def read(record):
    sl = C.traced(record, "train")
    if sl is None:
        return None
    per_step = bounds.train_products(record["model"], sl["rows"], sl["seq"])
    least = sum(C.bound_seconds(per_step[f],
                                C.launch_count(sl["launches"], f))
                for f in ("spmm", "sddmm"))
    spent = C.kernel_seconds(sl["trace"], {**C.SPMM, **C.SDDMM})
    if not least or not spent:
        return None
    return 100.0 * least / spent

"""Kernel B5 in a batch of prompts: the sum of each launch's least time
(``bench/work/bounds.py`` at the cell's rows and length) over B5's device
time in the traced slice, in %."""
from bench.metrics import _common as C
from bench.work import bounds

UNIT = "%"


def read(record):
    sl = C.traced(record, "prefill")
    if sl is None:
        return None
    per = bounds.prefill_attn_products(record["model"], sl["rows"],
                                       sl["seq"])
    least = C.bound_seconds(per, C.launch_count(sl["launches"], "attn"))
    spent = C.kernel_seconds(sl["trace"], C.ATTN)
    if not least or not spent:
        return None
    return 100.0 * least / spent

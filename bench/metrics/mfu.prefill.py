"""The whole prefill's share of the card's bf16 peak over the measured
window: the frozen work count (``bench/work/count.py``) of every batch of the
window over its time at 989 TFLOP/s, in %."""
from bench.metrics._common import mfu

UNIT = "%"


def read(record):
    return mfu(record, "prefill")

"""The device's idle share of the traced slice of the prefill cells: 1 - the
union of its operations' intervals over the slice's wall time, in %."""
from bench.metrics._common import idle_share

UNIT = "%"


def read(record):
    return idle_share(record, "prefill")

"""Kernel launch calls the host makes a batch of prompts (``cudaLaunchKernel`` and its
kin in the traced slice's trace): the host-issue layer of the prefill cells."""
from bench.metrics._common import launches_per_unit

UNIT = "launches/batch"


def read(record):
    return launches_per_unit(record, "prefill")

"""Kernel launch calls the host makes a step (``cudaLaunchKernel`` and its
kin in the traced slice's trace): the host-issue layer of the train cells."""
from bench.metrics._common import launches_per_unit

UNIT = "launches/step"


def read(record):
    return launches_per_unit(record, "train")

"""The control, the reference computed in fp8 in the program's place, fails
each cell's comparison; so do the planted faults of a training cell.
Taken at a size a CPU test holds (``bench/calibrate.py`` takes them on the
card at the cell's size)."""
from __future__ import annotations

import pytest

from bench.core import cells, control

import bench_smoke

# deeper and wider than the other CPU tests, so that fp8's rounding grows
# over the layers as it does at the cells' size
MODEL = {"n_layers": 4, "d_model": 256, "n_heads": 4, "n_kv_heads": 4,
         "head_dim": 64, "d_ff": 1024, "vocab_size": 2048,
         "ffn": {"density": 0.1, "block": [32, 32], "nnzb": 112}}


def _fails(values: dict, limits: dict) -> bool:
    return any(values[k] > v for k, v in limits.items() if k in values)


@pytest.mark.parametrize("name", cells.names("workloads"))
def test_control_and_faults_fail(name):
    cell = bench_smoke.small(name, MODEL)
    got = control.readings(cell, bench_smoke.SEED, bench_smoke.CPU)
    for reading, values in got.items():
        assert _fails(values, cell.limits), (reading, values, cell.limits)

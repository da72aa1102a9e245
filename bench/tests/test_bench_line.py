"""The result line: its keys in order, the cell's metrics with
``BENCHMARK.json``'s units, the device, the compared numbers last (and as
the last lines of standard error); no result without a card."""
from __future__ import annotations

import json
import subprocess
import sys

import pytest

from bench.core import cells, result

import bench_smoke

SPEC = json.loads((cells.BENCH.parent / "BENCHMARK.json").read_text())


def _expected(name, trace):
    if trace:
        return {m["name"]: m["unit"] for m in SPEC["per_layer"]
                if name in m.get("workloads", [name])}
    return {m["name"]: m["unit"] for m in SPEC["end_to_end"]
            if name in m.get("workloads", [name])}


@pytest.mark.parametrize("name", cells.names("workloads"))
def test_end_to_end_line(name, capsys):
    line = bench_smoke.run(bench_smoke.small(name))
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert {k: v["unit"] for k, v in line["metrics"].items()} == \
        _expected(name, False)
    assert all(v["value"] > 0 for k, v in line["metrics"].items()
               if k != "peak_mem_gb")          # no card: no device memory
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    assert set(line["checks"]) == set(cells.load(name).limits)
    result.emit(line)
    out, err = capsys.readouterr()
    assert json.loads(out.strip().splitlines()[-1]) == line
    tail = err.strip().splitlines()[-len(line["checks"]):]
    assert all(t.startswith("check ") and "limit" in t for t in tail)


@pytest.mark.parametrize("name", cells.names("workloads"))
def test_traced_line_reads_only_what_the_cpu_has(name):
    # no device trace here: the readers of host-clock and span metrics
    # read, the device readers stay silent
    line = bench_smoke.run(bench_smoke.small(name), trace=True)
    want = _expected(name, True)
    assert set(line["metrics"]) <= set(want)
    assert {"prepare_s", f"mfu.{cells.load(name).driver}"} <= \
        set(line["metrics"])
    assert all(want[k] == v["unit"] for k, v in line["metrics"].items())


def test_no_result_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    proc = subprocess.run(
        [sys.executable, str(cells.BENCH / "run.py"), "--workload",
         "ffn-train", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=cells.BENCH.parent, timeout=300)
    assert proc.returncode == 2 and proc.stdout == ""


@pytest.mark.cuda
@pytest.mark.parametrize("name", cells.names("workloads"))
def test_a_short_run_on_the_card(name):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    proc = subprocess.run(
        [sys.executable, str(cells.BENCH / "run.py"), "--workload", name,
         "--seed", str(2 ** 31 + 11), "--seconds", "5", "--trace", "0"],
        capture_output=True, text=True, cwd=cells.BENCH.parent, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"

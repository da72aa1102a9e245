"""The data files: every cell names a configuration, a traffic mix and a
driver that exist and agree with ``BENCHMARK.json``; a new cell, and a new
per-layer reader, are picked up from a file alone."""
from __future__ import annotations

import json
import shutil

import pytest

from bench.core import cells, runner

import bench_smoke

ROOT = cells.BENCH.parent
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("name", cells.names("workloads"))
def test_workload_file_names_config_traffic_and_driver(name):
    cell = cells.load(name)
    assert cell.config["name"] == cell.config_name
    assert cell.traffic["kind"] == cell.driver
    assert cells.NAME.match(cell.traffic_name)
    assert cells.driver(cell).KIND == cell.driver
    assert cell.chips == 1 and cell.limits
    assert 0 < len(cell.why) <= 200 and "\n" not in cell.why


def test_benchmark_json_matches_the_files():
    assert sorted(w["name"] for w in SPEC["workloads"]) == \
        cells.names("workloads")
    for w in SPEC["workloads"]:
        cell = cells.load(w["name"])
        assert (w["config"], w["traffic"], w["chips"], w["why"]) == \
            (cell.config_name, cell.traffic_name, cell.chips, cell.why)
    for c in SPEC["configs"]:
        assert c["file"] == f"bench/configs/{c['name']}.json"
        config = json.loads((ROOT / c["file"]).read_text())
        assert (config["source"], config["reduced"]) == \
            (c["source"], c["reduced"])
    readers = runner.readers()
    assert sorted(m["name"] for m in SPEC["per_layer"]) == sorted(readers)
    for m in SPEC["per_layer"]:
        assert readers[m["name"]].UNIT == m["unit"]


def test_a_new_cell_is_found_from_its_file_alone(tmp_path, monkeypatch):
    copy = tmp_path / "bench"
    for kind in ("configs", "workloads", "metrics"):
        shutil.copytree(cells.BENCH / kind, copy / kind)
    w = json.loads((copy / "workloads" / "ffn-train.json").read_text())
    w["traffic"] = {**w["traffic"], **bench_smoke.TRAIN,
                    "name": "train-small"}
    (copy / "workloads" / "ffn-train-small.json").write_text(json.dumps(w))
    monkeypatch.setattr(cells, "BENCH", copy)
    assert "ffn-train-small" in cells.names("workloads")
    cell = cells.load("ffn-train-small")
    assert cell.traffic_name == "train-small"
    assert cell.traffic["rows"] == bench_smoke.TRAIN["rows"]
    line = bench_smoke.run(bench_smoke.small("ffn-train-small"))
    assert line["correct"] and line["attempted"] >= 1


def test_a_new_reader_is_found_from_its_file_alone(tmp_path, monkeypatch):
    copy = tmp_path / "bench"
    for kind in ("configs", "workloads", "metrics"):
        shutil.copytree(cells.BENCH / kind, copy / kind)
    (copy / "metrics" / "steps_seen.train.py").write_text(
        'UNIT = "steps"\n\n\ndef read(record):\n'
        '    return record["window"]["units"] '
        'if record["kind"] == "train" else None\n')
    monkeypatch.setattr(cells, "BENCH", copy)
    assert "steps_seen.train" in runner.readers()
    line = bench_smoke.run(bench_smoke.small("ffn-train"), trace=True)
    assert line["metrics"]["steps_seen.train"]["unit"] == "steps"
    assert line["metrics"]["steps_seen.train"]["value"] == line["attempted"]

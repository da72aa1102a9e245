"""A cell (one entry of ``BENCHMARK.json``'s ``workloads``) as its data
files describe it, each found by name:

* ``bench/workloads/<cell>.json``: the configuration's name, the driver
  (``bench/drivers/<driver>.py``), the chips, why the cell exists, the
  limits of its correctness check, and ``traffic``: the mix's name and the
  parameters the driver's generator reads (rows, lengths, the optimizer of
  a training job);
* ``bench/configs/<config>.json``: the model as it is run (widths, the
  sparse FFN's blocks, the attention mask), its source and its cuts.

Adding a cell or a configuration is adding these files.
"""
from __future__ import annotations

import dataclasses
import importlib
import json
import re
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
MODEL_KEYS = ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim",
              "d_ff", "vocab_size", "dtype", "rope_theta", "norm_eps",
              "mlp_act", "ffn", "attention")


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    config_name: str
    traffic_name: str
    driver: str
    chips: int
    why: str
    limits: dict
    model: dict          # the configuration's widths (``MODEL_KEYS``)
    config: dict         # the whole configuration file
    traffic: dict        # the mix's parameters, its ``name`` among them


def _read(kind: str, name: str) -> dict:
    if not NAME.match(name):
        raise ValueError(f"bad {kind} name {name!r}")
    path = BENCH / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path}")
    return json.loads(path.read_text())


def names(kind: str = "workloads") -> list:
    """The names of every file of ``kind`` (``workloads``, ``configs``,
    ``metrics``) under ``bench/``."""
    suffix = ".py" if kind == "metrics" else ".json"
    return sorted(p.name[:-len(suffix)] for p in (BENCH / kind).iterdir()
                  if p.name.endswith(suffix) and not p.name.startswith("_"))


def load(name: str) -> Cell:
    """The cell ``name`` from its files."""
    w = _read("workloads", name)
    config = _read("configs", w["config"])
    traffic = dict(w["traffic"])
    return Cell(name=name, config_name=w["config"],
                traffic_name=traffic["name"], driver=w["driver"],
                chips=int(w["chips"]), why=w["why"],
                limits=dict(w["limits"]),
                model={k: config[k] for k in MODEL_KEYS}, config=config,
                traffic=traffic)


def driver(cell: Cell):
    """The module ``bench/drivers/<driver>.py``."""
    if not cell.driver.isidentifier():
        raise ValueError(f"bad driver name {cell.driver!r}")
    return importlib.import_module(f"bench.drivers.{cell.driver}")

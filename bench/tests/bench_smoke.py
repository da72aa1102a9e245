"""The cells at a size a CPU test holds: the same files, the same code,
smaller widths and traffic (the program's plain versions run on the
CPU)."""
from __future__ import annotations

import dataclasses
import time

import torch

from bench.core import cells, program

MODEL = {"n_layers": 2, "d_model": 128, "n_heads": 4, "n_kv_heads": 4,
         "head_dim": 32, "d_ff": 256, "vocab_size": 512,
         "ffn": {"density": 0.3, "block": [16, 16], "nnzb": 48}}
BANDED = {"kind": "banded", "bandwidth": 32, "block": [16, 16]}
PREFILL = {"rows": 2, "seq": 128, "kv_positions": 8, "pool_batches": 2}
TRAIN = {"rows": 2, "seq": 64, "pool_batches": 8}
SEED = 2 ** 31 + 5
CPU = torch.device("cpu")
torch.set_num_threads(2)        # several test workers share the CPU


def register(arch: str, model: dict) -> str:
    """A program arch ``arch`` at ``model``'s widths, registered beside
    the program's own for this test process: its name."""
    from repro_torch.configs.archs import ARCHS
    name = (f"{arch}:bench-{model['n_layers']}x{model['d_model']}"
            f"x{model['d_ff']}")
    if name not in ARCHS:
        ARCHS[name] = program.with_widths(ARCHS[arch], model)
    return name


def small(name: str, model: dict | None = None) -> cells.Cell:
    """Cell ``name`` at the CPU size: the same files, smaller widths and
    traffic, run by a program arch of those widths."""
    full = cells.load(name)
    m = {**full.model, **(MODEL if model is None else model)}
    if full.model["attention"]["kind"] == "banded":
        m["attention"] = BANDED
    traffic = {**full.traffic, **(PREFILL if full.driver == "prefill" else
                                  dict(TRAIN, rows=min(TRAIN["rows"],
                                                       full.traffic["rows"])))}
    config = {**full.config,
              "program_arch": register(full.config["program_arch"], m)}
    return dataclasses.replace(full, model=m, traffic=traffic, config=config)


def run(cell, trace: bool = False, seed: int = SEED) -> dict:
    """One run of ``cell`` on the CPU, the harness's look for a card
    skipped: its result object."""
    from bench import run as harness
    return harness.run_cell(cell, seed, 0.2, trace, CPU, time.time())

"""The plain reference against the port's plain path (the program on the
CPU) at a small size: every cell's run compares correct, with its numbers
well inside the cell's limits."""
from __future__ import annotations

import pytest

from bench.core import cells

import bench_smoke


@pytest.mark.parametrize("name", cells.names("workloads"))
def test_program_on_the_cpu_agrees_with_the_reference(name):
    line = bench_smoke.run(bench_smoke.small(name))
    assert line["correct"], line["checks"]
    for c in line["checks"].values():
        assert c["value"] <= c["limit"] / 2


def test_the_reference_prefill_is_the_last_row_of_its_forward():
    import torch

    from bench.core import inputs
    from bench.reference.model import Decoder
    cell = bench_smoke.small("attn-prefill")
    w = inputs.make_weights(cell.model, 3, bench_smoke.CPU)
    dec = Decoder(cell.model, w)
    ids = torch.randint(0, cell.model["vocab_size"], (80,))
    last, k, v = dec.prefill(ids, torch.tensor([0, 79]))
    short, k2, _ = dec.prefill(ids[:40], torch.tensor([0, 39]))
    # causal: the first 40 positions do not see the rest
    assert torch.allclose(k[:, 0], k2[:, 0], rtol=1e-5, atol=1e-6)
    assert last.shape == (cell.model["vocab_size"],)
    assert k.shape == (cell.model["n_layers"], 2, 4, 32)

"""The readings that set a cell's limits from above: the control (the
reference in the program's place, computed in fp8, the precision below the
configurations' bf16) and the faults planted in the reference in the
program's place, each compared with the float32 reference exactly as a
run compares the program (``core.judge``).  ``bench/calibrate.py`` takes
them on the card at the cell's size; ``bench/tests/test_bench_control.py``
at a size a CPU test holds.  The benchmark's own runs do not run them."""
from __future__ import annotations

import torch

from bench.core import inputs, judge
from bench.drivers import prefill, train
from bench.reference import model as ref_model


def prefill_readings(cell, seed: int, device) -> dict:
    """``{reading: {number: value}}`` of a prefill cell on the rows a run
    compares: ``control`` (fp8), ``answer_altered`` (the reference's logits
    with its largest and smallest swapped) and ``cache_unwritten`` (the
    keys and values left zero)."""
    m, traffic = cell.model, cell.traffic
    picks = prefill.kv_picks(traffic, seed)
    ids = prefill.batches_of(m, traffic, seed, device)[0]
    weights = inputs.make_weights(m, seed, device)
    ref = ref_model.Decoder(m, weights)
    ctl = ref_model.Decoder(m, weights, precision="fp8")
    out = {name: {"logits_gap": 0.0, "kv_gap": 0.0}
           for name in ("control", "answer_altered", "cache_unwritten")}
    for j, pos in enumerate(picks):
        pos = torch.as_tensor(pos, device=device)
        want = ref.prefill(ids[j], pos)
        got = ctl.prefill(ids[j], pos)
        swapped = want[0].clone()
        hi, lo = int(swapped.argmax()), int(swapped.argmin())
        swapped[hi], swapped[lo] = want[0][lo], want[0][hi]
        zero_k, zero_v = torch.zeros_like(want[1]), torch.zeros_like(want[2])
        for name, g in (("control", got),
                        ("answer_altered", (swapped, want[1], want[2])),
                        ("cache_unwritten", (want[0], zero_k, zero_v))):
            r = out[name]
            r["logits_gap"] = max(r["logits_gap"],
                                  judge.logits_gap(g[0], want[0]))
            r["kv_gap"] = max(r["kv_gap"], judge.kv_gap(g[1], g[2], want[1],
                                                        want[2]))
    return out


def _half(batch: torch.Tensor) -> torch.Tensor:
    """Half the batch: half its rows, or of one row half its positions."""
    rows, n = batch.shape
    if rows > 1:
        return batch[: rows // 2]
    return batch[:, : (n - 1) // 2 + 1]


def _train_values(got: dict, want: dict) -> dict:
    return {"loss_gap": judge.loss_gap(got["losses"], want["losses"]),
            "grad_gap": judge.leaf_gap(got["grad_norms"],
                                       want["grad_norms"])[0],
            "update_gap": judge.leaf_gap(
                got["delta_norms"], want["delta_norms"],
                keep=judge.moved(want["grad_norms"]))[0]}


def train_readings(cell, seed: int, device) -> dict:
    """``{reading: {number: value}}`` of a training cell over its first
    steps: ``control`` (fp8) and ``half_batch`` (half the batch left out,
    the mean over the rest); a state left unchanged reads 1 on
    ``update_gap`` by its definition and needs no run."""
    m, traffic = cell.model, cell.traffic
    opt, first = traffic["optimizer"], traffic["first_steps"]
    pool = train.batches_of(m, traffic, seed, device)
    batches = [pool[s] for s in range(first)]
    weights = inputs.make_weights(m, seed, device)
    want = ref_model.train_steps(m, weights, batches, opt)
    out = {"control": _train_values(
        ref_model.train_steps(m, weights, batches, opt, precision="fp8"),
        want)}
    out["half_batch"] = _train_values(
        ref_model.train_steps(m, weights, [_half(b) for b in batches], opt),
        want)
    out["state_unchanged"] = {"update_gap": 1.0}
    return out


def readings(cell, seed: int, device) -> dict:
    if cell.driver == "prefill":
        return prefill_readings(cell, seed, device)
    return train_readings(cell, seed, device)

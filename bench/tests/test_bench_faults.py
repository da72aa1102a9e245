"""A whole run with the timed path broken underneath comes out not correct:
the harness's look for a card skipped, the program patched at the point
where each fault the cell can have would arise.  One card, so no
exchange between chips to leave out."""
from __future__ import annotations

import pytest
import torch

import bench_smoke


def _state_unchanged(monkeypatch):
    from repro_torch.optim import adamw

    def update(cfg, grads, state, params, grad_norm=None):
        return params, state, {"grad_norm": torch.zeros(()),
                               "lr": torch.zeros(())}
    monkeypatch.setattr(adamw, "update", update)


def _half_batch(monkeypatch):
    from repro_torch.launch import steps
    whole = steps.T.train_loss

    def half(cfg, params, batch_in, remat="full"):
        rows = batch_in["tokens"].shape[0]
        keep = max(rows // 2, 1)
        cut = {k: v[:keep] for k, v in batch_in.items()}
        if rows == 1:           # one row: half its positions
            n = batch_in["tokens"].shape[1] // 2
            cut = {k: v[:, :n] for k, v in batch_in.items()}
        return whole(cfg, params, cut, remat=remat)
    monkeypatch.setattr(steps.T, "train_loss", half)


def _prefill_wrapped(monkeypatch, alter):
    from repro_torch.launch import steps
    make = steps.make_prefill_step

    def wrapped(cfg, cache_len):
        step = make(cfg, cache_len)

        def run(model, batch):
            return alter(*step(model, batch))
        return run
    monkeypatch.setattr(steps, "make_prefill_step", wrapped)


def _answer_altered(monkeypatch):
    def alter(logits, cache):
        out = logits.clone()
        hi, lo = out.argmax(-1), out.argmin(-1)
        rows = torch.arange(out.shape[0])
        out[rows, hi], out[rows, lo] = logits[rows, lo], logits[rows, hi]
        return out, cache
    _prefill_wrapped(monkeypatch, alter)


def _cache_unwritten(monkeypatch):
    _prefill_wrapped(monkeypatch, lambda logits, cache: (
        logits, {k: torch.zeros_like(v) for k, v in cache.items()}))


FAULTS = [("ffn-train", _state_unchanged), ("ffn-train", _half_batch),
          ("attn-train", _state_unchanged), ("attn-train", _half_batch),
          ("attn-prefill", _answer_altered),
          ("attn-prefill", _cache_unwritten)]


@pytest.mark.parametrize("name,fault", FAULTS,
                         ids=[f"{n}-{f.__name__[1:]}" for n, f in FAULTS])
def test_a_broken_run_is_not_correct(name, fault, monkeypatch):
    cell = bench_smoke.small(name)
    assert bench_smoke.run(cell)["correct"]
    fault(monkeypatch)
    line = bench_smoke.run(cell)
    assert not line["correct"], line["checks"]

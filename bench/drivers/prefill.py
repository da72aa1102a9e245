"""Batches of prompts through the program's
``launch/steps.make_prefill_step``, back to back: a batch job over long
documents, each batch ``[rows, seq]`` token ids, uniform over the
vocabulary, drawn from the seed.  A batch completes when its last-position
logits are on the host.

Set-up builds the one prefill step (``cache_len`` = ``seq``) and runs one
batch, which also builds the attention mask's tensors at that length.  The
window runs whole batches until one more would carry it past
``--seconds``.  ``prefill_tokens_per_s`` is the prompt tokens of the
window over its time.

Of the window's first batch the run keeps every row's logits and the keys
and values it wrote to the cache at ``kv_positions`` positions a row drawn
from the seed (its last among them).  After the window, with the
program's state freed, the reference computes the same rows in float32
and the two are compared (``core.judge``).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from bench.core import inputs, judge, profile, program
from bench.core.runner import (Outcome, free, log, peak_bytes, reset_peak,
                               sync, window)
from bench.reference import model as ref_model
from bench.work import count

KIND = "prefill"


def batches_of(model, traffic, seed, device) -> torch.Tensor:
    """``[pool_batches, rows, seq]`` ids; every row differs."""
    return inputs.token_rows(model, seed, traffic["pool_batches"],
                             traffic["rows"], traffic["seq"], device)


def kv_picks(traffic, seed) -> list:
    """For each row of a batch, ``kv_positions`` sorted positions (its last
    among them)."""
    r = inputs.rng(seed, inputs.STREAM_SAMPLE)
    n = traffic["seq"]
    return [np.sort(np.append(r.choice(n - 1, size=traffic["kv_positions"]
                                       - 1, replace=False), n - 1))
            for _ in range(traffic["rows"])]


def run(r) -> Outcome:
    from repro_torch.launch import steps

    cell, device, model_w = r.cell, r.device, r.cell.model
    traffic = cell.traffic
    rows, seq = traffic["rows"], traffic["seq"]
    cfg = program.port_config(model_w, cell.config["program_arch"])
    log("program imported")
    picks = kv_picks(traffic, r.seed)
    with program.spans(r.trace) as capture:
        log("building the program's model")
        model = program.build(cfg, device)
        log("loading the weights")
        program.load(model, cfg, inputs.make_weights(model_w, r.seed,
                                                     device))
        free(device)
        pool = batches_of(model_w, traffic, r.seed, device)
        step = steps.make_prefill_step(cfg, seq)
        log("warming up")
        reset_peak(device)
        logits, _ = step(model, {"tokens": pool[0]})
        logits.float().cpu()
        del logits
        sync(device)
    t_window = time.time()
    log("window")

    kept = {}

    def one_batch(b, keep=False):
        logits, cache = step(model, {"tokens": pool[b % len(pool)]})
        out = logits.float().cpu()
        if keep:
            for j, pos in enumerate(picks):
                pos = torch.as_tensor(pos, device=device)
                kept[j] = (out[j], cache["k"][:, j].index_select(1, pos),
                           cache["v"][:, j].index_select(1, pos))
        return bool(torch.isfinite(out).all())

    def batches_iter():
        b = 0
        while True:
            yield lambda b=b: one_batch(b, keep=b == 0)
            b += 1

    elapsed, results = window(batches_iter(), r.seconds, device)
    peak = peak_bytes(device)
    n_batches = len(results)
    metrics = {"prefill_tokens_per_s": (n_batches * rows * seq / elapsed,
                                        "tokens/s"),
               "peak_mem_gb": (peak / 1e9, "GB"),
               "setup_s": (t_window - r.t_start, "s")}
    failed = sum(1 for ok in results if not ok)
    record = None
    if r.trace:
        record = {"kind": KIND, "model": model_w,
                  "window": {"seconds": elapsed, "units": n_batches,
                             "flops": n_batches * count.prefill_flops(
                                 model_w, rows, seq)},
                  "spans": program.span_seconds(capture.events)}
        log(f"set-up spans (seconds): {record['spans']}")
        if device.type == "cuda":
            log("traced slice")
            n_trace = traffic["trace_units"]
            units = [lambda b=b: one_batch(b)
                     for b in range(n_batches, n_batches + n_trace)]
            before = program.launch_counts()
            trace = profile.run_traced(units, lambda: sync(device))
            after = program.launch_counts()
            record["slice"] = {
                "units": n_trace, "rows": rows, "seq": seq,
                "launches": {k: after[k] - before[k] for k in after},
                "trace": trace}
    del model, step, pool
    free(device)
    log("reference")

    weights = inputs.make_weights(model_w, r.seed, device)
    dec = ref_model.Decoder(model_w, weights)
    ids = batches_of(model_w, traffic, r.seed, device)[0]
    lg, kv = 0.0, 0.0
    for j, pos in enumerate(picks):
        want = dec.prefill(ids[j], torch.as_tensor(pos, device=device))
        got = kept[j]
        lg = max(lg, judge.logits_gap(got[0], want[0]))
        kv = max(kv, judge.kv_gap(got[1], got[2], want[1], want[2]))
    del dec, weights, kept
    free(device)
    return Outcome(metrics=metrics,
                   checks=judge.checks({"logits_gap": lg, "kv_gap": kv},
                                       cell.limits),
                   attempted=n_batches * rows, failed=failed * rows,
                   peak_bytes=peak, record=record)

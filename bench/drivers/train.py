"""Training steps through the program's ``launch/steps.make_train_step``.

Set-up builds one training step with its model and AdamW state, loads the
benchmark's weights and drives the step through the traffic's
``first_steps`` steps (the warm-up: every shape of the window, and the
steps the reference follows).  From the program's state it reads each
leaf's first clipped gradient (AdamW's first moment after one step, over
``1 - beta1``) and each leaf's change over those steps.  The window then
queues further steps of the same object on further batches, about four
seconds of them ahead of the step the host waits for, until ``--seconds``
have passed, and closes after the wait for every step sent
(``runner.window_ahead``); losses are read after it.
``train_tokens_per_s`` is the tokens of every step of the window over its
time.  After the
window, with the program's state freed, the reference runs the first
steps again in float32 and the two are compared (``core.judge``).
"""
from __future__ import annotations

import time

import torch

from bench.core import inputs, judge, profile, program
from bench.core.runner import (Outcome, free, log, peak_bytes, reset_peak,
                               sync, window_ahead)
from bench.reference import model as ref_model
from bench.work import count

KIND = "train"


def _opt_cfg(opt: dict):
    from repro_torch.optim import adamw
    b1, b2 = opt["betas"]
    return adamw.AdamWConfig(
        lr=opt["lr"], beta1=b1, beta2=b2, eps=opt["eps"],
        weight_decay=opt["weight_decay"], clip_norm=opt["clip_norm"],
        warmup_steps=opt["warmup_steps"], total_steps=opt["total_steps"],
        min_lr_ratio=opt["min_lr_ratio"])


def batches_of(model, traffic, seed, device) -> torch.Tensor:
    """``[pool, rows, seq + 1]`` ids: row r of a batch feeds tokens
    ``[:-1]`` and labels ``[1:]``; every row differs."""
    return inputs.token_rows(model, seed, traffic["pool_batches"],
                             traffic["rows"], traffic["seq"] + 1, device)


def run(r) -> Outcome:
    from repro_torch.launch import steps
    from repro_torch.optim import adamw

    cell, device, model_w = r.cell, r.device, r.cell.model
    traffic, opt = cell.traffic, cell.traffic["optimizer"]
    first = traffic["first_steps"]
    cfg = program.port_config(model_w, cell.config["program_arch"])
    log("program imported")
    with program.spans(r.trace) as capture:
        log("building the program's model")
        model = program.build(cfg, device)
        log("loading the weights")
        program.load(model, cfg, inputs.make_weights(model_w, r.seed,
                                                     device))
        free(device)
        pool = batches_of(model_w, traffic, r.seed, device)
        feed = [{"tokens": b[:, :-1].contiguous(),
                 "labels": b[:, 1:].contiguous()} for b in pool]
        params = dict(model.named_parameters())
        opt_state = adamw.init(params)
        step = steps.make_train_step(cfg, _opt_cfg(opt),
                                     remat=traffic["remat"])
        log("warming up")
        reset_peak(device)
        losses, grad_norms = [], None
        for s in range(first):
            t_unit = time.perf_counter()
            model, opt_state, met = step(model, opt_state, feed[s])
            losses.append(float(met["loss"]))
            t_unit = time.perf_counter() - t_unit
            if s == 0:
                grad_norms = {
                    k: float((m / (1 - opt["betas"][0])).norm())
                    for k, m in opt_state["m"].items()}
        start = inputs.make_weights(model_w, r.seed, device).dense
        delta_norms = {k: float((p.detach().float() - start[k].float())
                                .norm()) for k, p in params.items()}
        del start
        sync(device)
    t_window = time.time()
    log("window")

    tokens = traffic["rows"] * traffic["seq"]
    cursor = [first]

    def one_step():
        nonlocal model, opt_state
        model, opt_state, met = step(model, opt_state,
                                     feed[cursor[0] % len(feed)])
        cursor[0] += 1
        return met["loss"]

    elapsed, loss_list = window_ahead(one_step, r.seconds, device, t_unit)
    n_steps = len(loss_list)
    failed = sum(1 for t in loss_list if not torch.isfinite(t).item())
    peak = peak_bytes(device)
    metrics = {"train_tokens_per_s": (n_steps * tokens / elapsed,
                                      "tokens/s"),
               "peak_mem_gb": (peak / 1e9, "GB"),
               "setup_s": (t_window - r.t_start, "s")}
    record = None
    if r.trace:
        record = {"kind": KIND, "model": model_w,
                  "window": {"seconds": elapsed, "units": n_steps,
                             "flops": n_steps * count.train_step_flops(
                                 model_w, traffic["rows"],
                                 traffic["seq"])},
                  "spans": program.span_seconds(capture.events)}
        log(f"set-up spans (seconds): {record['spans']}")
        if device.type == "cuda":
            log("traced slice")
            before = program.launch_counts()
            n_trace = traffic["trace_units"]
            trace = profile.run_traced([one_step] * n_trace,
                                       lambda: sync(device))
            after = program.launch_counts()
            record["slice"] = {
                "units": n_trace,
                "rows": traffic["rows"], "seq": traffic["seq"],
                "launches": {k: after[k] - before[k] for k in after},
                "trace": trace}
    del model, opt_state, feed, pool, params, step
    free(device)
    log("reference")

    ref = ref_model.train_steps(
        model_w, inputs.make_weights(model_w, r.seed, device),
        [batches_of(model_w, traffic, r.seed, device)[s]
         for s in range(first)], opt)
    free(device)
    log(f"loss_gap, not compared: "
        f"{judge.loss_gap(losses, ref['losses'])!r}")
    values = {"grad_gap": judge.leaf_gap(grad_norms, ref["grad_norms"])[0],
              "update_gap": judge.leaf_gap(
                  delta_norms, ref["delta_norms"],
                  keep=judge.moved(ref["grad_norms"]))[0]}
    return Outcome(metrics=metrics,
                   checks=judge.checks(values, cell.limits),
                   attempted=n_steps, failed=failed, peak_bytes=peak,
                   record=record)

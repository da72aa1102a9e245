"""Training loop with the JAX package's fault-tolerance mechanics, on one
device:

  * checkpoint/restart — async ``CheckpointManager``; on (re)start the loop
    resumes from the latest checkpoint automatically;
  * failure injection — ``fail_at_step`` raises ``SimulatedFailure`` mid-run
    (``train_with_restarts`` catches it and relaunches);
  * straggler watchdog — EWMA of step times; steps slower than
    ``straggler_factor`` x EWMA are logged with their step index.

There is no mesh: the port trains on one card, so nothing is sharded.  The
JAX loop's trace spans and metrics (``repro.obs``) are left out until the
observability modules are ported (ROADMAP A8).
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Optional

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import ModelConfig, ShapeCell
from repro_torch.data.pipeline import DataConfig, make_batch
from repro_torch.launch import steps as st
from repro_torch.models import transformer as T
from repro_torch.optim import adamw

log = logging.getLogger("repro_torch.train")


class SimulatedFailure(RuntimeError):
    """Injected node failure (exercise the restart path)."""


@dataclasses.dataclass
class TrainResult:
    final_step: int
    losses: list
    step_times: list
    restarts_used: int
    straggler_steps: list


def batch_to_device(batch, device) -> dict:
    """A ``make_batch`` batch (numpy int32) as int64 tensors on ``device``."""
    return {k: torch.from_numpy(v).to(device=device, dtype=torch.int64)
            for k, v in batch.items()}


def train(cfg: ModelConfig, shape: ShapeCell, *, device="cuda",
          total_steps: int = 50,
          opt_cfg: Optional[adamw.AdamWConfig] = None,
          ckpt_dir: Optional[str] = None,
          ckpt_every: int = 20,
          fail_at_step: Optional[int] = None,
          straggler_factor: float = 3.0,
          remat: str = "none",
          data_cfg: DataConfig = DataConfig(),
          log_every: int = 10) -> TrainResult:
    """Train ``cfg`` from ``init_params(seed=0)`` (or the latest checkpoint
    under ``ckpt_dir``) up to ``total_steps`` on ``make_batch`` batches.
    Step times are on the host clock and include the device's work (the
    loss is read back every step)."""
    device = T.resolve_device(device)
    opt_cfg = opt_cfg or adamw.AdamWConfig(total_steps=total_steps)
    mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None
    train_step = st.make_train_step(cfg, opt_cfg, remat=remat)

    # ---- init or resume
    model = T.init_params(cfg, seed=0, device=device)
    opt_state = adamw.init(dict(model.named_parameters()))
    start_step = 0
    if mgr and mgr.latest_step() is not None:
        state, start_step = mgr.restore(
            {"params": model.state_dict(), "opt": opt_state})
        model.load_state_dict(state["params"])
        opt_state = state["opt"]
        log.info("resumed from step %d", start_step)

    losses, times, stragglers = [], [], []
    ewma = None
    try:
        for step in range(start_step, total_steps):
            if fail_at_step is not None and step == fail_at_step:
                raise SimulatedFailure(f"injected failure at step {step}")
            batch = batch_to_device(make_batch(cfg, shape, step, data_cfg),
                                    device)
            t0 = time.time()
            model, opt_state, metrics = train_step(model, opt_state, batch)
            loss = float(metrics["loss"])    # waits for the step's kernels
            dt = time.time() - t0
            losses.append(loss)
            times.append(dt)
            if ewma is None:
                ewma = dt
            else:
                if dt > straggler_factor * ewma:
                    stragglers.append(step)
                    log.warning("straggler suspected at step %d: "
                                "%.2fs vs EWMA %.2fs", step, dt, ewma)
                ewma = 0.9 * ewma + 0.1 * dt
            if step % log_every == 0:
                log.info("step %d loss %.4f (%.2fs)", step, loss, dt)
            if mgr and (step + 1) % ckpt_every == 0:
                mgr.save(step + 1, {"params": model.state_dict(),
                                    "opt": opt_state})
        if mgr:
            mgr.save(total_steps, {"params": model.state_dict(),
                                   "opt": opt_state}, block=True)
    finally:
        if mgr:
            mgr.wait()       # a relaunch must find every save this run made
    return TrainResult(total_steps, losses, times, 0, stragglers)


def train_with_restarts(cfg, shape, *, max_restarts: int = 2,
                        **kw) -> TrainResult:
    """The launcher: retries after (injected or real) failures; each retry
    resumes from the latest checkpoint."""
    restarts = 0
    fail_at = kw.pop("fail_at_step", None)
    while True:
        try:
            res = train(cfg, shape, fail_at_step=fail_at, **kw)
            return dataclasses.replace(res, restarts_used=restarts)
        except SimulatedFailure as e:
            restarts += 1
            fail_at = None                       # only fail once
            log.warning("%s -> restart %d/%d", e, restarts, max_restarts)
            if restarts > max_restarts:
                raise

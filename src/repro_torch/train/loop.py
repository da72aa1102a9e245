"""Training loop with the JAX package's fault-tolerance mechanics:

  * checkpoint/restart — async ``CheckpointManager``; on (re)start the loop
    resumes from the latest checkpoint automatically;
  * failure injection — ``fail_at_step`` raises ``SimulatedFailure`` mid-run
    (``train_with_restarts`` catches it and relaunches);
  * straggler watchdog — EWMA of step times; steps slower than
    ``straggler_factor`` x EWMA are logged with their step index;
  * elastic re-mesh — checkpoints are mesh-agnostic, so a relaunch on
    another mesh (``train_with_restarts``' ``mesh_factory``) re-shards.

With a mesh (a ``DeviceMesh`` over the initialised world,
``launch.mesh.make_mesh``), parameters and AdamW state are stored under the
JAX package's rules (``launch.sharding.param_shardings``,
``opt_state_shardings``), each batch is split over the data axes
(``batch_shardings``; a batch they do not divide is replicated), and the
step is ``launch.steps.make_train_step(..., mesh=mesh)``'s.  A step's time
is the slowest rank's, so every rank returns the same ``TrainResult``;
only rank 0 of each data group logs.  Without a mesh the model trains on
one device.  Each step emits the JAX loop's ``train.step`` timed event
(the loss in its args, the step time in its wall-clock field) and updates
the ``train.steps``, ``train.loss``, ``train.step_time_us`` and
``train.stragglers`` metrics (``repro_torch.obs``).  The int8 gradient
compression (``optim.compress``) is not called here, as in the JAX loop.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import ModelConfig, ShapeCell
from repro_torch.data.pipeline import DataConfig, make_batch
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import sharding as sh
from repro_torch.launch import steps as st
from repro_torch.launch.constrain import use_mesh
from repro_torch.models import transformer as T
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
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
    # the MoE load-balance loss of each step (0.0 without MoE layers); the
    # port's own field, after the JAX package's
    aux_losses: list = dataclasses.field(default_factory=list)


def batch_to_device(batch, device) -> dict:
    """A ``make_batch`` batch on ``device``: its ids (numpy int32) as int64
    tensors, ``patch_embeds`` (float32) as they are (the model casts them
    to its dtype)."""
    return {k: torch.from_numpy(v).to(
        device=device, dtype=None if v.dtype.kind == "f" else torch.int64)
        for k, v in batch.items()}


def _slowest(dt: float, device) -> float:
    """The largest of every rank's ``dt`` (a mesh step ends when its
    slowest rank does)."""
    if dist.get_world_size() == 1:
        return dt
    t = torch.tensor([dt], dtype=torch.float64, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return float(t.item())


def train(cfg: ModelConfig, shape: ShapeCell, mesh=None, *, device="cuda",
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
    under ``ckpt_dir``) up to ``total_steps`` on ``make_batch`` batches,
    on ``mesh`` when one is given (its ``device_type`` is then the device;
    a ``cuda`` mesh without a card raises).  Step times are on the host
    clock and include the device's work (the loss is read back every
    step)."""
    if mesh is not None:
        mesh_lib.check_device_type(mesh.device_type)
        device = mesh.device_type
    device = T.resolve_device(device)
    opt_cfg = opt_cfg or adamw.AdamWConfig(total_steps=total_steps)
    mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None
    train_step = st.make_train_step(cfg, opt_cfg, remat=remat, mesh=mesh)
    logs = mesh is None or mesh_lib.data_group(mesh)[1] == 0

    # ---- init or resume
    model = T.init_params(cfg, seed=0, device=device)
    if mesh is None:
        opt_state = adamw.init(dict(model.named_parameters()))
    else:
        model = st.shard_model(model, mesh)
        opt_state = st.init_opt_state(model)
        b_specs = sh.batch_shardings(mesh, st.input_specs(cfg, shape))
        dist.barrier()       # every save of an earlier launch is on disk
    start_step = 0
    if mgr and mgr.latest_step() is not None:
        state, start_step = mgr.restore(
            {"params": model.state_dict(), "opt": opt_state}, mesh=mesh,
            specs=None if mesh is None else st.state_specs(model, opt_state))
        model.load_state_dict(state["params"])
        opt_state = state["opt"]
        if logs:
            log.info("resumed from step %d%s", start_step,
                     "" if mesh is None else
                     f" (elastic re-shard onto {mesh_lib.axis_sizes(mesh)})")

    losses, times, stragglers, aux_losses = [], [], [], []
    ewma = None
    try:
        with use_mesh(mesh):
            for step in range(start_step, total_steps):
                if fail_at_step is not None and step == fail_at_step:
                    raise SimulatedFailure(
                        f"injected failure at step {step}")
                batch = batch_to_device(
                    make_batch(cfg, shape, step, data_cfg), device)
                if mesh is not None:
                    batch = sh.distribute_tree(mesh, batch, b_specs)
                t0 = time.time()
                model, opt_state, metrics = train_step(model, opt_state,
                                                       batch)
                loss = float(metrics["loss"])  # waits for the step's kernels
                dt = time.time() - t0
                if mesh is not None:
                    dt = _slowest(dt, device)
                losses.append(loss)
                times.append(dt)
                aux_losses.append(float(metrics["aux_loss"]))
                # the loss is deterministic for a fixed seed, so it rides in
                # the event args; the step time is wall clock and stays in
                # the metrics (report-only histogram) and the dur field
                obs_trace.timed_event("train.step", dt * 1e6,
                                      step=step, loss=loss)
                obs_metrics.counter("train.steps").inc()
                obs_metrics.gauge("train.loss").set(loss)
                obs_metrics.histogram("train.step_time_us").observe(dt * 1e6)
                if ewma is None:
                    ewma = dt
                else:
                    if dt > straggler_factor * ewma:
                        stragglers.append(step)
                        obs_metrics.counter("train.stragglers").inc()
                        if logs:
                            log.warning("straggler suspected at step %d: "
                                        "%.2fs vs EWMA %.2fs", step, dt,
                                        ewma)
                    ewma = 0.9 * ewma + 0.1 * dt
                if logs and step % log_every == 0:
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
    return TrainResult(total_steps, losses, times, 0, stragglers,
                       aux_losses)


def train_with_restarts(cfg, shape,
                        mesh_factory: Optional[Callable[[int], Any]] = None,
                        *, max_restarts: int = 2, **kw) -> TrainResult:
    """The launcher: retries after (injected or real) failures; each retry
    rebuilds the mesh with ``mesh_factory(restart_index)`` (elastic: the
    new mesh may differ; no factory, no mesh) and resumes from the latest
    checkpoint."""
    restarts = 0
    fail_at = kw.pop("fail_at_step", None)
    while True:
        try:
            mesh = None if mesh_factory is None else mesh_factory(restarts)
            res = train(cfg, shape, mesh, fail_at_step=fail_at, **kw)
            return dataclasses.replace(res, restarts_used=restarts)
        except SimulatedFailure as e:
            restarts += 1
            fail_at = None                       # only fail once
            log.warning("%s -> restart %d/%d", e, restarts, max_restarts)
            if restarts > max_restarts:
                raise

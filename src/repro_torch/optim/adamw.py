"""AdamW with global-norm clipping and a cosine schedule.

Plain functions over a model's named parameters (``dict(model.named_
parameters())``): the state holds float32 ``m``/``v`` per parameter and a
0-d int32 ``step``.  Buffers (the sparse layers' index arrays) are not
parameters and are never touched.  Unlike the JAX package's pure function,
``update`` writes the new parameters and moments IN PLACE (a copy of the
model and of its float32 state would double the memory of a training step);
the arithmetic is the JAX package's: the update is computed in float32 and
cast back to the parameter's dtype, decay applies to ``ndim >= 2``.
``torch.optim.AdamW`` is not used: its bf16 update and its clipping differ
from the reference.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def init(params: Dict[str, torch.Tensor]) -> Dict[str, object]:
    """Zero float32 moments beside every floating parameter; ``step`` 0."""
    device = next(iter(params.values())).device if params else "cpu"
    zeros = {name: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for name, p in params.items() if p.is_floating_point()}
    return {"m": zeros,
            "v": {name: torch.zeros_like(z) for name, z in zeros.items()},
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup, then cosine decay to ``min_lr_ratio * lr`` (float32)."""
    step = step.to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps) /
                    max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * t))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def global_norm(grads: Dict[str, Optional[torch.Tensor]]) -> torch.Tensor:
    """sqrt of the sum of squares of every floating gradient, in float32."""
    sq = [g.float().square().sum() for g in grads.values()
          if g is not None and g.is_floating_point()]
    return torch.sqrt(torch.stack(sq).sum())


def update(cfg: AdamWConfig, grads: Dict[str, Optional[torch.Tensor]],
           state: Dict[str, object], params: Dict[str, torch.Tensor]
           ) -> Tuple[Dict[str, torch.Tensor], Dict[str, object],
                      Dict[str, torch.Tensor]]:
    """One AdamW step: ``params`` and ``state``'s moments are updated in
    place and returned, with ``{"grad_norm", "lr"}``.  A parameter whose
    gradient is None (not reached by the loss) takes a zero gradient, as a
    JAX gradient of an unused leaf is zero."""
    step = state["step"] + 1
    lr = schedule(cfg, step)
    gnorm = global_norm(grads)
    if cfg.clip_norm is None:
        scale = torch.ones((), dtype=torch.float32, device=gnorm.device)
    else:
        scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    b1, b2 = cfg.beta1, cfg.beta2
    stepf = step.to(torch.float32)
    bc1 = 1 - b1 ** stepf
    bc2 = 1 - b2 ** stepf
    with torch.no_grad():
        for name, p in params.items():
            if not p.is_floating_point():
                continue
            g = grads.get(name)
            g = (torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                 if g is None else g.float()) * scale
            m, v = state["m"][name], state["v"][name]
            m.copy_(b1 * m + (1 - b1) * g)
            v.copy_(b2 * v + (1 - b2) * g.square())
            delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
            if p.ndim >= 2:                  # decoupled weight decay
                delta = delta + cfg.weight_decay * p.float()
            p.copy_(p.float() - lr * delta)
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}

"""Plain AdamW with global-norm clipping, decoupled weight decay on leaves
of two or more dimensions, and linear warm-up into cosine decay, in
float32: the update the training configurations state (``optimizer`` in
the workload file's traffic)."""
from __future__ import annotations

import math

import torch


def lr_at(opt: dict, step: int) -> float:
    warm = min(step / max(opt["warmup_steps"], 1), 1.0)
    t = (step - opt["warmup_steps"]) / max(opt["total_steps"] -
                                           opt["warmup_steps"], 1)
    t = min(max(t, 0.0), 1.0)
    ratio = opt["min_lr_ratio"]
    return opt["lr"] * warm * (ratio + (1 - ratio) *
                               0.5 * (1 + math.cos(math.pi * t)))


def init(leaves: dict) -> dict:
    return {"m": {k: torch.zeros_like(p) for k, p in leaves.items()},
            "v": {k: torch.zeros_like(p) for k, p in leaves.items()}}


def update(opt: dict, leaves: dict, grads: dict, state: dict,
           step: int) -> dict:
    """One step in place; returns the clipped gradients it applied."""
    b1, b2 = opt["betas"]
    gnorm = math.sqrt(sum(float(g.double().square().sum())
                          for g in grads.values()))
    scale = 1.0 if opt["clip_norm"] is None else \
        min(opt["clip_norm"] / (gnorm + 1e-9), 1.0)
    lr = lr_at(opt, step)
    bc1, bc2 = 1 - b1 ** step, 1 - b2 ** step
    clipped = {}
    with torch.no_grad():
        for k, p in leaves.items():
            g = grads[k] * scale
            clipped[k] = g
            m, v = state["m"][k], state["v"][k]
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            delta = (m / bc1) / (torch.sqrt(v / bc2) + opt["eps"])
            if p.ndim >= 2:
                delta = delta + opt["weight_decay"] * p
            p.sub_(lr * delta)
    return clipped

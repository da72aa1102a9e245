"""Training launcher CLI.

Examples:
  # full width on the card (the default device):
  PYTHONPATH=src python -m repro_torch.launch.train --arch smat-ffn-1.3b \
      --steps 5 --batch 2 --seq 1024

  # a few steps of the smoke config on the CPU:
  PYTHONPATH=src python -m repro_torch.launch.train \
      --arch smat-ffn-1.3b:smoke --device cpu --steps 4

  # failure injection + automatic restart from the latest checkpoint:
  PYTHONPATH=src python -m repro_torch.launch.train \
      --arch smat-ffn-1.3b:smoke --device cpu --steps 8 --batch 2 --seq 32 \
      --ckpt-dir /tmp/ckpt --ckpt-every 2 --inject-failure 5
"""
from __future__ import annotations

import argparse
import logging

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeCell
from repro_torch.kernels import bcsr_spmm
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from repro_torch.train.loop import train_with_restarts


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--inject-failure", type=int, default=None)
    ap.add_argument("--max-restarts", type=int, default=2)
    ap.add_argument("--remat", default="none", choices=list(T.REMAT))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s")

    cfg = get_config(args.arch)
    shape = ShapeCell("cli", "train", args.seq, args.batch)
    for name in bcsr_spmm.LAUNCHES:
        bcsr_spmm.LAUNCHES[name] = 0
    res = train_with_restarts(
        cfg, shape, device=T.resolve_device(args.device),
        total_steps=args.steps,
        opt_cfg=adamw.AdamWConfig(lr=args.lr, total_steps=args.steps),
        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
        fail_at_step=args.inject_failure,
        max_restarts=args.max_restarts, remat=args.remat)
    print(f"[train] done: {res.final_step} steps, "
          f"loss {res.losses[0]:.3f} -> {res.losses[-1]:.3f}, "
          f"restarts={res.restarts_used}, stragglers={res.straggler_steps}")
    print(f"[train] kernel launches: {dict(bcsr_spmm.LAUNCHES)} (0 on the "
          "CPU, where the plain versions run)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

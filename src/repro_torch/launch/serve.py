"""Serving launcher CLI: builds a model with random weights and runs
continuous batched decode over a synthetic request stream, reporting
tokens/s and how many times the sparse FFN kernel was launched.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch smat-ffn-1.3b
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch smat-ffn-1.3b:smoke --device cpu
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import bcsr_spmm
from repro_torch.models import transformer as T
from repro_torch.serve.engine import Request, ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--cache-len", type=int, default=128)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    params = T.init_params(cfg, seed=0, device=args.device)
    engine = ServeEngine(cfg, params, n_slots=args.slots,
                         cache_len=args.cache_len, device=args.device)

    rng = np.random.default_rng(0)
    requests = [Request(rid=rid,
                        prompt=rng.integers(0, cfg.vocab_size,
                                            size=args.prompt_len,
                                            dtype=np.int32),
                        max_new_tokens=args.new_tokens,
                        temperature=args.temperature)
                for rid in range(args.requests)]

    bcsr_spmm.LAUNCHES["nnz_stream"] = 0
    t0 = time.perf_counter()
    streamed = {}
    for rid, token in engine.generate(requests):
        streamed.setdefault(rid, []).append(token)
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    dt = time.perf_counter() - t0
    total_new = sum(len(toks) for toks in streamed.values())
    print(f"[serve] {len(streamed)}/{args.requests} requests, "
          f"{total_new} new tokens in {dt:.2f}s "
          f"({total_new / dt:.1f} tok/s on {engine.device})")
    print(f"[serve] scheduler: {engine.scheduler.step_idx} engine steps, "
          f"{engine.scheduler.prefix_hits} prefix-cache hits "
          f"({engine.scheduler.prefix_tokens_reused} tokens reused)")
    print(f"[serve] nnz_stream kernel launches: "
          f"{bcsr_spmm.LAUNCHES['nnz_stream']} (0 on the CPU, where the "
          "plain version runs)")
    for rid in sorted(streamed)[:3]:
        print(f"  rid={rid} first-tokens={streamed[rid][:8]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Serving launcher CLI: builds a model with random weights and runs
continuous batched decode over a synthetic request stream, reporting
tokens/s and how many times each CUDA kernel was launched.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch smat-ffn-1.3b
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch smat-ffn-1.3b:smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch smat-attn-1.3b:smoke --device cpu --cache-len 64
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch deepseek-v2-lite-16b:smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-1.3b
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch musicgen-medium:smoke --device cpu

Any registered arch serves (``--arch``): the paper's ``smat-ffn-1.3b`` and
``smat-attn-1.3b``, and the JAX package's ten (``mamba2-1.3b`` and
``zamba2-7b`` with prefix reuse off, their state not being
position-indexed; ``musicgen-medium`` streams a row of codebook tokens a
position from ``[prompt-len, 4]`` prompts; ``pixtral-12b`` serves text
prompts, with no patches).

With block-sparse attention whose page table saves pages at this cache
length (the second line: 3 of 4 pages a step), decode reads KV through the
paged gather and the CLI prints the paged cache's resident and offloaded
bytes.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import bcsr_attn, bcsr_spmm
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
    # codebooks: a prompt is [Lp, n_cb], one token a codebook a position
    row = (cfg.n_codebooks,) if cfg.input_mode == "codebooks" else ()
    requests = [Request(rid=rid,
                        prompt=rng.integers(0, cfg.vocab_size,
                                            size=(args.prompt_len,) + row,
                                            dtype=np.int32),
                        max_new_tokens=args.new_tokens,
                        temperature=args.temperature)
                for rid in range(args.requests)]

    counters = (bcsr_spmm.LAUNCHES, bcsr_attn.LAUNCHES)
    for launches in counters:
        for name in launches:
            launches[name] = 0
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
    if engine.paged_kv is not None:
        rep = engine.paged_kv.report()
        print(f"[serve] paged KV: resident "
              f"{rep['resident_bytes_total']} B, offloaded "
              f"{rep['offload_bytes_total']} B over "
              f"{len(rep['groups'])} layer group(s)")
    launched = {name: n for launches in counters
                for name, n in launches.items()}
    print(f"[serve] kernel launches: {sum(launched.values())} ("
          + ", ".join(f"{name} {n}" for name, n in launched.items())
          + "; 0 on the CPU, where the plain versions run)")
    for rid in sorted(streamed)[:3]:
        first = [t.tolist() if isinstance(t, np.ndarray) else t
                 for t in streamed[rid][:8]]
        print(f"  rid={rid} first-tokens={first}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

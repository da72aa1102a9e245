"""Serving example on the PyTorch/CUDA port: continuous batching through
the streaming ``ServeEngine.generate`` API (the steps of
``examples/serve_decode.py``, on an arch the port registers).

``engine.generate(requests)`` yields ``(rid, token)`` pairs as each slot
decodes: the scheduler admits and evicts requests every step, so a short
request that finishes frees its slot for the next queued one.  The arch,
``smat-attn-1.3b:smoke``, has block-sparse attention, so at cache 64 its
decode reads the KV cache through the mask's pages (3 of 4 a step).

  PYTHONPATH=src python examples/torch_serve_decode.py            # the card
  PYTHONPATH=src python examples/torch_serve_decode.py --device cpu
"""
import argparse
import time

import numpy as np

from repro_torch.configs import get_config
from repro_torch.models import transformer as T
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.paged_kv import PagedKVCache

ARCH = "smat-attn-1.3b:smoke"


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = T.resolve_device(args.device)
    cfg = get_config(ARCH)
    n_slots, cache_len = 2, 64
    params = T.init_params(cfg, seed=0, device=device)
    engine = ServeEngine(cfg, params, n_slots=n_slots, cache_len=cache_len,
                         device=device)

    rng = np.random.default_rng(0)
    n_requests, new_tokens = 5, 8
    requests = [
        Request(rid=rid,
                prompt=rng.integers(0, cfg.vocab_size, size=6,
                                    dtype=np.int32),
                max_new_tokens=new_tokens)
        for rid in range(n_requests)
    ]

    t0 = time.time()
    streamed = {}
    for rid, token in engine.generate(requests):
        streamed.setdefault(rid, []).append(token)
    dt = time.time() - t0
    total = sum(len(toks) for toks in streamed.values())
    print(f"served {len(streamed)}/{n_requests} requests ({total} tokens) "
          f"in {dt:.1f}s with {n_slots} decode slots, "
          f"{engine.decode_calls} decode calls")
    paged = PagedKVCache(cfg, cache_len, n_slots).report()
    for g in paged["groups"]:
        print(f"paged KV [{g['group']}]: paged={g['paged']}, "
              f"{g.get('pages_touched_per_step', 0)}/"
              f"{g.get('n_pages', 0)} pages a step, resident "
              f"{g.get('resident_bytes', 0)} B over {g['n_layers']} "
              f"layers")
    assert len(streamed) == n_requests
    assert all(len(t) == new_tokens for t in streamed.values())
    print("OK")
    return {"streams": streamed, "decode_calls": engine.decode_calls,
            "paged_kv": paged}


if __name__ == "__main__":
    main()

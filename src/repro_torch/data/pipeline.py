"""Deterministic synthetic LM data pipeline (numpy only), copied from the
JAX package so that both packages train on bit-identical batches.

Stateless generation keyed on (seed, step, host): every host materializes
ONLY its local batch shard (true multi-host input pipeline semantics), any
step can be regenerated after a restart (checkpoint stores just the step
counter), and a background prefetch thread hides generation latency.

The token stream is not iid noise: documents are Zipf-sampled n-gram chains,
so the CE loss actually decreases during the example training runs.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.configs.base import ModelConfig, ShapeCell


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    zipf_a: float = 1.3
    ngram: int = 3
    prefetch: int = 2


def _doc_tokens(rng: np.random.Generator, vocab: int, length: int,
                zipf_a: float, ngram: int) -> np.ndarray:
    """Markov-ish chain: next token = hash(prev n-gram) perturbed — gives
    learnable local structure."""
    base = rng.zipf(zipf_a, size=length).astype(np.int64)
    toks = base % vocab
    # overwrite 75% of positions with an n-gram-determined token
    for i in range(ngram, length):
        if toks[i] % 4 != 0:
            h = (toks[i - 1] * 1000003 + toks[i - 2] * 10007 +
                 toks[i - 3]) % vocab
            toks[i] = h
    return toks.astype(np.int32)


def make_batch(cfg: ModelConfig, shape: ShapeCell, step: int,
               data_cfg: DataConfig = DataConfig(),
               host_id: int = 0, n_hosts: int = 1,
               local_batch: Optional[int] = None) -> Dict[str, np.ndarray]:
    """The batch for ``step`` as seen by ``host_id`` (numpy, host-local)."""
    B = local_batch or (shape.global_batch // n_hosts)
    L = shape.seq_len
    rng = np.random.default_rng(
        np.random.SeedSequence([data_cfg.seed, step, host_id]))
    batch: Dict[str, np.ndarray] = {}
    if cfg.input_mode == "codebooks":
        toks = np.stack([
            np.stack([_doc_tokens(rng, cfg.vocab_size, L + 1,
                                  data_cfg.zipf_a, data_cfg.ngram)
                      for _ in range(cfg.n_codebooks)], axis=-1)
            for _ in range(B)])
        batch["tokens"] = toks[:, :-1]
        batch["labels"] = toks[:, 1:]
    elif cfg.input_mode == "tokens+patches":
        lt = L - cfg.patch_tokens
        toks = np.stack([_doc_tokens(rng, cfg.vocab_size, lt + 1,
                                     data_cfg.zipf_a, data_cfg.ngram)
                         for _ in range(B)])
        batch["tokens"] = toks[:, :-1]
        batch["labels"] = toks[:, 1:]
        batch["patch_embeds"] = rng.standard_normal(
            (B, cfg.patch_tokens, cfg.d_model)).astype(np.float32)
    else:
        toks = np.stack([_doc_tokens(rng, cfg.vocab_size, L + 1,
                                     data_cfg.zipf_a, data_cfg.ngram)
                         for _ in range(B)])
        batch["tokens"] = toks[:, :-1]
        batch["labels"] = toks[:, 1:]
    return batch


class PrefetchIterator:
    """Background-thread prefetch of ``make_batch`` (restart-safe: seeded by
    step index)."""

    def __init__(self, cfg: ModelConfig, shape: ShapeCell,
                 data_cfg: DataConfig = DataConfig(), start_step: int = 0,
                 host_id: int = 0, n_hosts: int = 1,
                 local_batch: Optional[int] = None):
        self._q: "queue.Queue" = queue.Queue(maxsize=data_cfg.prefetch)
        self._stop = threading.Event()
        self._step = start_step

        def worker():
            step = start_step
            while not self._stop.is_set():
                b = make_batch(cfg, shape, step, data_cfg, host_id, n_hosts,
                               local_batch)
                while not self._stop.is_set():
                    try:
                        self._q.put((step, b), timeout=0.2)
                        break
                    except queue.Full:
                        continue
                step += 1

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        return self._q.get()

    def close(self):
        self._stop.set()

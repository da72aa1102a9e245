"""Continuous-batching serving engine: a thin executor around
``serve.scheduler.Scheduler``, which makes every admit/feed/evict decision
on the host.

    engine = ServeEngine(cfg, model, n_slots=4, cache_len=256, device="cuda")
    for rid, token in engine.generate(requests):   # streaming results
        ...

Every decode call is ``n_slots`` rows wide whatever the number of active
slots: pad rows compute and are ignored, and a slot mask keeps their cache
rows unchanged.  The JAX package merges a functional step's new cache into
the old one for the masked slots (``_merge_cache``); here
``layers.attention`` writes the new K/V in place for the masked rows only,
which saves a full copy of the cache per step.  The engine runs under
``torch.inference_mode()``.

Prompts are fed token by token through decode calls, so a model with
block-sparse attention (``cfg.attn_sparsity``) is served through the decode
path, which applies the same mask the train/prefill path scores: through
the paged KV gather (``models.layers._paged_decode``) where the spec's
``paged_decode`` resolves a page table for the cache, else as a positional
bias; kernel B5 runs in training and in ``transformer.prefill``, never
here.  ``self.paged_kv`` (``serve.paged_kv.PagedKVCache``) carries the
paged cache's placement accounting.

Every decode call has one input signature whatever the slots do (the batch
is always ``n_slots`` rows, ``pos`` a Python int): the call is wrapped by a
``shapemon`` sentinel named ``serve.masked_step``
(``engine.step_sentinel``), which counts the signatures it sees.

A model whose sparse FFN is partitioned (``SparsitySpec(shards=...)``)
decodes in-process on one card; ``spmm_mesh`` runs every decode call under
``launch.dist_spmm.use_spmm_mesh``, so each sparse product runs over that
mesh (every rank of it runs the same engine).  Each
step is a ``serve.step`` span and moves the ``serve.steps`` and
``serve.tokens`` counters (``repro_torch.obs``).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as T
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import shapemon
from repro_torch.obs import trace as obs_trace
from repro_torch.serve.scheduler import Scheduler, SchedulerConfig

# decode-cache batch axis by leaf name (the launch.sharding.cache_shardings
# layouts), counted from the end so the stacking depth does not matter:
# attn k/v [..., B, S, KV, dh]; mla ckv/krope [..., B, S, r]; ssd conv
# [..., B, cw-1, d] / state [..., B, H, P, N]
_CACHE_BATCH_AXIS = {"k": -4, "v": -4, "ckv": -3, "krope": -3,
                     "conv": -3, "state": -4}

# leaves indexed by position, the ones a cross-slot prefix copy is exact
# for.  ssd conv/state summarize history (the state after the LAST token,
# not one entry a position), so prefix reuse is off for layouts with them
# (ssd, zamba).
_POSITION_INDEXED = ("k", "v", "ckv", "krope")


def _leaves(cache, path=()):
    """``(path, leaf)`` of every tensor of a (nested) cache dict, as the
    JAX package's ``tree_map_with_path`` walks it."""
    for name, leaf in cache.items():
        if isinstance(leaf, dict):
            yield from _leaves(leaf, path + (name,))
        else:
            yield path + (name,), leaf


def _batch_axis(path, leaf) -> int:
    name = path[-1]
    if name not in _CACHE_BATCH_AXIS:
        raise KeyError(
            f"unknown decode-cache leaf {name!r} at {'.'.join(path)}: add "
            "its batch axis to serve.engine._CACHE_BATCH_AXIS")
    return _CACHE_BATCH_AXIS[name] % leaf.ndim


def _copy_slot(cache, src: int, dst: int):
    """Copy slot ``src``'s cache rows over slot ``dst`` on every leaf, in
    place — the prefix-cache transfer.  Rows are batch-independent, so the
    copied prefix KV is bitwise identical to recomputing it."""
    for path, leaf in _leaves(cache):
        ax = _batch_axis(path, leaf)
        leaf.select(ax, dst).copy_(leaf.select(ax, src))
    return cache


def _reset_history(cache, slot: int):
    """Zero slot ``slot``'s rows of every leaf that is not indexed by
    position (ssd ``conv``/``state``, ``zamba``'s ``units_ssd`` and
    ``tail_ssd`` too), in place: a request admitted onto a slot starts
    from an empty history, not from the state its previous occupant left
    (ROADMAP C6: the JAX package's engine carries it over).
    Position-indexed leaves need no reset: the new request overwrites
    positions as it feeds them and attends causally."""
    for path, leaf in _leaves(cache):
        if path[-1] not in _POSITION_INDEXED:
            leaf.select(_batch_axis(path, leaf), slot).zero_()
    return cache


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                 # [Lp] (or [Lp, n_cb])
    max_new_tokens: int = 32
    temperature: float = 0.0
    out_tokens: Optional[list] = None


class ServeEngine:
    def __init__(self, cfg: ModelConfig, params, *, n_slots: int = 4,
                 cache_len: int = 256, seed: int = 0,
                 prefix_cache: bool = True, placement=None, spmm_mesh=None,
                 device="cuda"):
        """``params`` is the ``Transformer`` (``transformer.init_params``)
        on ``device``.  ``seed`` seeds the sampling of requests with a
        temperature above 0.  ``prefix_cache`` enables cross-slot KV reuse
        for shared prompt prefixes.  ``placement`` is the paged KV cache's
        ``serve.paged_kv.PagePlacementSpec`` (its default: all pages on
        the card).  ``spmm_mesh``: a mesh for the partitioned sparse FFN
        (``dist_spmm.make_spmm_mesh``); None runs partitioned layers
        in-process (the same math)."""
        self.device = T.resolve_device(device)
        if params.embed.device != self.device:
            raise ValueError(f"the model is on {params.embed.device}, the "
                             f"engine on {self.device}")
        self.cfg = cfg
        self.params = params
        self.n_slots = n_slots
        self.cache_len = cache_len
        self.spmm_mesh = spmm_mesh
        self.generator = torch.Generator().manual_seed(seed)
        with torch.inference_mode():
            self.cache = T.init_cache(cfg, n_slots, cache_len,
                                      device=self.device)
        prefix_ok = {path[-1] for path, _ in _leaves(self.cache)} <= \
            set(_POSITION_INDEXED)
        self.scheduler = Scheduler(SchedulerConfig(
            n_slots=n_slots, cache_len=cache_len,
            prefix_cache=bool(prefix_cache) and prefix_ok))
        self.paged_kv = None
        if getattr(cfg, "attn_sparsity", None) is not None and \
                cfg.layout in ("attn_mlp", "gemma_pair"):
            from repro_torch.serve.paged_kv import PagedKVCache
            self.paged_kv = PagedKVCache(cfg, cache_len, n_slots,
                                         placement=placement)
        self.done: Dict[int, Request] = {}
        self.decode_calls = 0          # model decode calls so far

        def _masked_step(params, cache, tokens, pos, slot_mask):
            return T.decode_step(cfg, params, cache, tokens, pos,
                                 slot_mask=slot_mask)

        # the signature sentinel: "slot masks keep shapes static" is the
        # count staying at 1 over a whole run (tests/test_torch_obs.py)
        self._decode = shapemon.monitor(_masked_step,
                                        name="serve.masked_step")
        self.step_sentinel = self._decode.sentinel

    # ---------------------------------------------------------------- admin
    def enqueue(self, req: Request) -> None:
        """Queue a request; it is admitted to a slot by the next step."""
        req.out_tokens = []
        self.scheduler.enqueue(req)

    def _slot_tokens(self, entries) -> torch.Tensor:
        """Batch tokens with each entry's token in its slot and pad (0)
        elsewhere: [n_slots], or [n_slots, n_cb] rows for ``codebooks``."""
        row = (self.cfg.n_codebooks,) if self.cfg.input_mode == \
            "codebooks" else ()
        arr = np.zeros((self.n_slots,) + row, np.int64)
        for slot, token, _ in entries:
            arr[slot] = token
        return torch.from_numpy(arr).to(self.device)

    def _sample(self, logits: np.ndarray, temperature: float):
        """A token from a slot's logits [V] (an int), or a row of tokens
        from [n_cb, V] (int32, one a codebook): the argmax, or a draw from
        the engine's generator above temperature 0."""
        if temperature <= 0:
            tok = logits.argmax(axis=-1)
            return int(tok) if np.ndim(tok) == 0 else tok.astype(np.int32)
        probs = torch.softmax(torch.from_numpy(logits) / temperature, dim=-1)
        tok = torch.multinomial(probs, 1, generator=self.generator)
        return int(tok) if probs.ndim == 1 else \
            tok[:, 0].numpy().astype(np.int32)

    def _mesh_scope(self):
        if self.spmm_mesh is None:
            return contextlib.nullcontext()
        from repro_torch.launch import dist_spmm  # local: layering
        return dist_spmm.use_spmm_mesh(self.spmm_mesh)

    # ----------------------------------------------------------------- step
    @torch.inference_mode()
    def step(self) -> List[Tuple[int, object]]:
        """Admit pending requests, run one decode call per position group of
        active slots, and return the tokens sampled this step as
        ``[(rid, token)]``."""
        with obs_trace.span("serve.step", step=self.scheduler.step_idx):
            produced = self._step_inner()
        obs_metrics.counter("serve.steps").inc()
        obs_metrics.counter("serve.tokens").inc(len(produced))
        return produced

    def _step_inner(self) -> List[Tuple[int, object]]:
        for adm in self.scheduler.admit():
            if adm["reuse"] > 0 and adm["src"] != adm["slot"]:
                _copy_slot(self.cache, adm["src"], adm["slot"])
            _reset_history(self.cache, adm["slot"])
        produced: List[Tuple[int, object]] = []
        for pos, entries in self.scheduler.plan():
            mask = np.zeros(self.n_slots, bool)
            for slot, _, _ in entries:
                mask[slot] = True
            with self._mesh_scope():
                logits, self.cache = self._decode(
                    self.params, self.cache, self._slot_tokens(entries),
                    int(pos), torch.from_numpy(mask).to(self.device))
            self.decode_calls += 1
            need = [e for e in entries if e[2]]
            if need:
                logits = logits.float().cpu().numpy()
            for slot, token, _ in entries:
                self.scheduler.advance(slot, token)
            for slot, _, _ in need:
                req = self.scheduler.slots[slot].req
                tok = self._sample(logits[slot], req.temperature)
                if self.scheduler.record_output(slot, tok):
                    self.done[req.rid] = req
                produced.append((req.rid, tok))
        self.scheduler.step_idx += 1
        return produced

    # ------------------------------------------------------------- generate
    def generate(self, requests, max_steps: int = 100_000
                 ) -> Iterator[Tuple[int, object]]:
        """Stream ``(request_id, token)`` pairs as decoding produces them.
        Later requests are admitted as slots free up, so the iterator
        interleaves results in deterministic (position-group, slot) order."""
        for req in requests:
            self.enqueue(req)
        steps = 0
        while self.scheduler.has_work() and steps < max_steps:
            yield from self.step()
            steps += 1

"""Continuous-batching scheduler: slot-level admit/feed/evict decisions.

Pure host-side policy (python/numpy): the engine executes whatever this
module decides, so every scheduling decision is deterministic in the
request trace alone.  It is the JAX package's scheduler: ``self.trace``,
its ``serve.<event>`` obs events and its ``serve.*`` metrics are kept
exactly, so the two packages' traces and deterministic payloads compare
equal.

States per slot: FREE (no request) -> PREFILL (fed < len(prompt) - 1)
-> DECODE (sampling) -> FREE again on completion.  Prefill is
*by-decode*: each engine step feeds every active slot exactly one token
at its own position, so a slot prefilling at position p and a slot
decoding at position p batch into the same decode call — prefill/decode
interleave falls out of position grouping, with the batch always
``n_slots`` rows wide (slot masks).

Prefix-cache reuse: the per-slot history of tokens whose KV was written
(``written``) survives eviction; a new request admits with ``fed = c``
where ``c`` is the longest common prefix against any slot's history
(capped at ``len(prompt) - 1`` so the first sample still decodes the
last prompt token at its true position).  The engine copies the donor
slot's KV rows — batch rows compute independently, so copied KV is
bitwise identical to recomputing the prefix.

>>> import numpy as np
>>> class R:                    # anything with these four attributes works
...     def __init__(self, rid, prompt, n=2):
...         self.rid, self.prompt = rid, np.asarray(prompt, np.int32)
...         self.max_new_tokens, self.out_tokens = n, []
>>> s = Scheduler(SchedulerConfig(n_slots=2, cache_len=16))
>>> s.enqueue(R(0, [5, 6, 7])); s.enqueue(R(1, [5, 6, 9]))
>>> [(a["rid"], a["slot"], a["reuse"]) for a in s.admit()]
[(0, 0, 0), (1, 1, 0)]
>>> [(pos, [e[0] for e in entries]) for pos, entries in s.plan()]
[(0, [0, 1])]
>>> for slot, tok, sample in s.plan()[0][1]:
...     s.advance(slot, tok)
>>> [(pos, [e[0] for e in entries]) for pos, entries in s.plan()]
[(1, [0, 1])]
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import List, Optional

from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    """Static scheduling policy knobs (hashable)."""
    n_slots: int = 4
    cache_len: int = 256
    prefix_cache: bool = True


def _tok_key(value):
    """Hashable identity of one fed token (scalar or codebook row)."""
    import numpy as np
    arr = np.asarray(value)
    return int(arr) if arr.ndim == 0 else tuple(int(x) for x in arr.ravel())


@dataclasses.dataclass
class _Slot:
    req: object         # .rid .prompt .max_new_tokens .out_tokens
    fed: int = 0        # tokens fed through decode == KV rows written
    admitted_step: int = 0   # step_idx at admission (latency accounting)


class Scheduler:
    """FIFO continuous-batching scheduler over ``n_slots`` cache rows."""

    def __init__(self, config: SchedulerConfig):
        self.config = config
        self.queue: deque = deque()
        self.slots: List[Optional[_Slot]] = [None] * config.n_slots
        # fed-token keys per slot row; kept after eviction so a later
        # request can prefix-match the KV still sitting in the cache
        self.written: List[tuple] = [()] * config.n_slots
        self.trace: List[dict] = []
        self.step_idx = 0
        self.prefix_hits = 0
        self.prefix_tokens_reused = 0

    def _emit(self, event: str, **fields) -> dict:
        """THE scheduler trace emitter: one record, two views.  The record
        lands in ``self.trace`` (a private per-instance list, so it never
        depends on ``REPRO_TRACE``) and goes out as a ``serve.<event>`` obs
        event (spans, wall clock, exporters)."""
        rec = {"event": event, "step": self.step_idx, **fields}
        self.trace.append(rec)
        obs_trace.event(f"serve.{event}", **rec)
        return rec

    # ------------------------------------------------------------- admission
    def enqueue(self, req) -> None:
        total = len(req.prompt) + int(req.max_new_tokens)
        if total > self.config.cache_len:
            raise ValueError(
                f"request {req.rid}: prompt + max_new_tokens = {total} "
                f"exceeds cache_len = {self.config.cache_len} (the paged "
                "decode path requires an unwrapped KV ring)")
        self.queue.append(req)

    def has_work(self) -> bool:
        return bool(self.queue) or any(s is not None for s in self.slots)

    def _best_donor(self, prompt_keys: tuple) -> tuple:
        """(reuse_len, src_slot): longest common prefix of the prompt
        against any slot row's written-KV history; ties -> lowest slot."""
        best_c, best_s = 0, -1
        for s, hist in enumerate(self.written):
            c = 0
            for a, b in zip(prompt_keys, hist):
                if a != b:
                    break
                c += 1
            if c > best_c:
                best_c, best_s = c, s
        return best_c, best_s

    def admit(self) -> List[dict]:
        """Fill free slots FIFO; returns admission records (the engine
        performs the KV row copy for ``reuse > 0``)."""
        out = []
        for slot in range(self.config.n_slots):
            if self.slots[slot] is not None or not self.queue:
                continue
            req = self.queue.popleft()
            keys = tuple(_tok_key(t) for t in req.prompt)
            reuse, src = (0, -1)
            if self.config.prefix_cache:
                reuse, src = self._best_donor(keys)
                # the last prompt token must still be decoded at its true
                # position so its logits produce the first sample
                reuse = min(reuse, len(req.prompt) - 1)
                if reuse <= 0:
                    reuse, src = 0, -1
            self.slots[slot] = _Slot(req=req, fed=reuse,
                                     admitted_step=self.step_idx)
            obs_metrics.counter("serve.admit").inc()
            self.written[slot] = keys[:reuse]
            if reuse > 0:
                self.prefix_hits += 1
                self.prefix_tokens_reused += reuse
                obs_metrics.counter("serve.prefix_hit").inc()
                obs_metrics.counter("serve.prefix_tokens_reused").inc(reuse)
            out.append(self._emit("admit", rid=req.rid, slot=slot,
                                  reuse=reuse, src=src))
        return out

    # ------------------------------------------------------------------ step
    def plan(self) -> List[tuple]:
        """Work for one engine step: ``[(pos, [(slot, token, sample)])]``
        — groups sorted by position, slots ascending within a group.
        ``token`` is the value to feed at ``pos`` (prompt during prefill,
        the last sample during decode); ``sample`` marks slots whose
        logits produce an output token this step."""
        groups: dict = {}
        for slot, st in enumerate(self.slots):
            if st is None:
                continue
            lp = len(st.req.prompt)
            token = (st.req.prompt[st.fed] if st.fed < lp
                     else st.req.out_tokens[st.fed - lp])
            groups.setdefault(st.fed, []).append(
                (slot, token, st.fed >= lp - 1))
        return [(pos, groups[pos]) for pos in sorted(groups)]

    def advance(self, slot: int, token) -> None:
        """Record that ``token``'s KV was written at this slot's position."""
        st = self.slots[slot]
        self.written[slot] = self.written[slot] + (_tok_key(token),)
        st.fed += 1

    def record_output(self, slot: int, token) -> bool:
        """Append a sampled token; evict on completion.  Returns True when
        the request just finished."""
        st = self.slots[slot]
        st.req.out_tokens.append(token)
        if len(st.req.out_tokens) >= st.req.max_new_tokens:
            self._emit("finish", rid=st.req.rid, slot=slot,
                       n_out=len(st.req.out_tokens))
            obs_metrics.counter("serve.finish").inc()
            obs_metrics.histogram("serve.latency_steps").observe(
                self.step_idx - st.admitted_step)
            self.slots[slot] = None
            return True
        return False

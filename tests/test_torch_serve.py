"""The port's serving path against the JAX package's.

The scheduler is pure Python in both packages: driven by the same request
stream and the same sampled tokens, the traces must be equal record for
record.  The engine is held against a JAX ``decode_step`` loop (the JAX
``ServeEngine`` itself is not the oracle), on ``smat-ffn-1.3b:smoke`` in
float32 with the JAX parameters loaded through ``repro_torch.convert``:
greedy tokens must be identical.  Concurrency is checked inside the port:
slots at divergent positions, and a prefix-cache copy, give the tokens each
request gets when decoded alone."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.models import transformer as JT
from repro.serve import scheduler as jsched
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.launch import serve as serve_cli
from repro_torch.serve import scheduler as tsched
from repro_torch.serve.engine import Request, ServeEngine

ARCH = "smat-ffn-1.3b:smoke"


class _Req:
    def __init__(self, rid, prompt, n):
        self.rid, self.prompt = rid, np.asarray(prompt, np.int32)
        self.max_new_tokens, self.out_tokens = n, []


def _shared_prefix_stream():
    """Five requests over two slots; 2 and 4 share prefixes with earlier
    ones, so admissions reuse KV rows of evicted requests."""
    return [(0, [5, 6, 7, 8], 3), (1, [9, 10], 2), (2, [5, 6, 7, 1, 2], 2),
            (3, [11], 4), (4, [9, 10, 12], 1)]


def _drive(module, prefix_cache):
    """Run a Scheduler to completion, sampling token (31 * pos + slot) % 97,
    and return its trace."""
    s = module.Scheduler(module.SchedulerConfig(
        n_slots=2, cache_len=16, prefix_cache=prefix_cache))
    for rid, prompt, n in _shared_prefix_stream():
        s.enqueue(_Req(rid, prompt, n))
    while s.has_work():
        s.admit()
        for pos, entries in s.plan():
            for slot, token, _ in entries:
                s.advance(slot, token)
            for slot, _, sample in entries:
                if sample:
                    s.record_output(slot, (31 * pos + slot) % 97)
        s.step_idx += 1
    return s.trace, s.prefix_hits, s.prefix_tokens_reused


@pytest.mark.parametrize("prefix_cache", [True, False])
def test_scheduler_trace_equals_jax(prefix_cache):
    got = _drive(tsched, prefix_cache)
    want = _drive(jsched, prefix_cache)
    assert got == want
    if prefix_cache:
        assert got[1] > 0, "the stream should hit the prefix cache"


@pytest.fixture(scope="module")
def pair():
    jcfg = dataclasses.replace(jax_get_config(ARCH), dtype="float32")
    tcfg = dataclasses.replace(get_config(ARCH), dtype="float32")
    jparams = JT.init_params(jcfg, seed=0)
    params_np = jax.tree.map(np.asarray, jparams)
    return jcfg, tcfg, jparams, convert.params_from_jax(tcfg, params_np,
                                                         "cpu")


def _jax_greedy(jcfg, jparams, prompt, max_new):
    """Oracle of tests/test_serve_batching.py:49: every prompt token at
    pos 0..L-1, the first output sampled from the last prompt token."""
    cache = JT.init_cache(jcfg, 1, 32)
    out, pos = [], 0
    for t in prompt:
        logits, cache = JT.decode_step(jcfg, jparams, cache,
                                       jnp.asarray([t], jnp.int32),
                                       jnp.asarray(pos, jnp.int32))
        pos += 1
    for _ in range(max_new):
        tok = int(np.asarray(logits)[0].argmax(-1))
        out.append(tok)
        logits, cache = JT.decode_step(jcfg, jparams, cache,
                                       jnp.asarray([tok], jnp.int32),
                                       jnp.asarray(pos, jnp.int32))
        pos += 1
    return out


def _serve(tcfg, model, jobs, n_slots, max_new):
    """jobs: [(rid, prompt)] -> {rid: tokens} through one port engine."""
    eng = ServeEngine(tcfg, model, n_slots=n_slots, cache_len=32,
                      device="cpu")
    out = {}
    for rid, tok in eng.generate([Request(rid, np.asarray(p, np.int32),
                                          max_new_tokens=max_new)
                                  for rid, p in jobs]):
        out.setdefault(rid, []).append(tok)
    assert sorted(out) == sorted(r for r, _ in jobs)
    assert sorted(eng.done) == sorted(out)
    return out


@pytest.mark.parametrize("n_slots", [1, 3])
def test_engine_matches_jax_decode_oracle(pair, n_slots):
    jcfg, tcfg, jparams, model = pair
    prompt, max_new = [58, 93, 70, 61, 52], 4
    oracle = _jax_greedy(jcfg, jparams, prompt, max_new)
    got = _serve(tcfg, model, [(0, prompt)], n_slots, max_new)[0]
    assert got == oracle, (got, oracle)


def test_concurrent_divergent_positions_match_solo(pair):
    """Different prompt lengths decoded together (diverged positions, one
    decode call per position group, slot masks) give each request exactly
    its solo tokens."""
    _, tcfg, _, model = pair
    jobs = [(0, [1, 2, 3, 4, 5, 6, 7]), (1, [9, 8]), (2, [300, 4, 17])]
    solo = {}
    for rid, prompt in jobs:
        solo.update(_serve(tcfg, model, [(rid, prompt)], 1, 3))
    assert _serve(tcfg, model, jobs, 2, 3) == solo


def test_prefix_cache_copy_matches_solo(pair):
    """A request admitted onto a slot that copies a donor's prefix KV
    (``_copy_slot``) decodes as it does alone."""
    _, tcfg, _, model = pair
    jobs = [(0, [7, 8, 9, 10, 11]), (1, [3]), (2, [7, 8, 9, 10, 40])]
    solo = {}
    for rid, prompt in jobs:
        solo.update(_serve(tcfg, model, [(rid, prompt)], 1, 2))
    eng = ServeEngine(tcfg, model, n_slots=2, cache_len=32, device="cpu")
    got = {}
    for rid, tok in eng.generate([Request(r, np.asarray(p, np.int32), 2)
                                  for r, p in jobs]):
        got.setdefault(rid, []).append(tok)
    assert eng.scheduler.prefix_hits == 1
    assert got == solo


def test_engine_refuses_a_model_on_another_device(pair):
    _, tcfg, _, model = pair
    with pytest.raises(ValueError, match="model is on"):
        ServeEngine(tcfg, model, device="meta")


def test_serve_cli_on_cpu(capsys):
    assert serve_cli.main(["--arch", ARCH, "--device", "cpu", "--requests",
                           "3", "--slots", "2", "--prompt-len", "3",
                           "--new-tokens", "2", "--cache-len", "16"]) == 0
    out = capsys.readouterr().out
    assert "3/3 requests, 6 new tokens" in out
    assert "kernel launches: 0" in out


@pytest.mark.parametrize("n_slots", [1, 3])
def test_attention_engine_matches_jax_decode_oracle(n_slots):
    """smat-attn-1.3b:smoke (block-sparse attention; decode applies the
    mask as a bias, ``paged_decode="off"``: the paged path is held in
    ``test_torch_paged_kv.py``) through the port's engine against a JAX
    ``decode_step`` loop: identical greedy tokens over a 40-token prompt,
    past the banded(32) window."""
    arch = "smat-attn-1.3b:smoke"

    def off(cfg):
        return dataclasses.replace(cfg, dtype="float32",
                                   attn_sparsity=dataclasses.replace(
                                       cfg.attn_sparsity, paged_decode="off"))
    jcfg, tcfg = off(jax_get_config(arch)), off(get_config(arch))
    jparams = JT.init_params(jcfg, seed=0)
    model = convert.params_from_jax(tcfg, jax.tree.map(np.asarray, jparams),
                                    "cpu")
    prompt = list(np.random.default_rng(4).integers(0, tcfg.vocab_size, 26))
    oracle = _jax_greedy(jcfg, jparams, prompt, 4)
    got = _serve(tcfg, model, [(0, prompt)], n_slots, 4)[0]
    assert got == oracle, (got, oracle)


@pytest.mark.parametrize("n_slots", [1, 3])
def test_sharded_engine_matches_jax_decode_oracle(monkeypatch, n_slots):
    """``smat-ffn-1.3b:smoke`` with ``SparsitySpec(shards=2)`` through the
    port's engine (the partitioned FFN in-process) against a JAX
    ``decode_step`` loop over JAX's ``spmm_sharded`` (unlocked as in
    ``jax_oracle``, ROADMAP C1): identical greedy tokens."""
    from repro.obs import jaxmon
    monkeypatch.setattr(jaxmon, "_trace_active",
                        lambda: not jax._src.core.trace_state_clean())

    def sharded(cfg):
        return dataclasses.replace(cfg, dtype="float32",
                                   ffn_sparsity=dataclasses.replace(
                                       cfg.ffn_sparsity, shards=2))
    jcfg, tcfg = sharded(jax_get_config(ARCH)), sharded(get_config(ARCH))
    jparams = JT.init_params(jcfg, seed=0)
    model = convert.params_from_jax(tcfg, jax.tree.map(np.asarray, jparams),
                                    "cpu")
    prompt, max_new = [58, 93, 70, 61, 52], 4
    oracle = _jax_greedy(jcfg, jparams, prompt, max_new)
    got = _serve(tcfg, model, [(0, prompt)], n_slots, max_new)[0]
    assert got == oracle, (got, oracle)

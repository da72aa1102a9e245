"""The port's ``zamba`` layout (``zamba2-7b:smoke``: 2 units of 2 Mamba2
layers, each unit followed by the ONE shared attention + MLP block, then a
Mamba2 tail of 1) against the JAX package's.

Float32 on both sides with the JAX weights loaded through
``repro_torch.convert`` (``units`` unstacked twice, ``tail`` once,
``shared_attn`` as it is): logits, loss, gradients and the nested decode
cache within 1e-4, greedy tokens identical.  ``param_count``,
``param_specs`` and ``cache_specs`` equal JAX's trees exactly.  The
engine serves concurrent requests with each request's solo tokens: its
admission resets the slot's ``units_ssd`` and ``tail_ssd`` rows (ROADMAP
C6), and prefix reuse stays off (the Mamba2 state is not indexed by
position).
"""
# ruff: noqa: E402
import pytest

torch = pytest.importorskip("torch")

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_config as jax_get_config
from repro.models import transformer as JT
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeCell
from repro_torch.data import pipeline
from repro_torch.models import transformer as T
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.train import loop

ARCH = "zamba2-7b:smoke"
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "int32": torch.int32}
_j_forward = jax.jit(JT.forward, static_argnums=0)
_j_decode = jax.jit(JT.decode_step, static_argnums=0)
_j_prefill = jax.jit(JT.prefill, static_argnums=(0, 3))


def _to_numpy(tree):
    return jax.tree.map(
        lambda a: np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16
                             else a), tree)


def _flat(tree, prefix=""):
    """``{dotted path: leaf}`` of a nested dict (the JAX trees, the port's
    caches)."""
    if not isinstance(tree, dict):
        return {prefix: tree}
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}.{k}" if prefix else k))
    return out


@pytest.fixture(scope="module")
def pair():
    jcfg = dataclasses.replace(jax_get_config(ARCH), dtype="float32")
    tcfg = dataclasses.replace(get_config(ARCH), dtype="float32")
    jparams = JT.init_params(jcfg, seed=0)
    return jcfg, tcfg, jparams, convert.params_from_jax(
        tcfg, _to_numpy(jparams), "cpu")


def _jax_leaf(jtree, name: str) -> np.ndarray:
    """The JAX leaf of the port parameter ``name``: ``units.<u>.<j>.*`` at
    [u, j] of the twice-stacked leaf, ``tail.<j>.*`` at [j],
    ``shared_attn.*`` as it is."""
    parts = name.split(".")
    lead = {"units": 2, "tail": 1}.get(parts[0], 0)
    index = tuple(int(p) for p in parts[1:1 + lead])
    leaf = jtree[parts[0]]
    for key in parts[1 + lead:]:
        leaf = leaf[key]
    return np.asarray(leaf)[index]


def test_params_from_jax_fill_every_leaf(pair):
    jcfg, tcfg, jparams, model = pair
    assert len(model.units) == 2 and len(model.units[0]) == 2
    assert len(model.tail) == 1
    jflat = _flat(_to_numpy(jparams))
    n = 0
    for name, p in model.state_dict().items():
        np.testing.assert_array_equal(p.numpy(), _jax_leaf(
            _to_numpy(jparams), name), err_msg=name)
        n += 1
    # every JAX leaf lands somewhere: units x2 stacked, tail x1, shared x0
    stack = {"units": 4, "tail": 1, "shared_attn": 1}
    assert n == sum(stack.get(k.split(".")[0], 1) for k in jflat)


def test_forward_logits_and_loss_match(pair):
    jcfg, tcfg, jparams, model = pair
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, tcfg.vocab_size, size=(2, 64), dtype=np.int32)
    labels = rng.integers(0, tcfg.vocab_size, size=(2, 64), dtype=np.int32)
    j_logits, _, _ = _j_forward(jcfg, jparams, {"tokens": jnp.asarray(tokens)})
    j_loss = JT.lm_loss(jcfg, j_logits, jnp.asarray(labels))
    with torch.inference_mode():
        t_logits, _, t_aux = model({"tokens": torch.from_numpy(tokens).long()})
        t_loss = T.lm_loss(tcfg, t_logits, torch.from_numpy(labels))
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(t_loss), float(j_loss), rtol=1e-4,
                               atol=1e-4)
    assert float(t_aux) == 0.0


def test_step0_gradients_match(pair):
    """Every gradient within 1e-4 x its leaf's max |grad|; the shared
    block's sums its units' contributions."""
    jcfg, tcfg, jparams, model = pair
    batch = pipeline.make_batch(tcfg, ShapeCell("t", "train", 32, 2), 0)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: JT.train_loss(jcfg, p, jbatch, remat="none"),
        has_aux=True))(jparams)
    loss, _ = T.train_loss(tcfg, model, loop.batch_to_device(batch, "cpu"),
                           remat="none")
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=1e-4, atol=1e-4)
    try:
        for name, p in model.named_parameters():
            want = _jax_leaf(jgrads, name)
            np.testing.assert_allclose(
                p.grad.numpy(), want, rtol=0,
                atol=1e-4 * float(np.abs(want).max()), err_msg=name)
    finally:
        model.zero_grad(set_to_none=True)


def test_prefill_then_greedy_decode_match(pair):
    """Prefill 32 tokens, then 8 greedy steps: logits within 1e-4 each
    step, every cache leaf within 1e-4 (each unit's own attention ring),
    tokens identical."""
    jcfg, tcfg, jparams, model = pair
    prompt = np.random.default_rng(1).integers(0, tcfg.vocab_size,
                                               size=(2, 32), dtype=np.int32)
    j_logits, j_cache = _j_prefill(jcfg, jparams,
                                   {"tokens": jnp.asarray(prompt)}, 48)
    with torch.inference_mode():
        t_logits, t_cache = T.prefill(
            tcfg, model, {"tokens": torch.from_numpy(prompt).long()}, 48)
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits),
                               rtol=1e-4, atol=1e-4)
    tok_j = np.asarray(j_logits)[:, -1].argmax(-1)
    tok_t = t_logits[:, -1].argmax(-1)
    j_toks, t_toks = [tok_j], [tok_t.numpy()]
    with torch.inference_mode():
        for pos in range(32, 40):
            j_step, j_cache = _j_decode(jcfg, jparams, j_cache,
                                        jnp.asarray(tok_j, jnp.int32),
                                        jnp.asarray(pos, jnp.int32))
            t_step, t_cache = T.decode_step(tcfg, model, t_cache, tok_t, pos)
            np.testing.assert_allclose(t_step.numpy(), np.asarray(j_step),
                                       rtol=1e-4, atol=1e-4,
                                       err_msg=f"pos {pos}")
            tok_j, tok_t = np.asarray(j_step).argmax(-1), t_step.argmax(-1)
            j_toks.append(tok_j)
            t_toks.append(tok_t.numpy())
    np.testing.assert_array_equal(np.stack(t_toks), np.stack(j_toks))
    got, want = _flat(t_cache), _flat(j_cache)
    assert sorted(got) == sorted(want) == [
        "tail_ssd.conv", "tail_ssd.state", "units_attn.k", "units_attn.v",
        "units_ssd.conv", "units_ssd.state"]
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-4, atol=1e-4, err_msg=k)


@pytest.mark.parametrize("arch", [ARCH, "zamba2-7b"])
def test_param_count_and_specs_equal_jax(arch):
    """``param_count`` exactly JAX's (5,736,657,792 for zamba2-7b), the
    param and cache specs leaf for leaf (the port's stack axes unstacked
    into its lists)."""
    jcfg, tcfg = jax_get_config(arch), get_config(arch)
    assert tcfg.param_count() == jcfg.param_count()
    if arch == "zamba2-7b":
        assert tcfg.param_count() == 5_736_657_792
    jflat = _flat(JT.param_specs(jcfg))
    want = {}
    for path, leaf in jflat.items():
        head = path.split(".")[0]
        lead = {"units": 2, "tail": 1}.get(head, 0)
        shape, dtype = tuple(leaf.shape), DTYPES[str(leaf.dtype)]
        idx = np.ndindex(*shape[:lead])
        for ix in idx:
            key = ".".join([head, *map(str, ix), *path.split(".")[1:]])
            want[key] = (shape[lead:], dtype)
    got = {k: (tuple(v.shape), v.dtype) for k, v in
           T.flat_specs(T.param_specs(tcfg, device="cpu")).items()}
    assert got == want
    jc = {k: (tuple(v.shape), DTYPES[str(v.dtype)])
          for k, v in _flat(JT.cache_specs(jcfg, 3, 40)).items()}
    tc = {k: (tuple(v.shape), v.dtype)
          for k, v in _flat(T.cache_specs(tcfg, 3, 40)).items()}
    assert tc == jc


def test_param_specs_are_the_built_model(pair):
    _, tcfg, _, model = pair
    got = {k: (tuple(v.shape), v.dtype) for k, v in
           T.flat_specs(T.param_specs(tcfg, device="cpu")).items()}
    assert got == {k: (tuple(v.shape), v.dtype)
                   for k, v in model.state_dict().items()}


def _serve(tcfg, model, jobs, n_slots, max_new):
    eng = ServeEngine(tcfg, model, n_slots=n_slots, cache_len=32,
                      device="cpu")
    out = {}
    for rid, tok in eng.generate([Request(rid, np.asarray(p, np.int32),
                                          max_new_tokens=max_new)
                                  for rid, p in jobs]):
        out.setdefault(rid, []).append(tok)
    return eng, out


def test_engine_concurrent_requests_match_solo(pair):
    """Diverged positions decoded together, request 2 admitted onto
    request 1's freed slot (its Mamba2 rows reset, ROADMAP C6) and request
    3 sharing request 0's prefix (no reuse: prefix reuse is off): each
    request gets its solo tokens."""
    _, tcfg, _, model = pair
    jobs = [(0, [1, 2, 3, 4, 5, 6, 7]), (1, [9, 8]), (2, [300, 4, 17]),
            (3, [1, 2, 3, 4, 40])]
    solo = {}
    for rid, prompt in jobs:
        solo.update(_serve(tcfg, model, [(rid, prompt)], 1, 3)[1])
    eng, got = _serve(tcfg, model, jobs, 2, 3)
    assert got == solo
    assert not eng.scheduler.config.prefix_cache
    assert eng.scheduler.prefix_hits == 0


def test_engine_matches_a_jax_decode_loop(pair):
    """One request through the port's engine (3 slots) against a JAX
    ``decode_step`` loop: identical greedy tokens."""
    jcfg, tcfg, jparams, model = pair
    prompt, max_new = [58, 93, 70, 61, 52], 4
    cache = JT.init_cache(jcfg, 1, 32)
    want, pos = [], 0
    for t in prompt + [None] * max_new:
        if t is None:
            t = int(np.asarray(logits)[0].argmax())
            want.append(t)
            if len(want) == max_new:
                break
        logits, cache = _j_decode(jcfg, jparams, cache,
                                  jnp.asarray([t], jnp.int32),
                                  jnp.asarray(pos, jnp.int32))
        pos += 1
    assert _serve(tcfg, model, [(0, prompt)], 3, max_new)[1][0] == want


def test_reset_history_zeroes_every_mamba_row_of_the_slot():
    from repro_torch.serve import engine as E
    tcfg = get_config(ARCH)
    cache = T.init_cache(tcfg, 3, 16, device="cpu")
    for leaf in _flat(cache).values():
        leaf.fill_(1)
    E._reset_history(cache, 1)
    for name, leaf in _flat(cache).items():
        ax = E._CACHE_BATCH_AXIS[name.split(".")[-1]] % leaf.ndim
        row = leaf.select(ax, 1)
        assert bool((row == 0).all()) == ("ssd" in name), name
        assert bool((leaf.select(ax, 0) == 1).all()), name

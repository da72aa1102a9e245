"""The port's ``gemma_pair`` layout (``gemma2-27b:smoke``: one local
sliding-window + global pair a block, post-norms, logit softcaps, the
embedding scaled by sqrt(d_model)) against the JAX package's.

Float32 on both sides with the JAX weights loaded through
``repro_torch.convert``: logits, losses, caches and gradients within 1e-4
(gradients: of each leaf's max |grad|), greedy tokens identical.  The bf16
embedding (the scale rounded to bf16 before the product) is bit-equal.  A
``gemma_pair`` config with block-sparse attention (``banded(32)`` and
``local_global``; the local half's mask capped at its window) runs through
the port's ``models.attention`` (its plain versions on the CPU), and its
``PagedKVCache`` splits into JAX's local and global groups.
"""
# ruff: noqa: E402
import pytest

torch = pytest.importorskip("torch")

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_config as jax_get_config
from repro.models import attention as JA
from repro.models import transformer as JT
from repro.obs import jaxmon
from repro.serve import paged_kv as jpk
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeCell
from repro_torch.data import pipeline
from repro_torch.models import attention as A
from repro_torch.models import transformer as T
from repro_torch.serve import paged_kv as tpk
from repro_torch.train import loop

ARCH = "gemma2-27b:smoke"
_j_forward = jax.jit(JT.forward, static_argnums=0)
_j_decode = jax.jit(JT.decode_step, static_argnums=0)
_j_prefill = jax.jit(JT.prefill, static_argnums=(0, 3))


def _cfgs(dtype="float32", sparse=None):
    """(jax cfg, port cfg) of ``gemma2-27b:smoke`` in ``dtype``, with
    ``sparse`` = (jax mask, port mask) as block-sparse attention scores."""
    jcfg = dataclasses.replace(jax_get_config(ARCH), dtype=dtype)
    tcfg = dataclasses.replace(get_config(ARCH), dtype=dtype)
    if sparse is not None:
        jspec = jax_get_config("smat-attn-1.3b:smoke").attn_sparsity
        tspec = get_config("smat-attn-1.3b:smoke").attn_sparsity
        jcfg = dataclasses.replace(jcfg, attn_sparsity=dataclasses.replace(
            jspec, mask=sparse[0]))
        tcfg = dataclasses.replace(tcfg, attn_sparsity=dataclasses.replace(
            tspec, mask=sparse[1]))
    return jcfg, tcfg


def _to_numpy(tree):
    return jax.tree.map(
        lambda a: np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16
                             else a), tree)


@pytest.fixture(scope="module")
def pair():
    jcfg, tcfg = _cfgs()
    jparams = JT.init_params(jcfg, seed=0)
    return jcfg, tcfg, jparams, convert.params_from_jax(
        tcfg, _to_numpy(jparams), "cpu")


def test_model_holds_one_block_a_pair(pair):
    _, tcfg, _, model = pair
    assert len(model.blocks) == tcfg.n_layers // 2 == 1
    blk = model.blocks[0]
    for kind in ("local", "global"):
        half = getattr(blk, kind)
        assert {n for n, _ in half.named_children()} == {"attn", "mlp"}
        assert {n for n, _ in half.named_parameters(recurse=False)} == {
            "ln1", "ln1_post", "ln2", "ln2_post"}
        assert half.mlp.seed_hint == 0


def test_forward_logits_and_loss_match(pair):
    """64 tokens a row: past the local half's 64-token window."""
    jcfg, tcfg, jparams, model = pair
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, tcfg.vocab_size, size=(2, 80), dtype=np.int32)
    labels = rng.integers(0, tcfg.vocab_size, size=(2, 80), dtype=np.int32)
    j_logits, _, _ = _j_forward(jcfg, jparams, {"tokens": jnp.asarray(tokens)})
    j_loss = JT.lm_loss(jcfg, j_logits, jnp.asarray(labels))
    with torch.inference_mode():
        t_logits, _, _ = model({"tokens": torch.from_numpy(tokens).long()})
        t_loss = T.lm_loss(tcfg, t_logits, torch.from_numpy(labels))
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(t_loss), float(j_loss), rtol=1e-4,
                               atol=1e-4)
    # the final softcap bounds every logit
    assert float(t_logits.abs().max()) < tcfg.final_logit_softcap


def test_prefill_then_greedy_decode_match(pair):
    """Prefill of 40 tokens into a 96-slot cache (the local ring capped at
    64), then 30 greedy decode steps, past the local ring's wrap: logits
    within 1e-4 each step, caches within 1e-4, tokens identical."""
    jcfg, tcfg, jparams, model = pair
    prompt = np.random.default_rng(1).integers(0, tcfg.vocab_size,
                                               size=(2, 40), dtype=np.int32)
    j_logits, j_cache = _j_prefill(jcfg, jparams,
                                   {"tokens": jnp.asarray(prompt)}, 96)
    with torch.inference_mode():
        t_logits, t_cache = T.prefill(
            tcfg, model, {"tokens": torch.from_numpy(prompt).long()}, 96)
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits),
                               rtol=1e-4, atol=1e-4)
    assert t_cache["local"]["k"].shape[2] == 64
    assert t_cache["global"]["k"].shape[2] == 96
    tok_j = np.asarray(j_logits)[:, -1].argmax(-1)
    tok_t = t_logits[:, -1].argmax(-1)
    j_toks, t_toks = [tok_j], [tok_t.numpy()]
    with torch.inference_mode():
        for pos in range(40, 70):
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
    for kind in ("local", "global"):
        for name in ("k", "v"):
            np.testing.assert_allclose(
                t_cache[kind][name].numpy(),
                np.asarray(j_cache[kind][name]), rtol=1e-4, atol=1e-4,
                err_msg=f"{kind}.{name}")


def _jax_grad_leaf(jgrads, name: str) -> np.ndarray:
    """The JAX gradient of the port parameter ``name`` (``blocks.<i>.*``
    at index i of the stacked leaf)."""
    parts = name.split(".")
    if parts[0] != "blocks":
        return np.asarray(jgrads[parts[0]])
    leaf = jgrads["blocks"]
    for key in parts[2:]:
        leaf = leaf[key]
    return np.asarray(leaf[int(parts[1])])


def test_train_loss_and_step0_gradients_match(pair):
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
        names = [n for n, _ in model.named_parameters()]
        assert len(names) == 3 + 2 * 11     # 3 globals, 11 a half
        for name, p in model.named_parameters():
            want = _jax_grad_leaf(jgrads, name)
            np.testing.assert_allclose(
                p.grad.numpy(), want, rtol=0,
                atol=1e-4 * float(np.abs(want).max()), err_msg=name)
    finally:
        model.zero_grad(set_to_none=True)


def test_bf16_embedding_is_bit_equal_to_jax():
    """In bf16 the scale sqrt(128) is rounded to bf16 before the product,
    as ``jnp.asarray(d ** 0.5, x.dtype)`` is: the embeddings are equal bit
    for bit (an f32 scale would differ)."""
    jcfg, tcfg = _cfgs(dtype="bfloat16")
    jparams = JT.init_params(jcfg, seed=0)
    model = convert.params_from_jax(tcfg, _to_numpy(jparams), "cpu")
    tokens = np.random.default_rng(2).integers(0, tcfg.vocab_size, (2, 17),
                                               dtype=np.int32)
    want = JT._embed(jcfg, jparams, {"tokens": jnp.asarray(tokens)})
    with torch.inference_mode():
        got = T._embed(tcfg, model, {"tokens": torch.from_numpy(tokens)
                                     .long()})
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
    f32_scale = (model.embed[torch.from_numpy(tokens).long()].float() *
                 tcfg.d_model ** 0.5).to(torch.bfloat16)
    assert not torch.equal(f32_scale, got)


SPARSE = {"banded": (JA.banded(32), A.banded(32)),
          "local_global": (JA.local_global(16, 8), A.local_global(16, 8))}


@pytest.fixture
def jax_oracle(monkeypatch):
    """Unlock the monitored JAX functions (ROADMAP C1), test-side only."""
    monkeypatch.setattr(jaxmon, "_trace_active",
                        lambda: not jax._src.core.trace_state_clean())


@pytest.mark.parametrize("mask", list(SPARSE))
def test_sparse_attention_gemma_pair_matches_jax(jax_oracle, mask):
    """A ``gemma_pair`` config with block-sparse attention scores: the
    local half's mask takes ``window_cap`` = its window.  Forward logits
    over 96 tokens (past the window) and the last-position logits of a
    prefill within 1e-4 of JAX's."""
    jcfg, tcfg = _cfgs(sparse=SPARSE[mask])
    jparams = JT.init_params(jcfg, seed=0)
    model = convert.params_from_jax(tcfg, _to_numpy(jparams), "cpu")
    tokens = np.random.default_rng(3).integers(0, tcfg.vocab_size, (1, 96),
                                               dtype=np.int32)
    j_logits, _, _ = JT.forward(jcfg, jparams, {"tokens": jnp.asarray(tokens)})
    with torch.inference_mode():
        t_logits, _, _ = model({"tokens": torch.from_numpy(tokens).long()})
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("cache_len,n_slots,budget", [
    (64, 2, None), (128, 3, 2), (96, 1, 1), (40, 2, None)])
def test_paged_kv_report_splits_local_and_global_as_jax(cache_len, n_slots,
                                                        budget):
    """``PagedKVCache`` of the sparse ``gemma_pair`` config: the local
    group (its ring capped at the window) and the global one, report and
    page tables equal to JAX's (given the JAX package's bandwidths)."""
    jcfg, tcfg = _cfgs(sparse=SPARSE["banded"])
    bw = dict(hbm_gbps=819.0, host_gbps=32.0)
    want = jpk.PagedKVCache(jcfg, cache_len, n_slots, jpk.PagePlacementSpec(
        resident_pages=budget, **bw))
    got = tpk.PagedKVCache(tcfg, cache_len, n_slots, tpk.PagePlacementSpec(
        resident_pages=budget, **bw))
    assert got.report() == want.report()
    assert [g["group"] for g in got.report()["groups"]] == ["local",
                                                            "global"]
    j_leaves, t_leaves = want.table_leaves(), got.table_leaves(device="cpu")
    assert sorted(t_leaves) == sorted(j_leaves)
    for group, leaves in j_leaves.items():
        for name, leaf in leaves.items():
            np.testing.assert_array_equal(t_leaves[group][name].numpy(),
                                          np.asarray(leaf))


def test_engine_pages_gemma_pair_and_reuses_prefixes():
    """The engine builds the ``PagedKVCache`` hook for a sparse
    ``gemma_pair`` config, and keeps prefix reuse on (k/v rings only)."""
    from repro_torch.serve.engine import ServeEngine
    _, tcfg = _cfgs(sparse=SPARSE["banded"])
    model = T.init_params(tcfg, seed=0, device="cpu")
    eng = ServeEngine(tcfg, model, n_slots=2, cache_len=64, device="cpu")
    assert eng.paged_kv is not None
    assert eng.scheduler.config.prefix_cache
    assert [g["group"] for g in eng.paged_kv.report()["groups"]] == [
        "local", "global"]

"""The port's model against the JAX package's on ``smat-ffn-1.3b:smoke`` in
float32 on both sides, with the JAX parameters loaded through
``repro_torch.convert``.  Logits and loss agree within 1e-4 (both sum in
float32, in different orders, over two layers)."""
# ruff: noqa: E402
import pytest

pytest.importorskip("torch")

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jax_get_config
from repro.models import transformer as JT
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.models import transformer as T

ARCH = "smat-ffn-1.3b"


def _cfgs(arch=ARCH + ":smoke"):
    return (dataclasses.replace(jax_get_config(arch), dtype="float32"),
            dataclasses.replace(get_config(arch), dtype="float32"))


def _to_numpy(tree):
    return jax.tree.map(
        lambda a: np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16
                             else a), tree)


@pytest.fixture(scope="module")
def pair():
    jcfg, tcfg = _cfgs()
    jparams = JT.init_params(jcfg, seed=0)
    model = convert.params_from_jax(tcfg, _to_numpy(jparams), "cpu")
    return jcfg, tcfg, jparams, model


def test_forward_logits_and_loss_match(pair):
    jcfg, tcfg, jparams, model = pair
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, tcfg.vocab_size, size=(2, 12), dtype=np.int32)
    labels = rng.integers(0, tcfg.vocab_size, size=(2, 12), dtype=np.int32)
    labels[0, :3] = -100
    j_logits, _, _ = JT.forward(jcfg, jparams, {"tokens": jnp.asarray(tokens)})
    j_loss = JT.lm_loss(jcfg, j_logits, jnp.asarray(labels))
    with torch.inference_mode():
        t_logits, _, _ = model({"tokens": torch.from_numpy(tokens).long()})
        t_loss = T.lm_loss(tcfg, t_logits, torch.from_numpy(labels))
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(t_loss), float(j_loss), rtol=1e-4,
                               atol=1e-4)


def test_prefill_matches(pair):
    jcfg, tcfg, jparams, model = pair
    tokens = np.random.default_rng(1).integers(0, tcfg.vocab_size,
                                               size=(2, 9), dtype=np.int32)
    j_logits, j_cache = JT.prefill(jcfg, jparams,
                                   {"tokens": jnp.asarray(tokens)}, 16)
    with torch.inference_mode():
        t_logits, t_cache = T.prefill(tcfg, model,
                                      {"tokens": torch.from_numpy(tokens)
                                       .long()}, 16)
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits),
                               rtol=1e-4, atol=1e-4)
    for name in ("k", "v"):
        np.testing.assert_allclose(t_cache[name].numpy(),
                                   np.asarray(j_cache[name]), rtol=1e-4,
                                   atol=1e-4)


def test_decode_loop_matches_with_identical_greedy_tokens(pair):
    jcfg, tcfg, jparams, model = pair
    prompt = [58, 93, 70, 61, 52, 7, 300]
    j_cache = JT.init_cache(jcfg, 1, 32)
    t_cache = T.init_cache(tcfg, 1, 32, device="cpu")
    j_tokens, t_tokens = [], []
    tok_j = tok_t = None
    with torch.inference_mode():
        for pos in range(len(prompt) + 5):
            fed_j = prompt[pos] if pos < len(prompt) else tok_j
            fed_t = prompt[pos] if pos < len(prompt) else tok_t
            j_logits, j_cache = JT.decode_step(
                jcfg, jparams, j_cache, jnp.asarray([fed_j], jnp.int32),
                jnp.asarray(pos, jnp.int32))
            t_logits, t_cache = T.decode_step(
                tcfg, model, t_cache, torch.tensor([fed_t]), pos)
            np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits),
                                       rtol=1e-4, atol=1e-4,
                                       err_msg=f"pos {pos}")
            if pos >= len(prompt) - 1:
                tok_j = int(np.asarray(j_logits)[0].argmax())
                tok_t = int(t_logits[0].argmax())
                j_tokens.append(tok_j)
                t_tokens.append(tok_t)
    assert t_tokens == j_tokens


def test_own_init_params_sparse_structures_equal_jax(pair):
    """init_params draws the dense weights from a torch.Generator, but the
    sparse FFN structures and values come from numpy seeds: equal to the
    JAX package's, layer by layer."""
    jcfg, tcfg, jparams, _ = pair
    own = T.init_params(tcfg, seed=0, device="cpu")
    j_mlp = jparams["blocks"]["mlp"]
    for i, blk in enumerate(own.blocks):
        for name in ("gate", "up", "down"):
            layer = getattr(blk.mlp, name)
            for field, value in j_mlp[name].items():
                np.testing.assert_array_equal(
                    getattr(layer, field).detach().numpy(),
                    np.asarray(value[i]), err_msg=f"{i}.{name}.{field}")
            np.testing.assert_array_equal(
                layer.rowptr.numpy(),
                np.concatenate([[0], np.cumsum(np.bincount(
                    np.asarray(j_mlp[name]["row_ids"][i]),
                    minlength=layer.meta.n_block_rows))]))


@pytest.mark.parametrize("arch", [ARCH, ARCH + ":smoke"])
def test_config_fields_equal_except_backend(arch):
    jcfg, tcfg = jax_get_config(arch), get_config(arch)
    j, t = dataclasses.asdict(jcfg), dataclasses.asdict(tcfg)
    j_spec, t_spec = j.pop("ffn_sparsity"), t.pop("ffn_sparsity")
    assert t == j
    assert t_spec.pop("backend") == "nnz_stream"
    j_spec.pop("backend")
    j_spec.pop("interpret")
    assert t_spec == j_spec


def test_unported_configs_raise():
    # a shards=2 attention config (the row-sharded score structure, A5)
    # runs, and gives the logits of its shards=0 twin on the same weights;
    # an unknown layout raises ValueError, as the JAX package's
    # _init_block does
    tcfg = dataclasses.replace(get_config("smat-attn-1.3b:smoke"),
                               dtype="float32")
    cfg = dataclasses.replace(tcfg, attn_sparsity=dataclasses.replace(
        tcfg.attn_sparsity, shards=2))
    model = T.init_params(cfg, seed=0, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (1, 40))).long()
    with torch.inference_mode():
        logits, _, _ = model({"tokens": tokens})
        plain, _, _ = T.forward(tcfg, model, {"tokens": tokens})
    assert logits.shape == (1, 40, cfg.vocab_size)
    assert bool(torch.isfinite(logits).all())
    np.testing.assert_allclose(logits.numpy(), plain.numpy(), rtol=1e-5,
                               atol=1e-5)
    bad = dataclasses.replace(get_config(ARCH + ":smoke"), layout="rwkv")
    with pytest.raises(ValueError, match="rwkv"):
        JT.init_params(dataclasses.replace(jax_get_config(ARCH + ":smoke"),
                                           layout="rwkv"))
    with pytest.raises(ValueError, match="unknown layout 'rwkv'"):
        T.Transformer(bad, device="cpu")
    with pytest.raises(ValueError, match="unknown layout 'rwkv'"):
        T.init_cache(bad, 1, 8, device="cpu")


@pytest.fixture
def jax_oracle(monkeypatch):
    """Unlock the monitored JAX functions (ROADMAP C1), test-side only."""
    from repro.obs import jaxmon
    monkeypatch.setattr(jaxmon, "_trace_active",
                        lambda: not jax._src.core.trace_state_clean())


def test_sharded_ffn_logits_match_jax(jax_oracle):
    """``smat-ffn-1.3b:smoke`` with ``SparsitySpec(shards=2)`` in both
    packages, the JAX weights (the partition's ``shard_*`` leaves too)
    loaded through ``convert.params_from_jax``: logits and loss within
    1e-4 of JAX's forward."""
    jcfg, tcfg = _cfgs()
    jcfg = dataclasses.replace(jcfg, ffn_sparsity=dataclasses.replace(
        jcfg.ffn_sparsity, shards=2))
    tcfg = dataclasses.replace(tcfg, ffn_sparsity=dataclasses.replace(
        tcfg.ffn_sparsity, shards=2))
    jparams = JT.init_params(jcfg, seed=0)
    model = convert.params_from_jax(tcfg, _to_numpy(jparams), "cpu")
    assert "shard_src" in jparams["blocks"]["mlp"]["gate"]
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, tcfg.vocab_size, size=(2, 12), dtype=np.int32)
    labels = rng.integers(0, tcfg.vocab_size, size=(2, 12), dtype=np.int32)
    j_logits, _, _ = JT.forward(jcfg, jparams, {"tokens": jnp.asarray(tokens)})
    j_loss = JT.lm_loss(jcfg, j_logits, jnp.asarray(labels))
    with torch.inference_mode():
        t_logits, _, _ = model({"tokens": torch.from_numpy(tokens).long()})
        t_loss = T.lm_loss(tcfg, t_logits, torch.from_numpy(labels))
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(t_loss), float(j_loss), rtol=1e-4,
                               atol=1e-4)
    gate = model.blocks[1].mlp.gate
    np.testing.assert_array_equal(
        gate.shard_src.numpy(),
        np.asarray(jparams["blocks"]["mlp"]["gate"]["shard_src"][1]))


# ------------------------------------------- the mla_moe and ssd layouts
NEW_ARCHS = ["deepseek-v2-lite-16b:smoke", "deepseek-v2-236b:smoke",
             "mamba2-1.3b:smoke"]
_j_forward = jax.jit(JT.forward, static_argnums=0)
_j_decode = jax.jit(JT.decode_step, static_argnums=0)
_j_prefill = jax.jit(JT.prefill, static_argnums=(0, 3))


@pytest.fixture(scope="module", params=NEW_ARCHS)
def new_pair(request):
    """A ``mla_moe`` or ``ssd`` smoke arch in float32 in both packages, the
    JAX weights loaded through ``convert.params_from_jax``."""
    jcfg, tcfg = _cfgs(request.param)
    jparams = JT.init_params(jcfg, seed=0)
    model = convert.params_from_jax(tcfg, _to_numpy(jparams), "cpu")
    return jcfg, tcfg, jparams, model


def test_new_layouts_forward_logits_loss_and_aux_match(new_pair):
    """Logits, loss and the summed MoE load-balance loss (0 for ssd)
    within 1e-4; 64 tokens a row, past the MoE capacity of some experts."""
    jcfg, tcfg, jparams, model = new_pair
    rng = np.random.default_rng(6)
    tokens = rng.integers(0, tcfg.vocab_size, size=(2, 64), dtype=np.int32)
    labels = rng.integers(0, tcfg.vocab_size, size=(2, 64), dtype=np.int32)
    j_logits, _, j_aux = _j_forward(jcfg, jparams,
                                    {"tokens": jnp.asarray(tokens)})
    j_loss = JT.lm_loss(jcfg, j_logits, jnp.asarray(labels))
    with torch.inference_mode():
        t_logits, _, t_aux = model({"tokens": torch.from_numpy(tokens)
                                    .long()})
        t_loss = T.lm_loss(tcfg, t_logits, torch.from_numpy(labels))
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(t_loss), float(j_loss), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(float(t_aux), float(j_aux), rtol=1e-4,
                               atol=1e-4)
    assert (float(t_aux) > 0) == (tcfg.layout == "mla_moe")


def _jax_grad_leaf(jgrads, name: str) -> np.ndarray:
    parts = name.split(".")
    if parts[0] != "blocks":
        return np.asarray(jgrads[parts[0]])
    leaf = jgrads["blocks"]
    for key in parts[2:]:
        leaf = leaf[key]
    return np.asarray(leaf[int(parts[1])])


def test_new_layouts_step0_gradients_match(new_pair):
    """Loss (with 0.01 x aux) and every parameter's gradient at step 0:
    each within 1e-4 x its leaf's max |grad|."""
    from repro_torch.configs.base import ShapeCell
    from repro_torch.data import pipeline
    from repro_torch.train import loop
    jcfg, tcfg, jparams, model = new_pair
    batch = pipeline.make_batch(tcfg, ShapeCell("t", "train", 32, 2), 0)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: JT.train_loss(jcfg, p, jbatch, remat="none"),
        has_aux=True))(jparams)
    loss, parts = T.train_loss(tcfg, model,
                               loop.batch_to_device(batch, "cpu"),
                               remat="none")
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=1e-4, atol=1e-4)
    try:
        for name, p in model.named_parameters():
            want = _jax_grad_leaf(jgrads, name)
            scale = float(np.abs(want).max())
            np.testing.assert_allclose(p.grad.numpy(), want, rtol=0,
                                       atol=1e-4 * scale, err_msg=name)
    finally:
        model.zero_grad(set_to_none=True)


def test_new_layouts_prefill_and_greedy_decode_match(new_pair):
    """Prefill logits and cache leaves within 1e-4, then a greedy decode
    loop from the prefilled cache: logits within 1e-4 every step and the
    tokens identical."""
    jcfg, tcfg, jparams, model = new_pair
    prompt = np.random.default_rng(7).integers(
        0, tcfg.vocab_size, size=(2, 32), dtype=np.int32)
    j_logits, j_cache = _j_prefill(jcfg, jparams,
                                   {"tokens": jnp.asarray(prompt)}, 48)
    with torch.inference_mode():
        t_logits, t_cache = T.prefill(
            tcfg, model, {"tokens": torch.from_numpy(prompt).long()}, 48)
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits),
                               rtol=1e-4, atol=1e-4)
    assert set(t_cache) == set(j_cache)
    for k in t_cache:
        np.testing.assert_allclose(t_cache[k].numpy(),
                                   np.asarray(j_cache[k]), rtol=1e-4,
                                   atol=1e-4, err_msg=k)
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
            tok_j = np.asarray(j_step).argmax(-1)
            tok_t = t_step.argmax(-1)
            j_toks.append(tok_j)
            t_toks.append(tok_t.numpy())
    np.testing.assert_array_equal(np.stack(t_toks), np.stack(j_toks))


# the archs registered with the JAX package's fields unchanged (the two
# smat archs differ in their backends: test_config_fields_equal_except_backend)
SAME_ARCHS = ["deepseek-v2-lite-16b", "deepseek-v2-236b", "mamba2-1.3b",
              "pixtral-12b", "h2o-danube-1.8b", "minitron-4b",
              "qwen2.5-14b", "gemma2-27b", "zamba2-7b", "musicgen-medium"]


def test_every_jax_arch_is_registered():
    from repro.configs import list_archs as jax_list_archs
    from repro_torch.configs import list_archs
    assert sorted(list_archs()) == sorted(jax_list_archs())
    assert len(list_archs()) == 12


@pytest.mark.parametrize("arch", SAME_ARCHS + [a + ":smoke"
                                               for a in SAME_ARCHS])
def test_new_config_fields_equal_jax(arch):
    jcfg, tcfg = jax_get_config(arch), get_config(arch)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert (tcfg.d_inner, tcfg.ssm_heads) == (jcfg.d_inner, jcfg.ssm_heads)


def test_new_layouts_remat_full_matches_none():
    """``remat="full"`` over MoE blocks: the same loss, aux and gradients
    (the checkpointed block returns its aux loss too)."""
    from repro_torch.configs.base import ShapeCell
    from repro_torch.data import pipeline
    from repro_torch.train import loop
    _, tcfg = _cfgs("deepseek-v2-lite-16b:smoke")
    batch = loop.batch_to_device(pipeline.make_batch(
        tcfg, ShapeCell("t", "train", 32, 2), 1), "cpu")
    out = {}
    for remat in ("none", "full"):
        model = T.init_params(tcfg, seed=0, device="cpu")
        loss, parts = T.train_loss(tcfg, model, batch, remat=remat)
        loss.backward()
        out[remat] = (float(loss.detach()), float(parts["aux_loss"]),
                      {n: p.grad for n, p in model.named_parameters()})
    assert out["full"][:2] == out["none"][:2]
    assert out["none"][1] > 0
    for name, g in out["none"][2].items():
        torch.testing.assert_close(out["full"][2][name], g, rtol=1e-6,
                                   atol=1e-6, msg=name)

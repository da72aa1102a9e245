"""The port's ``codebooks`` and ``tokens+patches`` inputs against the JAX
package's, on ``musicgen-medium:smoke`` (4 codebooks: tokens [B, L, 4],
logits [B, L, 4, V], decode rows [B, 4]) and ``pixtral-12b:smoke`` (8
patch embeddings in front of the tokens; the loss over text positions).

Float32 on both sides with the JAX weights loaded through
``repro_torch.convert``: logits, losses and gradients within 1e-4, greedy
tokens and engine streams identical.  ``input_specs`` equal JAX's (the ids
int64 in the port, int32 in JAX).  In bf16 the codebook sum runs in order
0..3 in the model dtype, as JAX's Python ``sum``: bit-equal.
"""
# ruff: noqa: E402
import pytest

torch = pytest.importorskip("torch")

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_config as jax_get_config
from repro.configs.base import ShapeCell as JaxShapeCell
from repro.launch import steps as jst
from repro.models import transformer as JT
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeCell
from repro_torch.data import pipeline
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import steps as st
from repro_torch.models import transformer as T
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.train import loop

AUDIO, VLM = "musicgen-medium:smoke", "pixtral-12b:smoke"
_j_forward = jax.jit(JT.forward, static_argnums=0)
_j_decode = jax.jit(JT.decode_step, static_argnums=0)
_j_prefill = jax.jit(JT.prefill, static_argnums=(0, 3))


def _to_numpy(tree):
    return jax.tree.map(
        lambda a: np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16
                             else a), tree)


def _pair(arch, dtype="float32"):
    jcfg = dataclasses.replace(jax_get_config(arch), dtype=dtype)
    tcfg = dataclasses.replace(get_config(arch), dtype=dtype)
    jparams = JT.init_params(jcfg, seed=0)
    return jcfg, tcfg, jparams, convert.params_from_jax(
        tcfg, _to_numpy(jparams), "cpu")


@pytest.fixture(scope="module")
def audio():
    return _pair(AUDIO)


@pytest.fixture(scope="module")
def vlm():
    return _pair(VLM)


def _jax_grads_match(jcfg, tcfg, jparams, model, batch):
    """``train_loss`` and every step-0 gradient (of each leaf's max)
    within 1e-4 of ``jax.grad``'s."""
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
            parts = name.split(".")
            leaf = jgrads[parts[0]]
            for key in parts[2:]:
                leaf = leaf[key]
            want = np.asarray(leaf if parts[0] != "blocks"
                              else leaf[int(parts[1])])
            np.testing.assert_allclose(
                p.grad.numpy(), want, rtol=0,
                atol=1e-4 * float(np.abs(want).max()), err_msg=name)
    finally:
        model.zero_grad(set_to_none=True)
    return float(loss.detach())


# ================================================================ codebooks
def test_codebooks_forward_and_loss_match(audio):
    jcfg, tcfg, jparams, model = audio
    assert tuple(model.embed.shape) == (4, tcfg.vocab_size, tcfg.d_model)
    assert tuple(model.lm_head.shape) == (4, tcfg.d_model, tcfg.vocab_size)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, tcfg.vocab_size, (2, 24, 4), dtype=np.int32)
    labels = rng.integers(0, tcfg.vocab_size, (2, 24, 4), dtype=np.int32)
    labels[0, :5, 1] = -100
    j_logits, _, _ = _j_forward(jcfg, jparams, {"tokens": jnp.asarray(tokens)})
    j_loss = JT.lm_loss(jcfg, j_logits, jnp.asarray(labels))
    with torch.inference_mode():
        t_logits, _, _ = model({"tokens": torch.from_numpy(tokens).long()})
        t_loss = T.lm_loss(tcfg, t_logits, torch.from_numpy(labels))
    assert tuple(t_logits.shape) == (2, 24, 4, tcfg.vocab_size)
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(t_loss), float(j_loss), rtol=1e-4,
                               atol=1e-4)


def test_codebooks_step0_gradients_match(audio):
    jcfg, tcfg, jparams, model = audio
    batch = pipeline.make_batch(tcfg, ShapeCell("t", "train", 32, 2), 0)
    assert batch["tokens"].shape == (2, 32, 4)
    _jax_grads_match(jcfg, tcfg, jparams, model, batch)


def _jax_greedy_rows(jcfg, jparams, prompt, max_new):
    """A JAX ``decode_step`` loop over [Lp, 4] prompt rows: the greedy
    row of argmaxes after the last prompt row."""
    cache = JT.init_cache(jcfg, 1, 32)
    out, pos = [], 0
    for row in list(prompt) + [None] * max_new:
        if row is None:
            row = np.asarray(logits)[0].argmax(-1).astype(np.int32)
            out.append(row)
            if len(out) == max_new:
                break
        logits, cache = _j_decode(jcfg, jparams, cache,
                                  jnp.asarray(np.asarray(row)[None],
                                              jnp.int32),
                                  jnp.asarray(pos, jnp.int32))
        pos += 1
    return out


def test_codebooks_decode_matches(audio):
    """Prefill of [2, 12, 4], then greedy [2, 4] decode rows: logits
    within 1e-4 each step, rows identical."""
    jcfg, tcfg, jparams, model = audio
    prompt = np.random.default_rng(1).integers(0, tcfg.vocab_size,
                                               (2, 12, 4), dtype=np.int32)
    j_logits, j_cache = _j_prefill(jcfg, jparams,
                                   {"tokens": jnp.asarray(prompt)}, 32)
    with torch.inference_mode():
        t_logits, t_cache = T.prefill(
            tcfg, model, {"tokens": torch.from_numpy(prompt).long()}, 32)
        tok_j = np.asarray(j_logits)[:, -1].argmax(-1)
        tok_t = t_logits[:, -1].argmax(-1)
        for pos in range(12, 18):
            np.testing.assert_array_equal(tok_t.numpy(), tok_j)
            assert tuple(tok_t.shape) == (2, 4)
            j_step, j_cache = _j_decode(jcfg, jparams, j_cache,
                                        jnp.asarray(tok_j, jnp.int32),
                                        jnp.asarray(pos, jnp.int32))
            t_step, t_cache = T.decode_step(tcfg, model, t_cache, tok_t, pos)
            np.testing.assert_allclose(t_step.numpy(), np.asarray(j_step),
                                       rtol=1e-4, atol=1e-4,
                                       err_msg=f"pos {pos}")
            tok_j, tok_t = np.asarray(j_step).argmax(-1), t_step.argmax(-1)


@pytest.mark.parametrize("n_slots", [1, 3])
def test_codebooks_engine_streams_match_a_jax_decode_loop(audio, n_slots):
    """[5, 4] prompts through the port's engine: each request's stream of
    int32 codebook rows equals a JAX ``decode_step`` loop's; two requests
    at diverged positions too."""
    jcfg, tcfg, jparams, model = audio
    rng = np.random.default_rng(2)
    prompts = {0: rng.integers(0, tcfg.vocab_size, (5, 4), dtype=np.int32),
               1: rng.integers(0, tcfg.vocab_size, (3, 4), dtype=np.int32)}
    eng = ServeEngine(tcfg, model, n_slots=n_slots, cache_len=32,
                      device="cpu")
    got = {}
    for rid, row in eng.generate([Request(r, p, max_new_tokens=3)
                                  for r, p in prompts.items()]):
        got.setdefault(rid, []).append(row)
    for rid, prompt in prompts.items():
        want = _jax_greedy_rows(jcfg, jparams, prompt, 3)
        assert all(r.dtype == np.int32 and r.shape == (4,)
                   for r in got[rid])
        np.testing.assert_array_equal(np.stack(got[rid]), np.stack(want))


def test_codebooks_sampled_rows_are_drawn_per_codebook(audio):
    _, tcfg, _, model = audio
    eng = ServeEngine(tcfg, model, n_slots=2, cache_len=32, device="cpu",
                      seed=3)
    prompt = np.zeros((4, 4), np.int32)
    rows = [r for _, r in eng.generate([Request(0, prompt, 4,
                                                temperature=1.0)])]
    assert len(rows) == 4 and all(r.shape == (4,) for r in rows)
    assert all(0 <= int(t) < tcfg.vocab_size for r in rows for t in r)


def test_codebooks_bf16_embedding_is_bit_equal_to_jax():
    """The bf16 codebook sum, in order 0..3 in bf16, against the JAX
    package's ``_embed`` (its Python ``sum``, op by op)."""
    jcfg, tcfg, jparams, model = _pair(AUDIO, dtype="bfloat16")
    tokens = np.random.default_rng(4).integers(0, tcfg.vocab_size,
                                               (2, 9, 4), dtype=np.int32)
    want = JT._embed(jcfg, jparams, {"tokens": jnp.asarray(tokens)})
    with torch.inference_mode():
        got = T._embed(tcfg, model, {"tokens": torch.from_numpy(tokens)
                                     .long()})
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


def test_serve_cli_streams_codebook_rows(capsys):
    assert serve_cli.main(["--arch", AUDIO, "--device", "cpu", "--requests",
                           "3", "--slots", "2", "--prompt-len", "3",
                           "--new-tokens", "2", "--cache-len", "16"]) == 0
    out = capsys.readouterr().out
    assert "3/3 requests, 6 new tokens" in out
    assert "first-tokens=[[" in out


# =========================================================== tokens+patches
def _vlm_inputs(tcfg, B, Lt, seed):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, tcfg.vocab_size, (B, Lt), dtype=np.int32)
    patches = rng.standard_normal((B, tcfg.patch_tokens, tcfg.d_model)
                                  ).astype(np.float32)
    return tokens, patches


def test_patches_forward_matches(vlm):
    """Logits over 8 patch + 16 text positions within 1e-4 of JAX's."""
    jcfg, tcfg, jparams, model = vlm
    tokens, patches = _vlm_inputs(tcfg, 2, 16, 5)
    j_logits, _, _ = _j_forward(jcfg, jparams, {
        "tokens": jnp.asarray(tokens), "patch_embeds": jnp.asarray(patches)})
    with torch.inference_mode():
        t_logits, _, _ = model({"tokens": torch.from_numpy(tokens).long(),
                                "patch_embeds": torch.from_numpy(patches)})
    assert tuple(t_logits.shape) == (2, 8 + 16, tcfg.vocab_size)
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits),
                               rtol=1e-4, atol=1e-4)


def test_patches_loss_is_over_text_only(vlm):
    """``train_loss`` and its gradients against JAX's; the loss equals
    ``lm_loss`` over the text positions' logits alone."""
    jcfg, tcfg, jparams, model = vlm
    batch = pipeline.make_batch(tcfg, ShapeCell("t", "train", 32, 2), 0)
    assert batch["tokens"].shape == (2, 32 - 8)
    assert batch["patch_embeds"].shape == (2, 8, tcfg.d_model)
    loss = _jax_grads_match(jcfg, tcfg, jparams, model, batch)
    tb = loop.batch_to_device(batch, "cpu")
    assert tb["patch_embeds"].dtype == torch.float32
    with torch.inference_mode():
        logits, _, _ = model(tb)
        text = T.lm_loss(tcfg, logits[:, 8:], tb["labels"])
    assert float(text) == loss


def test_patches_prefill_then_decode_matches(vlm):
    """A prefill of 8 patches + 12 tokens (the patches passed through),
    then 6 greedy decode steps from position 20: logits within 1e-4,
    tokens identical."""
    jcfg, tcfg, jparams, model = vlm
    tokens, patches = _vlm_inputs(tcfg, 2, 12, 6)
    j_logits, j_cache = _j_prefill(jcfg, jparams, {
        "tokens": jnp.asarray(tokens),
        "patch_embeds": jnp.asarray(patches)}, 40)
    with torch.inference_mode():
        t_logits, t_cache = T.prefill(tcfg, model, {
            "tokens": torch.from_numpy(tokens).long(),
            "patch_embeds": torch.from_numpy(patches)}, 40)
        np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits),
                                   rtol=1e-4, atol=1e-4)
        tok_j = np.asarray(j_logits)[:, -1].argmax(-1)
        tok_t = t_logits[:, -1].argmax(-1)
        for pos in range(20, 26):
            np.testing.assert_array_equal(tok_t.numpy(), tok_j)
            j_step, j_cache = _j_decode(jcfg, jparams, j_cache,
                                        jnp.asarray(tok_j, jnp.int32),
                                        jnp.asarray(pos, jnp.int32))
            t_step, t_cache = T.decode_step(tcfg, model, t_cache, tok_t, pos)
            np.testing.assert_allclose(t_step.numpy(), np.asarray(j_step),
                                       rtol=1e-4, atol=1e-4,
                                       err_msg=f"pos {pos}")
            tok_j, tok_t = np.asarray(j_step).argmax(-1), t_step.argmax(-1)
    for name in ("k", "v"):
        np.testing.assert_allclose(t_cache[name].numpy(),
                                   np.asarray(j_cache[name]), rtol=1e-4,
                                   atol=1e-4)


# ============================================================== input specs
@pytest.mark.parametrize("arch", [AUDIO, VLM, "musicgen-medium",
                                  "pixtral-12b"])
@pytest.mark.parametrize("kind,seq,batch", [("train", 2048, 2),
                                            ("prefill", 2048, 2),
                                            ("decode", 96, 3)])
def test_input_specs_equal_jax(arch, kind, seq, batch):
    got = st.input_specs(get_config(arch), ShapeCell("c", kind, seq, batch))
    want = jst.input_specs(jax_get_config(arch),
                           JaxShapeCell("c", kind, seq, batch))
    assert set(got) == set(want)
    for k, v in got.items():
        assert tuple(v.shape) == tuple(want[k].shape), k
        assert v.device.type == "meta"
        if k == "patch_embeds":
            assert str(want[k].dtype) == "bfloat16" and \
                v.dtype == torch.bfloat16
        else:
            assert str(want[k].dtype) == "int32" and v.dtype == torch.int64

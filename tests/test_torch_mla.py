"""The port's Multi-head Latent Attention (``models.layers.mla_attention``)
against the JAX package's, on numpy-seeded float32 weights and inputs at the
``:smoke`` size of both DeepSeek-V2 archs: ``deepseek-v2-lite-16b`` (q
through ``wq``) and ``deepseek-v2-236b`` (q through the ``q_lora`` pair).

Train (no cache), prefill (the latent ring written at slots 0..) and decode
(the absorbed form against the ring, ``pos % S``) agree within 1e-5 in their
outputs and in the ``ckv``/``krope`` cache leaves.  The port writes the
cache in place; with a ``slot_mask`` only the selected rows change, and they
equal the JAX step's (the engine's ``_merge_cache``).  The per-head q/k
width (nope + rope = 48 here, 192 at full width) differs from the value
width (32; 128), which ``_sdpa`` must carry through.
"""
# ruff: noqa: E402
import pytest

pytest.importorskip("torch")

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jax_get_config
from repro.models import layers as JL
from repro_torch.configs import get_config
from repro_torch.models import layers as L

TOL = dict(rtol=1e-5, atol=1e-5)
ARCHS = ["deepseek-v2-lite-16b:smoke", "deepseek-v2-236b:smoke"]
B, SC = 3, 24
# one compile a shape instead of one a primitive
_j_mla = jax.jit(JL.mla_attention, static_argnums=0)


@pytest.fixture(scope="module", params=ARCHS)
def mla(request):
    """(jcfg, tcfg, JAX params, port module) on the same float32 weights."""
    jcfg = dataclasses.replace(jax_get_config(request.param), dtype="float32")
    tcfg = dataclasses.replace(get_config(request.param), dtype="float32")
    jp = JL.init_mla(jcfg, jax.random.PRNGKey(3), jnp.float32)
    # non-zero norm scales so that q_norm/kv_norm are exercised
    rng = np.random.default_rng(0)
    jp = {k: (jnp.asarray(rng.standard_normal(v.shape).astype(np.float32)
                          * 0.1) if k.endswith("norm") else v)
          for k, v in jp.items()}
    mod = L.init_mla(tcfg, None, torch.float32, device="cpu")
    assert set(dict(mod.named_parameters())) == set(jp)
    with torch.no_grad():
        for k, v in jp.items():
            getattr(mod, k).copy_(torch.from_numpy(np.asarray(v)))
    return jcfg, tcfg, jp, mod


def _x(cfg, L_, seed):
    return np.random.default_rng(seed).standard_normal(
        (B, L_, cfg.d_model)).astype(np.float32)


def test_q_lora_is_taken_where_the_config_sets_it(mla):
    jcfg, tcfg, jp, mod = mla
    assert ("wq_a" in jp) == bool(tcfg.q_lora_rank) == hasattr(mod, "wq_b")
    assert tcfg.nope_head_dim + tcfg.rope_head_dim != tcfg.v_head_dim


@pytest.mark.parametrize("L_", [1, 7, 20])
def test_train_matches_jax(mla, L_):
    jcfg, tcfg, jp, mod = mla
    x = _x(tcfg, L_, 1)
    want, jc = _j_mla(jcfg, jp, jnp.asarray(x))
    with torch.no_grad():
        got, tc = L.mla_attention(tcfg, mod, torch.from_numpy(x))
    assert jc is None and tc is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _jax_cache(cfg):
    return JL.init_mla_cache(cfg, B, SC, jnp.float32)


def _port_cache(cfg):
    return L.init_mla_cache(cfg, B, SC, torch.float32, device="cpu")


def _same_cache(tc, jc):
    assert set(tc) == set(jc) == {"ckv", "krope"}
    for k in tc:
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]), **TOL,
                                   err_msg=k)


@pytest.mark.parametrize("L_", [5, SC])
def test_prefill_then_decode_matches_jax(mla, L_):
    """Prefill ``L_ <= S`` tokens, then decode 6 steps (the ring wraps
    when ``L_ == S``): outputs and both cache leaves within 1e-5."""
    jcfg, tcfg, jp, mod = mla
    x = _x(tcfg, L_ + 6, 2)
    jc, tc = _jax_cache(jcfg), _port_cache(tcfg)
    want, jc = _j_mla(jcfg, jp, jnp.asarray(x[:, :L_]), cache=jc,
                      pos=jnp.asarray(0, jnp.int32))
    with torch.no_grad():
        got, tc2 = L.mla_attention(tcfg, mod, torch.from_numpy(x[:, :L_]),
                                   cache=tc, pos=0)
    assert tc2 is tc                              # written in place
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    _same_cache(tc, jc)
    for pos in range(L_, L_ + 6):
        xt = x[:, pos:pos + 1]
        want, jc = _j_mla(jcfg, jp, jnp.asarray(xt), cache=jc,
                          pos=jnp.asarray(pos, jnp.int32))
        with torch.no_grad():
            got, _ = L.mla_attention(tcfg, mod, torch.from_numpy(xt),
                                     cache=tc, pos=pos)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL,
                                   err_msg=f"pos {pos}")
        _same_cache(tc, jc)


def test_decode_from_an_empty_ring_equals_the_train_path(mla):
    """Token-by-token absorbed decode from pos 0 gives the train path's
    outputs (causal attention over the materialised K/V)."""
    _, tcfg, _, mod = mla
    x = torch.from_numpy(_x(tcfg, 9, 3))
    tc = _port_cache(tcfg)
    with torch.no_grad():
        full, _ = L.mla_attention(tcfg, mod, x)
        steps = [L.mla_attention(tcfg, mod, x[:, p:p + 1], cache=tc,
                                 pos=p)[0] for p in range(9)]
    torch.testing.assert_close(torch.cat(steps, dim=1), full, **TOL)


def test_slot_mask_writes_only_the_selected_rows(mla):
    jcfg, tcfg, jp, mod = mla
    x = _x(tcfg, 5, 4)
    jc, tc = _jax_cache(jcfg), _port_cache(tcfg)
    _, jc = _j_mla(jcfg, jp, jnp.asarray(x[:, :4]), cache=jc,
                   pos=jnp.asarray(0, jnp.int32))
    with torch.no_grad():
        L.mla_attention(tcfg, mod, torch.from_numpy(x[:, :4]), cache=tc,
                        pos=0)
        before = {k: v.clone() for k, v in tc.items()}
        mask = torch.tensor([True, False, True])
        got, _ = L.mla_attention(tcfg, mod, torch.from_numpy(x[:, 4:]),
                                 cache=tc, pos=4, slot_mask=mask)
    want, jnew = _j_mla(jcfg, jp, jnp.asarray(x[:, 4:]), cache=jc,
                        pos=jnp.asarray(4, jnp.int32))
    for k in tc:
        np.testing.assert_array_equal(tc[k][1].numpy(), before[k][1].numpy())
        np.testing.assert_allclose(tc[k][mask].numpy(),
                                   np.asarray(jnew[k])[mask.numpy()], **TOL)
    # the selected rows' outputs are the JAX step's
    np.testing.assert_allclose(got[mask].numpy(),
                               np.asarray(want)[mask.numpy()], **TOL)


def test_prefill_past_the_ring_keeps_the_reference_layout(mla):
    """A prefill longer than the ring (L = 30 > S = 24, L % S != 0) writes
    the last S latents at slots 0.., a layout the decode's ``k_pos``
    formula reads as other positions (ROADMAP C7).  The port keeps the
    reference's layout: its next decode step equals JAX's within 1e-5."""
    jcfg, tcfg, jp, mod = mla
    x = _x(tcfg, 31, 8)
    jc, tc = _jax_cache(jcfg), _port_cache(tcfg)
    _, jc = _j_mla(jcfg, jp, jnp.asarray(x[:, :30]), cache=jc,
                   pos=jnp.asarray(0, jnp.int32))
    want, jc = _j_mla(jcfg, jp, jnp.asarray(x[:, 30:]), cache=jc,
                      pos=jnp.asarray(30, jnp.int32))
    with torch.no_grad():
        L.mla_attention(tcfg, mod, torch.from_numpy(x[:, :30]), cache=tc,
                        pos=0)
        got, _ = L.mla_attention(tcfg, mod, torch.from_numpy(x[:, 30:]),
                                 cache=tc, pos=30)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    _same_cache(tc, jc)

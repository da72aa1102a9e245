"""The port's Mamba2 SSD block (``models.ssm``) against the JAX package's, on
numpy-seeded float32 inputs at the ``mamba2-1.3b:smoke`` size (d_inner 256,
16 heads of 16, state 16, chunk 32).

``_causal_conv``, ``_segsum``, the chunked ``ssd_scan`` (output and final
state, one chunk and several) and ``ssd_decode_step`` agree within 1e-5; so
does ``ssd_block`` in training, in a prefill (its conv window and state) and
in decode steps after it.  Inside the port, a prefill followed by decode
steps gives the outputs of one prefill over the whole sequence, and a
``slot_mask`` leaves the other rows' conv window and state untouched.
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
from repro.models import ssm as JS
from repro_torch.configs import get_config
from repro_torch.models import ssm as S

TOL = dict(rtol=1e-5, atol=1e-5)
ARCH = "mamba2-1.3b:smoke"
B = 2
# one compile a shape instead of one a primitive
_j_block = jax.jit(JS.ssd_block, static_argnums=0)
_j_scan = jax.jit(JS.ssd_scan, static_argnums=6)


@pytest.fixture(scope="module")
def ssd():
    jcfg = dataclasses.replace(jax_get_config(ARCH), dtype="float32")
    tcfg = dataclasses.replace(get_config(ARCH), dtype="float32")
    jp = JS.init_ssd(jcfg, jax.random.PRNGKey(7), jnp.float32)
    # non-trivial A, D, dt bias, norm and conv bias
    rng = np.random.default_rng(0)
    for k in ("A_log", "dt_bias", "norm", "conv_b"):
        jp[k] = jnp.asarray(rng.standard_normal(jp[k].shape)
                            .astype(np.float32) * 0.5)
    jp["D"] = jnp.asarray(rng.uniform(0.5, 1.5, jp["D"].shape)
                          .astype(np.float32))
    mod = S.init_ssd(tcfg, None, torch.float32, device="cpu")
    assert set(dict(mod.named_parameters())) == set(jp)
    with torch.no_grad():
        for k, v in jp.items():
            getattr(mod, k).copy_(torch.from_numpy(np.array(v)))
    return jcfg, tcfg, jp, mod


def _np(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def test_causal_conv_and_segsum_match_jax():
    rng = np.random.default_rng(1)
    x, w, b = _np(rng, 2, 9, 12), _np(rng, 4, 12), _np(rng, 12)
    np.testing.assert_allclose(
        S._causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                       torch.from_numpy(b)).numpy(),
        np.asarray(JS._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                   jnp.asarray(b))), **TOL)
    lv = -np.abs(_np(rng, 2, 3, 8))
    got = S._segsum(torch.from_numpy(lv)).numpy()
    want = np.asarray(JS._segsum(jnp.asarray(lv)))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], **TOL)


def _scan_inputs(seed, L_, H=8, P=4, G=2, N=6):
    rng = np.random.default_rng(seed)
    x = _np(rng, B, L_, H, P)
    dt = np.log1p(np.exp(_np(rng, B, L_, H)))          # softplus > 0
    A = -np.exp(_np(rng, H) * 0.5)
    return (x, dt.astype(np.float32), A.astype(np.float32),
            _np(rng, B, L_, G, N), _np(rng, B, L_, G, N), _np(rng, H))


@pytest.mark.parametrize("L_,chunk", [(16, 16), (48, 16), (40, 8)])
def test_ssd_scan_matches_jax(L_, chunk):
    args = _scan_inputs(L_, L_)
    jy, jh = _j_scan(*map(jnp.asarray, args), chunk)
    ty, th = S.ssd_scan(*map(torch.from_numpy, args), chunk)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        S.ssd_scan(*map(torch.from_numpy, args), chunk + 1)


def test_ssd_decode_step_matches_jax_and_the_scan():
    """A decode step from the scan's state of L tokens gives what a scan of
    L + 1 tokens gives at the last position (and JAX's step)."""
    x, dt, A, Bm, Cm, D = _scan_inputs(5, 17)
    state = np.random.default_rng(2).standard_normal(
        (B, 8, 4, 6)).astype(np.float32)
    one = [a[:, 0] for a in (x, dt, Bm, Cm)]
    jy, js = JS.ssd_decode_step(*map(jnp.asarray, (one[0], one[1], A, one[2],
                                                   one[3], D, state)))
    ty, ts = S.ssd_decode_step(*map(torch.from_numpy, (one[0], one[1], A,
                                                       one[2], one[3], D,
                                                       state)))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **TOL)
    t = [torch.from_numpy(a) for a in (x, dt, A, Bm, Cm, D)]
    _, h16 = S.ssd_scan(t[0][:, :16], t[1][:, :16], t[2], t[3][:, :16],
                        t[4][:, :16], t[5], 16)
    y17, h17 = S.ssd_scan(*t, 17)
    yd, hd = S.ssd_decode_step(t[0][:, 16], t[1][:, 16], t[2], t[3][:, 16],
                               t[4][:, 16], t[5], h16)
    torch.testing.assert_close(yd, y17[:, 16], **TOL)
    torch.testing.assert_close(hd, h17, **TOL)


def _x(cfg, L_, seed):
    return np.random.default_rng(seed).standard_normal(
        (B, L_, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("L_", [1, 32, 96])
def test_ssd_block_train_matches_jax(ssd, L_):
    jcfg, tcfg, jp, mod = ssd
    x = _x(tcfg, L_, 3)
    want, jc = _j_block(jcfg, jp, jnp.asarray(x))
    with torch.no_grad():
        got, tc = S.ssd_block(tcfg, mod, torch.from_numpy(x))
    assert jc is None and tc is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _caches(jcfg, tcfg):
    return (JS.init_ssd_cache(jcfg, B, jnp.float32),
            S.init_ssd_cache(tcfg, B, torch.float32, device="cpu"))


def _same_cache(tc, jc):
    assert set(tc) == set(jc) == {"conv", "state"}
    for k in tc:
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]), **TOL,
                                   err_msg=k)


@pytest.mark.parametrize("L_", [3, 64])
def test_ssd_block_prefill_then_decode_matches_jax(ssd, L_):
    jcfg, tcfg, jp, mod = ssd
    x = _x(tcfg, L_ + 5, 4)
    jc, tc = _caches(jcfg, tcfg)
    want, jc = _j_block(jcfg, jp, jnp.asarray(x[:, :L_]), cache=jc,
                        pos=jnp.asarray(0, jnp.int32))
    with torch.no_grad():
        got, tc2 = S.ssd_block(tcfg, mod, torch.from_numpy(x[:, :L_]),
                               cache=tc, pos=0)
    assert tc2 is tc                                  # written in place
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    _same_cache(tc, jc)
    for pos in range(L_, L_ + 5):
        xt = x[:, pos:pos + 1]
        want, jc = _j_block(jcfg, jp, jnp.asarray(xt), cache=jc,
                            pos=jnp.asarray(pos, jnp.int32))
        with torch.no_grad():
            got, _ = S.ssd_block(tcfg, mod, torch.from_numpy(xt), cache=tc,
                                 pos=pos)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL,
                                   err_msg=f"pos {pos}")
        _same_cache(tc, jc)


def test_prefill_then_decode_equals_prefill_alone(ssd):
    """Prefill 32 tokens and decode 32 more: the decode outputs, and the
    final conv window and state, are those of one 64-token prefill (two
    chunks)."""
    _, tcfg, _, mod = ssd
    x = torch.from_numpy(_x(tcfg, 64, 5))
    whole = S.init_ssd_cache(tcfg, B, torch.float32, device="cpu")
    part = S.init_ssd_cache(tcfg, B, torch.float32, device="cpu")
    with torch.no_grad():
        full, _ = S.ssd_block(tcfg, mod, x, cache=whole, pos=0)
        S.ssd_block(tcfg, mod, x[:, :32], cache=part, pos=0)
        steps = [S.ssd_block(tcfg, mod, x[:, p:p + 1], cache=part,
                             pos=p)[0] for p in range(32, 64)]
    torch.testing.assert_close(torch.cat(steps, dim=1), full[:, 32:], **TOL)
    for k in whole:
        torch.testing.assert_close(part[k], whole[k], **TOL)


def test_slot_mask_keeps_the_other_rows(ssd):
    _, tcfg, _, mod = ssd
    x = torch.from_numpy(_x(tcfg, 33, 6))
    tc = S.init_ssd_cache(tcfg, B, torch.float32, device="cpu")
    solo = S.init_ssd_cache(tcfg, B, torch.float32, device="cpu")
    with torch.no_grad():
        S.ssd_block(tcfg, mod, x[:, :32], cache=tc, pos=0)
        S.ssd_block(tcfg, mod, x[:, :32], cache=solo, pos=0)
        before = {k: v.clone() for k, v in tc.items()}
        mask = torch.tensor([False, True])
        S.ssd_block(tcfg, mod, x[:, 32:], cache=tc, pos=32, slot_mask=mask)
        S.ssd_block(tcfg, mod, x[:, 32:], cache=solo, pos=32)
    for k in tc:
        assert torch.equal(tc[k][0], before[k][0]), k
        assert torch.equal(tc[k][1], solo[k][1]), k

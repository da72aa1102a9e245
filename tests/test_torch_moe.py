"""The port's MoE FFN (``models.moe``) against the JAX package's, on
numpy-seeded float32 weights and inputs at the ``:smoke`` sizes of both
DeepSeek-V2 archs (4 experts, top-2, 1 shared expert).

Host data must be exactly equal: the router's top-k indices (``_route``)
and each row's slot positions (``_dispatch_row``, a stable sort), and the
slot tables (token and gate weight of every (expert, capacity) cell) built
from them.  Outputs and the load-balance loss agree within 1e-5 in both
dispatch arms (``gather`` and ``einsum``), also where a row is at capacity
and (token, slot)s drop.  The port's combine is a per-token gather summed
in slot order, so it repeats bit for bit.
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
from repro.models import moe as JM
from repro_torch.configs import get_config
from repro_torch.models import moe as M

TOL = dict(rtol=1e-5, atol=1e-5)
ARCHS = ["deepseek-v2-lite-16b:smoke", "deepseek-v2-236b:smoke"]
# one compile a shape instead of one a primitive
_j_moe = jax.jit(JM.moe_ffn, static_argnums=0, static_argnames="dispatch")
_j_route = jax.jit(JM._route, static_argnums=0)
_j_dispatch = jax.jit(jax.vmap(JM._dispatch_row))


def _put(mod, tree):
    with torch.no_grad():
        for k, v in tree.items():
            if isinstance(v, dict):
                _put(getattr(mod, k), v)
            else:
                getattr(mod, k).copy_(torch.from_numpy(np.array(v)))


@pytest.fixture(scope="module", params=ARCHS)
def moe(request):
    jcfg = dataclasses.replace(jax_get_config(request.param), dtype="float32")
    tcfg = dataclasses.replace(get_config(request.param), dtype="float32")
    jp = JM.init_moe(jcfg, jax.random.PRNGKey(5), jnp.float32)
    mod = M.init_moe(tcfg, None, torch.float32, device="cpu")
    assert set(dict(mod.named_parameters())) == {
        ".".join(p.key for p in path) for path, _ in
        jax.tree_util.tree_flatten_with_path(jp)[0]}
    _put(mod, jp)
    return jcfg, tcfg, jp, mod


def _x(cfg, L_, seed, B=3):
    return np.random.default_rng(seed).standard_normal(
        (B, L_, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("L_", [1, 16])
def test_route_indices_exactly_equal(moe, L_):
    jcfg, tcfg, jp, mod = moe
    x = _x(tcfg, L_, 1)
    jv, ji, ja = _j_route(jcfg, jp, jnp.asarray(x))
    with torch.no_grad():
        tv, ti, ta = M._route(tcfg, mod, torch.from_numpy(x))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)
    np.testing.assert_allclose(float(ta), float(ja), **TOL)


@pytest.mark.parametrize("e,Lk", [(4, 1), (4, 32), (64, 96), (160, 6)])
def test_dispatch_row_exactly_equal(e, Lk):
    """Each row's positions in its experts' queues, batched and one row at
    a time, with many collisions (few experts) and few (many)."""
    e_flat = np.random.default_rng(Lk).integers(0, e, (5, Lk))
    want = np.asarray(_j_dispatch(jnp.asarray(e_flat, jnp.int32)))
    got = M._dispatch_row(torch.from_numpy(e_flat))
    np.testing.assert_array_equal(got.numpy(), want)
    for r in range(5):
        np.testing.assert_array_equal(
            M._dispatch_row(torch.from_numpy(e_flat[r])).numpy(), want[r])


def _jax_slot_tables(cfg, gv, gi, C):
    """The JAX ``_moe_gather``'s scatter of token and gate into the [E, C]
    tables, replayed in numpy from its ``_dispatch_row`` positions."""
    B, Lq, k = gi.shape
    e = cfg.n_experts
    pos = np.asarray(_j_dispatch(jnp.asarray(gi.reshape(B, Lq * k),
                                             jnp.int32)))
    st = np.full((B, e, C), Lq)
    sw = np.zeros((B, e, C), np.float32)
    tok = np.repeat(np.arange(Lq), k)
    for b in range(B):
        for j, (ex, p) in enumerate(zip(gi[b].reshape(-1), pos[b])):
            if p < C:
                st[b, ex, p] = tok[j]
                sw[b, ex, p] = gv[b].reshape(-1)[j]
    return st, sw, pos < C


@pytest.mark.parametrize("cf", [1.25, 0.3, 8.0])
def test_slot_tables_exactly_equal(moe, cf):
    jcfg, tcfg, _, mod = moe
    x = _x(tcfg, 24, 2)
    with torch.no_grad():
        gv, gi, _ = M._route(tcfg, mod, torch.from_numpy(x))
    C = int(cf * 24 * tcfg.moe_top_k / tcfg.n_experts) + 1
    st, sw, cell = M._slot_tables(tcfg, gv, gi, C)
    keep = cell < tcfg.n_experts * C
    w_st, w_sw, w_keep = _jax_slot_tables(jcfg, gv.numpy(), gi.numpy(), C)
    np.testing.assert_array_equal(st.numpy(), w_st)
    np.testing.assert_array_equal(sw.numpy(), w_sw)
    np.testing.assert_array_equal(keep.numpy(), w_keep)
    if cf == 0.3:
        assert not keep.all()                  # rows at capacity drop
    if cf == 8.0:
        assert keep.all()                      # C >= L * k: nothing drops
    e_flat = gi.reshape(3, -1)
    np.testing.assert_array_equal(
        cell.numpy(), np.where(w_keep, e_flat * C + (
            M._dispatch_row(e_flat)).numpy(), tcfg.n_experts * C))


@pytest.mark.parametrize("dispatch", ["gather", "einsum"])
@pytest.mark.parametrize("cf,L_", [(1.25, 1), (1.25, 16), (0.3, 16)])
def test_moe_ffn_matches_jax(moe, dispatch, cf, L_):
    """Both arms, with and without drops (``cf=0.3``: rows at capacity)."""
    jcfg, tcfg, jp, mod = moe
    jcfg = dataclasses.replace(jcfg, capacity_factor=cf)
    tcfg = dataclasses.replace(tcfg, capacity_factor=cf)
    x = _x(tcfg, L_, 3)
    want, jaux = _j_moe(jcfg, jp, jnp.asarray(x), dispatch=dispatch)
    with torch.no_grad():
        got, taux = M.moe_ffn(tcfg, mod, torch.from_numpy(x),
                              dispatch=dispatch)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(taux), float(jaux), **TOL)


def test_arms_agree_and_gather_repeats_bitwise(moe):
    _, tcfg, _, mod = moe
    x = torch.from_numpy(_x(tcfg, 16, 4))
    tcfg = dataclasses.replace(tcfg, capacity_factor=0.3)
    with torch.no_grad():
        a, aux_a = M.moe_ffn(tcfg, mod, x, dispatch="gather")
        b, aux_b = M.moe_ffn(tcfg, mod, x, dispatch="einsum")
        again, _ = M.moe_ffn(tcfg, mod, x, dispatch="gather")
    torch.testing.assert_close(a, b, **TOL)
    assert float(aux_a) == float(aux_b)
    assert torch.equal(a, again)


def test_rows_are_independent(moe):
    """Capacity is per batch row: a row's output does not depend on the
    other rows (a serving slot's routing never sees another slot's)."""
    _, tcfg, _, mod = moe
    tcfg = dataclasses.replace(tcfg, capacity_factor=0.3)
    x = torch.from_numpy(_x(tcfg, 16, 5))
    with torch.no_grad():
        full, _ = M.moe_ffn(tcfg, mod, x)
        for r in range(3):
            one, _ = M.moe_ffn(tcfg, mod, x[r:r + 1])
            torch.testing.assert_close(one[0], full[r], rtol=0, atol=1e-6)

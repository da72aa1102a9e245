"""The port's paged block-sparse KV decode against the JAX package's.

Host data (page demand, placement, the paged-decode decision, page tables,
``PagedKVCache.report()``, scheduler traces) must be exactly equal.  The
paged attention itself, float32 on the CPU: the port's ``_paged_decode``
within 1e-5 (rtol and atol) of JAX's, and bit-equal to its own run over the
FULL page table (the pin the JAX package holds inside itself, re-established
inside the port).  Served token streams must be identical.

The JAX ``_paged_decode`` and engine step are monitored by ``jaxmon``,
which calls ``jax.core.trace_state_clean()``: JAX 0.9.0 removed it (ROADMAP
fault C1).  The ``jax_oracle`` fixture points ``jaxmon._trace_active`` at
``jax._src.core.trace_state_clean()`` for the test's duration; no file of
the JAX package changes."""
# ruff: noqa: E402
import pytest

pytest.importorskip("torch")

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jax_get_config
from repro.models import attention as JA
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.obs import jaxmon
from repro.serve import engine as jengine
from repro.serve import paged_kv as jpk
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.launch import serve as serve_cli
from repro_torch.models import attention as A
from repro_torch.models import layers as TL
from repro_torch.models import transformer as T
from repro_torch.obs import shapemon
from repro_torch.serve import engine as tengine
from repro_torch.serve import paged_kv as tpk

ARCH = "smat-attn-1.3b"
SMOKE = ARCH + ":smoke"
MASKS = {
    "banded": (JA.banded(24), A.banded(24)),
    "local_global": (JA.local_global(16, 8), A.local_global(16, 8)),
    "blockwise_causal": (JA.blockwise_causal(), A.blockwise_causal()),
}
# the JAX package's cost-model constants, passed explicitly to compare
JAX_BW = dict(hbm_gbps=819.0, host_gbps=32.0)


@pytest.fixture
def jax_oracle(monkeypatch):
    """Unlock the monitored JAX functions (ROADMAP C1), test-side only."""
    monkeypatch.setattr(jaxmon, "_trace_active",
                        lambda: not jax._src.core.trace_state_clean())


def _cfgs(paged="auto", mask=None, dtype="float32"):
    """(jax cfg, port cfg) of smat-attn-1.3b:smoke with the paged-decode
    mode, optionally another mask, in ``dtype``."""
    out = []
    for get, m in ((jax_get_config, None if mask is None else mask[0]),
                   (get_config, None if mask is None else mask[1])):
        cfg = get(SMOKE)
        kw = {"paged_decode": paged}
        if m is not None:
            kw["mask"] = m
        out.append(dataclasses.replace(cfg, dtype=dtype, attn_sparsity=(
            dataclasses.replace(cfg.attn_sparsity, **kw))))
    return tuple(out)


# ============================================================ host pipeline
@pytest.mark.parametrize("mask", list(MASKS))
@pytest.mark.parametrize("seq_len,block", [(64, (16, 16)), (96, (16, 32)),
                                           (128, (32, 16))])
def test_page_demand_and_placement_equal_jax(mask, seq_len, block):
    jm, tm = MASKS[mask]
    want = jpk.page_demand(jm, seq_len, block)
    got = tpk.page_demand(tm, seq_len, block)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype
    n_pages = seq_len // block[1]
    for policy, budget in (("greedy", None), ("greedy", 0), ("greedy", 1),
                           ("greedy", n_pages // 2), ("greedy", n_pages + 3),
                           ("all_device", 1)):
        np.testing.assert_array_equal(
            tpk.page_placement(tm, seq_len, block, tpk.PagePlacementSpec(
                policy, budget, **JAX_BW)),
            jpk.page_placement(jm, seq_len, block, jpk.PagePlacementSpec(
                policy, budget, **JAX_BW)), err_msg=f"{policy} {budget}")
    with pytest.raises(ValueError, match="unknown placement policy"):
        tpk.page_placement(tm, seq_len, block,
                           tpk.PagePlacementSpec("lru", 1))


@pytest.mark.parametrize("mask", list(MASKS))
@pytest.mark.parametrize("mode", ["auto", "force", "off"])
@pytest.mark.parametrize("cache_len", [32, 48, 64, 72])
def test_decode_pages_equal_jax(mask, mode, cache_len):
    jcfg, tcfg = _cfgs(mode, MASKS[mask])
    want = JL._decode_pages(jcfg, None, cache_len)
    got = TL._decode_pages(tcfg, None, cache_len)
    assert (got is None) == (want is None)
    if want is not None:
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_port_bandwidths_are_the_cards():
    spec = tpk.PagePlacementSpec()
    assert (spec.hbm_gbps, spec.host_gbps) == (3350.0, 64.0)
    assert (jpk.PagePlacementSpec().hbm_gbps,
            jpk.PagePlacementSpec().host_gbps) == (819.0, 32.0)


@pytest.mark.parametrize("arch,cache_len,n_slots,budget", [
    (SMOKE, 64, 2, None), (SMOKE, 64, 3, 2), (SMOKE, 48, 1, 1),
    (SMOKE, 40, 2, None),          # pages do not tile the cache
    (SMOKE, 32, 2, None),          # no page saving: the dense bias
    (ARCH, 8320, 4, None), (ARCH, 8320, 4, 40)])
def test_report_equals_jax(arch, cache_len, n_slots, budget):
    """``PagedKVCache.report()`` equals the JAX dict, the registered config
    at ``[prefill-attn]``'s cache of 8,320 too (65 pages, 33 touched a
    step), given the JAX package's bandwidths."""
    jcfg, tcfg = jax_get_config(arch), get_config(arch)
    want = jpk.PagedKVCache(jcfg, cache_len, n_slots, jpk.PagePlacementSpec(
        resident_pages=budget, **JAX_BW)).report()
    got = tpk.PagedKVCache(tcfg, cache_len, n_slots, tpk.PagePlacementSpec(
        resident_pages=budget, **JAX_BW)).report()
    assert got == want
    if arch == ARCH:
        row = got["groups"][0]
        assert (row["paged"], row["n_pages"],
                row["pages_touched_per_step"]) == (True, 65, 33)


@pytest.mark.parametrize("cache_len", [64, 40])
def test_table_leaves_equal_jax(cache_len):
    jcfg, tcfg = jax_get_config(SMOKE), get_config(SMOKE)
    want = jpk.PagedKVCache(jcfg, cache_len, 2).table_leaves()
    got = tpk.PagedKVCache(tcfg, cache_len, 2).table_leaves(device="cpu")
    assert sorted(got) == sorted(want)
    for group, leaves in want.items():
        assert sorted(got[group]) == sorted(leaves)
        for name, leaf in leaves.items():
            t = got[group][name]
            assert t.device.type == "cpu"
            assert str(t.dtype).removeprefix("torch.") == str(leaf.dtype)
            np.testing.assert_array_equal(t.numpy(), np.asarray(leaf))


def test_paged_kv_cache_refuses_what_it_cannot_page():
    tcfg = get_config("smat-ffn-1.3b:smoke")
    with pytest.raises(ValueError, match="requires cfg.attn_sparsity"):
        tpk.PagedKVCache(tcfg, 64, 2)
    with pytest.raises(ValueError, match="A7"):
        tpk.PagedKVCache(dataclasses.replace(get_config(SMOKE),
                                             layout="gemma_pair"), 64, 2)


# ========================================================= paged attention
def _decode_inputs(cfg, cache_len, B=3, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, 1, cfg.n_heads, cfg.head_dim))
    kc = rng.standard_normal((B, cache_len, cfg.n_kv_heads, cfg.head_dim))
    vc = rng.standard_normal((B, cache_len, cfg.n_kv_heads, cfg.head_dim))
    return tuple(x.astype(np.float32) for x in (q, kc, vc))


def full_table(n_block_rows, n_pages, device="cpu"):
    """Every page in every row, all live: the dense-bias fold's table."""
    pages = torch.arange(n_pages, device=device).expand(n_block_rows, -1)
    return pages.contiguous(), torch.ones_like(pages, dtype=torch.bool)


@pytest.mark.parametrize("mask", list(MASKS))
@pytest.mark.parametrize("cap", [None, 5.0])
def test_paged_decode_matches_jax_and_its_full_table(jax_oracle, mask, cap):
    """At positions 0, 7, 17, 40 and 63 of a 64-slot cache (block 16): the
    port's ``_paged_decode`` within 1e-5 of JAX's, and bit-equal to the
    same call over the full 4-page table."""
    jcfg, tcfg = _cfgs("force", MASKS[mask])
    cache_len = 64
    q, kc, vc = _decode_inputs(tcfg, cache_len)
    jpages, jlive = JL._decode_pages(jcfg, None, cache_len)
    pages, live = A.decode_page_tensors(TL._sparse_mask(tcfg, None),
                                        cache_len, (16, 16), "cpu")
    np.testing.assert_array_equal(pages.numpy(), jpages)
    fpages, flive = full_table(pages.shape[0], cache_len // 16)
    scale = tcfg.head_dim ** -0.5
    tq, tk, tv = (torch.from_numpy(x) for x in (q, kc, vc))
    for pos in (0, 7, 17, 40, 63):
        got = TL._paged_decode(tcfg, tq, tk, tv, pos, None, cap, scale,
                               pages=pages, live=live)
        full = TL._paged_decode(tcfg, tq, tk, tv, pos, None, cap, scale,
                                pages=fpages, live=flive)
        want = JL._paged_decode(jcfg, jnp.asarray(q), jnp.asarray(kc),
                                jnp.asarray(vc), jnp.asarray(pos, jnp.int32),
                                None, cap, scale, pages=jpages, live=jlive)
        assert got.shape == (3, 1, tcfg.n_heads, tcfg.head_dim)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5, err_msg=f"pos {pos}")
        assert torch.equal(got, full), f"paged != full table at pos {pos}"


def test_paged_decode_equals_the_dense_bias_decode():
    """The paged path and the dense-bias path (``paged_decode="off"``) of
    ``layers.attention`` agree within 1e-5 on the same cache: the same
    mask, two softmax folds."""
    _, tcfg = _cfgs("force")
    _, toff = _cfgs("off")
    model = T.init_params(tcfg, seed=0, device="cpu")
    attn = model.blocks[0].attn
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, 1, tcfg.d_model)).astype(
        np.float32))
    kc, vc = (torch.from_numpy(a) for a in _decode_inputs(tcfg, 64, B=2)[1:])
    for pos in (0, 30, 63):
        outs = []
        with torch.inference_mode():
            for cfg in (tcfg, toff):
                cache = {"k": kc.clone(), "v": vc.clone()}
                outs.append(TL.attention(cfg, attn, x, cache=cache,
                                         pos=pos)[0])
        np.testing.assert_allclose(outs[0].numpy(), outs[1].numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=f"{pos}")


def test_paged_decode_sees_one_signature_per_shape():
    _, tcfg = _cfgs("force")
    q, kc, vc = (torch.from_numpy(x) for x in _decode_inputs(tcfg, 64))
    pages, live = A.decode_page_tensors(TL._sparse_mask(tcfg, None), 64,
                                        (16, 16), "cpu")
    shapemon.reset("models.paged_decode")
    for pos in (0, 5, 33, 63):
        TL._paged_decode(tcfg, q, kc, vc, pos, None, None, 0.5,
                         pages=pages, live=live)
    assert shapemon.trace_count("models.paged_decode") == 1
    TL._paged_decode(tcfg, q[:2], kc[:2], vc[:2], 3, None, None, 0.5,
                     pages=pages, live=live)
    assert shapemon.trace_count("models.paged_decode") == 2


# ================================================================== serving
def _requests(module, vocab, seed=0):
    """Five requests of 3-14 prompt tokens; requests 2 and 4 share a prefix
    with 0 and 1, so admissions reuse KV rows."""
    rng = np.random.default_rng(seed)
    p = [rng.integers(0, vocab, size=n, dtype=np.int32) for n in (9, 3, 8, 6)]
    prompts = [p[0], p[1], np.concatenate([p[0][:6], p[2]]), p[3],
               np.concatenate([p[1], p[2]])]
    return [module.Request(rid=i, prompt=prompt, max_new_tokens=4 + i % 3)
            for i, prompt in enumerate(prompts)]


def _run(engine, requests):
    streams = {}
    for rid, tok in engine.generate(requests):
        streams.setdefault(rid, []).append(int(tok))
    return streams


@pytest.fixture(scope="module")
def smoke_params():
    jcfg, tcfg = _cfgs("auto")
    jparams = JT.init_params(jcfg, seed=0)
    return jparams, convert.params_from_jax(
        tcfg, jax.tree.map(np.asarray, jparams), "cpu")


@pytest.mark.parametrize("mode,cache_len", [("force", 64), ("auto", 64),
                                            ("auto", 32)])
def test_engine_matches_jax_engine(jax_oracle, smoke_params, mode,
                                   cache_len):
    """Five requests over two slots (admissions, evictions, a prefix hit):
    the port engine and the JAX engine give identical token streams,
    scheduler traces and paged reports; ``auto`` pages at cache 64 (3 of 4
    pages a step) and keeps the dense bias at 32 (2 of 2)."""
    jparams, model = smoke_params
    jcfg, tcfg = _cfgs(mode)
    jeng = jengine.ServeEngine(jcfg, jparams, n_slots=2, cache_len=cache_len,
                               placement=jpk.PagePlacementSpec(**JAX_BW))
    teng = tengine.ServeEngine(tcfg, model, n_slots=2, cache_len=cache_len,
                               placement=tpk.PagePlacementSpec(**JAX_BW),
                               device="cpu")
    reqs = _requests(jengine, tcfg.vocab_size)
    shapemon.reset("models.paged_decode")
    want = _run(jeng, reqs)
    got = _run(teng, _requests(tengine, tcfg.vocab_size))
    assert got == want
    assert teng.scheduler.trace == jeng.scheduler.trace
    assert teng.scheduler.prefix_hits == jeng.scheduler.prefix_hits > 0
    assert teng.paged_kv.report() == jeng.paged_kv.report()
    paged = TL._decode_pages(tcfg, None, cache_len) is not None
    assert paged == (mode == "force" or cache_len == 64)
    assert teng.paged_kv.report()["groups"][0]["paged"] == paged
    assert shapemon.trace_count("models.paged_decode") == int(paged)
    assert teng.step_sentinel.count == 1


def test_force_and_off_serve_equal_streams(smoke_params):
    _, model = smoke_params
    streams = {}
    for mode in ("force", "off"):
        _, tcfg = _cfgs(mode)
        eng = tengine.ServeEngine(tcfg, model, n_slots=3, cache_len=64,
                                  device="cpu")
        streams[mode] = _run(eng, _requests(tengine, tcfg.vocab_size))
    assert streams["force"] == streams["off"]


def test_serve_cli_prints_the_paged_kv_line(capsys):
    assert serve_cli.main(["--arch", SMOKE, "--device", "cpu", "--requests",
                           "3", "--slots", "2", "--prompt-len", "4",
                           "--new-tokens", "3", "--cache-len", "64"]) == 0
    out = capsys.readouterr().out
    assert "3/3 requests, 9 new tokens" in out
    # 4 pages x 16 positions x 2 kv heads x 32 x 2 (k, v) x 2 B (bf16) x 2
    # slots x 2 layers, all resident
    assert "[serve] paged KV: resident 65536 B, offloaded 0 B over 1 " \
        "layer group(s)" in out

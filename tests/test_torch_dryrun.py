"""``launch.dryrun`` in process against the JAX package's dry-run functions.

Every host field of the reports must equal the JAX functions' output: the
partitioned FFN's shard balance, resolved shard count, chunk schedule and
``verify_summary`` (a ``shards=2`` view of ``smat-ffn-1.3b:smoke``); the
mask report of ``smat-attn-1.3b:smoke`` (with the JAX spec given the port's
registered ``backend="fused"``) with its workspace bytes and
``verify_summary``; the paged-KV report with its page-table leaf specs.
The kernel picks are the port's own (its registry and its H100 model): they
must equal what the port's dispatch resolves for the same metas.  XLA's
numbers (compile times, cost analysis) are not compared; a cell's argument
bytes are held to the JAX specs' bytes divided as the JAX rule tables place
each leaf, on one card and on a ``2,2`` mesh, for the attention arch and
the MLA/MoE and SSD archs (MoE expert banks over ``model``, their latent and
conv/state caches by the cache rules).
"""
# ruff: noqa: E402
import pytest

torch = pytest.importorskip("torch")

import dataclasses
import json
import os

import jax
import numpy as np

from repro.configs import get_config as jax_get_config
from repro.configs.base import ShapeCell as JaxShapeCell
from repro.launch import mesh as jmesh
from repro.launch import sharding as jsh
from repro.launch import steps as jst
from repro.models import transformer as JT
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeCell
from repro_torch.kernels import ops
from repro_torch.launch import dryrun
from repro_torch.models import attention as A
from repro_torch.models import layers as L


@pytest.fixture(scope="module")
def jdr():
    """The JAX dry-run module, imported without letting its first lines
    force 512 host devices on this process (its flag is read from
    ``DRYRUN_XLA_FLAGS``; the process keeps its own ``XLA_FLAGS``)."""
    saved = {k: os.environ.get(k) for k in ("XLA_FLAGS", "DRYRUN_XLA_FLAGS")}
    os.environ["DRYRUN_XLA_FLAGS"] = saved["XLA_FLAGS"] or ""
    try:
        from repro.launch import dryrun as module
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return module


def _sharded(cfg, n):
    return dataclasses.replace(cfg, ffn_sparsity=dataclasses.replace(
        cfg.ffn_sparsity, shards=n))


def test_sparse_shard_report_equals_jax(jdr):
    cfg = _sharded(get_config("smat-ffn-1.3b:smoke"), 2)
    jcfg = _sharded(jax_get_config("smat-ffn-1.3b:smoke"), 2)
    got = dryrun.sparse_shard_report(cfg, device="cpu")
    want = jdr.sparse_shard_report(jcfg)
    assert set(got) == set(want) == {"gate_up", "down"}
    metas = L.mlp_sparse_metas(cfg.ffn_sparsity, cfg.d_model, cfg.d_ff,
                               tuple(range(cfg.n_layers)), "cpu")
    for (lname, rep), m in zip(got.items(), metas):
        picks = rep.pop("auto_picks")
        jpicks = want[lname].pop("auto_picks")
        assert rep == want[lname]
        assert len(picks) == len(jpicks) == m.n_shards
        assert picks == [A.pick_label(*ops.resolve_backend(
            "auto", None, sm, 512, device="cpu")) for sm in m.shard_metas]
    assert dryrun.sparse_shard_report(get_config("smat-ffn-1.3b:smoke"),
                                      device="cpu") == {}


PICKS = ("attn_pick", "sddmm_pick", "spmm_pick")


def test_sparse_attention_report_equals_jax(jdr):
    cfg = get_config("smat-attn-1.3b:smoke")
    jcfg = jax_get_config("smat-attn-1.3b:smoke")
    jcfg = dataclasses.replace(jcfg, attn_sparsity=dataclasses.replace(
        jcfg.attn_sparsity, backend=cfg.attn_sparsity.backend))
    got = dryrun.sparse_attention_report(cfg, device="cpu")
    want = jdr.sparse_attention_report(jcfg)
    assert {k: v for k, v in got.items() if k not in PICKS} == \
        {k: v for k, v in want.items() if k not in PICKS}
    meta = A.attention_mask_meta(cfg.attn_sparsity.mask, got["seq_len"],
                                 tuple(cfg.attn_sparsity.block))
    for op in ("sddmm", "spmm"):
        assert got[op + "_pick"] == A.pick_label(*ops.resolve_backend(
            "auto", None, meta, cfg.head_dim, op=op, device="cpu"))
    assert got["attn_pick"] in ("attn_fused", "attn_composed")
    assert dryrun.sparse_attention_report(get_config("smat-ffn-1.3b:smoke"),
                                          device="cpu") == {}


@pytest.mark.parametrize("cache_len", [64, 512])
def test_paged_kv_report_equals_jax(jdr, cache_len):
    """The JAX report given the port's placement bandwidths (the H100's
    HBM and PCIe rates, which the step-read estimates follow), with the
    JAX dry-run's page-table leaf specs."""
    from repro.serve import paged_kv as jpk
    from repro_torch.serve import paged_kv as tpk
    name = "smat-attn-1.3b:smoke"
    got = dryrun.paged_kv_report(get_config(name), cache_len=cache_len)
    want = jdr.paged_kv_report(jax_get_config(name), cache_len=cache_len)
    bw = tpk.PagePlacementSpec()
    h100 = jpk.PagedKVCache(jax_get_config(name), cache_len, 4,
                            jpk.PagePlacementSpec(
                                hbm_gbps=bw.hbm_gbps,
                                host_gbps=bw.host_gbps)).report()
    assert got.pop("table_leaf_specs") == want.pop("table_leaf_specs")
    assert got == h100
    assert dryrun.paged_kv_report(get_config("smat-ffn-1.3b:smoke")) == {}


def test_paged_kv_report_covers_gemma_pair_as_jax(jdr):
    """A ``gemma_pair`` config with block-sparse attention: the local and
    global groups, as the JAX dry-run reports them (given the port's
    bandwidths), their page-table leaf specs too."""
    from repro.serve import paged_kv as jpk
    from repro_torch.serve import paged_kv as tpk

    def sparse(get):
        spec = get("smat-attn-1.3b:smoke").attn_sparsity
        return dataclasses.replace(get("gemma2-27b:smoke"),
                                   attn_sparsity=spec)
    cfg, jcfg = sparse(get_config), sparse(jax_get_config)
    got = dryrun.paged_kv_report(cfg, cache_len=128)
    want = jdr.paged_kv_report(jcfg, cache_len=128)
    bw = tpk.PagePlacementSpec()
    h100 = jpk.PagedKVCache(jcfg, 128, 4, jpk.PagePlacementSpec(
        hbm_gbps=bw.hbm_gbps, host_gbps=bw.host_gbps)).report()
    assert got.pop("table_leaf_specs") == want.pop("table_leaf_specs")
    assert got == h100
    assert [g["group"] for g in got["groups"]] == ["local", "global"]
    assert dryrun.paged_kv_report(get_config("zamba2-7b:smoke")) == {}


def _factor(mesh, spec) -> int:
    sizes = dict(mesh.shape)
    n = 1
    for a in spec:
        for name in (a if isinstance(a, tuple) else (a,)):
            if name is not None:
                n *= sizes[name]
    return n


def _stack_dims(jcfg) -> dict:
    """The JAX param tree's stacked subtrees and their stack dims."""
    if jcfg.layout == "zamba":
        return {"units": (jcfg.hybrid_n_units, jcfg.hybrid_unit_len),
                "tail": (jcfg.hybrid_tail,)}
    return {"blocks": (JT._n_repeats(jcfg),)}


def _jax_leaves(tree, shardings, mesh, stacks=None):
    """``{port path: bytes one device holds}`` of a JAX spec tree placed by
    ``shardings``: the leaves of the stacked subtrees ``stacks`` ({name:
    stack dims}, at the top or under ``m``/``v``) split a layer each."""
    out = {}
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    shard = jax.tree_util.tree_leaves(shardings)
    for (p, leaf), s in zip(flat, shard):
        parts = [str(getattr(k, "key", getattr(k, "idx", k))) for k in p]
        nbytes = leaf.size * leaf.dtype.itemsize / _factor(mesh, s.spec)
        at = next((i for i, k in enumerate(parts[:2]) if k in (stacks or {})),
                  None)
        if at is None or not leaf.shape:
            out[".".join(parts)] = nbytes
            continue
        dims = stacks[parts[at]]
        for ix in np.ndindex(*dims):
            key = parts[:at + 1] + [str(i) for i in ix] + parts[at + 1:]
            out[".".join(key)] = nbytes / int(np.prod(dims))
    return out


def _batch_bytes(batch_specs, shardings, mesh) -> float:
    """A batch's bytes a device holds, the port's ids int64 (JAX: int32),
    ``patch_embeds`` bf16 in both."""
    leaves = _jax_leaves(batch_specs, shardings, mesh)
    return sum(b * (2 if str(batch_specs[k].dtype) == "int32" else 1)
               for k, b in leaves.items())


CELLS = [("train", 32, 2), ("prefill", 32, 2), ("decode", 64, 2),
         ("decode", 64, 8)]


@pytest.mark.parametrize("name", ["smat-attn-1.3b:smoke",
                                  "deepseek-v2-lite-16b:smoke",
                                  "deepseek-v2-236b:smoke",
                                  "mamba2-1.3b:smoke", "gemma2-27b:smoke",
                                  "zamba2-7b:smoke", "musicgen-medium:smoke",
                                  "pixtral-12b:smoke"])
@pytest.mark.parametrize("mesh_shape", [(1, 1), (2, 2)])
@pytest.mark.parametrize("kind,seq,batch", CELLS)
def test_cell_argument_bytes_follow_the_jax_placement(kind, seq, batch,
                                                      mesh_shape, name):
    cfg, jcfg = get_config(name), jax_get_config(name)
    mesh = dryrun.make_mesh(mesh_shape)
    jm = jmesh.make_abstract_mesh(mesh_shape, ("data", "model"))
    rec = dryrun.run_cell(cfg, ShapeCell(kind, kind, seq, batch), mesh,
                          device="cpu", verbose=False)
    assert (rec["arch"], rec["shape"], rec["mesh"], rec["n_devices"],
            rec["status"], rec["remat"]) == \
        (name, kind, "x".join(map(str, mesh_shape)),
         mesh_shape[0] * mesh_shape[1], "ok", "full")
    assert rec["lower_s"] is rec["compile_s"] is \
        rec["memory"]["temp_bytes"] is None
    jcell = JaxShapeCell(kind, kind, seq, batch)
    params = JT.param_specs(jcfg)
    mode = "serve" if kind != "train" and batch >= 8 else "train"
    p_shard = jsh.param_shardings(jm, params, mode=mode)
    want = _jax_leaves(params, p_shard, jm, _stack_dims(jcfg))
    # the port's schedule buffers: replicated, as every index leaf
    from repro_torch.models import transformer as T
    port = T.flat_specs(T.param_specs(cfg, device="cpu"))
    extra = {k: v for k, v in port.items() if k not in want}
    assert {k.rsplit(".", 1)[1] for k in extra} == (
        set(ops.PORT_FIELDS) if cfg.ffn_sparsity else set())
    total = sum(want.values()) + sum(v.numel() * 4 for v in extra.values())
    batch_specs = jst.input_specs(jcfg, jcell)
    ids = 2                                   # int64 ids against int32
    if kind == "train":
        opt = jst.opt_specs(jcfg, params)
        o_shard = jsh.opt_state_shardings(jm, opt, p_shard)
        moments = _jax_leaves({"m": opt["m"], "v": opt["v"]},
                              {"m": o_shard["m"], "v": o_shard["v"]}, jm,
                              _stack_dims(jcfg))
        # the port keeps no moment beside an integer leaf
        floating = {k for k, v in port.items() if v.is_floating_point()}
        total += sum(b for k, b in moments.items()
                     if k.split(".", 1)[1] in floating) + 4
        total += _batch_bytes(batch_specs,
                              jsh.batch_shardings(jm, batch_specs), jm)
    elif kind == "prefill":
        total += _batch_bytes(batch_specs,
                              jsh.batch_shardings(jm, batch_specs), jm)
    else:
        tok = batch_specs["tokens"]
        f = _factor(jm, jsh.batch_shardings(jm, batch_specs)["tokens"].spec) \
            if batch >= 8 else 1
        total += ids * tok.size * tok.dtype.itemsize / f
        cache = JT.cache_specs(jcfg, batch, seq)
        c_shard = jsh.cache_shardings(jm, cache, jcfg, seq_shard=batch < 8)
        total += sum(_jax_leaves(cache, c_shard, jm).values())
    assert rec["memory"]["argument_bytes"] == round(total)
    roof = rec["roofline"]
    assert roof["flops_per_device"] > 0 and roof["bytes_per_device"] > 0
    assert roof["wire_bytes_per_device"] == 0


def test_main_writes_every_cell_and_report(tmp_path):
    out = tmp_path / "r.json"
    assert dryrun.main(["--arch", "smat-attn-1.3b:smoke", "--device", "cpu",
                        "--batch", "2", "--seq", "64", "--mesh-shape", "2,2",
                        "--out", str(out)]) == 0
    records = json.loads(out.read_text())
    assert [r["status"] for r in records] == \
        ["sparse_attention", "paged_kv"] + ["ok"] * 4
    assert all(r["mesh"] == "2x2" and r["batch"] == 2 and r["seq_len"] == 64
               for r in records[2:])


def test_main_all_at_full_size(tmp_path, capsys):
    """All 12 archs x the 4 shape cells: 41 ok, the 7 ``long_500k`` cells
    of pure full-attention archs skipped (``cell_applicable``)."""
    out = tmp_path / "all.json"
    assert dryrun.main(["--all", "--device", "cpu", "--out", str(out)]) == 0
    records = json.loads(out.read_text())
    ok = [(r["arch"], r["shape"]) for r in records if r["status"] == "ok"]
    assert len(ok) == 41
    assert [(r["arch"], r["shape"]) for r in records
            if r["status"] == "skip"] == [
        (a, "long_500k") for a in (
            "deepseek-v2-236b", "deepseek-v2-lite-16b", "minitron-4b",
            "musicgen-medium", "pixtral-12b", "qwen2.5-14b",
            "smat-ffn-1.3b")]
    assert {a for a, s in ok if s == "long_500k"} == {
        "gemma2-27b", "h2o-danube-1.8b", "mamba2-1.3b", "smat-attn-1.3b",
        "zamba2-7b"}
    assert "41 cells ok, 0 errors" in capsys.readouterr().out


def test_main_exits_1_on_an_error_record(monkeypatch):
    def broken(*args, **kwargs):
        raise RuntimeError("planted")
    monkeypatch.setattr(dryrun, "run_cell", broken)
    assert dryrun.main(["--arch", "smat-ffn-1.3b:smoke", "--shape",
                        "train_4k", "--device", "cpu"]) == 1

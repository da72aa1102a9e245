"""The example twins (``examples/torch_*.py``) with ``--device cpu``, in
process, their host numbers held to the JAX package's functions called
directly (the JAX ``examples/quickstart.py`` itself is not run: its step 5
reaches the monitored ``spmm_sharded``, ROADMAP C1).

* quickstart: the matrix's nnz, the BCSR block counts before and after the
  Jaccard reorder, the four shards' loads and imbalance, and the mask
  report's structure fields must equal the JAX package's; the twin's own
  asserts hold the products (1e-3 against dense, fused attention 1e-5 of
  max against composed and 1e-4 against dense-masked attention).
* serve: five requests of eight tokens each, and the paged-KV report equal
  to the JAX ``PagedKVCache`` report given the port's bandwidths.
* train: the printed parameter count equals the JAX config's; at a cut
  depth and vocabulary the loss falls over 12 steps (the twin asserts it).
"""
# ruff: noqa: E402
import pytest

torch = pytest.importorskip("torch")

import dataclasses
import importlib.util
from pathlib import Path

import jax.numpy as jnp

from repro.configs import get_config as jax_get_config
from repro.configs.base import ModelConfig as JaxModelConfig
from repro.core import bcsr as jbcsr
from repro.core import sparse_linear as jsl
from repro.core import topology as jtopology
from repro.kernels import ops as jops
from repro.launch import dist_spmm as jdist
from repro.models import attention as JA
from repro.serve import paged_kv as jpk
from repro_torch.serve import paged_kv as tpk

ROOT = Path(__file__).resolve().parents[1]


def _example(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_quickstart_twin_numbers_equal_jax(capsys):
    out = _example("torch_quickstart").main(["--device", "cpu"])
    assert capsys.readouterr().out.rstrip().endswith("OK")
    csr = jtopology.blocked_random(n=1024, nnz_target=30_000, cluster=32,
                                   seed=0)
    a = jbcsr.from_scipy(csr, (16, 16))
    meta = jops.prepare_sparse_meta(a, reorder="jaccard")
    meta_id = jops.prepare_sparse_meta(a)
    stats = jdist.shard_balance_stats(a, 4)
    assert out["nnz"] == csr.nnz
    assert out["nnzb"] == (meta_id.nnzb, meta.nnzb)
    assert (out["loads"], out["imbalance"]) == \
        (stats["loads"], stats["imbalance"])
    assert out["layer_shape"] == (2, 8, 512)
    jrep = JA.attention_mask_report(
        JA.AttnSparsitySpec(mask=JA.banded(48), block=(16, 16),
                            backend="auto"), 128)
    for key in ("mask", "block", "seq_len", "nnzb", "max_bpr",
                "block_density_vs_causal", "shards"):
        assert out["mask_report"][key] == jrep[key], key
    assert out["mask_report"]["attn_impl"] == "fused"


def test_serve_twin_streams_and_paged_report(capsys):
    out = _example("torch_serve_decode").main(["--device", "cpu"])
    assert capsys.readouterr().out.rstrip().endswith("OK")
    assert sorted(out["streams"]) == list(range(5))
    assert all(len(t) == 8 for t in out["streams"].values())
    bw = tpk.PagePlacementSpec()
    want = jpk.PagedKVCache(
        jax_get_config("smat-attn-1.3b:smoke"), 64, 2,
        jpk.PagePlacementSpec(hbm_gbps=bw.hbm_gbps,
                              host_gbps=bw.host_gbps)).report()
    assert out["paged_kv"] == want
    assert want["groups"][0]["paged"]


def test_train_twin_param_count_equals_jax_and_loss_falls(tmp_path,
                                                          capsys):
    module = _example("torch_train_sparse_lm")
    cfg = module.CONFIG
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
              if f.name != "ffn_sparsity"}
    spec = cfg.ffn_sparsity
    jcfg = JaxModelConfig(**fields, ffn_sparsity=jsl.SparsitySpec(
        density=spec.density, block=spec.block, backend="xla"))
    assert cfg.param_count() == jcfg.param_count()
    layers, vocab = 1, 256
    out = module.main(["--device", "cpu", "--layers", str(layers),
                       "--vocab", str(vocab), "--steps", "12", "--batch",
                       "2", "--seq", "16", "--ckpt-dir", str(tmp_path)])
    printed = capsys.readouterr().out
    small = dataclasses.replace(jcfg, n_layers=layers, vocab_size=vocab)
    assert out["param_count"] == small.param_count()
    assert f"params ~{small.param_count() / 1e6:.0f}M" in printed
    assert printed.rstrip().endswith("OK")
    assert len(out["losses"]) == 12 and out["losses"][-1] < out["losses"][0]
    assert jnp.isfinite(jnp.asarray(out["losses"])).all()

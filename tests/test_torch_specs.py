"""The port's dims-only specs and parameter counts against the JAX package's.

Every leaf of ``param_specs``, ``cache_specs``, ``input_specs``,
``opt_specs`` and ``sparse_linear_specs`` (unsharded, ``shards=2``, with
and without a seed) of every registered arch's ``:smoke`` view (all
twelve: every layout and input mode) must have the shape and dtype of the
JAX package's ``jax.eval_shape`` leaf at the same path, the layer stack
unstacked as ``convert.params_from_jax`` reads it (``zamba``'s ``units``
twice).  Stated
differences, each checked exactly:

* the port's sparse layers add its schedule buffers (``ops.PORT_FIELDS``);
  with the layer's seed each has the shape of the built model's buffer;
* token ids are int64 (what the port feeds), int32 in the JAX package
  (``patch_embeds`` are bf16 in both);
* AdamW's state is kept for the floating parameters only (the JAX package
  keeps a 0-d moment beside every integer leaf too).

``param_count``, ``active_param_count`` and ``sparse_param_flops`` must be
exactly equal.
"""
# ruff: noqa: E402
import pytest

torch = pytest.importorskip("torch")

import dataclasses

import jax
import numpy as np

from repro.configs import get_config as jax_get_config
from repro.configs.base import ModelConfig as JaxModelConfig
from repro.configs.base import ShapeCell as JaxShapeCell
from repro.core import sparse_linear as jsl
from repro.launch import steps as jst
from repro.models import transformer as JT
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig, ShapeCell
from repro_torch.core import sparse_linear as sl
from repro_torch.kernels import ops
from repro_torch.launch import steps as st
from repro_torch.models import transformer as T

FULL = ["smat-ffn-1.3b", "smat-attn-1.3b", "deepseek-v2-lite-16b",
        "deepseek-v2-236b", "mamba2-1.3b", "pixtral-12b", "h2o-danube-1.8b",
        "minitron-4b", "qwen2.5-14b", "gemma2-27b", "zamba2-7b",
        "musicgen-medium"]
ARCHS = [a + ":smoke" for a in FULL]
CELLS = [("train", 64, 2), ("prefill", 64, 2), ("decode", 96, 3)]
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "int32": torch.int32, "bool": torch.bool}


def _path(keys) -> str:
    return ".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in keys)


def _jax_flat(tree) -> dict:
    return {_path(p): leaf for p, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _stack_dims(jcfg) -> dict:
    """The JAX tree's stacked subtrees and their stack dims: ``blocks``
    over the repeats (a ``gemma_pair`` block is a pair of layers);
    ``zamba``'s ``units`` [n_units, unit_len] and ``tail``."""
    if jcfg.layout == "zamba":
        return {"units": (jcfg.hybrid_n_units, jcfg.hybrid_unit_len),
                "tail": (jcfg.hybrid_tail,)}
    return {"blocks": (JT._n_repeats(jcfg),)}


def _unstacked(jflat: dict, jcfg) -> dict:
    """JAX ``{path: (shape, dtype)}`` with each stacked leaf split into one
    entry a layer (``blocks.<i>.*``; ``units.<u>.<j>.*``), as the port's
    model holds them (a 0-d leaf there, AdamW's moment of a stacked
    integer leaf, stands for one a layer)."""
    out = {}
    stacks = _stack_dims(jcfg)
    for path, leaf in jflat.items():
        shape, dtype = tuple(leaf.shape), DTYPES[str(leaf.dtype)]
        head, _, rest = path.partition(".")
        dims = stacks.get(head)
        if dims is None:
            out[path] = (shape, dtype)
            continue
        assert shape == () or shape[:len(dims)] == dims, path
        for ix in np.ndindex(*dims):
            key = ".".join([head, *map(str, ix), rest])
            out[key] = (shape[len(dims):], dtype)
    return out


def _port(flat: dict) -> dict:
    return {k: (tuple(v.shape), v.dtype) for k, v in flat.items()}


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    name = request.param
    jcfg = jax_get_config(name)
    return name, get_config(name), jcfg, \
        _unstacked(_jax_flat(JT.param_specs(jcfg)), jcfg)


def test_param_specs_equal_jax_and_the_model(arch):
    _, cfg, _, jax_params = arch
    specs = T.flat_specs(T.param_specs(cfg, device="cpu"))
    assert all(v.device.type == "meta" for v in specs.values())
    got = _port(specs)
    extra = set(got) - set(jax_params)
    assert {k.rsplit(".", 1)[1] for k in extra} == (
        set(ops.PORT_FIELDS) if cfg.ffn_sparsity else set())
    assert {k: got[k] for k in jax_params} == jax_params
    # with the layers' seeds, the port buffers too are the built model's
    model = T.init_params(cfg, device="cpu")
    assert got == {k: (tuple(v.shape), v.dtype)
                   for k, v in model.state_dict().items()}


def test_cache_specs_equal_jax(arch):
    _, cfg, jcfg, _ = arch
    got = _port(T.flat_specs(T.cache_specs(cfg, 3, 40)))
    want = {k: (tuple(v.shape), DTYPES[str(v.dtype)])
            for k, v in _jax_flat(JT.cache_specs(jcfg, 3, 40)).items()}
    assert got == want
    built = T.flat_specs(T.init_cache(cfg, 3, 40, device="cpu"))
    assert got == {k: (tuple(v.shape), v.dtype) for k, v in built.items()}


@pytest.mark.parametrize("kind,seq,batch", CELLS)
def test_input_specs_equal_jax(arch, kind, seq, batch):
    _, cfg, jcfg, _ = arch
    got = st.input_specs(cfg, ShapeCell("c", kind, seq, batch))
    want = jst.input_specs(jcfg, JaxShapeCell("c", kind, seq, batch))
    assert set(got) == set(want)
    for k, v in got.items():
        assert tuple(v.shape) == tuple(want[k].shape), k
        if k == "patch_embeds":
            assert str(want[k].dtype) == "bfloat16" == str(v.dtype)[6:]
        else:
            assert str(want[k].dtype) == "int32" and v.dtype == torch.int64
        assert v.device.type == "meta"


def test_opt_specs_follow_adamw_init(arch):
    _, cfg, jcfg, jax_params = arch
    params = T.param_specs(cfg, device="cpu")
    got = st.opt_specs(cfg, params)
    jopt = jst.opt_specs(jcfg, JT.param_specs(jcfg))
    jm = _unstacked(_jax_flat(jopt["m"]), jcfg)
    floating = {k for k, v in T.flat_specs(params).items()
                if v.is_floating_point()}
    assert set(got["m"]) == set(got["v"]) == floating
    for k in floating:
        assert (tuple(got["m"][k].shape), got["m"][k].dtype) == jm[k], k
    # the JAX state's other moments are the 0-d ones beside integer leaves
    others = {k for k in jm if k not in floating}
    assert others == {k for k in jax_params if k not in floating}
    assert all(jm[k] == ((), torch.float32) for k in others)
    assert (got["step"].shape, got["step"].dtype) == \
        ((), getattr(torch, str(jopt["step"].dtype)))
    from repro_torch.optim import adamw
    built = adamw.init(dict(T.init_params(cfg, device="cpu")
                            .named_parameters()))
    assert _port(got["m"]) == {k: (tuple(v.shape), v.dtype)
                               for k, v in built["m"].items()}


SPECS = [dict(density=0.3, block=(16, 16)), dict(density=0.2, block=(16, 32)),
         dict(density=0.3, block=(16, 16), shards=2),
         dict(density=0.25, block=(16, 16), shards=3, shard_cols=2)]


@pytest.mark.parametrize("kw", SPECS, ids=lambda kw: "-".join(
    f"{k}{v}" for k, v in kw.items()))
@pytest.mark.parametrize("seed", [None, 11])
def test_sparse_linear_specs_equal_jax(kw, seed):
    in_dim, out_dim = 96, 176
    spec, jspec = sl.SparsitySpec(**kw), jsl.SparsitySpec(**kw)
    got, meta = sl.sparse_linear_specs(in_dim, out_dim, spec,
                                       torch.float32, seed=seed,
                                       device="cpu")
    want, jmeta = jsl.sparse_linear_specs(in_dim, out_dim, jspec,
                                          jax.numpy.float32, seed=seed)
    assert dataclasses.asdict(meta) == dataclasses.asdict(jmeta)
    port_only = set(got) - set(want)
    prefix = "shard_" if sl.is_sharded(spec) else ""
    assert port_only == {prefix + f for f in ops.PORT_FIELDS}
    for k, v in want.items():
        assert (tuple(got[k].shape), got[k].dtype) == \
            (tuple(v.shape), DTYPES[str(v.dtype)]), k
    if seed is not None:
        built, bmeta = sl.init_sparse_linear(seed, in_dim, out_dim, spec,
                                             torch.float32, device="cpu")
        assert bmeta == meta
        assert _port(got) == {k: (tuple(v.shape), v.dtype)
                              for k, v in built.items()}


CONFIGS = ARCHS + FULL
EXAMPLE_100M = dict(
    name="smat-ffn-100m", family="dense", layout="attn_mlp", n_layers=12,
    d_model=768, n_heads=12, n_kv_heads=4, head_dim=64, d_ff=3072,
    vocab_size=32000, dtype="float32")


@pytest.mark.parametrize("name", CONFIGS + ["100m", "dense"])
def test_param_counts_equal_jax(name):
    if name in ("100m", "dense"):
        kw = dict(EXAMPLE_100M, qkv_bias=name == "dense")
        sparse = name == "100m"
        cfg = ModelConfig(**kw, ffn_sparsity=sl.SparsitySpec(
            density=0.3, block=(32, 32)) if sparse else None)
        jcfg = JaxModelConfig(**kw, ffn_sparsity=jsl.SparsitySpec(
            density=0.3, block=(32, 32)) if sparse else None)
    else:
        cfg, jcfg = get_config(name), jax_get_config(name)
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.active_param_count() == jcfg.active_param_count()


def test_param_counts_of_the_full_width_archs():
    """The counts the chip runs are sized by: 16.21 B (2.66 B active a
    token) for deepseek-v2-lite-16b, 1.59 B at 2 of its layers, 1.45 B for
    mamba2-1.3b."""
    lite = get_config("deepseek-v2-lite-16b")
    assert (lite.param_count(), lite.active_param_count()) == \
        (16_210_198_528, 2_663_120_896)
    assert dataclasses.replace(lite, n_layers=2).param_count() == \
        1_589_116_928
    assert get_config("mamba2-1.3b").param_count() == 1_446_402_048


def test_param_count_raises_for_layouts_not_ported():
    """Every layout is ported now: ``zamba`` counts its Mamba2 layers, then
    the shared block once, exactly as the JAX package does (5.74 B for
    zamba2-7b), here for a config of another shape too."""
    cfg = dataclasses.replace(get_config("zamba2-7b"), hybrid_n_units=3,
                              hybrid_unit_len=2, hybrid_tail=0)
    jcfg = dataclasses.replace(jax_get_config("zamba2-7b"), hybrid_n_units=3,
                               hybrid_unit_len=2, hybrid_tail=0)
    assert cfg.param_count() == jcfg.param_count()
    assert get_config("zamba2-7b").param_count() == 5_736_657_792


@pytest.mark.parametrize("kw", SPECS[:3], ids=["b16", "b16x32", "shards2"])
def test_sparse_param_flops_equal_jax(kw):
    spec, jspec = sl.SparsitySpec(**kw), jsl.SparsitySpec(**kw)
    for seed in (None, 5):
        _, meta = sl.sparse_linear_specs(96, 176, spec, seed=seed,
                                         device="cpu")
        _, jmeta = jsl.sparse_linear_specs(96, 176, jspec, seed=seed)
        assert sl.sparse_param_flops(meta) == jsl.sparse_param_flops(jmeta)
        h, w = meta.block
        assert sl.sparse_param_flops(meta) == 2 * meta.nnzb * h * w
    assert np.isscalar(sl.sparse_param_flops(meta))

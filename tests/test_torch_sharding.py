"""The port's sharding rules (``repro_torch.launch.sharding``), meshes and
``constrain`` against the JAX package's.

Per-leaf partition specs of the ``smat-ffn-1.3b:smoke`` and
``smat-attn-1.3b:smoke`` parameter, optimizer, batch and decode-cache trees
(the JAX trees' shapes, and a partitioned-FFN variant for the ``shard_*``
leaves) must be exactly equal to the JAX package's on a ``(2, 4)``
``("data", "model")`` and a ``(2, 2, 2)`` pod abstract mesh.  The port's
own model (one module a layer, no stacked axis) gets the JAX spec less its
leading stack dim.  ``constrain`` is the identity with no mesh active.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.launch import constrain as jcon
from repro.launch import mesh as jmesh
from repro.launch import sharding as jsh
from repro.models import transformer as JT
from repro_torch.configs import get_config
from repro_torch.launch import constrain as tcon
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import sharding as tsh
from repro_torch.models import transformer as T

MESHES = [((2, 4), ("data", "model")), ((2, 2, 2), ("pod", "data", "model"))]
ARCHS = ["smat-ffn-1.3b:smoke", "smat-attn-1.3b:smoke", "sharded-ffn"]


def _jax_cfg(arch):
    if arch == "sharded-ffn":
        cfg = jax_get_config("smat-ffn-1.3b:smoke")
        return dataclasses.replace(cfg, ffn_sparsity=dataclasses.replace(
            cfg.ffn_sparsity, shards=2))
    return jax_get_config(arch)


def _meshes(shape, axes):
    return (jmesh.make_abstract_mesh(shape, axes),
            tmesh.make_abstract_mesh(shape, axes))


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, prefix + (k,))
    else:
        yield prefix, tree


def _specs(named_shardings):
    """``{path: tuple(spec)}`` of a JAX tree of ``NamedSharding``s."""
    return {p: tuple(s.spec) for p, s in _flat(named_shardings)}


def _port(tree):
    return {p: tuple(s) for p, s in _flat(tree)}


@pytest.mark.parametrize("shape,axes", MESHES)
def test_mesh_helpers_equal_jax(shape, axes):
    jm, tm = _meshes(shape, axes)
    assert tm.axis_names == tuple(jm.axis_names)
    assert tm.shape == dict(jm.shape)
    assert tmesh.data_axes(tm) == jmesh.data_axes(jm)
    assert tmesh.model_axis(tm) == jmesh.model_axis(jm)
    assert tsh.spmm_shard_count(tm) == jsh.spmm_shard_count(jm)
    # no mesh: the number of devices, 1 on this machine in both
    assert tsh.spmm_shard_count() == jsh.spmm_shard_count() == 1


@pytest.mark.parametrize("shape,axes", MESHES)
def test_fit_spec_equal_jax(shape, axes):
    jm, tm = _meshes(shape, axes)
    rng = np.random.default_rng(0)
    choices = [None, "data", "model", "pod", ("pod", "data"),
               ("data", "model"), ("pod", "data", "model"), "absent"]
    for _ in range(300):
        nd = int(rng.integers(1, 4))
        dims = tuple(int(d) for d in rng.choice([1, 2, 3, 4, 6, 8, 12], nd))
        spec = [choices[i] for i in rng.integers(0, len(choices), nd)]
        want = jsh.fit_spec(jm, jax.sharding.PartitionSpec(*spec), dims)
        assert tuple(tsh.fit_spec(tm, tsh.PartitionSpec(*spec), dims)) == \
            tuple(want), (spec, dims)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape,axes", MESHES)
def test_param_and_opt_specs_equal_jax(arch, shape, axes):
    jm, tm = _meshes(shape, axes)
    params = jax.eval_shape(lambda: JT.init_params(_jax_cfg(arch), seed=0))
    for mode in ("train", "serve"):
        want = _specs(jsh.param_shardings(jm, params, mode=mode))
        assert _port(tsh.param_shardings(tm, params, mode=mode)) == want
    opt = {"m": params, "v": params,
           "step": jax.ShapeDtypeStruct((), np.int32)}
    assert _port(tsh.opt_state_shardings(tm, opt)) == \
        _specs(jsh.opt_state_shardings(jm, opt))
    assert _port(tsh.replicated(tm, params)) == \
        _specs(jsh.replicated(jm, params))
    names = {p[-1] for p, _ in _flat(params)}
    if arch == "sharded-ffn":
        assert {"shard_src", "gather_rows"} <= names


@pytest.mark.parametrize("arch", ARCHS[:2])
@pytest.mark.parametrize("shape,axes", MESHES)
def test_batch_and_cache_specs_equal_jax(arch, shape, axes):
    jm, tm = _meshes(shape, axes)
    cfg = _jax_cfg(arch)
    batch = {"tokens": jax.ShapeDtypeStruct((8, 16), np.int32),
             "labels": jax.ShapeDtypeStruct((8, 16), np.int32),
             "odd": jax.ShapeDtypeStruct((3, 5), np.int32)}
    assert _port(tsh.batch_shardings(tm, batch)) == \
        _specs(jsh.batch_shardings(jm, batch))
    for batch_size, cache_len in ((4, 64), (1, 48)):
        cache = jax.eval_shape(lambda: JT.init_cache(cfg, batch_size,
                                                     cache_len))
        for seq_shard in (False, True):
            assert _port(tsh.cache_shardings(tm, cache, cfg, seq_shard)) == \
                _specs(jsh.cache_shardings(jm, cache, cfg, seq_shard))


@pytest.mark.parametrize("shape,axes", MESHES)
def test_port_model_specs_are_jax_specs_less_the_stack_axis(shape, axes):
    """The port keeps one module a layer: a block leaf's spec is the JAX
    stacked leaf's without its leading (layer) dim."""
    jm, tm = _meshes(shape, axes)
    params = jax.eval_shape(lambda: JT.init_params(
        jax_get_config("smat-ffn-1.3b:smoke"), seed=0))
    want = _specs(jsh.param_shardings(jm, params))
    model = T.Transformer(get_config("smat-ffn-1.3b:smoke"), device="meta")
    got = tsh.param_shardings(tm, dict(model.named_parameters()))
    checked = 0
    for name, spec in got.items():       # the flat dict keeps its keys
        path = tuple(name.split("."))
        if path[0] == "blocks":           # blocks.<i>.<module>...<leaf>
            jpath = ("blocks",) + path[2:]
            assert tuple(spec) == want[jpath][1:], path
        else:
            assert tuple(spec) == want[path], path
        checked += 1
    assert checked == len(list(model.parameters()))


def test_constrain_is_the_identity_without_a_mesh():
    """The port runs no training mesh, so ``constrain`` returns its input,
    as the JAX package's does with no mesh active."""
    x = torch.arange(24.0).reshape(4, 6)
    jx = jax.numpy.asarray(x.numpy())
    for axes in ((None, tcon.BATCH + (tcon.MODEL,)), ("data",), ()):
        assert tcon.constrain(x, *axes) is x
        assert jcon.constrain(jx, *axes) is jx
    assert (tcon.BATCH, tcon.MODEL) == (jcon.BATCH, jcon.MODEL)

"""Load a JAX-package parameter tree into the port's model.

The JAX package stacks the layers on a leading ``[n_layers, ...]`` axis (it
scans them); the port keeps one module per layer.  Tests use this to run
both packages on the same dense weights: ``torch.Generator`` and
``jax.random`` draw different numbers from one seed, while the sparse FFN
structures and values come from numpy seeds and are equal anyway.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.sparse_linear import SHARDED_JAX_FIELDS
from repro_torch.kernels import ops
from repro_torch.launch import dist_spmm
from repro_torch.models import transformer as T


def _put(target: torch.Tensor, value) -> None:
    value = torch.from_numpy(np.array(value))
    if tuple(value.shape) != tuple(target.shape):
        raise ValueError(f"shape {tuple(value.shape)} does not fit "
                         f"{tuple(target.shape)}")
    target.copy_(value.to(target.dtype))


def _put_sparse(sparse, layer, i: int) -> None:
    """Layer ``i`` of a JAX sparse linear tree into a ``SparseLinear``: the
    JAX fields by name, then the port's own (``ops.PORT_FIELDS``) rebuilt
    from them; for a partitioned layer (``shard_*`` leaves, stacked
    ``[n_layers, S, ...]``) each shard's, through
    ``dist_spmm.shard_port_fields``."""
    sharded = "shard_src" in layer
    if sharded:
        want = {"vals", *SHARDED_JAX_FIELDS}
    else:
        want = set(ops.SparseArrays._fields) - set(ops.PORT_FIELDS)
    missing = want - set(layer)
    if missing:
        raise KeyError(f"the JAX layer lacks {sorted(missing)}")
    for field, value in layer.items():
        _put(getattr(sparse, field), value[i])
    meta = sparse.meta
    if sharded:
        rebuilt = dist_spmm.shard_port_fields(
            np.asarray(layer["shard_row_ids"][i]),
            np.asarray(layer["shard_col_ids"][i]),
            np.asarray(layer["shard_t_row_ids"][i]), meta)
        for field, value in rebuilt.items():
            _put(getattr(sparse, "shard_" + field), value)
        return
    rebuilt = ops.port_fields(
        np.asarray(layer["row_ids"][i]), np.asarray(layer["col_ids"][i]),
        np.asarray(layer["t_row_ids"][i]), meta.n_block_rows,
        meta.n_block_cols, meta.max_bpr)
    for field, value in rebuilt.items():
        _put(getattr(sparse, field), value)


def params_from_jax(cfg: ModelConfig, params_np, device) -> T.Transformer:
    """``params_np`` is the JAX ``init_params`` tree with every leaf a numpy
    array (pass bf16 leaves through float32).  Returns the port's
    ``Transformer`` on ``device`` holding the same values."""
    model = T.Transformer(cfg, device=T.resolve_device(device))
    blocks = params_np["blocks"]
    with torch.no_grad():
        for name in ("final_norm", "embed", "lm_head"):
            _put(getattr(model, name), params_np[name])
        for i, blk in enumerate(model.blocks):
            _put(blk.ln1, blocks["ln1"][i])
            _put(blk.ln2, blocks["ln2"][i])
            for name, value in blocks["attn"].items():
                _put(getattr(blk.attn, name), value[i])
            for name, layer in blocks["mlp"].items():
                if isinstance(layer, dict):          # a sparse linear layer
                    _put_sparse(getattr(blk.mlp, name), layer, i)
                else:
                    _put(getattr(blk.mlp, name), layer[i])
    return model

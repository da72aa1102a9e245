"""Sharding rules: parameter/optimizer/batch/cache partition specs.

Strategy (MaxText-style 2D: TP x FSDP), the JAX package's tables:
  * ``model`` axis: tensor parallelism -- attention heads, FFN hidden, MoE
    experts (EP), vocab, MLA per-head up-projections, BCSR nnz blocks.
  * ``data`` (+ ``pod``) axes: batch parallelism; additionally FSDP-shards
    every weight's non-TP major dim.
  * decode caches: batch over data axes, kv-heads over model; when kv-heads
    do not divide the model axis the cache SEQUENCE is sharded over
    ``model`` instead; ``seq_shard`` shards the sequence over the data axes
    too (sequence-parallel decode).

All rules are validated against tensor shapes: a mesh axis that does not
divide its dimension is dropped.

The functions return per-leaf specs and place nothing: a spec is a
``PartitionSpec``, a tuple holding, per dim, an axis name, a tuple of axis
names or None.  A tree is a (nested) mapping or sequence whose leaves have
a ``shape`` (tensors, numpy arrays); a flat mapping with dotted keys (a
module's ``named_parameters()``) is read as the nested one.  The port's
train loop runs on one card, so nothing in the port reads the param, opt,
batch and cache rules yet: they are held equal to the JAX package's for
the training mesh to come (ROADMAP A11).  ``spmm_shard_count`` is what the
partitioned SpMM path and ``SparsitySpec(reorder="shard_balance")`` read.
"""
from __future__ import annotations

from collections.abc import Mapping
from typing import Any

import numpy as np
import torch

from repro_torch.launch.mesh import axis_names, axis_sizes, data_axes


class PartitionSpec(tuple):
    """Per-dim mesh axes of one leaf (the JAX ``PartitionSpec``):
    ``PartitionSpec("data", None)`` shards dim 0 over ``data``.  As in
    JAX, a one-name tuple is stored as the name and an empty one as
    None."""

    def __new__(cls, *axes):
        def norm(a):
            if isinstance(a, tuple):
                return None if not a else a[0] if len(a) == 1 else a
            return a
        return super().__new__(cls, (norm(a) for a in axes))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec

# -------------------------------------------------------------- param rules
# spec given for the TRAILING dims; leading stack dims padded with None.
_PARAM_RULES = {
    # embeddings / head
    "embed": P("model", "data"),          # [V, D]
    "lm_head": P("data", "model"),        # [D, V]
    # attention
    "wq": P("data", "model"), "wk": P("data", "model"),
    "wv": P("data", "model"), "wo": P("model", "data"),
    "bq": P("model"), "bk": P("model"), "bv": P("model"),
    # MLA
    "wq_a": P("data", None), "wq_b": P(None, "model"),
    "wkv_a": P("data", None), "wkv_b": P(None, "model"),
    # dense / shared-expert MLP
    "w_gate": P("data", "model"), "w_up": P("data", "model"),
    "w_down": P("model", "data"),
    # MoE (experts on model = EP); router replicated on model
    "router": P("data", None),
    # SSD: FSDP on d_model; inner dims replicated
    "w_in": P("data", None), "w_out": P(None, "data"),
    "conv_w": P(None, None), "conv_b": P(None),
    "A_log": P(None), "D": P(None), "dt_bias": P(None),
    # norms
    "norm": P(None), "ln1": P(None), "ln2": P(None),
    "ln1_post": P(None), "ln2_post": P(None), "final_norm": P(None),
    "q_norm": P(None), "kv_norm": P(None),
    # BCSR sparse layer: REPLICATED (nnz-sharding over `model` would make
    # every sparse matmul reduce partial output rows across shards; the
    # block-sparse weights are small, so replication costs MBs)
    "vals": P(None, None, None),
    "row_ids": P(None), "col_ids": P(None), "real_mask": P(None),
    "t_perm": P(None), "t_row_ids": P(None), "t_col_ids": P(None),
    # reorder permutation leaves (core.permute): replicated
    "row_perm": P(None), "inv_perm": P(None),
    # partitioned-execution leaves (launch.dist_spmm, SparsitySpec.shards):
    # replicated index structure -- the row-shard axis lives in the
    # dedicated spmm mesh (use_spmm_mesh), not in the training mesh
    "shard_src": P(None, None), "shard_row_ids": P(None, None),
    "shard_col_ids": P(None, None), "shard_mask": P(None, None),
    "shard_t_perm": P(None, None), "shard_t_row_ids": P(None, None),
    "shard_t_col_ids": P(None, None), "gather_rows": P(None),
}

_MOE_EXPERT_LEAVES = {"w_gate", "w_up", "w_down"}  # [E, D, F] under "moe"


def _axis_size(mesh, a) -> int:
    if a is None:
        return 1
    sizes = axis_sizes(mesh)
    if isinstance(a, tuple):
        return int(np.prod([sizes[x] for x in a]))
    return int(sizes[a])


def _sanitize(mesh, a):
    """Drop axes not present in this mesh (small test meshes)."""
    if a is None:
        return None
    names = axis_names(mesh)
    if isinstance(a, tuple):
        kept = tuple(x for x in a if x in names)
        return kept if kept else None
    return a if a in names else None


def fit_spec(mesh, spec, shape) -> PartitionSpec:
    """Sanitize + enforce divisibility."""
    out = []
    for dim, a in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        a = _sanitize(mesh, a)
        if a is not None and dim % _axis_size(mesh, a) != 0:
            if isinstance(a, tuple):          # try a shrinking prefix
                while a and dim % _axis_size(mesh, a) != 0:
                    a = a[:-1]
                a = a or None
            else:
                a = None
        out.append(a)
    return P(*out)


def _shape(leaf) -> tuple:
    return tuple(int(s) for s in leaf.shape)


def _rule_for(path, leaf) -> PartitionSpec:
    keys = list(path)
    name = keys[-1]
    ndim = len(_shape(leaf))

    if name in _MOE_EXPERT_LEAVES and "moe" in keys and "shared" not in keys:
        base = {"w_gate": P("model", "data", None),
                "w_up": P("model", "data", None),
                "w_down": P("model", None, "data")}[name]
    elif name == "embed" and ndim >= 3:
        base = P(None, "model", "data")       # codebooks [ncb, V, D]
    elif name == "lm_head" and ndim >= 3:
        base = P(None, "data", "model")
    elif name in _PARAM_RULES:
        base = _PARAM_RULES[name]
    else:
        base = P()

    pad = ndim - len(base)
    if pad < 0:
        return P()
    return P(*([None] * pad + list(base)))


def _map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over a tree, keeping its structure; a dotted key
    of a mapping is read as nested keys (``"blocks.0.mlp.gate.vals"``)."""
    if isinstance(tree, Mapping):
        return {k: _map_with_path(
            fn, v, path + tuple(int(p) if p.isdigit() else p
                                for p in str(k).split(".")))
            for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def _batch_axes(mesh):
    da = data_axes(mesh)
    return da if len(da) > 1 else (da[0] if da else None)


def spmm_shard_count(mesh=None) -> int:
    """Number of shards a sparse layer's work is split across: the bin
    count ``SparsitySpec(reorder="shard_balance")`` balances nonzero-block
    loads over, and ``shards="auto"``'s cap.  The product of the mesh's
    axis sizes; with no mesh, the number of cards (1 on a machine without
    one)."""
    if mesh is None:
        return max(torch.cuda.device_count(), 1)
    return max(int(np.prod(list(axis_sizes(mesh).values()))), 1)


def _strip_data_axes(spec) -> PartitionSpec:
    """Serve-mode: weights are NOT FSDP-sharded; TP over ``model`` only,
    replicas across data axes."""
    def strip(a):
        if a is None:
            return None
        if isinstance(a, tuple):
            kept = tuple(x for x in a if x not in ("data", "pod"))
            return kept or None
        return None if a in ("data", "pod") else a
    return P(*[strip(a) for a in spec])


# serve-mode overrides: decode is weight-traffic bound, so layers whose
# train rule is FSDP-only get explicit inference TP
_SERVE_RULES = {
    "w_in": P("model", None),
    "w_out": P(None, "model"),
    "wq_a": P(None, "model"), "wkv_a": P(None, None),
    "router": P(None, None),
}


def param_shardings(mesh, params_or_specs, mode: str = "train") -> Any:
    def assign(path, leaf):
        keys = list(path)
        rule = _rule_for(path, leaf)
        if mode == "serve":
            name = keys[-1]
            is_expert = name in _MOE_EXPERT_LEAVES and "moe" in keys and \
                "shared" not in keys
            if is_expert:
                pass      # MoE expert banks stay FSDP-sharded
            elif name in _SERVE_RULES:
                base = _SERVE_RULES[name]
                rule = P(*([None] * (len(_shape(leaf)) - len(base))
                           + list(base)))
            else:
                rule = _strip_data_axes(rule)
        return fit_spec(mesh, rule, _shape(leaf))
    return _map_with_path(assign, params_or_specs)


def opt_state_shardings(mesh, opt_specs, params_shardings=None) -> Any:
    """m/v mirror the param shardings; scalar leaves replicated."""
    def assign(path, leaf):
        if len(_shape(leaf)) == 0:
            return P()
        # strip the leading "m"/"v" container key and reuse the param rule
        return fit_spec(mesh, _rule_for(path[1:], leaf), _shape(leaf))
    return _map_with_path(assign, opt_specs)


# ------------------------------------------------------------ batch / cache
def batch_shardings(mesh, batch_specs) -> Any:
    bd = _batch_axes(mesh)

    def assign(path, leaf):
        nd = len(_shape(leaf))
        return fit_spec(mesh, P(*([bd] + [None] * (nd - 1))), _shape(leaf))
    return _map_with_path(assign, batch_specs)


def cache_shardings(mesh, cache_specs_tree, cfg,
                    seq_shard: bool = False) -> Any:
    """Decode caches.  Layout conventions (after layer stacking):
       attn k/v:   [..., B, S, KV, dh]
       mla:        ckv [..., B, S, r] / krope [..., B, S, rope]
       ssd:        conv [..., B, cw-1, d_xbc]; state [..., B, H, P, N]
    seq_shard=True (single-request long-context): S takes the data axes."""
    bd = _batch_axes(mesh)
    sizes = axis_sizes(mesh)
    model_ok = "model" in sizes

    def assign(path, leaf):
        name = path[-1]
        shape = _shape(leaf)
        nd = len(shape)
        if name in ("k", "v"):
            B, S, KV, dh = shape[-4:]
            kv_axis = "model" if model_ok and KV % sizes["model"] == 0 \
                else None
            s_axes = []
            if seq_shard and bd is not None:
                s_axes += list(bd) if isinstance(bd, tuple) else [bd]
            if kv_axis is None and model_ok:
                s_axes.append("model")
            spec = [None] * (nd - 4) + [
                None if seq_shard else bd,
                tuple(s_axes) if s_axes else None,
                kv_axis, None]
        elif name in ("ckv", "krope"):
            s_axes = []
            if seq_shard and bd is not None:
                s_axes += list(bd) if isinstance(bd, tuple) else [bd]
            spec = [None] * (nd - 3) + [
                None if seq_shard else bd,
                tuple(s_axes) if s_axes else None, None]
        elif name == "conv":
            spec = [None] * (nd - 3) + [None if seq_shard else bd,
                                        None, None]
        elif name == "state":
            spec = [None] * (nd - 4) + [None if seq_shard else bd,
                                        None, None, None]
        else:
            # paged-KV page tables ("pages", "page_live") and anything
            # else: replicated
            spec = [None] * nd
        return fit_spec(mesh, P(*spec), shape)
    return _map_with_path(assign, cache_specs_tree)


def replicated(mesh, specs) -> Any:
    return _map_with_path(lambda path, leaf: P(), specs)

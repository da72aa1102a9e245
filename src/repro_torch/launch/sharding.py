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
module's ``named_parameters()``) is read as the nested one.  The rule
tables are held equal to the JAX package's; the training mesh
(``train.loop.train(cfg, shape, mesh)``) stores parameters and AdamW state
under ``param_shardings`` and ``opt_state_shardings`` and splits the batch
under ``batch_shardings``, and the dry-run divides each leaf's bytes by
them.  ``spmm_shard_count`` is what the partitioned SpMM path and
``SparsitySpec(reorder="shard_balance")`` read.

From a spec to a ``DTensor``: ``placements`` gives one placement a mesh
dim (``Shard(d)`` where tensor dim ``d`` names that axis, else
``Replicate()``; a tuple such as ``("pod", "data")`` shards one dim over
both, major to minor in mesh order, as JAX nests them), ``local_shard``
this rank's block of a full tensor (a view: no communication),
``shard_tensor`` a ``DTensor`` that owns a copy of that block, and
``distribute_tree`` does it for every leaf of a tree.  Back from a
``DTensor``: ``full`` gathers it whole (a collective), ``narrow_to``
to a spec that shards more (a view), ``local`` takes this rank's block (a
view); ``full`` and ``local`` pass a plain tensor through and map over a
nested mapping.

One data-sharded leaf at a time, for the mesh step's per-layer gather
(``data_sharded`` says which leaves are): ``gather_data`` gathers this
rank's block over the data axes its spec shards it on (one all-gather
over their group; ``whole=True`` gathers the ``model`` axis too; the mesh
step gathers a model-split parameter over the data axes only, every
other one whole), and
``scatter_grad`` takes a gradient whole over the data axes, each rank's
partial sum, back to this rank's block of the storage: one
reduce-scatter over the data group (pod-major), in the gradient's dtype.
"""
from __future__ import annotations

from collections.abc import Mapping
from typing import Any, List

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.launch.constrain import all_gather
from repro_torch.launch.mesh import (axes_group, axis_names, axis_sizes,
                                     data_axes, data_group)


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


def keep_axes(spec, axes) -> PartitionSpec:
    """``spec`` with every mesh axis outside ``axes`` dropped (the dims it
    sharded are then whole over those axes)."""
    def keep(a):
        if a is None:
            return None
        if isinstance(a, tuple):
            kept = tuple(x for x in a if x in axes)
            return kept or None
        return a if a in axes else None
    return P(*[keep(a) for a in spec])


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


# ------------------------------------------------------- specs -> DTensors
def _mesh_axes(mesh, a) -> tuple:
    """The mesh axes of one spec entry, checked to be in mesh order (a
    ``DTensor`` shards a dim over several mesh dims major to minor in mesh
    order only)."""
    axes = () if a is None else a if isinstance(a, tuple) else (a,)
    names = axis_names(mesh)
    if list(axes) != [n for n in names if n in axes]:
        raise ValueError(f"spec entry {a!r} is not in the mesh's axis order "
                         f"{names}")
    return axes


def placements(mesh, spec) -> List[Any]:
    """One ``DTensor`` placement a mesh dim: ``Shard(d)`` where tensor dim
    ``d`` of ``spec`` names that mesh axis, else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    names = axis_names(mesh)
    out = [Replicate() for _ in names]
    for d, a in enumerate(spec):
        for name in _mesh_axes(mesh, a):
            out[names.index(name)] = Shard(d)
    return out


def local_shard(mesh, t: torch.Tensor, spec) -> torch.Tensor:
    """This rank's block of the full tensor ``t`` under ``spec`` (a view;
    no communication): each dim sharded over mesh axes is cut into as many
    equal pieces as their sizes' product, and the rank takes the piece its
    coordinates give, major to minor (``fit_spec`` makes them divide)."""
    coord = dict(zip(axis_names(mesh), mesh.get_coordinate()))
    sizes = axis_sizes(mesh)
    for d, a in enumerate(spec):
        piece, n = 0, 1
        for name in _mesh_axes(mesh, a):
            piece, n = piece * sizes[name] + coord[name], n * sizes[name]
        if n > 1:
            if t.shape[d] % n:
                raise ValueError(f"dim {d} of {tuple(t.shape)} does not "
                                 f"divide into {n} pieces under {spec}")
            step = t.shape[d] // n
            t = t.narrow(d, piece * step, step)
    return t


def from_local(mesh, local: torch.Tensor, spec, shape):
    """The ``DTensor`` of global ``shape`` under ``spec`` whose block on this
    rank is ``local`` (its storage, not a copy)."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(
        local, mesh, placements(mesh, spec), run_check=False,
        shape=torch.Size(shape),
        stride=torch.empty(shape, device="meta").stride())


def shard_tensor(mesh, t: torch.Tensor, spec):
    """A ``DTensor`` of the full tensor ``t`` under ``spec`` whose local
    tensor is a copy of this rank's block (every rank holds the same
    ``t``; nothing is sent)."""
    local = local_shard(mesh, t, spec).clone(
        memory_format=torch.contiguous_format)
    return from_local(mesh, local, spec, t.shape)


def distribute_tree(mesh, tree, specs) -> Any:
    """``shard_tensor`` over every leaf of a (nested or flat) mapping of
    tensors, ``specs`` the same mapping of specs (``param_shardings``,
    ``opt_state_shardings`` or ``batch_shardings`` of it)."""
    if isinstance(tree, Mapping):
        return {k: distribute_tree(mesh, v, specs[k]) for k, v in tree.items()}
    return shard_tensor(mesh, tree, specs)


def _leafwise(fn, tree):
    if isinstance(tree, Mapping):
        return {k: _leafwise(fn, v) for k, v in tree.items()}
    return fn(tree)


def narrow_to(mesh, d, spec):
    """The ``DTensor`` ``d`` under ``spec``, which shards every mesh dim
    ``d`` shards (on the same tensor dim) and maybe more: this rank's block
    of ``d``'s local tensor (a view; no communication)."""
    from torch.distributed.tensor import Shard
    names = axis_names(mesh)
    have = {n for n, p in zip(names, d.placements) if isinstance(p, Shard)}
    more = P(*[tuple(a for a in _mesh_axes(mesh, e) if a not in have)
               for e in spec])
    return from_local(mesh, local_shard(mesh, d.to_local(), more), spec,
                      d.shape)


def _data_dim(mesh, spec):
    """``(dim, axes)``: the tensor dim ``spec`` shards over data axes and
    those axes in mesh order, or ``(None, ())``.  A parameter's spec
    shards at most one dim over them, and over no other axis."""
    data = data_axes(mesh)
    found = [(d, _mesh_axes(mesh, a)) for d, a in enumerate(spec)
             if set(_mesh_axes(mesh, a)) & set(data)]
    if not found:
        return None, ()
    (d, axes), = found
    if not set(axes) <= set(data):
        raise ValueError(f"dim {d} of {spec} mixes data and other axes")
    return d, axes


def data_sharded(mesh, spec) -> bool:
    """True where ``spec`` shards a dim over data axes of more than one
    rank (the mesh step gathers such a leaf one layer at a time)."""
    d, axes = _data_dim(mesh, spec)
    return d is not None and _axis_size(mesh, axes) > 1


def gather_over(mesh, local: torch.Tensor, spec, axes) -> torch.Tensor:
    """This rank's block ``local`` of a tensor under ``spec`` gathered over
    the mesh ``axes``: one all-gather for each dim sharded over any of them,
    over their group (``launch.mesh.axes_group``, whose ranks run major to
    minor in mesh order, the order of the blocks).  A dim sharded over
    these and other axes keeps its block over the others, which must be
    the major ones.  ``local`` itself where nothing is gathered."""
    out = local
    for e, a in enumerate(spec):
        on = _mesh_axes(mesh, a)
        mine = tuple(x for x in on if x in axes)
        if not mine:
            continue
        if on[len(on) - len(mine):] != mine:
            raise ValueError(f"dim {e} of {spec}: a gather over {mine} "
                             f"leaves a minor axis of {on} sharded")
        group, _, size = axes_group(mesh, mine)
        if size > 1:
            out = all_gather(out, e, group, size)
    return out


def gather_data(mesh, local: torch.Tensor, spec,
                whole: bool = False) -> torch.Tensor:
    """This rank's block ``local`` of a leaf under ``spec`` gathered over
    the data axes its spec shards it on (one all-gather over their group,
    its ``model`` shard kept), and with ``whole`` over ``model`` too (a
    second all-gather): the full tensor."""
    return gather_over(mesh, local, spec,
                       data_axes(mesh) + (("model",) if whole else ()))


def scatter_grad(mesh, grad: torch.Tensor, spec) -> torch.Tensor:
    """This rank's block, under ``spec``, of the sum over the data group of
    ``grad``: each rank's gradient of a leaf that ``spec`` shards over data
    axes, whole over those axes (its ``model`` block already taken).  One
    reduce-scatter over the data group, whose ranks are ordered pod-major:
    rank ``i`` receives the block its coordinates on the spec's data axes
    give (a gradient sharded on dim 0 is reduced in place, with no copy).
    Where the mesh has a data axis the spec leaves unsharded (a ``pod``
    axis; ``spec`` shards over ``data`` only), ranks that differ only there
    hold the same block: each block is reduced in flat pieces, one a rank,
    and the pieces are all-gathered over those axes.  The sum runs in the
    gradient's dtype, as ``launch.constrain.psum_data`` sums the others."""
    d, axes = _data_dim(mesh, spec)
    group, _, size = data_group(mesh)
    data = data_axes(mesh)
    sizes = axis_sizes(mesh)
    rest = tuple(a for a in data if a not in axes)
    blocks = grad.chunk(_axis_size(mesh, axes), dim=d)
    n_rest = size // len(blocks)
    numel = blocks[0].numel()
    if n_rest == 1:                  # rank i takes block i
        piece = numel
        buf = grad.reshape(-1) if d == 0 else torch.stack(blocks).reshape(-1)
    else:
        piece = -(-numel // n_rest)
        buf = grad.new_zeros((size * piece,))
        for i in range(size):
            coord = dict(zip(data, np.unravel_index(
                i, [sizes[a] for a in data])))
            b = int(np.ravel_multi_index([coord[a] for a in axes],
                                         [sizes[a] for a in axes]))
            r = int(np.ravel_multi_index([coord[a] for a in rest],
                                         [sizes[a] for a in rest]))
            flat = blocks[b].reshape(-1)[r * piece:(r + 1) * piece]
            buf[i * piece:i * piece + flat.numel()].copy_(flat)
    out = buf.new_empty((piece,))
    dist.reduce_scatter_tensor(out, buf, group=group)
    if n_rest > 1:
        r_group, _, _ = axes_group(mesh, rest)
        out = all_gather(out, 0, r_group, n_rest)[:numel]
    return out.view(blocks[0].shape)


def _full(d) -> torch.Tensor:
    from torch.distributed.tensor import Replicate, Shard
    mesh, names = d.device_mesh, axis_names(d.device_mesh)
    dims = [() for _ in range(d.dim())]
    for name, p in zip(names, d.placements):
        if isinstance(p, Shard):
            dims[p.dim] += (name,)
        elif not isinstance(p, Replicate):
            raise ValueError(f"cannot gather a {p} placement")
    return gather_over(mesh, d.to_local(), P(*[a or None for a in dims]),
                       names)


def full(tree) -> Any:
    """Every ``DTensor`` leaf of ``tree`` (or ``tree`` itself) gathered to
    its full tensor (a collective: every rank of its mesh calls it, in the
    same order; ``gather_over`` every axis, not ``DTensor.full_tensor``,
    which crashed over gloo with CUDA tensors); any other leaf as it is."""
    return _leafwise(lambda t: _full(t) if hasattr(t, "full_tensor")
                     else t, tree)


def local(tree) -> Any:
    """Every ``DTensor`` leaf of ``tree`` (or ``tree`` itself) as this
    rank's block (a view of its storage: in-place updates land in the
    shard); any other leaf as it is."""
    return _leafwise(lambda t: t.to_local() if hasattr(t, "to_local")
                     else t, tree)

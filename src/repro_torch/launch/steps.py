"""Step functions (train / prefill / decode), the ones the train loop and
serving run.

Sparse-FFN archs need no special handling here: each sparse layer holds its
static meta, and ``ops.spmm``'s backward runs the kernels (``bcsr_spmm``
for dB, ``bcsr_sddmm`` for dvals).  Neither do block-sparse attention archs
(``smat-attn-1.3b``): training and prefill run kernel B5 through
``models.attention``, whose backward runs the SDDMM/SpMM kernels, and
decode applies the mask as a bias.  Every other layout and input mode runs
the same steps; ``T.train_loss`` adds the MoE load-balance loss of
``mla_moe`` and scores only the text positions of ``tokens+patches``.
``input_specs`` and ``opt_specs`` give
a cell's inputs and AdamW state as ``meta``-device tensors (shape and dtype
only), for the dry-run (``launch.dryrun``).

Under a training mesh (``make_train_step(..., mesh=mesh)``) the step runs
gather-then-compute over ZeRO-3 storage: a ``MeshModel`` (``shard_model``)
stores each parameter as a ``DTensor`` under
``launch.sharding.param_shardings`` and AdamW's moments under
``opt_state_shardings`` (``init_opt_state``).  A step gathers the
parameters, runs the model forward and backward on this rank's batch rows
(the kernels get plain local tensors), sums the gradients, clips with the
norm of the full gradient, and updates each rank's own shard of
parameters and moments.

Where the ``model`` axis has more than one rank and divides the sequence,
the compute splits over it, as the JAX package's sharding rules and
``constrain`` calls have GSPMD do for every layout and input
(``split_leaves``; ``launch.constrain.use_mesh(mesh, split=True)``): the
head-, hidden-, expert- and vocab-sharded leaves are gathered over the
data axes only, so each rank computes with its ``model`` shard of
``wq``/``wk``/``wv``/``wo`` (both halves of a ``gemma_pair`` block,
``zamba``'s shared block), the dense FFN's ``w_gate``/``w_up``/``w_down``,
MLA's ``wq`` (or ``wq_b``), ``wkv_b`` and ``wo``, the routed experts' bank
(``gather`` dispatch) and the shared experts' hidden columns, ``embed``
and ``lm_head`` (each codebook's table too); the residual stream is
carried sequence-split (``tokens+patches``: the patch positions and the
text); the block-sparse FFN runs its B1/B2 on the rank's tokens against
replicated BCSR weights, B5 and the attention backward's batched products
on its heads; the Mamba2 mixer runs the whole sequence on every rank.  A
split leaf's gradient is summed over the data group; a replicated leaf's
(norms, ``vals``, ``wk``/``wv`` where the axis does not divide the kv
heads, MLA's ``wkv_a``/``wq_a``, the router, every Mamba2 leaf) over the
data and model groups.  A ``model`` axis of one rank, and a sequence the
axis does not divide, gather every parameter whole and replicate the
compute over ``model``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ModelConfig, ShapeCell
from repro_torch.core.sparse_linear import meta_spec as _spec
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import sharding as sh
from repro_torch.launch.constrain import psum_data, psum_model, use_mesh
from repro_torch.models import transformer as T
from repro_torch.optim import adamw


def input_specs(cfg: ModelConfig, shape: ShapeCell) -> Dict[str, torch.Tensor]:
    """Every model input of this cell as a ``meta``-device tensor: the JAX
    package's ``input_specs``, with the ids int64, as the port feeds them
    (``train.loop.batch_to_device``, the serving engine).  Train cells
    hold ``tokens`` and ``labels`` [B, L] ([B, L, n_cb] for
    ``codebooks``; [B, L - P] beside ``patch_embeds`` [B, P, D] in bf16
    for ``tokens+patches``), prefill the same less ``labels``, decode one
    token a sequence [B] ([B, n_cb])."""
    T._check_layout(cfg)
    B, L = shape.global_batch, shape.seq_len
    ids = torch.int64
    if shape.kind in ("train", "prefill"):
        if cfg.input_mode == "codebooks":
            batch = {"tokens": _spec((B, L, cfg.n_codebooks), ids),
                     "labels": _spec((B, L, cfg.n_codebooks), ids)}
        elif cfg.input_mode == "tokens+patches":
            lt = L - cfg.patch_tokens
            batch = {"tokens": _spec((B, lt), ids),
                     "patch_embeds": _spec((B, cfg.patch_tokens,
                                            cfg.d_model), torch.bfloat16),
                     "labels": _spec((B, lt), ids)}
        else:
            batch = {"tokens": _spec((B, L), ids),
                     "labels": _spec((B, L), ids)}
        if shape.kind == "prefill":
            batch.pop("labels")
        return batch
    if cfg.input_mode == "codebooks":
        return {"tokens": _spec((B, cfg.n_codebooks), ids)}
    return {"tokens": _spec((B,), ids)}


def opt_specs(cfg: ModelConfig, params_specs) -> Dict[str, object]:
    """``optim.adamw.init``'s state for these parameter specs (the nested
    ``models.transformer.param_specs`` tree or a flat mapping): float32
    ``m`` and ``v`` beside every floating leaf, keyed by its
    ``named_parameters()`` name, and a 0-d int32 ``step``."""
    flat = T.flat_specs(params_specs)
    zeros = {name: _spec(p.shape, torch.float32)
             for name, p in flat.items() if p.is_floating_point()}
    return {"m": zeros,
            "v": {name: _spec(z.shape, torch.float32)
                  for name, z in zeros.items()},
            "step": _spec((), torch.int32)}


# ------------------------------------------------------------ mesh storage
@dataclasses.dataclass
class MeshModel:
    """A model stored under a training mesh.  ``shards`` holds each
    parameter as a ``DTensor`` under ``specs`` (its
    ``launch.sharding.param_shardings`` spec): the parameters' storage.
    ``module`` holds the buffers (the sparse layers' index arrays, which the
    rules replicate) and, during a step only, the gathered parameters; its
    parameters are empty between steps."""
    module: T.Transformer
    mesh: Any
    specs: Dict[str, Any]
    shards: Dict[str, Any]

    def state_dict(self) -> Dict[str, Any]:
        """``module.state_dict()``'s keys in its order, each parameter its
        ``DTensor``: a checkpoint of it gathers to the unsharded bytes."""
        return {k: self.shards.get(k, v)
                for k, v in self.module.state_dict().items()}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        """Take ``state``'s parameters (``DTensor``s) as the shards and copy
        its buffers into the module."""
        self.shards.update({k: state[k] for k in self.shards})
        self.module.load_state_dict(
            {k: v for k, v in state.items() if k not in self.shards},
            strict=False)


def _release(p: torch.Tensor) -> None:
    """Drop a module parameter's full storage (the shards keep it)."""
    p.data = p.data.new_empty(0)


def shard_model(module: T.Transformer, mesh) -> MeshModel:
    """Store ``module``'s parameters under ``mesh``'s parameter rules (each
    rank a copy of its block; every rank holds the same ``module``) and
    release their full storage."""
    params = dict(module.named_parameters())
    specs = sh.param_shardings(mesh, params)
    shards = sh.distribute_tree(
        mesh, {n: p.detach() for n, p in params.items()}, specs)
    for p in params.values():
        _release(p)
    return MeshModel(module, mesh, specs, shards)


def opt_shardings(mesh, opt_state) -> Dict[str, Any]:
    """``launch.sharding.opt_state_shardings`` of an AdamW state (full
    tensors or ``DTensor``s, read for their global shapes)."""
    like = {k: ({n: torch.empty(t.shape, device="meta")
                 for n, t in v.items()} if isinstance(v, dict)
                else torch.empty(v.shape, device="meta"))
            for k, v in opt_state.items()}
    return sh.opt_state_shardings(mesh, like)


def init_opt_state(model: MeshModel) -> Dict[str, Any]:
    """``adamw.init`` of the shards: ``m`` and ``v`` as ``DTensor``s under
    ``opt_state_shardings`` (each rank zeros of its block), ``step``
    replicated."""
    mesh, shards = model.mesh, model.shards
    local = adamw.init({n: d.to_local() for n, d in shards.items()})
    specs = opt_shardings(mesh, {"m": shards, "v": shards,
                                 "step": local["step"]})
    moments = {k: {n: sh.from_local(mesh, t, specs[k][n], shards[n].shape)
                   for n, t in local[k].items()} for k in ("m", "v")}
    return {**moments,
            "step": sh.from_local(mesh, local["step"], specs["step"], ())}


def state_specs(model: MeshModel, opt_state) -> Dict[str, Any]:
    """The spec of every leaf of ``{"params": model.state_dict(), "opt":
    opt_state}`` (None for the buffers, which stay whole): what
    ``CheckpointManager.restore(..., mesh=model.mesh, specs=)`` distributes
    a restored checkpoint under, on this mesh whatever mesh wrote it."""
    return {"params": {k: model.specs.get(k) for k in model.state_dict()},
            "opt": opt_shardings(model.mesh, opt_state)}


# the leaves the split computes on their ``model`` shard, keyed by their
# module's name and their own (the last two parts of the path: the rules
# tell the routed expert bank ``moe.w_gate`` from the shared experts'
# ``shared.w_gate`` and the dense FFN's ``mlp.w_gate`` so), each with the
# head counts the ``model`` axis must divide too (the JAX fit rule on the
# activations: a dim of heads x head_dim can divide where the heads do
# not; vocab, hidden and expert dims are the weight's own, which
# ``param_shardings``' fit rule already holds)
_SPLIT_DIMS = {
    ("", "embed"): (), ("", "lm_head"): (),
    **{("attn", n): ("n_heads",) for n in ("wq", "bq", "wo")},
    **{("attn", n): ("n_heads", "n_kv_heads")
       for n in ("wk", "bk", "wv", "bv")},
    **{("mla", n): ("n_heads",) for n in ("wq", "wq_b", "wkv_b", "wo")},
    **{(module, n): () for module in ("mlp", "moe", "shared")
       for n in ("w_gate", "w_up", "w_down")},
}


def split_leaves(cfg: ModelConfig, mesh, specs: Dict[str, Any],
                 seq_len: int) -> frozenset:
    """Names of the parameters the mesh step computes on their ``model``
    shard (``specs``: the parameters' ``param_shardings``; ``seq_len``:
    the carry's positions, ``tokens+patches``' patches included): the
    head-, hidden-, expert- and vocab-sharded leaves of ``_SPLIT_DIMS``
    (the routed experts' bank with the ``gather`` dispatch only: the JAX
    package constrains nothing in the ``einsum`` one), each where the
    ``model`` axis divides its dims, when that axis has more than one rank
    and divides the sequence (the carry is split over it).  Empty
    otherwise: the step then gathers every parameter whole and replicates
    the compute over ``model``."""
    m = mesh_lib.axis_sizes(mesh).get("model", 1)
    if m == 1 or seq_len % m:
        return frozenset()

    def splits(name, spec):
        parts = name.split(".")
        key = (parts[-2] if len(parts) > 1 else "", parts[-1])
        dims = _SPLIT_DIMS.get(key)
        if dims is None or key[0] == "moe" and cfg.moe_dispatch != "gather":
            return False
        return "model" in sh.keep_axes(spec, ("model",)) and \
            all(getattr(cfg, f) % m == 0 for f in dims)
    return frozenset(n for n, spec in specs.items() if splits(n, spec))


def mesh_loss_and_grads(cfg: ModelConfig, model: MeshModel, batch: Dict,
                        remat: str = "full"):
    """The mesh step's forward and backward: gather the parameters into
    the module, run ``T.train_loss`` on this rank's rows of ``batch``
    (``DTensor`` leaves under ``batch_shardings``, or local tensors),
    release the gathered parameters, and sum the gradients and the loss
    terms over the data group.  Returns ``(metrics, grads)``: the global
    ``loss``, ``lm_loss`` and ``aux_loss``, and the full gradient of the
    global loss by parameter name.

    Where ``split_leaves`` names leaves, the compute is split over
    ``model`` (``use_mesh(..., split=True)``): those leaves are gathered
    over the data axes only (``gather_to``; each rank keeps its ``model``
    shard) and their gradients, summed over the data group, come back as
    ``DTensor``s sharded over ``model`` (the shard on each rank); every
    other leaf is gathered whole and its gradient, the rank's share (its
    positions, its heads), is summed over the model group too.  Otherwise
    every parameter is gathered whole (``DTensor.full_tensor``) and the
    compute is replicated over ``model``."""
    mesh = model.mesh
    params = dict(model.module.named_parameters())
    batch = sh.local(batch)
    seq = batch["tokens"].shape[1] + (batch["patch_embeds"].shape[1]
                                      if "patch_embeds" in batch else 0)
    split = split_leaves(cfg, mesh, model.specs, seq)
    keep = {n: sh.keep_axes(model.specs[n], ("model",)) for n in split}
    with use_mesh(mesh, split=bool(split)):
        for name, p in params.items():
            d = model.shards[name]
            p.data = sh.gather_to(mesh, d, keep[name]) if name in split \
                else d.full_tensor()
            p.grad = None
        loss, parts = T.train_loss(cfg, model.module, batch, remat=remat)
        loss.backward()
        grads = {n: p.grad for n, p in params.items()}
        for p in params.values():
            p.grad = None
            _release(p)
        names = [n for n, g in grads.items() if g is not None]
        terms = [t.detach().float() for t in (loss, *parts.values())]
        *summed, total = psum_data([*(grads[n] for n in names),
                                    torch.stack(terms)])
        whole = [i for i, n in enumerate(names) if n not in split]
        for i, g in zip(whole, psum_model([summed[i] for i in whole])):
            summed[i] = g
    grads.update(zip(names, summed))
    for name in split:
        if grads[name] is not None:
            grads[name] = sh.from_local(mesh, grads[name], keep[name],
                                        model.shards[name].shape)
    metrics = dict(zip(("loss", *parts), total.unbind()))
    return metrics, grads


def _split_norm(mesh, grads) -> torch.Tensor:
    """The full gradient's norm, for ``mesh_loss_and_grads``' gradients:
    ``adamw.global_norm`` where no leaf is split over ``model``; else each
    split leaf's shard counted on its rank and summed over the model
    group, and each whole leaf once."""
    split = {n: g for n, g in grads.items() if isinstance(g, DTensor)}
    if not split:
        return adamw.global_norm(grads)
    sq = adamw.sum_squares({n: g.to_local() for n, g in split.items()})
    group = mesh_lib.model_group(mesh)[0]
    torch.distributed.all_reduce(sq, group=group)
    rest = {n: g for n, g in grads.items() if n not in split}
    return torch.sqrt(sq + adamw.sum_squares(rest))


def make_train_step(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig,
                    remat: str = "full", mesh: Optional[Any] = None):
    """``train_step(model, opt_state, batch) -> (model, opt_state,
    metrics)``: loss and gradients of ``T.train_loss``, then one AdamW
    update of the model's parameters, in place.  ``batch`` holds ``tokens``
    and ``labels`` tensors on the model's device; the metrics are 0-d
    tensors (``loss``, ``lm_loss``, ``aux_loss``, ``grad_norm``, ``lr``),
    read without a host sync.

    With ``mesh`` the model is a ``MeshModel`` on that mesh, ``opt_state``
    ``init_opt_state``'s and ``batch`` ``DTensor``s under
    ``batch_shardings`` (or this rank's rows): the step gathers, computes
    (``mesh_loss_and_grads``), clips with the full gradient's norm and
    updates this rank's shards; the metrics are the global ones."""
    if mesh is not None:
        def mesh_step(model: MeshModel, opt_state, batch: Dict):
            if model.mesh is not mesh:
                raise ValueError("the model is stored on another mesh")
            metrics, grads = mesh_loss_and_grads(cfg, model, batch, remat)
            gnorm = _split_norm(mesh, grads)
            data = mesh_lib.data_axes(mesh)
            local_grads = {
                n: None if g is None else
                sh.local_shard(mesh, g.to_local(),
                               sh.keep_axes(model.specs[n], data))
                if isinstance(g, DTensor) else
                sh.local_shard(mesh, g, model.specs[n])
                for n, g in grads.items()}
            state = sh.local(opt_state)
            _, state, om = adamw.update(opt_cfg, local_grads, state,
                                        sh.local(model.shards),
                                        grad_norm=gnorm)
            opt_state["step"] = sh.from_local(mesh, state["step"], sh.P(),
                                              ())
            return model, opt_state, {**metrics, **om}
        return mesh_step

    def train_step(model: T.Transformer, opt_state, batch: Dict):
        params = dict(model.named_parameters())
        for p in params.values():
            p.grad = None
        loss, parts = T.train_loss(cfg, model, batch, remat=remat)
        loss.backward()
        grads = {name: p.grad for name, p in params.items()}
        _, opt_state, om = adamw.update(opt_cfg, grads, opt_state, params)
        for p in params.values():
            p.grad = None                    # free the gradients' memory
        metrics = {"loss": loss.detach(),
                   **{k: v.detach() for k, v in parts.items()}, **om}
        return model, opt_state, metrics
    return train_step


def make_prefill_step(cfg: ModelConfig, cache_len: int):
    def prefill_step(model: T.Transformer, batch):
        with torch.no_grad():
            logits, cache = T.prefill(cfg, model, batch, cache_len)
        # just the last-position logits (what serving samples from)
        return logits[:, -1], cache
    return prefill_step


def make_decode_step(cfg: ModelConfig):
    def serve_step(model: T.Transformer, cache, tokens, pos):
        with torch.no_grad():
            return T.decode_step(cfg, model, cache, tokens, pos)
    return serve_step

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
over ZeRO-3 storage: a ``MeshModel`` (``shard_model``) stores each
parameter as a ``DTensor`` under ``launch.sharding.param_shardings`` and
AdamW's moments under ``opt_state_shardings`` (``init_opt_state``).  A
step runs the model forward and backward on this rank's batch rows (the
kernels get plain local tensors) and gathers the data-sharded parameters
one group at a time, as the JAX package's scanned step does under GSPMD:
a block (a ``gemma_pair`` pair; for ``zamba`` a Mamba2 layer, the shared
block at each use, a tail layer), ``embed``, the head, each gathered just
before it runs and dropped after, gathered again for its backward, its
gradients reduce-scattered over the data group to the rank's blocks
(``mesh_loss_and_grads``, ``_LayerGather``; ``RECORD`` counts it).  The
step then clips with the norm of the full gradient, taken over every
rank's blocks, and updates each rank's own shard of parameters and
moments.  A data group of one rank, and a batch the data axes do not
divide (replicated), keep the whole-model step: every parameter gathered
for the step, the gradients summed whole (on one data rank the unsharded
step bit for bit).

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
compute over ``model``.  Under both splits a data-sharded leaf's gradient
is reduce-scattered over the data group; a leaf computed whole is summed
over the model group too: before its scatter where its spec shards it
over ``model`` (each rank's share is of the whole leaf, so the sum comes
before the rank's ``model`` block is taken), after it otherwise.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, NamedTuple, Optional

import torch
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ModelConfig, ShapeCell
from repro_torch.core.sparse_linear import meta_spec as _spec
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import sharding as sh
from repro_torch.launch.constrain import (gathering, model_split, psum_data,
                                          psum_model, use_mesh)
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
    rules replicate) and, during a step only, the parameters gathered for
    the whole step (the data-sharded ones come in one group at a time,
    ``mesh_loss_and_grads``); its parameters are empty between steps."""
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


# the last mesh step's per-layer gather: plain integers, as the kernels
# keep their launch counts (``reset_record`` zeroes them): ``gathers``
# and ``regathers`` count leaves gathered over the data axes in the
# forward and again in the backward, ``reduce_scatters`` gradients
# reduce-scattered over the data group, ``all_reduces`` gradients summed
# whole over a data group of more than one rank; ``peak_bytes`` is the
# largest count of gathered parameter bytes alive at once on the rank,
# ``group_bytes`` the largest group's gathered bytes
RECORD: Dict[str, int] = dict.fromkeys(
    ("gathers", "regathers", "reduce_scatters", "all_reduces",
     "peak_bytes", "group_bytes"), 0)
# the same step's collectives one by one, kept only where a check turns
# them on (``EVENTS = []``; None keeps nothing): ``("gather", phase, group,
# leaves, alive)`` (``alive``: every leaf gathered on the rank just after
# it), ``("reduce_scatter", leaf)``, ``("all_reduce", leaf)``
EVENTS: Optional[list] = None


def reset_record() -> None:
    RECORD.update(dict.fromkeys(RECORD, 0))
    if EVENTS is not None:
        EVENTS.clear()


def _event(*event) -> None:
    if EVENTS is not None:
        EVENTS.append(event)


class _Saved(NamedTuple):
    """What autograd keeps of a gathered weight it saves: the leaf, the
    group, and the view's geometry on the gathered tensor."""
    group: str
    name: str
    size: torch.Size
    stride: tuple
    offset: int


class _Gather(torch.autograd.Function):
    """A leaf's gather over the data axes (forward), and its gradient's
    reduce-scatter back to the rank's block (backward)."""

    @staticmethod
    def forward(ctx, local, layers, name, use):
        ctx.layers, ctx.name, ctx.use = layers, name, use
        return layers.gather(name)

    @staticmethod
    def backward(ctx, grad):
        return ctx.layers.reduce(ctx.name, ctx.use, grad), None, None, None


class _LayerGather:
    """The per-layer gather of one mesh step over the leaves ``names``
    (data-sharded, data group of more than one rank): ``group`` is what
    ``launch.constrain.gathered`` enters.  ``leaves`` holds each leaf's
    block of the storage as a tensor that takes the gradient; ``whole``
    names the leaves computed whole (the others keep their ``model``
    shard); ``summed`` those of them whose gradient was summed over the
    model group before its scatter (a split's shares of a leaf sharded
    over ``model``)."""

    def __init__(self, model: "MeshModel", names, whole):
        self.mesh, self.specs, self.whole = model.mesh, model.specs, whole
        root = model.module
        self.prefix = {id(m): n + "." if n else ""
                       for n, m in root.named_modules()}
        self.owner = {}
        for n in names:
            path, _, attr = n.rpartition(".")
            self.owner[n] = (root.get_submodule(path), attr)
        self.leaves = {n: model.shards[n].to_local().detach()
                       .requires_grad_() for n in names}
        self.backward_phase = False
        self.live = {}        # storage address -> (group, leaf), forward
        self.groups = {}      # group -> its leaves
        self.uses = dict.fromkeys(names, 0)   # forward uses to backward
        self.pending = {}     # forward use -> leaves whose gradient is due
        self.acc = {}         # leaf -> its summed gradient (shared block)
        self.summed = set()
        self.held = None      # (group, tensors, bytes) for a backward
        self.alive = 0
        self.n_uses = 0

    # ---------------------------------------------------------- gathers
    def gather(self, name) -> torch.Tensor:
        RECORD["regathers" if self.backward_phase else "gathers"] += 1
        return sh.gather_data(self.mesh, self.leaves[name].detach(),
                              self.specs[name], whole=name in self.whole)

    def _note(self, group, fulls, alive_names) -> int:
        nbytes = sum(t.numel() * t.element_size() for t in fulls.values())
        self.alive += nbytes
        RECORD["peak_bytes"] = max(RECORD["peak_bytes"], self.alive)
        RECORD["group_bytes"] = max(RECORD["group_bytes"], nbytes)
        if EVENTS is not None:
            _event("gather", "backward" if self.backward_phase else
                   "forward", group, tuple(sorted(fulls)),
                   tuple(sorted(alive_names)))
        return nbytes

    def _release_held(self) -> None:
        if self.held is not None:
            self.alive -= self.held[2]
            self.held = None

    def _regather(self, group) -> dict:
        """The group's leaves gathered for its backward (each group's
        backward in turn; the one before is dropped)."""
        self._release_held()
        fulls = {n: self.gather(n) for n in self.groups[group]}
        self.held = (group, fulls, self._note(group, fulls, fulls))
        return fulls

    @contextlib.contextmanager
    def group(self, module, names):
        prefix = self.prefix[id(module)]
        group = prefix + "+".join(names) if names else prefix.rstrip(".")
        leaves = [prefix + n for n in names] if names else \
            [prefix + n for n, _ in module.named_parameters()]
        mine = [n for n in leaves if n in self.leaves]
        if not mine:
            yield
            return
        self.groups[group] = mine
        if self.backward_phase:      # a checkpoint's recompute
            self._release_held()
            use = None
        else:
            use, self.n_uses = self.n_uses, self.n_uses + 1
            self.pending[use] = set(mine)
            for n in mine:
                self.uses[n] += 1
        fulls = {n: _Gather.apply(self.leaves[n], self, n, use)
                 for n in mine}
        if self.backward_phase:
            self.held = (group, None, self._note(group, fulls, fulls))
        else:
            alive = [n for _, n in self.live.values()] + mine
            nbytes = self._note(group, fulls, alive)
            self.live.update({t.untyped_storage().data_ptr(): (group, n)
                              for n, t in fulls.items()})
        params = {n: self.owner[n][0]._parameters[self.owner[n][1]]
                  for n in mine}
        for n in mine:
            owner, attr = self.owner[n]
            owner._parameters[attr] = fulls[n]
        try:
            yield
        finally:
            for n in mine:
                owner, attr = self.owner[n]
                owner._parameters[attr] = params[n]
            if not self.backward_phase:
                for t in fulls.values():
                    del self.live[t.untyped_storage().data_ptr()]
                self.alive -= nbytes

    # ------------------------------------------------ autograd's saved
    def _pack(self, t):
        if not self.live or t.numel() == 0:
            return t
        hit = self.live.get(t.untyped_storage().data_ptr())
        if hit is None:
            return t
        return _Saved(*hit, t.size(), t.stride(), t.storage_offset())

    def _unpack(self, saved):
        if not isinstance(saved, _Saved):
            return saved
        held = self.held
        fulls = held[1] if held is not None and held[0] == saved.group \
            and held[1] is not None else self._regather(saved.group)
        return fulls[saved.name].as_strided(saved.size, saved.stride,
                                            saved.offset)

    # -------------------------------------------------------- gradients
    def reduce(self, name, use, grad):
        """A forward use's gradient of ``name``: summed into the leaf's
        other uses' until its last in the backward (a shared block's first
        in the forward), then reduce-scattered to the rank's block."""
        self.uses[name] -= 1
        out = None
        if self.uses[name]:
            self.acc[name] = grad if name not in self.acc \
                else self.acc[name] + grad
        else:
            if name in self.acc:
                grad = self.acc.pop(name) + grad
            spec = self.specs[name]
            if name in self.whole:       # its model block (a view)
                model = sh.keep_axes(spec, ("model",))
                if "model" in model and model_split() is not None:
                    # each model rank's share (its positions): summed
                    # before the block is taken
                    grad, = psum_model([grad])
                    self.summed.add(name)
                grad = sh.local_shard(self.mesh, grad, model)
            out = sh.scatter_grad(self.mesh, grad, spec)
            RECORD["reduce_scatters"] += 1
            _event("reduce_scatter", name)
        due = self.pending[use]
        due.discard(name)
        if not due:                  # the group's backward is done
            self._release_held()
        return out

    @contextlib.contextmanager
    def forward(self):
        with gathering(self), torch.autograd.graph.saved_tensors_hooks(
                self._pack, self._unpack):
            yield

    @contextlib.contextmanager
    def backward(self):
        self.backward_phase = True
        try:
            with gathering(self):
                yield
        finally:
            self._release_held()


def _divided(mesh, batch) -> bool:
    """Whether ``batch`` (``DTensor`` leaves, or this rank's rows) is split
    over a data group of more than one rank."""
    if mesh_lib.data_group(mesh)[2] == 1:
        return False
    tokens = batch["tokens"]
    return not isinstance(tokens, DTensor) or \
        tokens.to_local().shape[0] < tokens.shape[0]


def mesh_loss_and_grads(cfg: ModelConfig, model: MeshModel, batch: Dict,
                        remat: str = "full"):
    """The mesh step's forward and backward on this rank's rows of
    ``batch`` (``DTensor`` leaves under ``batch_shardings``, or local
    tensors).  Returns ``(metrics, grads)``: the global ``loss``,
    ``lm_loss`` and ``aux_loss`` and the norm of the global loss's full
    gradient (``grad_norm``), and that gradient by parameter name, each a
    ``DTensor`` under the leaf's ``param_shardings`` spec (this rank's
    block of it), as the JAX package's step returns it
    (``out_shardings``).

    Under a data group of more than one rank and a batch split over it,
    the data-sharded leaves (``sharding.data_sharded``) are gathered one
    group at a time (``_LayerGather``): the model marks each group it
    runs (``launch.constrain.gathered``: a block, ``zamba``'s shared
    block at each use, ``embed``, the head), the group's leaves are
    gathered there (``sharding.gather_data``) and dropped once it has
    run, and gathered again for its backward.  Under ``remat`` "full",
    "dots" or "names" the checkpoint's recompute runs the group's gather
    itself.  Under "none" a ``saved_tensors_hooks`` pair keeps autograd
    from holding a gathered weight from the forward to the backward: the
    pack hook stores a saved tensor that lives in a gathered weight as the
    leaf's name and the view's geometry, and the unpack hook gathers the
    group again (once for all its saved tensors) and takes the view.  The
    hooks were chosen over an autograd ``Function`` around each group,
    which would have to recompute the group's forward to rebuild what it
    saves, and so launch its kernels twice.  Each gather is an autograd
    ``Function`` (``_Gather``) whose backward receives the leaf's whole
    gradient once the group's backward has made it, and reduce-scatters
    it over the data group to the rank's block
    (``sharding.scatter_grad``); a leaf used more than once (``zamba``'s
    shared block) sums its uses' gradients and is reduce-scattered once,
    after its last use in the backward (unit 0), its summed gradient held
    whole until then.  No rank holds the model gathered, or its whole
    gradient; ``RECORD`` counts what the step gathered and reduced
    (``EVENTS`` lists each collective, where a check turns it on).

    The other leaves (no data axis in their spec: norms, the sparse FFN's
    ``vals``, the SSD's ``conv_w``/``A_log``/``D``/``dt_bias``) are
    gathered once for the whole step (``sharding.gather_data``) and their
    gradients summed over the data group whole (``psum_data``); so is
    every leaf under a data group of one rank (the unsharded step bit for
    bit), or a batch the data axes do not divide (replicated).

    Where ``split_leaves`` names leaves, the compute is split over
    ``model`` (``use_mesh(..., split=True)``): those leaves are gathered
    over the data axes only (each rank keeps its ``model`` shard) and
    every other leaf whole; the latter's gradient, the rank's share (its
    positions, its heads), is summed over the model group too (a
    data-sharded leaf's before its reduce-scatter where its spec shards it
    over ``model``, ``_LayerGather.summed``).  Otherwise
    every parameter is gathered whole and the compute is replicated over
    ``model``."""
    mesh = model.mesh
    params = dict(model.module.named_parameters())
    by_layer = frozenset(n for n in params if sh.data_sharded(
        mesh, model.specs[n])) if _divided(mesh, batch) else frozenset()
    batch = sh.local(batch)
    seq = batch["tokens"].shape[1] + (batch["patch_embeds"].shape[1]
                                      if "patch_embeds" in batch else 0)
    split = split_leaves(cfg, mesh, model.specs, seq)
    held = {n: sh.keep_axes(model.specs[n], ("model",)) if n in split
            else sh.P() for n in params}
    reset_record()
    layers = _LayerGather(model, by_layer, by_layer - split) \
        if by_layer else None
    with use_mesh(mesh, split=bool(split)):
        for name, p in params.items():
            if name not in by_layer:
                p.data = sh.gather_data(mesh, model.shards[name].to_local(),
                                        model.specs[name],
                                        whole=name not in split)
            p.grad = None
        with layers.forward() if layers else contextlib.nullcontext():
            loss, parts = T.train_loss(cfg, model.module, batch, remat=remat)
        with layers.backward() if layers else contextlib.nullcontext():
            loss.backward()
        grads = {n: p.grad for n, p in params.items()}
        for p in params.values():
            p.grad = None
            _release(p)
        for n in by_layer:
            grads[n] = layers.leaves[n].grad
            held[n] = model.specs[n]
        names = [n for n, g in grads.items()
                 if g is not None and n not in by_layer]
        terms = [t.detach().float() for t in (loss, *parts.values())]
        *summed, total = psum_data([*(grads[n] for n in names),
                                    torch.stack(terms)])
        grads.update(zip(names, summed))
        if mesh_lib.data_group(mesh)[2] > 1:
            RECORD["all_reduces"] += len(names)
            for n in names:
                _event("all_reduce", n)
        summed = layers.summed if layers else ()
        whole = [n for n, g in grads.items()
                 if g is not None and n not in split and n not in summed]
        grads.update(zip(whole, psum_model([grads[n] for n in whole])))
        grads = {n: None if g is None else
                 sh.from_local(mesh, g, held[n], model.shards[n].shape)
                 for n, g in grads.items()}
        gnorm = _split_norm(mesh, grads)
    metrics = dict(zip(("loss", *parts), total.unbind()))
    metrics["grad_norm"] = gnorm
    return metrics, {n: None if g is None else
                     sh.narrow_to(mesh, g, model.specs[n])
                     for n, g in grads.items()}


def _split_norm(mesh, grads) -> torch.Tensor:
    """The norm of the full gradient from ``DTensor`` gradients, each
    element counted once: the leaves are grouped by the mesh axes (of more
    than one rank) their placements shard, each group's sum of squares is
    summed over those axes (an all-reduce of one number), and the
    replicated leaves' is added last (``adamw.global_norm`` where every
    leaf is replicated)."""
    from torch.distributed.tensor import Shard
    names = mesh_lib.axis_names(mesh)
    sizes = mesh_lib.axis_sizes(mesh)
    by_axes: Dict[tuple, dict] = {}
    for n, g in grads.items():
        if g is not None:
            axes = tuple(a for a, p in zip(names, g.placements)
                         if isinstance(p, Shard) and sizes[a] > 1)
            by_axes.setdefault(axes, {})[n] = g.to_local()
    rest = by_axes.pop((), {})
    if not by_axes:
        return adamw.global_norm(rest)
    total = None
    for axes in sorted(by_axes):
        sq = adamw.sum_squares(by_axes[axes])
        torch.distributed.all_reduce(sq,
                                     group=mesh_lib.axes_group(mesh, axes)[0])
        total = sq if total is None else total + sq
    return torch.sqrt(total + adamw.sum_squares(rest)) if rest \
        else torch.sqrt(total)


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
    ``batch_shardings`` (or this rank's rows): the step computes
    (``mesh_loss_and_grads``: the per-layer gather, each gradient this
    rank's block), clips with the full gradient's norm and updates this
    rank's shards; the metrics are the global ones."""
    if mesh is not None:
        def mesh_step(model: MeshModel, opt_state, batch: Dict):
            if model.mesh is not mesh:
                raise ValueError("the model is stored on another mesh")
            metrics, grads = mesh_loss_and_grads(cfg, model, batch, remat)
            gnorm = metrics.pop("grad_norm")
            local_grads = {n: None if g is None else g.to_local()
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

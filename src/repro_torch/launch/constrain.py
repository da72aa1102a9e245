"""Mesh-aware activation sharding, the active training mesh, and the
collectives of the compute split over ``model``.

``use_mesh(mesh)`` makes ``mesh`` the active training mesh for the code it
wraps (the JAX package's ``with mesh:``); ``train.loop.train`` enters it,
and ``current_mesh()`` returns it (None outside).  ``use_mesh(mesh,
split=True)`` also splits the compute over the mesh's ``model`` axis: the
mesh step enters it for every layout and input mode where the axis divides
the sequence (``launch.steps.split_leaves``; ``tokens+patches`` counts
its patches).  Inside, ``model_split()`` gives the split (this rank's
model group, its index and the group's size), and the model code computes
on shards as the JAX package's sharding rules and ``constrain`` calls have
GSPMD do: the residual stream is carried sequence-split (norms and the
block-sparse FFN on the rank's positions), attention (both halves of a
``gemma_pair`` block, ``zamba``'s shared block) and MLA run the rank's
heads on the whole sequence (MLA gathers its latent, not the per-head
K/V), the dense FFN and the shared experts their hidden columns, the
routed experts the rank's slice of the bank (expert parallelism), the
Mamba2 mixer the whole sequence on every rank, embedding (each codebook's
table) and logits the rank's vocab slice.  Outside a split (no mesh,
``model`` = 1, a sequence the axis does not divide) ``model_split()`` is
None and every collective below is the identity.

The JAX ``fit`` rule holds for the split (``launch.steps.split_leaves``):
a dim the ``model`` axis does not divide stays replicated (2 kv heads on
a ``model`` axis of 4: ``wk``/``wv`` whole on every rank; 6 routed
experts: the bank whole on every rank).

The collectives sit where GSPMD would insert them, each an autograd
``Function`` over the model group with its backward:

  * ``gather(x, dim)``:  all-gather along ``dim``; backward reduce-scatter;
  * ``scatter(x, dim)``: reduce-scatter along ``dim``; backward all-gather;
  * ``reduce(x)``:       all-reduce; backward the identity;
  * ``enter(x)``:        the identity; backward all-reduce (a replicated
    operand entering split compute, where no gather brings it in).

Sums over the model group of 16-bit tensors run in float32 and round once
(every reduction backend supports float32).  ``all_gather(x, dim, group,
size)`` is the plain all-gather under ``gather``, and under the mesh
step's per-layer gather over any group (``launch.sharding``).
``local_seq(x, dim)`` takes
this rank's chunk with no collective: its backward leaves zeros at the
other ranks' positions, this rank's share of a replicated computation's
gradient, which the gather before it, or the gradient sum of a replicated
leaf over the model group (``psum_model``), completes.

``constrain(x, axis0, axis1, ...)`` names the logical mesh axes an
activation's dims should be sharded over, where the JAX package's calls
stand.  The port's split is explicit (the carry arrives split; the layers
compute on their shards and call the collectives above), so ``constrain``
returns ``x`` unchanged.

``psum_data`` sums tensors over the active mesh's data group (the ranks
that share a ``model`` coordinate, ``launch.mesh.data_group``): what the
losses' global counts and the gradients are summed over, where GSPMD would
sum over the global batch; ``psum_model`` over the model group, with no
gradient.

``gathered(module, names)`` marks where the model runs one group of
parameters (a block, ``zamba``'s shared block at each use, ``embed``, the
head): the mesh step's per-layer gather (``launch.steps``, entered with
``gathering``) brings the group's data-sharded leaves in for the group's
compute and drops them after it; outside it the mark does nothing.

``BATCH`` is the conventional hierarchical batch axis (pod+data).
"""
from __future__ import annotations

import contextlib
from typing import Any, List, NamedTuple, Optional, Sequence

import torch

BATCH = ("pod", "data")
MODEL = "model"


class ModelSplit(NamedTuple):
    """The active split over ``model``: this rank's model group (never
    None: a split has more than one rank), its index there, the size."""
    group: Any
    index: int
    size: int


# the active meshes, innermost last: (mesh, its data group or None, the
# ModelSplit or None)
_ACTIVE: list = []


def constrain(x, *axes):
    return x


# the active per-layer gathers (``launch.steps``), innermost last
_GATHERS: list = []


@contextlib.contextmanager
def gathering(gather):
    """Make ``gather`` (whose ``group(module, names)`` is a context
    manager) the one ``gathered`` enters inside the block."""
    _GATHERS.append(gather)
    try:
        yield gather
    finally:
        _GATHERS.pop()


def gathered(module, names: Optional[Sequence[str]] = None):
    """A context manager inside which the parameters of ``module`` (those
    of ``names`` only, when given) are the ones to compute with: the
    active per-layer gather's group, or nothing to do outside one."""
    if not _GATHERS:
        return contextlib.nullcontext()
    return _GATHERS[-1].group(module, names)


@contextlib.contextmanager
def use_mesh(mesh, split: bool = False):
    """Make ``mesh`` (a ``DeviceMesh``, or None for no mesh) the active
    training mesh inside the block, its compute split over ``model`` with
    ``split`` (where that axis has more than one rank).  Entering builds
    the mesh's data group, and with ``split`` its model group, the first
    time it asks (a collective: every rank of the mesh enters)."""
    group, tp = None, None
    if mesh is not None:
        from repro_torch.launch.mesh import data_group, model_group
        group = data_group(mesh)[0]
        if split:
            m_group, index, size = model_group(mesh)
            if m_group is not None:
                tp = ModelSplit(m_group, index, size)
    _ACTIVE.append((mesh, group, tp))
    try:
        yield mesh
    finally:
        _ACTIVE.pop()


def current_mesh():
    """The active training mesh, or None."""
    return _ACTIVE[-1][0] if _ACTIVE else None


def data_parallel() -> bool:
    """True under an active mesh whose data group has more than one rank
    (where a rank's loss is its share of the global one)."""
    return bool(_ACTIVE) and _ACTIVE[-1][1] is not None


def model_split() -> Optional[ModelSplit]:
    """The active split over ``model``, or None (replicated compute)."""
    return _ACTIVE[-1][2] if _ACTIVE else None


# ------------------------------------------------ the model group's sums
def _wide(x: torch.Tensor) -> torch.Tensor:
    """``x`` as a contiguous tensor the sum can run in: float32 for a
    16-bit float (a new tensor), else ``x`` itself when contiguous."""
    if x.dtype in (torch.bfloat16, torch.float16):
        return x.float()
    return x.contiguous()


def all_gather(x: torch.Tensor, dim: int, group, size: int) -> torch.Tensor:
    """The ``size`` ranks' ``x`` of ``group`` concatenated along ``dim`` in
    the group's order (one ``all_gather_into_tensor``)."""
    import torch.distributed as dist
    x = x.contiguous()
    out = x.new_empty((size * x.numel(),))
    dist.all_gather_into_tensor(out, x.reshape(-1), group=group)
    parts = out.view(size, *x.shape)
    if dim == 0:
        return parts.view(size * x.shape[0], *x.shape[1:])
    return torch.cat(parts.unbind(0), dim=dim)


def _reduce_scatter(x: torch.Tensor, dim: int,
                    tp: ModelSplit) -> torch.Tensor:
    import torch.distributed as dist
    if x.shape[dim] % tp.size:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                         f"over {tp.size} ranks")
    parts = _wide(torch.stack(x.chunk(tp.size, dim=dim)))
    out = parts.new_empty(parts.shape[1:])
    dist.reduce_scatter_tensor(out.view(-1), parts.view(-1), group=tp.group)
    return out.to(x.dtype)


def _all_reduce(x: torch.Tensor, tp: ModelSplit, op=None) -> torch.Tensor:
    import torch.distributed as dist
    out = _wide(x)
    out = out.clone() if out is x else out
    dist.all_reduce(out, op=op or dist.ReduceOp.SUM, group=tp.group)
    return out.to(x.dtype)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, tp):
        ctx.dim, ctx.tp = dim, tp
        return all_gather(x, dim, tp.group, tp.size)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.dim, ctx.tp), None, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, tp):
        ctx.dim, ctx.tp = dim, tp
        return _reduce_scatter(x, dim, tp)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.dim, ctx.tp.group, ctx.tp.size), None, None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        return _all_reduce(x, tp)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.tp), None


def gather(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The ranks' chunks of ``x`` concatenated along ``dim`` in model order
    (all-gather; backward reduce-scatter); ``x`` with no split."""
    tp = model_split()
    return x if tp is None else _Gather.apply(x, dim, tp)


def scatter(x: torch.Tensor, dim: int) -> torch.Tensor:
    """This rank's chunk along ``dim`` of the ranks' ``x`` summed
    (reduce-scatter; backward all-gather); ``x`` with no split."""
    tp = model_split()
    return x if tp is None else _Scatter.apply(x, dim, tp)


def reduce(x: torch.Tensor) -> torch.Tensor:
    """The ranks' ``x`` summed (all-reduce; backward the identity: every
    rank carries the same downstream gradient); ``x`` with no split."""
    tp = model_split()
    return x if tp is None else _Reduce.apply(x, tp)


def enter(x: torch.Tensor) -> torch.Tensor:
    """``x`` (replicated) as an operand of split compute: the identity,
    whose backward sums the ranks' partial gradients (all-reduce)."""
    tp = model_split()
    return x if tp is None else _Enter.apply(x, tp)


def local_seq(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """This rank's chunk of ``x`` along ``dim`` (a view; no collective);
    ``x`` with no split."""
    tp = model_split()
    if tp is None:
        return x
    return x.chunk(tp.size, dim=dim)[tp.index]


def pmax_model(x: torch.Tensor) -> torch.Tensor:
    """The elementwise maximum of the ranks' ``x``, with no gradient;
    ``x`` with no split."""
    tp = model_split()
    if tp is None:
        return x
    import torch.distributed as dist
    return _all_reduce(x.detach(), tp, op=dist.ReduceOp.MAX)


def _psum(tensors: Sequence[torch.Tensor], group) -> List[torch.Tensor]:
    import torch.distributed as dist
    out = [t.detach().contiguous() for t in tensors]
    works = [dist.all_reduce(t, group=group, async_op=True) for t in out]
    for work in works:
        work.wait()
    return out


def psum_data(tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """``tensors`` summed over the active mesh's data group, in place, as a
    list in the same order of their detached (contiguous) selves; the
    tensors themselves where there is no mesh or its data group has one
    rank.  Each tensor is its own ``all_reduce``, all of them in flight at
    once, so the sum needs no copy beside the tensors; no gradient flows
    through it."""
    if not data_parallel():
        return list(tensors)
    return _psum(tensors, _ACTIVE[-1][1])


def psum_model(tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """``tensors`` summed over the model group of the active split (16-bit
    ones in float32, rounded back), all in flight at once, with no
    gradient; the tensors themselves with no split."""
    tp = model_split()
    if tp is None:
        return list(tensors)
    wide = _psum([_wide(t.detach()) for t in tensors], tp.group)
    return [w.to(t.dtype) for w, t in zip(wide, tensors)]

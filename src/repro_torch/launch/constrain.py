"""Mesh-aware activation sharding constraints, and the active training mesh.

``use_mesh(mesh)`` makes ``mesh`` the active training mesh for the code it
wraps (the JAX package's ``with mesh:``); ``train.loop.train`` enters it,
and ``current_mesh()`` returns it (None outside).

``constrain(x, axis0, axis1, ...)`` names the logical mesh axes an
activation's dims should be sharded over.  The port's mesh step computes
on local tensors (each rank its batch rows, with the parameters gathered:
``launch.steps.make_train_step``), so ``constrain`` returns ``x``
unchanged, with a mesh or without; the call sites stand where the JAX
package's do.

``psum_data`` sums tensors over the active mesh's data group (the ranks
that share a ``model`` coordinate, ``launch.mesh.data_group``): what the
losses' global counts and the gradients are summed over, where GSPMD would
sum over the global batch.

``BATCH`` is the conventional hierarchical batch axis (pod+data).
"""
from __future__ import annotations

import contextlib
from typing import List, Sequence

import torch

BATCH = ("pod", "data")
MODEL = "model"

# the active meshes, innermost last: (mesh, its data group or None)
_ACTIVE: list = []


def constrain(x, *axes):
    return x


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` (a ``DeviceMesh``, or None for no mesh) the active
    training mesh inside the block.  Entering builds the mesh's data group
    the first time (a collective: every rank of the mesh enters)."""
    group = None
    if mesh is not None:
        from repro_torch.launch.mesh import data_group
        group = data_group(mesh)[0]
    _ACTIVE.append((mesh, group))
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


def psum_data(tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """``tensors`` summed over the active mesh's data group, in place, as a
    list in the same order of their detached (contiguous) selves; the
    tensors themselves where there is no mesh or its data group has one
    rank.  Each tensor is its own ``all_reduce``, all of them in flight at
    once, so the sum needs no copy beside the tensors; no gradient flows
    through it."""
    out = list(tensors)
    if not data_parallel():
        return out
    import torch.distributed as dist
    group = _ACTIVE[-1][1]
    out = [t.detach().contiguous() for t in out]
    works = [dist.all_reduce(t, group=group, async_op=True) for t in out]
    for work in works:
        work.wait()
    return out

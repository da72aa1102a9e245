"""Mesh construction over ``torch.distributed``.

Single pod: 16 x 16 = 256 ranks, axes (data, model).
Multi-pod:  2 x 16 x 16 = 512 ranks, axes (pod, data, model); ``pod`` is the
outer data-parallel axis.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the
initialised world (``torch.distributed.init_process_group``: nothing on a
machine tells a program of its cluster, so the caller gives the group its
address, size and rank).  ``device_type`` is explicit and defaults to the
card; ``"cpu"`` builds a mesh for ``gloo`` process groups (the CPU tests).
``make_abstract_mesh`` gives the shape and axis names alone, with no
process group: what the sharding rules read.  ``data_group`` gives a
rank's data-parallel group under a mesh (the training mesh's gradient and
loss sums run over it), ``model_group`` its tensor-parallel group (the
split compute's collectives run over it), ``axes_group`` the group along
any set of axes (a parameter's gather over the axes it is sharded on,
a gradient norm's sum over the axes its shards differ on).  The
functions touch no process state until called.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Axis sizes and names of a mesh, with no process group behind them
    (the JAX ``AbstractMesh``): ``shape`` maps each axis name to its size,
    as the JAX mesh's ``shape`` does."""
    axis_sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))


def axis_names(mesh) -> Tuple[str, ...]:
    """The axis names of a ``DeviceMesh`` or an ``AbstractMesh``."""
    if isinstance(mesh, AbstractMesh):
        return mesh.axis_names
    return tuple(mesh.mesh_dim_names or ())


def axis_sizes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` or an ``AbstractMesh``."""
    if isinstance(mesh, AbstractMesh):
        return mesh.shape
    return dict(zip(axis_names(mesh), (int(s) for s in mesh.mesh.shape)))


def check_device_type(device_type: str) -> None:
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass "
                           "device_type='cpu' explicitly to build a mesh "
                           "of CPU (gloo) ranks")


def make_mesh(shape, axes, device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` with axis names ``axes`` over the
    initialised world, whose size must be ``prod(shape)`` (tests use small
    ones, e.g. (2, 2))."""
    from torch.distributed.device_mesh import init_device_mesh
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         "length")
    check_device_type(device_type)
    need = int(np.prod(shape, dtype=np.int64))
    if not dist.is_available() or not dist.is_initialized():
        raise ValueError(
            f"a mesh of {need} ranks needs an initialised process group "
            "(torch.distributed.init_process_group with its address, world "
            "size and rank)")
    have = dist.get_world_size()
    if have != need:
        raise ValueError(f"mesh {dict(zip(axes, shape))} needs {need} ranks, "
                         f"the world has {have}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type=device_type)


def make_abstract_mesh(shape, axes) -> AbstractMesh:
    """Shape and axis names only, no process group."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         "length")
    return AbstractMesh(shape, axes)


def data_axes(mesh) -> tuple:
    """The (possibly hierarchical) batch axes of a mesh."""
    return tuple(a for a in axis_names(mesh) if a in ("pod", "data"))


def model_axis(mesh) -> str:
    return "model"


# axes_group's results per mesh: {(id(mesh), axes): (mesh, result)}
_GROUPS: Dict[tuple, tuple] = {}


def axes_group(mesh, inner) -> Tuple[Optional["dist.ProcessGroup"], int,
                                     int]:
    """``(group, index, size)`` of the ranks that share this rank's
    coordinate on every axis outside ``inner`` (axis names; those the mesh
    lacks are ignored), ordered along ``inner``'s axes major to minor in
    mesh order.  Every rank creates every such group with
    ``dist.new_group``, in the same order, the first time it asks (cached
    per mesh and axes); ``group`` is None for one rank."""
    names = axis_names(mesh)
    kind = tuple(n for n in names if n in inner)
    hit = _GROUPS.get((id(mesh), kind))
    if hit is not None and hit[0] is mesh:
        return hit[1]
    i_dims = [i for i, n in enumerate(names) if n in inner]
    o_dims = [i for i in range(len(names)) if i not in i_dims]
    size = int(np.prod([mesh.mesh.shape[i] for i in i_dims], dtype=np.int64))
    rows = mesh.mesh.permute(*o_dims, *i_dims).reshape(-1, size).tolist()
    me = dist.get_rank()
    out = None
    for row in rows:
        group = dist.new_group(row) if size > 1 else None
        if me in row:
            out = (group, row.index(me), size)
    if out is None:
        raise ValueError(f"rank {me} is not in the mesh {mesh}")
    _GROUPS[(id(mesh), kind)] = (mesh, out)
    return out


def data_group(mesh) -> Tuple[Optional["dist.ProcessGroup"], int, int]:
    """``(group, index, size)`` of this rank's data-parallel group under a
    ``DeviceMesh``: the ranks that share its coordinate on every axis but
    ``pod`` and ``data`` (one group per ``model`` coordinate), ordered
    pod-major, as the JAX package orders a batch sharded over ``("pod",
    "data")``; ``index`` is this rank's place in that order.  ``group`` is
    None when the group has one rank.

    The groups are built with ``dist.new_group`` over the ranks of each
    ``model`` coordinate, not with the private ``DeviceMesh._flatten``."""
    return axes_group(mesh, ("pod", "data"))


def model_group(mesh) -> Tuple[Optional["dist.ProcessGroup"], int, int]:
    """``(group, index, size)`` of this rank's tensor-parallel group under
    a ``DeviceMesh``: the ranks that share its data coordinate (``pod`` and
    ``data``), ordered along ``model``; ``index`` is this rank's ``model``
    coordinate, the shard of a model-sharded dim it holds.  ``group`` is
    None when the ``model`` axis has one rank (or the mesh none)."""
    return axes_group(mesh, ("model",))

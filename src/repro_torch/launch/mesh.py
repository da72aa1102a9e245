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
process group: what the sharding rules read.  The functions touch no
process state until called.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

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

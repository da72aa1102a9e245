"""Int8 error-feedback gradient compression for the data-parallel all-reduce.

The JAX package's twin: at 1000+ nodes the gradient all-reduce over the
cross-pod link is the scaling bottleneck; 4x compression (f32 -> int8 with
a per-tensor scale) plus error feedback (the residual carried into the
next step) is the standard remedy.  The JAX package writes it with
``jax.lax.psum`` inside ``shard_map``; here the psum is a
``torch.distributed.all_reduce`` over the group ``axis_name`` resolves to
on the active training mesh (``launch.constrain.use_mesh``): ``"data"``
(or ``("pod", "data")``) is the mesh's data group, any other axis name its
own mesh dim.

Rounding is half to even in both packages (``jnp.round``, ``torch.round``);
the ``+ 1e-12`` and ``/ 127.0`` are float32 arithmetic.  Neither training
loop calls this module: the exact all-reduce stays the default.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch
import torch.distributed as dist

from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.constrain import current_mesh


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    amax = torch.max(torch.abs(x)) + 1e-12
    # a divisor on the tensor's device: CUDA turns a division by a Python
    # scalar into a product with its reciprocal, which can differ by an ulp
    scale = amax / torch.tensor(127.0, device=amax.device)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def _group(axis_name):
    """The process group of ``axis_name`` on the active mesh: the data
    group for the data axes (one mesh dim's group where it has one rank),
    else that axis's mesh dim."""
    mesh = current_mesh()
    if mesh is None:
        raise ValueError(f"a psum over {axis_name!r} needs an active mesh "
                         "(launch.constrain.use_mesh)")
    names = axis_name if isinstance(axis_name, tuple) else (axis_name,)
    data = mesh_lib.data_axes(mesh)
    if set(names) <= {"pod", "data"}:
        if not data or set(names) != set(data):
            raise ValueError(f"{axis_name!r} is not the mesh's data axes "
                             f"{data}")
        group, _, size = mesh_lib.data_group(mesh)
        return group if size > 1 else mesh.get_group(data[-1])
    if len(names) != 1:
        raise ValueError(f"cannot sum over the axes {axis_name!r}")
    return mesh.get_group(names[0])


def _psum(x: torch.Tensor, axis_name) -> torch.Tensor:
    x = x.clone()
    dist.all_reduce(x, group=_group(axis_name))
    return x


def compressed_psum(x: torch.Tensor, axis_name) -> torch.Tensor:
    """Sum over ``axis_name`` of int8-quantized values (each rank
    contributes ``q * scale``; the scales are exact).  Under an active
    mesh only."""
    q, scale = quantize_int8(x)
    # the wire format is int8 + one f32: emulated by summing the dequantized
    # payload (no typed-compression collective; the int8 cast bounds the
    # information that crosses the link, which is what is modelled)
    part = q.to(torch.float32) * scale
    return _psum(part, axis_name)


def _tree_map2(fn, a, b):
    """``fn`` over the leaves of two trees of one structure (nested dicts,
    lists or tuples); returns a pair of trees."""
    if isinstance(a, dict):
        pairs = {k: _tree_map2(fn, a[k], b[k]) for k in a}
        return ({k: p[0] for k, p in pairs.items()},
                {k: p[1] for k, p in pairs.items()})
    if isinstance(a, (list, tuple)):
        pairs = [_tree_map2(fn, x, y) for x, y in zip(a, b)]
        return (type(a)(p[0] for p in pairs), type(a)(p[1] for p in pairs))
    return fn(a, b)


def ef_compress_grads(grads, residual, axis_name="data") -> Tuple[Any, Any]:
    """Error-feedback compression step for one tree of local grads.

    g_hat = Q(g + r);  r' = (g + r) - g_hat;  return psum(g_hat), r'
    """
    def one(g, r):
        if not torch.is_floating_point(g):
            return g, r
        g32 = g.to(torch.float32) + r
        q, scale = quantize_int8(g32)
        g_hat = dequantize_int8(q, scale)
        new_r = g32 - g_hat
        return _psum(g_hat, axis_name), new_r
    return _tree_map2(one, grads, residual)


def init_residual(params):
    if isinstance(params, dict):
        return {k: init_residual(v) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(init_residual(v) for v in params)
    return (torch.zeros(params.shape, dtype=torch.float32,
                        device=params.device)
            if torch.is_floating_point(params)
            else torch.zeros((), dtype=torch.float32, device=params.device))

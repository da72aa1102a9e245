"""PyTorch/CUDA port of the ``repro`` package, for one NVIDIA H100.

The ported surface so far is the main path of ``smat-ffn-1.3b``: host BCSR
-> ``prepare`` -> ``spmm`` / ``sddmm`` (hand-written CUDA kernels, forward
and backward) -> sparse FFN -> transformer -> serving (``ServeEngine``) and
training (``repro_torch.train.loop``).  Exports resolve lazily (PEP 562),
so ``import repro_torch`` imports nothing heavy until a name is touched.
The package imports torch, numpy and scipy, never jax or ``repro``.

>>> import repro_torch
>>> repro_torch.get_config("smat-ffn-1.3b").ffn_sparsity.backend
'nnz_stream'
"""
from __future__ import annotations

import importlib

__all__ = [
    "Request",
    "ServeEngine",
    "get_config",
    "prepare",
    "sddmm",
    "spmm",
]

_EXPORTS = {
    "Request": "repro_torch.serve.engine",
    "ServeEngine": "repro_torch.serve.engine",
    "get_config": "repro_torch.configs",
    "prepare": "repro_torch.kernels.ops",
    "sddmm": "repro_torch.kernels.ops",
    "spmm": "repro_torch.kernels.ops",
}


def __getattr__(name: str):
    try:
        module = _EXPORTS[name]
    except KeyError:
        raise AttributeError(
            f"module 'repro_torch' has no attribute {name!r}") from None
    value = getattr(importlib.import_module(module), name)
    globals()[name] = value        # cache: next access skips __getattr__
    return value


def __dir__():
    return sorted(set(globals()) | set(__all__))

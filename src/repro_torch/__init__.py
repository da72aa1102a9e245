"""PyTorch/CUDA port of the ``repro`` package, for one NVIDIA H100.

The ported surface so far is the main path of ``smat-ffn-1.3b`` and the
SMaT library path: host BCSR -> ``prepare`` (with the block-densifying row
reorder) -> ``spmm`` / ``sddmm`` (hand-written CUDA kernels, streamed and
static-schedule, forward and backward; ``backend="auto"`` through the
``Autotuner``) -> sparse FFN (``SparsitySpec``) -> transformer -> serving
(``ServeEngine``) and training (``repro_torch.train.loop``); and block-sparse
attention (``AttnSparsitySpec``, ``smat-attn-1.3b``: the fused kernel B5 or
the composed SDDMM/SpMM pair).  Exports resolve lazily (PEP 562),
so ``import repro_torch`` imports nothing heavy until a name is touched.
The package imports torch, numpy and scipy, never jax or ``repro``.

>>> import repro_torch
>>> repro_torch.get_config("smat-ffn-1.3b").ffn_sparsity.backend
'nnz_stream'
"""
from __future__ import annotations

import importlib

__all__ = [
    "AttnSparsitySpec",
    "Autotuner",
    "Request",
    "ServeEngine",
    "SparsitySpec",
    "get_config",
    "prepare",
    "prepare_sparse",
    "sddmm",
    "spmm",
]

_EXPORTS = {
    "AttnSparsitySpec": "repro_torch.core.attention_mask",
    "Autotuner": "repro_torch.kernels.autotune",
    "Request": "repro_torch.serve.engine",
    "ServeEngine": "repro_torch.serve.engine",
    "SparsitySpec": "repro_torch.core.sparse_linear",
    "get_config": "repro_torch.configs",
    "prepare": "repro_torch.kernels.ops",
    "prepare_sparse": "repro_torch.kernels.ops",
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

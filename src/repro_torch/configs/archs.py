"""Registered architectures.  The port registers the paper's two
workloads so far: an LM whose FFN weights are 90% block-sparse, multiplied
by the BCSR SpMM kernels, and the same LM with block-sparse attention
scores on top."""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig
from repro_torch.core.attention_mask import AttnSparsitySpec, banded
from repro_torch.core.sparse_linear import SparsitySpec

ARCHS = {}


def _register(cfg: ModelConfig) -> ModelConfig:
    ARCHS[cfg.name] = cfg
    return cfg


# The JAX package registers this arch with backend="xla" so it stays
# lowerable on a CPU; here the main path must run the CUDA kernel, so the
# port registers it with backend="nnz_stream" (its wrapper takes the plain
# version only for tensors on the CPU).
_register(ModelConfig(
    name="smat-ffn-1.3b", family="dense", layout="attn_mlp",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=8192, vocab_size=32000,
    ffn_sparsity=SparsitySpec(density=0.10, block=(128, 128),
                              backend="nnz_stream"),
))

# Both sparse workloads at once: block-sparse FFN weights AND block-sparse
# attention scores (a banded mask in 128x128 blocks).  The JAX package
# registers both specs with backend="xla" so that its registry stays
# lowerable on a CPU; here the card must run the kernels, so the FFN takes
# backend="nnz_stream" (B1/B2) and attention backend="fused" (B5; its
# backward runs the composed SDDMM/SpMM kernels).  Both wrappers take their
# plain versions only for tensors on the CPU.
_register(ModelConfig(
    name="smat-attn-1.3b", family="dense", layout="attn_mlp",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=8192, vocab_size=32000,
    ffn_sparsity=SparsitySpec(density=0.10, block=(128, 128),
                              backend="nnz_stream"),
    attn_sparsity=AttnSparsitySpec(mask=banded(4096), block=(128, 128),
                                   backend="fused"),
))


def smoke_config(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family config for CPU tests: few layers, small width,
    tiny vocab (the JAX package's shrink for the layouts ported so far)."""
    kw = dict(
        name=cfg.name + ":smoke",
        n_layers=2,
        d_model=128,
        vocab_size=512,
        d_ff=256 if cfg.d_ff else 0,
    )
    if cfg.n_heads:
        kw.update(n_heads=4, n_kv_heads=min(cfg.n_kv_heads, 2) or 2,
                  head_dim=32)
    if cfg.sliding_window:
        kw.update(sliding_window=64)
    if cfg.ffn_sparsity is not None:
        kw.update(ffn_sparsity=SparsitySpec(
            density=0.3, block=(16, 16), backend=cfg.ffn_sparsity.backend,
            bn=128))
    if cfg.attn_sparsity is not None:
        kw.update(attn_sparsity=dataclasses.replace(
            cfg.attn_sparsity, mask=banded(32), block=(16, 16), bn=128))
    return dataclasses.replace(cfg, **kw)

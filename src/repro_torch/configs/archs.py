"""Registered architectures: the paper's two workloads (an LM whose FFN
weights are 90% block-sparse, multiplied by the BCSR SpMM kernels, and the
same LM with block-sparse attention scores on top), and of the JAX
package's assigned archs the ones whose layout is ported: Mamba2 (``ssd``)
and DeepSeek-V2 (``mla_moe``), with the JAX package's fields."""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig
from repro_torch.core.attention_mask import AttnSparsitySpec, banded
from repro_torch.core.sparse_linear import SparsitySpec

ARCHS = {}


def _register(cfg: ModelConfig) -> ModelConfig:
    ARCHS[cfg.name] = cfg
    return cfg


# --------------------------------------------------------------------- [ssm]
# SSD (state-space duality), arXiv:2405.21060
_register(ModelConfig(
    name="mamba2-1.3b", family="ssm", layout="ssd",
    n_layers=48, d_model=2048, n_heads=0, n_kv_heads=0, head_dim=0,
    d_ff=0, vocab_size=50280,
    ssm_state=128, ssm_expand=2, ssm_head_dim=64, ssm_groups=1,
))

# --------------------------------------------------------------------- [moe]
# DeepSeek-V2(-Lite), arXiv:2405.04434 — MLA kv_lora=512, shared+routed top-6
_register(ModelConfig(
    name="deepseek-v2-lite-16b", family="moe", layout="mla_moe",
    n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=1408, vocab_size=102400,
    use_mla=True, kv_lora_rank=512, q_lora_rank=None,
    rope_head_dim=64, nope_head_dim=128, v_head_dim=128,
    n_experts=64, n_shared_experts=2, moe_top_k=6, expert_d_ff=1408,
))

_register(ModelConfig(
    name="deepseek-v2-236b", family="moe", layout="mla_moe",
    n_layers=60, d_model=5120, n_heads=128, n_kv_heads=128, head_dim=128,
    d_ff=1536, vocab_size=102400,
    use_mla=True, kv_lora_rank=512, q_lora_rank=1536,
    rope_head_dim=64, nope_head_dim=128, v_head_dim=128,
    n_experts=160, n_shared_experts=2, moe_top_k=6, expert_d_ff=1536,
))

# --------------------------------------------------- the paper's own archs
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
    if cfg.use_mla:
        kw.update(kv_lora_rank=64,
                  q_lora_rank=64 if cfg.q_lora_rank else None,
                  rope_head_dim=16, nope_head_dim=32, v_head_dim=32)
    if cfg.n_experts:
        kw.update(n_experts=4, n_shared_experts=min(cfg.n_shared_experts, 1),
                  moe_top_k=2, expert_d_ff=64)
    if cfg.ssm_state:
        kw.update(ssm_state=16, ssm_head_dim=16, ssm_chunk=32)
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

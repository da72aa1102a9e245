"""Model configuration schema — every field of the JAX package's
``ModelConfig`` — and the ``ShapeCell`` of a run.  Block-sparse attention
(``attn_sparsity``) is not ported yet, so a config that sets it raises."""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core.sparse_linear import SparsitySpec


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | vlm | audio
    layout: str                 # attn_mlp | gemma_pair | mla_moe | ssd | zamba
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # --- attention details
    rope_theta: float = 10_000.0
    qkv_bias: bool = False
    sliding_window: Optional[int] = None
    attn_logit_softcap: Optional[float] = None
    final_logit_softcap: Optional[float] = None

    # --- MLA (deepseek)
    use_mla: bool = False
    kv_lora_rank: int = 512
    q_lora_rank: Optional[int] = None
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128

    # --- MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    moe_top_k: int = 0
    expert_d_ff: int = 0
    capacity_factor: float = 1.25
    moe_dispatch: str = "gather"

    # --- SSM (mamba2 / zamba2)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_groups: int = 1
    ssm_conv_width: int = 4
    ssm_chunk: int = 256

    # --- hybrid (zamba2)
    hybrid_unit_len: int = 5
    hybrid_n_units: int = 13
    hybrid_tail: int = 3

    # --- modality stubs
    input_mode: str = "tokens"      # tokens | tokens+patches | codebooks
    n_codebooks: int = 1
    patch_tokens: int = 0

    # --- the paper's technique: block-sparse FFN weights
    ffn_sparsity: Optional[SparsitySpec] = None

    # --- block-sparse attention: must stay None until it is ported
    attn_sparsity: Optional[object] = None

    dtype: str = "bfloat16"
    mlp_act: str = "silu"           # silu (gated) | gelu (gated, gemma2)

    def __post_init__(self):
        if self.attn_sparsity is not None:
            raise NotImplementedError(
                "block-sparse attention (attn_sparsity) is not ported yet")


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str           # train | prefill | decode
    seq_len: int
    global_batch: int

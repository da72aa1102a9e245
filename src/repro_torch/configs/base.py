"""Model configuration schema — every field of the JAX package's
``ModelConfig`` — and the shape cells: ``ShapeCell``, the JAX package's
``SHAPES`` and ``cell_applicable``."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch.core.attention_mask import AttnSparsitySpec
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

    # --- the paper's second workload: block-sparse attention (scores
    # sampled on a static BCSR mask; the layer is models.attention)
    attn_sparsity: Optional[AttnSparsitySpec] = None

    dtype: str = "bfloat16"
    mlp_act: str = "silu"           # silu (gated) | gelu (gated, gemma2)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic sequence mixing: SSM/hybrid state, a bounded SWA
        window, or a bounded block-sparse attention mask (banded /
        local+global)."""
        if self.attn_sparsity is not None and \
                self.attn_sparsity.mask.kind in ("banded", "local_global"):
            return True
        return self.family in ("ssm", "hybrid") or \
            self.sliding_window is not None

    @property
    def has_decode(self) -> bool:
        return True  # all assigned archs are decoder-style

    def param_count(self) -> int:
        """Analytic parameter count (drives the 6*N*D model-FLOPs count of
        ``launch.roofline.model_flops_for``): embeddings and head (one pair
        a codebook), plus a layer's attention (or MLA) and its gated MLP
        (sparse: its density's share) or MoE, or its SSD mixer; ``zamba``
        counts its Mamba2 layers, then the shared block once.  The JAX
        package's count."""
        d = self.d_model
        if self.input_mode == "codebooks":
            n = self.n_codebooks * self.vocab_size * d * 2
        else:
            n = self.vocab_size * d * 2
        if self.layout == "ssd":
            return n + self.n_layers * _ssd_params(self)
        if self.layout == "zamba":
            n_mamba = self.hybrid_unit_len * self.hybrid_n_units + \
                self.hybrid_tail
            return n + n_mamba * _ssd_params(self) + \
                _attn_params(self) + _mlp_params(self)
        if self.layout == "mla_moe":
            return n + self.n_layers * (_mla_params(self) +
                                        _moe_params(self))
        return n + self.n_layers * (_attn_params(self) + _mlp_params(self))

    def active_param_count(self) -> int:
        """Per-token active params (MoE: the top-k and shared experts and
        the router only)."""
        if self.layout != "mla_moe":
            return self.param_count()
        d = self.d_model
        active_experts = self.moe_top_k + self.n_shared_experts
        per_layer = _mla_params(self) + \
            3 * d * self.expert_d_ff * active_experts + d * self.n_experts
        return self.vocab_size * d * 2 + self.n_layers * per_layer


def _attn_params(cfg: ModelConfig) -> int:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return d * h * hd + 2 * d * kv * hd + h * hd * d


def _mlp_params(cfg: ModelConfig) -> int:
    if cfg.ffn_sparsity is not None:
        return int(3 * cfg.d_model * cfg.d_ff * cfg.ffn_sparsity.density)
    return 3 * cfg.d_model * cfg.d_ff  # gated: up, gate, down


def _mla_params(cfg: ModelConfig) -> int:
    d, h = cfg.d_model, cfg.n_heads
    qd = h * (cfg.nope_head_dim + cfg.rope_head_dim)
    n = 0
    if cfg.q_lora_rank:
        n += d * cfg.q_lora_rank + cfg.q_lora_rank * qd
    else:
        n += d * qd
    n += d * (cfg.kv_lora_rank + cfg.rope_head_dim)           # down kv + rope
    n += cfg.kv_lora_rank * h * (cfg.nope_head_dim + cfg.v_head_dim)
    n += h * cfg.v_head_dim * d                               # out proj
    return n


def _moe_params(cfg: ModelConfig) -> int:
    d = cfg.d_model
    n = d * cfg.n_experts                                     # router
    n += 3 * d * cfg.expert_d_ff * cfg.n_experts              # routed
    n += 3 * d * cfg.expert_d_ff * cfg.n_shared_experts       # shared
    return n


def _ssd_params(cfg: ModelConfig) -> int:
    d, di = cfg.d_model, cfg.d_inner
    g, ns, hh = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
    d_xbc = di + 2 * g * ns
    in_proj = d * (2 * di + 2 * g * ns + hh)
    conv = cfg.ssm_conv_width * d_xbc
    return in_proj + conv + 2 * hh + di * d + di              # A,D,out,norm


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str           # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeCell("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeCell("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeCell("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeCell("long_500k", "decode", 524_288, 1),
}


def cell_applicable(cfg: ModelConfig, shape: ShapeCell) -> Tuple[bool, str]:
    """(runs?, reason): long_500k skips pure full-attention archs."""
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, ("pure full-attention arch: 500k decode requires "
                       "sub-quadratic sequence mixing")
    return True, ""

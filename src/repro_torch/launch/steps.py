"""Step functions (train / prefill / decode), the ones the train loop and
serving run.

Sparse-FFN archs need no special handling here: each sparse layer holds its
static meta, and ``ops.spmm``'s backward runs the kernels (``bcsr_spmm``
for dB, ``bcsr_sddmm`` for dvals).  Neither do block-sparse attention archs
(``smat-attn-1.3b``): training and prefill run kernel B5 through
``models.attention``, whose backward runs the SDDMM/SpMM kernels, and
decode applies the mask as a bias.  ``mla_moe`` and ``ssd`` archs run the
same steps; ``T.train_loss`` adds their MoE load-balance loss.
``input_specs`` and ``opt_specs`` give
a cell's inputs and AdamW state as ``meta``-device tensors (shape and dtype
only), for the dry-run (``launch.dryrun``).
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig, ShapeCell
from repro_torch.core.sparse_linear import meta_spec as _spec
from repro_torch.models import transformer as T
from repro_torch.optim import adamw


def input_specs(cfg: ModelConfig, shape: ShapeCell) -> Dict[str, torch.Tensor]:
    """Every model input of this cell as a ``meta``-device tensor: the JAX
    package's ``input_specs`` for token inputs, with the ids int64, as the
    port feeds them (``train.loop.batch_to_device``, the serving engine).
    Train cells hold ``tokens`` and ``labels`` [B, L], prefill ``tokens``,
    decode one token a sequence [B]."""
    T._check_layout(cfg)
    B, L = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        return {"tokens": _spec((B, L), torch.int64),
                "labels": _spec((B, L), torch.int64)}
    if shape.kind == "prefill":
        return {"tokens": _spec((B, L), torch.int64)}
    return {"tokens": _spec((B,), torch.int64)}


def opt_specs(cfg: ModelConfig, params_specs) -> Dict[str, object]:
    """``optim.adamw.init``'s state for these parameter specs (the nested
    ``models.transformer.param_specs`` tree or a flat mapping): float32
    ``m`` and ``v`` beside every floating leaf, keyed by its
    ``named_parameters()`` name, and a 0-d int32 ``step``."""
    flat = T.flat_specs(params_specs)
    zeros = {name: _spec(p.shape, torch.float32)
             for name, p in flat.items() if p.is_floating_point()}
    return {"m": zeros,
            "v": {name: _spec(z.shape, torch.float32)
                  for name, z in zeros.items()},
            "step": _spec((), torch.int32)}


def make_train_step(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig,
                    remat: str = "full"):
    """``train_step(model, opt_state, batch) -> (model, opt_state,
    metrics)``: loss and gradients of ``T.train_loss``, then one AdamW
    update of the model's parameters, in place.  ``batch`` holds ``tokens``
    and ``labels`` tensors on the model's device; the metrics are 0-d
    tensors (``loss``, ``lm_loss``, ``aux_loss``, ``grad_norm``, ``lr``),
    read without a host sync."""
    def train_step(model: T.Transformer, opt_state, batch: Dict):
        params = dict(model.named_parameters())
        for p in params.values():
            p.grad = None
        loss, parts = T.train_loss(cfg, model, batch, remat=remat)
        loss.backward()
        grads = {name: p.grad for name, p in params.items()}
        _, opt_state, om = adamw.update(opt_cfg, grads, opt_state, params)
        for p in params.values():
            p.grad = None                    # free the gradients' memory
        metrics = {"loss": loss.detach(),
                   **{k: v.detach() for k, v in parts.items()}, **om}
        return model, opt_state, metrics
    return train_step


def make_prefill_step(cfg: ModelConfig, cache_len: int):
    def prefill_step(model: T.Transformer, batch):
        with torch.no_grad():
            logits, cache = T.prefill(cfg, model, batch, cache_len)
        # just the last-position logits (what serving samples from)
        return logits[:, -1], cache
    return prefill_step


def make_decode_step(cfg: ModelConfig):
    def serve_step(model: T.Transformer, cache, tokens, pos):
        with torch.no_grad():
            return T.decode_step(cfg, model, cache, tokens, pos)
    return serve_step

"""Step functions (train / prefill / decode), the ones the train loop and
serving run.

Sparse-FFN archs need no special handling here: each sparse layer holds its
static meta, and ``ops.spmm``'s backward runs the kernels (``bcsr_spmm``
for dB, ``bcsr_sddmm`` for dvals).  Neither do block-sparse attention archs
(``smat-attn-1.3b``): training and prefill run kernel B5 through
``models.attention``, whose backward runs the SDDMM/SpMM kernels, and
decode applies the mask as a bias.  The JAX package's ``input_specs`` and
``opt_specs`` are dry-run helpers and are not ported yet.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as T
from repro_torch.optim import adamw


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

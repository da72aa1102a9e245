"""Model assembly: embeddings, the block stack, caches, and the forward /
prefill / decode entry points for the ``attn_mlp`` layout (a standard
decoder; ``smat-ffn`` with its block-sparse FFN).

The JAX package stacks the blocks on a leading axis and scans them; here
``Transformer.blocks`` is a ``ModuleList`` walked by a Python loop, and the
decode cache keeps the stacked layout (``{"k", "v"}: [n_layers, B, S, KV,
dh]``) so a layer's cache is a view into it.  ``forward``'s ``remat``
replaces the JAX package's ``jax.checkpoint`` policies: ``"full"`` runs
each block under ``torch.utils.checkpoint``; ``"dots"`` and ``"names"`` are
not ported yet.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch
from torch import nn
from torch.utils import checkpoint as torch_checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device`` (``"cuda"`` names the current card,
    ``cuda:<index>``, so it compares equal to a tensor's device); raises for
    a CUDA device on a machine without one, so an entry point never quietly
    runs on the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' explicitly to "
                "run on the CPU")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _check_layout(cfg: ModelConfig) -> None:
    if cfg.layout != "attn_mlp" or cfg.input_mode != "tokens":
        raise NotImplementedError(
            f"layout {cfg.layout!r} with input_mode {cfg.input_mode!r} is not "
            "ported yet (only attn_mlp over tokens)")


class Block(nn.Module):
    """One ``attn_mlp`` layer: pre-norm attention, then pre-norm MLP."""

    def __init__(self, cfg, *, dtype, device, generator=None,
                 seed_hint: int = 0):
        super().__init__()
        d = cfg.d_model
        self.ln1 = nn.Parameter(torch.zeros(d, device=device))
        self.attn = L.init_attention(cfg, generator, dtype, device=device)
        self.ln2 = nn.Parameter(torch.zeros(d, device=device))
        self.mlp = L.init_mlp(cfg, generator, dtype, device=device,
                              seed_hint=seed_hint)


class Transformer(nn.Module):
    """The decoder.  Dense weights are drawn from ``generator`` (left
    uninitialised when it is None); the sparse FFN structures and values
    always come from their numpy seeds, as in the JAX package."""

    def __init__(self, cfg: ModelConfig, *, device, generator=None):
        super().__init__()
        _check_layout(cfg)
        self.cfg = cfg
        dtype, d = _dtype(cfg), cfg.d_model
        self.final_norm = nn.Parameter(torch.zeros(d, device=device))
        self.embed = L._weight((cfg.vocab_size, d), 0.02, dtype, device,
                               generator)
        self.lm_head = L._weight((d, cfg.vocab_size), d ** -0.5, dtype,
                                 device, generator)
        self.blocks = nn.ModuleList(
            Block(cfg, dtype=dtype, device=device, generator=generator,
                  seed_hint=i) for i in range(cfg.n_layers))

    def forward(self, batch_in, *, cache=None, pos=None, slot_mask=None,
                remat: str = "none"):
        return forward(self.cfg, self, batch_in, cache=cache, pos=pos,
                       slot_mask=slot_mask, remat=remat)


def init_params(cfg: ModelConfig, seed: int = 0, *,
                device="cuda") -> Transformer:
    """The model with random weights from ``seed`` on ``device``."""
    device = resolve_device(device)
    generator = torch.Generator(device=device)
    generator.manual_seed(seed)
    return Transformer(cfg, device=device, generator=generator)


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, *,
               device="cuda"):
    """Decode caches for the whole network, stacked over layers."""
    _check_layout(cfg)
    one = L.init_attn_cache(cfg, batch, cache_len, _dtype(cfg),
                            window=cfg.sliding_window,
                            device=resolve_device(device))
    return {name: leaf[None].repeat(cfg.n_layers, *([1] * leaf.ndim))
            for name, leaf in one.items()}


# ================================================================== forward
def _embed(cfg: ModelConfig, params, batch_in) -> torch.Tensor:
    return params.embed[batch_in["tokens"]]                 # [B, L, D]


def _head(cfg: ModelConfig, params, x) -> torch.Tensor:
    x = L.rms_norm(x, params.final_norm)
    logits = x @ params.lm_head
    return L.softcap(logits.float(), cfg.final_logit_softcap)


def _apply_block(cfg: ModelConfig, p: Block, x, cache, pos, slot_mask=None):
    """Returns (x, cache)."""
    a, c = L.attention(cfg, p.attn, L.rms_norm(x, p.ln1),
                       window=cfg.sliding_window, cache=cache, pos=pos,
                       slot_mask=slot_mask)
    x = x + a
    x = x + L.mlp(cfg, p.mlp, L.rms_norm(x, p.ln2),
                  seed_hints=(p.mlp.seed_hint,))
    return x, c


REMAT = ("none", "full")


def _remat_block(cfg: ModelConfig, blk: Block, x):
    """One block without a cache under activation checkpointing: its
    activations are recomputed in the backward (JAX ``remat="full"``)."""
    return torch_checkpoint.checkpoint(
        lambda x_: _apply_block(cfg, blk, x_, None, None)[0], x,
        use_reentrant=False)


def forward(cfg: ModelConfig, params: Transformer, batch_in, *, cache=None,
            pos=None, slot_mask=None, remat: str = "none"
            ) -> Tuple[torch.Tensor, Any, torch.Tensor]:
    """Returns (logits, cache, aux_loss); the cache is updated in place.
    ``remat="full"`` checkpoints each block (training, no cache)."""
    if remat in ("dots", "names"):
        raise NotImplementedError(
            f"remat={remat!r} (a jax.checkpoint policy) is not ported yet; "
            f"use one of {REMAT}")
    if remat not in REMAT:
        raise ValueError(f"unknown remat {remat!r}; want one of {REMAT}")
    x = _embed(cfg, params, batch_in)
    for i, blk in enumerate(params.blocks):
        if remat == "full" and cache is None:
            x = _remat_block(cfg, blk, x)
            continue
        layer_cache = None if cache is None else \
            {name: leaf[i] for name, leaf in cache.items()}
        x, _ = _apply_block(cfg, blk, x, layer_cache, pos, slot_mask)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return _head(cfg, params, x), cache, aux


# ================================================================ entry points
def lm_loss(cfg: ModelConfig, logits, labels) -> torch.Tensor:
    """Next-token CE.  labels already shifted; -100 = ignore."""
    valid = labels >= 0
    lab = labels.clamp_min(0).long()
    lp = torch.log_softmax(logits, dim=-1)
    nll = -lp.gather(-1, lab[..., None])[..., 0]
    return (nll * valid).sum() / valid.sum().clamp_min(1)


def train_loss(cfg: ModelConfig, params: Transformer, batch_in,
               remat: str = "full"):
    """Returns (loss, {"lm_loss", "aux_loss"}); ``batch_in`` holds
    ``tokens`` and shifted ``labels`` (-100 = ignore)."""
    logits, _, aux = forward(cfg, params, batch_in, remat=remat)
    loss = lm_loss(cfg, logits, batch_in["labels"])
    return loss + 0.01 * aux, {"lm_loss": loss, "aux_loss": aux}


def prefill(cfg: ModelConfig, params: Transformer, batch_in, cache_len: int):
    """Build decode caches from a prompt.  Returns (logits, cache)."""
    B = batch_in["tokens"].shape[0]
    cache = init_cache(cfg, B, cache_len, device=params.embed.device)
    logits, cache, _ = forward(cfg, params, batch_in, cache=cache, pos=0)
    return logits, cache


def decode_step(cfg: ModelConfig, params: Transformer, cache, tokens,
                pos: int, slot_mask=None):
    """One decode step: tokens [B], pos an int.  Writes the step's K/V into
    ``cache`` in place (only the rows where ``slot_mask`` [B] is True, when
    given).  Returns (logits [B, V], cache)."""
    logits, cache, _ = forward(cfg, params, {"tokens": tokens[:, None]},
                               cache=cache, pos=pos, slot_mask=slot_mask)
    return logits[:, 0], cache

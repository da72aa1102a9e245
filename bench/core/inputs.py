"""Everything a run feeds both the program and the reference, drawn from
``--seed`` on the run's device: the weights (dense values, the sparse FFN's
block patterns and block values) and the token ids.  The same seed gives
the same inputs; each kind of input draws from its own stream, so a cell's
shapes never change what another kind draws.

Weights are named as the port's parameters (``named_parameters()``):
``embed`` [V, d], ``lm_head`` [d, V], ``final_norm`` [d], and for block i
``blocks.i.ln1``/``ln2`` [d], ``blocks.i.attn.wq``/``wk``/``wv`` [d, d]
(x @ w), ``blocks.i.attn.wo`` [d, d], ``blocks.i.mlp.gate.vals``/
``up.vals``/``down.vals`` [nnzb, h, w].  ``patterns`` holds each sparse
matrix's stored blocks (``blocks.i.mlp.gate``: [out, in] = [d_ff,
d_model]; ``down``: [d_model, d_ff]) as sorted row-major block indices
``row * n_block_cols + col``; every block-row and block-col holds at least
one block, as the port's own patterns do.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

STREAM_WEIGHTS, STREAM_TOKENS, STREAM_SAMPLE = 1, 2, 4
SPARSE = ("gate", "up", "down")


def sub_seed(seed: int, *tags: int) -> int:
    """A 63-bit seed of the stream ``tags`` of the run seed ``seed`` (any
    whole number)."""
    ss = np.random.SeedSequence([int(seed) % 2 ** 64, *tags])
    hi, lo = (int(x) for x in ss.generate_state(2, np.uint32))
    return ((hi << 32) | lo) & (2 ** 63 - 1)


def generator(device, seed: int, *tags: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, *tags))
    return g


def rng(seed: int, *tags: int) -> np.random.Generator:
    return np.random.default_rng(sub_seed(seed, *tags))


def dtype_of(model) -> torch.dtype:
    return getattr(torch, model["dtype"])


def check_model(model) -> None:
    """The shapes the loader and the reference handle: square attention
    projections, as many kv heads as heads, whole blocks."""
    d, H, KV, dh = (model[k] for k in ("d_model", "n_heads", "n_kv_heads",
                                       "head_dim"))
    h, w = model["ffn"]["block"]
    if H * dh != d or KV != H:
        raise ValueError("the benchmark handles n_heads * head_dim == "
                         "d_model and n_kv_heads == n_heads only")
    if d % w or d % h or model["d_ff"] % h or model["d_ff"] % w:
        raise ValueError("the FFN's widths must be whole blocks")


@dataclasses.dataclass
class Weights:
    dense: dict          # name -> tensor (dense leaves and sparse values)
    patterns: dict       # "blocks.i.mlp.<gate|up|down>" -> [nnzb] int64
    shapes: dict         # the same keys -> (out, in)


def block_patterns(g, n_mats: int, nbr: int, nbc: int, nnzb: int,
                   device) -> torch.Tensor:
    """``[n_mats, nnzb]`` sorted block indices: a random cover of every
    block-row and block-col (one block a row, or a column, of the longer
    side, the other side's index drawn evenly), then random further blocks
    up to ``nnzb``."""
    m, total = max(nbr, nbc), nbr * nbc
    if not m <= nnzb <= total:
        raise ValueError(f"nnzb {nnzb} outside [{m}, {total}]")
    perm = torch.rand(n_mats, m, generator=g, device=device).argsort(-1)
    i = torch.arange(m, device=device).expand(n_mats, m)
    rows, cols = (i, perm % nbc) if nbr >= nbc else (perm % nbr, i)
    score = torch.rand(n_mats, total, generator=g, device=device)
    score.scatter_(1, rows * nbc + cols, 2.0)        # the cover first
    return score.topk(nnzb, dim=1).indices.sort(dim=1).values


def make_weights(model, seed: int, device) -> Weights:
    """The weights of ``model`` from ``seed``, in a few large calls on
    ``device``, in the dtype they are served in (norm scales in float32,
    as the port keeps them)."""
    check_model(model)
    g = generator(device, seed, STREAM_WEIGHTS)
    dt = dtype_of(model)
    n, d, f, V = (model[k] for k in ("n_layers", "d_model", "d_ff",
                                     "vocab_size"))
    h, w = model["ffn"]["block"]
    nnzb = model["ffn"]["nnzb"]

    def randn(shape, scale, dtype=dt):
        return torch.randn(shape, generator=g, device=device,
                           dtype=dtype).mul_(scale)

    dense = {"embed": randn((V, d), 0.02),
             "lm_head": randn((d, V), d ** -0.5)}
    norms = randn((2 * n + 1, d), 0.1, torch.float32)
    attn = randn((n, 4, d, d), d ** -0.5)
    vals = randn((n, 3, nnzb, h, w), w ** -0.5)
    dense["final_norm"] = norms[2 * n]
    up = block_patterns(g, 2 * n, f // h, d // w, nnzb, device)
    down = block_patterns(g, n, d // h, f // w, nnzb, device)
    patterns, shapes = {}, {}
    for i in range(n):
        pre = f"blocks.{i}"
        dense[f"{pre}.ln1"], dense[f"{pre}.ln2"] = norms[i], norms[n + i]
        for j, name in enumerate(("wq", "wk", "wv", "wo")):
            dense[f"{pre}.attn.{name}"] = attn[i, j]
        for j, name in enumerate(SPARSE):
            dense[f"{pre}.mlp.{name}.vals"] = vals[i, j]
            patterns[f"{pre}.mlp.{name}"] = (down[i] if name == "down"
                                             else up[2 * i + j])
            shapes[f"{pre}.mlp.{name}"] = (d, f) if name == "down" \
                else (f, d)
    return Weights(dense, patterns, shapes)


def token_rows(model, seed: int, n: int, rows: int, length: int,
               device) -> torch.Tensor:
    """``[n, rows, length]`` token ids, uniform over the vocabulary."""
    g = generator(device, seed, STREAM_TOKENS)
    return torch.randint(0, model["vocab_size"], (n, rows, length),
                         generator=g, device=device)

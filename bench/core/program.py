"""The adapter between the harness and the program under test, the port
``repro_torch``: the one module of the harness that imports it.

It takes the program's registered architecture for a configuration and
holds it to the configuration's widths, builds the model through the
program's own constructor, and loads the benchmark's weights into it: the
dense leaves by copy, each sparse FFN matrix through the program's own
``kernels.ops.prepare_sparse`` (the host path a deployment runs on the
weights it loads; its ``prepare.*`` spans are the ``prepare_s`` metric's).
From the program the harness takes the model and its entry points
(``launch/steps``), its launch counters and its spans.
"""
from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from bench.core import inputs


def port_config(model: dict, arch: str):
    """The program's registered ``ModelConfig`` of ``arch``, which must
    have ``model``'s widths: the benchmark runs the model as configured,
    with the kernels the program chose for it."""
    from repro_torch.configs.archs import ARCHS
    base = ARCHS[arch]
    cfg = with_widths(base, model)
    if cfg != base:
        raise ValueError(f"the program's {arch} differs from the "
                         f"benchmark's configuration:\n  {base}\n  {cfg}")
    plain = (cfg.layout == "attn_mlp" and cfg.input_mode == "tokens" and
             not cfg.qkv_bias and cfg.sliding_window is None and
             cfg.attn_logit_softcap is None and
             cfg.final_logit_softcap is None and
             not cfg.ffn_sparsity.shards)
    if not plain:
        raise ValueError(f"{arch}: the reference implements a plain "
                         "attn_mlp decoder with a whole sparse FFN")
    return cfg


def with_widths(base, model: dict):
    """``base`` (a program ``ModelConfig``) with ``model``'s widths, FFN
    blocks and attention mask laid over it."""
    from repro_torch.core.attention_mask import banded
    ffn, attn = model["ffn"], model["attention"]
    if base.ffn_sparsity is None:
        raise ValueError(f"{base.name} has no sparse FFN")
    kw = {k: model[k] for k in ("n_layers", "d_model", "n_heads",
                                "n_kv_heads", "head_dim", "d_ff",
                                "vocab_size", "dtype", "rope_theta",
                                "mlp_act")}
    kw["ffn_sparsity"] = dataclasses.replace(
        base.ffn_sparsity, density=ffn["density"], block=tuple(ffn["block"]))
    if attn["kind"] == "banded":
        if base.attn_sparsity is None:
            raise ValueError(f"{base.name} has no block-sparse attention")
        kw["attn_sparsity"] = dataclasses.replace(
            base.attn_sparsity, mask=banded(attn["bandwidth"]),
            block=tuple(attn["block"]))
    elif base.attn_sparsity is not None:
        raise ValueError(f"{base.name} has block-sparse attention")
    return dataclasses.replace(base, **kw)


def build(cfg, device):
    """The program's model with its dense weights left unset (the
    program's path for weights that are loaded)."""
    from repro_torch.models import transformer as T
    return T.Transformer(cfg, device=torch.device(device), generator=None)


def _load_sparse(sparse, a_rows, a_cols, vals, shape, block, spec, device):
    from repro_torch.core import bcsr as bcsr_lib
    from repro_torch.kernels import ops
    h, w = block
    nbr = shape[0] // h
    a = bcsr_lib.BCSR(vals.float().cpu().numpy(), a_cols.astype(np.int32),
                      a_rows.astype(np.int32),
                      bcsr_lib.rowptr_from_rows(a_rows.astype(np.int32),
                                                nbr), shape, (h, w))
    arrays, meta = ops.prepare_sparse(
        a, vals.dtype, reorder=spec.reorder,
        reorder_granularity="block_row", device=device)
    if tuple(arrays.vals.shape) != tuple(sparse.vals.shape):
        raise ValueError(f"the program holds {tuple(sparse.vals.shape)} "
                         f"blocks where the configuration has "
                         f"{tuple(arrays.vals.shape)}")
    if not (np.array_equal(arrays.row_ids.cpu().numpy(), a_rows) and
            np.array_equal(arrays.col_ids.cpu().numpy(), a_cols)):
        raise ValueError("the program reorders the FFN's blocks; the "
                         "loader keeps them in the benchmark's order")
    for field in sparse.buffer_fields:
        setattr(sparse, field, getattr(arrays, field))
    sparse.vals.data = arrays.vals
    sparse.meta = meta


def load(model, cfg, weights: inputs.Weights) -> None:
    """Copy ``weights`` into the program's ``model`` (every parameter must
    have a weight, and every weight a parameter)."""
    params = dict(model.named_parameters())
    missing = sorted(set(params) ^ set(weights.dense))
    if missing:
        raise ValueError(f"parameters and weights differ: {missing[:8]}")
    block = tuple(cfg.ffn_sparsity.block)
    with torch.no_grad():
        for name, p in params.items():
            if not name.endswith(".vals"):
                p.copy_(weights.dense[name])
        for key, idx in weights.patterns.items():
            sparse = model.get_submodule(key)
            out_dim, in_dim = weights.shapes[key]
            nbc = in_dim // block[1]
            flat = idx.cpu().numpy()
            _load_sparse(sparse, flat // nbc, flat % nbc,
                         weights.dense[key + ".vals"], (out_dim, in_dim),
                         block, cfg.ffn_sparsity, params[key + ".vals"].device)


def launch_counts() -> dict:
    """The program's kernel launch counters (B1-B4 by backend, B5)."""
    from repro_torch.kernels import bcsr_attn, bcsr_spmm
    return {**bcsr_spmm.LAUNCHES, **bcsr_attn.LAUNCHES}


@contextlib.contextmanager
def spans(enabled: bool):
    """Keep the program's spans in memory while ``enabled``
    (``obs.trace.capture``; its ``.events`` lists them); else None."""
    if not enabled:
        yield None
        return
    from repro_torch.obs import trace
    with trace.capture(cap=1 << 20) as cap:
        yield cap


def span_seconds(events) -> dict:
    """Seconds inside each span name, from the captured end records."""
    out: dict = {}
    for e in events:
        if e.kind == "E" and e.dur_us is not None:
            out[e.name] = out.get(e.name, 0.0) + e.dur_us / 1e6
    return out

"""Roofline terms of one (arch x shape x mesh) cell on the H100.

Three terms, in seconds, each the least time the card could take:

  compute    = flops_per_device / PEAK_FLOPS_BF16
  memory     = bytes_per_device / HBM_BW
  collective = wire bytes per device / NVLINK_BW

The JAX package reads its flops and bytes from XLA's ``cost_analysis()`` of
the compiled step and its collective bytes from the optimized HLO text
(``parse_collectives``, kept here as a plain text function for parity).
The port has no compiler to ask, so ``work_count`` counts the work
analytically.  Its rules fix the yardstick a step is judged by:

* It is computed from the config, the shape cell and the structure metas.
  Nothing depends on the backend a layer resolves, on a kernel's tile, on a
  schedule's padding slots or on the MoE dispatch arm, so a kernel
  redesign can never move it.
* Dense products count 2*m*k*n: the attention projections, a dense FFN,
  the LM head (at the positions whose logits the step needs: all of them
  in a train step, the last of each sequence in prefill and decode, which
  return only those).
* A sparse FFN layer counts ``sparse_param_flops(meta)`` per token: 2*h*w
  over each stored block of its true structure meta.
* Attention's scores and context count 2*dh each per (query, key) pair a
  head evaluates: the lower triangle for causal dense attention (within
  the sliding window when one is set); for a block-sparse mask, its live
  blocks x h x w; in decode, the cache rows the step reads (the live pages
  of the last query's page-table row where the config pages its KV, else
  the whole ring).
* ``mla_moe``.  MLA counts its projections (q, directly or through the
  q LoRA; the latent and rope key; the output) per token.  In training and
  prefill it adds the per-head K and V it builds from the latent, 2*r*h*
  (nope + v) a token, and 2*(nope + rope + v) a (query, key) pair a head.
  In decode (the absorbed form) it adds q's and the context's products
  with ``wkv_b``, 2*h*r*(nope + v) a token, and 2*(2r + rope) a pair a
  head over the whole ring.  The MoE counts its active experts only: the
  router, 2*d*E a token, and top-k plus shared gated MLPs, 6*d*F each a
  token.
* ``ssd``.  The in/out projections and the depthwise conv (2*cw a
  channel) a token.  The chunked scan: 2*(N + P) a head per (i, j) pair
  of the lower triangle of each chunk (its scores and their product with
  the inputs), and 4*P*N a head a token (the chunk states and the
  inter-chunk read).  In decode, the recurrence step: 4*P*N a head a
  token (the state's decay and update, and its read).
* Training counts forward + dX + dW: three times the forward.
* Bytes are a stated minimum: each weight read once a forward pass (the
  embedding: one row a token, at most the table; a routed expert's
  weights only for the min(E, tokens * k) experts the step can reach); for
  training the weights read again in the backward (all but the embedding,
  the same experts), the gradients written, and AdamW's reads (gradient,
  parameter, ``m``, ``v``) and writes (parameter, ``m``, ``v``); the
  cell's inputs read once; the decode cache a prefill writes, and in
  decode the cache rows a step reads and the row it writes (MLA: the
  latent, (r + rope) elements a position a layer; SSD: the conv window and
  the float32 state, read and written, a sequence a layer); the float32
  logits written once, at the LM head's positions (the prefill's output:
  one row a sequence).  Activations, index buffers and the attention mask
  are not counted.
* The collective term counts the bytes ``launch.dist_spmm``'s all-gathers
  move when a partitioned FFN (``SparsitySpec(shards=S)``) runs one shard a
  rank over the cell's devices (S x ``shard_cols`` of them): each product
  gathers every shard's output rows, and in training its dB and dvals
  partials, each at ``parse_collectives``' (n-1)/n factor.  On one card,
  or in-process, it is 0.

Every count is for the whole step on all devices; ``launch.dryrun``
divides it per device.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core.perf_model import HBM_BW, NVLINK_BW, PEAK_FLOPS_BF16

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "f8e4m3fn": 1, "f8e5m2": 1,
}

# "bf16[4096,512]{1,0}" or "f32[]" or tuple "(f32[8,16], f32[8,16])"
_SHAPE_RE = re.compile(r"([a-z0-9]+)\[([0-9,]*)\]")
_INSTR_RE = re.compile(
    r"^\s*(?:ROOT\s+)?%?[\w.\-]+\s*=\s*(\(?[^)=]*\)?)\s+"
    r"(all-reduce|all-gather|reduce-scatter|all-to-all|collective-permute)"
    r"(-start|-done)?\(", re.M)
_REPLICA_GROUPS_RE = re.compile(r"replica_groups=\{([^}]*)\}")
_REPLICA_GROUPS_V2_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]")


def _shape_bytes(type_str: str) -> int:
    total = 0
    for dtype, dims in _SHAPE_RE.findall(type_str):
        if dtype not in _DTYPE_BYTES:
            continue
        numel = 1
        for d in dims.split(","):
            if d:
                numel *= int(d)
        total += numel * _DTYPE_BYTES[dtype]
    return total


def _group_size(line: str) -> int:
    m = _REPLICA_GROUPS_V2_RE.search(line)
    if m:                                   # [num_groups, group_size]
        return int(m.group(2))
    m = _REPLICA_GROUPS_RE.search(line)
    if m:
        first = m.group(1).split("}")[0].strip("{} ")
        if first:
            return len([x for x in first.split(",") if x.strip() != ""])
    return 1


def _wire_factor(kind: str, n: int) -> float:
    """Bytes on the wire a device moves per output byte of a collective
    over ``n`` devices: ring all-reduce 2(n-1)/n, all-gather /
    reduce-scatter / all-to-all (n-1)/n, a permute its whole payload."""
    if kind == "collective-permute":
        return 1.0
    if n <= 1:
        return 0.0
    if kind == "all-reduce":
        return 2.0 * (n - 1) / n
    return (n - 1) / n


@dataclasses.dataclass
class CollectiveStats:
    counts: Dict[str, int]
    bytes_total: Dict[str, int]      # output-shape bytes per kind
    wire_bytes: float                # per-device bytes actually crossing links

    def to_dict(self):
        return {"counts": self.counts, "bytes": self.bytes_total,
                "wire_bytes": self.wire_bytes}


def parse_collectives(hlo_text: str) -> CollectiveStats:
    """Collective counts, output bytes and wire bytes of an HLO text (the
    JAX package's parser; the port's own collectives are counted by
    ``work_count``)."""
    counts: Dict[str, int] = {}
    btot: Dict[str, int] = {}
    wire = 0.0
    for line in hlo_text.splitlines():
        m = _INSTR_RE.match(line)
        if not m:
            continue
        type_str, kind, phase = m.group(1), m.group(2), m.group(3)
        if phase == "-done":
            continue                        # counted at -start
        nbytes = _shape_bytes(type_str)
        counts[kind] = counts.get(kind, 0) + 1
        btot[kind] = btot.get(kind, 0) + nbytes
        wire += _wire_factor(kind, max(_group_size(line), 1)) * nbytes
    return CollectiveStats(counts, btot, wire)


@dataclasses.dataclass
class Roofline:
    flops_per_device: float
    bytes_per_device: float
    wire_bytes_per_device: float
    t_compute: float
    t_memory: float
    t_collective: float
    bottleneck: str
    model_flops: float               # 6*N*D useful flops (global)
    useful_ratio: float              # model_flops / (flops_per_device*chips)
    peak_fraction: float             # compute term / max(all terms)
    collectives: Dict

    @property
    def t_bound(self) -> float:
        """The least time of the step: the largest of the three terms."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    def to_dict(self):
        return dataclasses.asdict(self)


def compute_roofline(flops: float, bytes_acc: float, wire_bytes: float,
                     n_devices: int, model_flops: float,
                     peak=PEAK_FLOPS_BF16, hbm=HBM_BW, link=NVLINK_BW,
                     collectives: Optional[Dict] = None) -> Roofline:
    """The three terms of per-device ``flops``, ``bytes_acc`` and
    ``wire_bytes``, with the H100's peaks by default (``link`` is NVLink's
    rate, one direction)."""
    t_c = flops / peak
    t_m = bytes_acc / hbm
    t_x = wire_bytes / link
    terms = {"compute": t_c, "memory": t_m, "collective": t_x}
    bottleneck = max(terms, key=terms.get)
    total_hw_flops = flops * n_devices
    useful = model_flops / total_hw_flops if total_hw_flops else 0.0
    t_max = max(t_c, t_m, t_x) or 1.0
    return Roofline(
        flops_per_device=flops, bytes_per_device=bytes_acc,
        wire_bytes_per_device=wire_bytes,
        t_compute=t_c, t_memory=t_m, t_collective=t_x,
        bottleneck=bottleneck, model_flops=model_flops,
        useful_ratio=useful, peak_fraction=t_c / t_max,
        collectives=collectives or {})


def model_flops_for(cfg, shape, n_tokens: Optional[int] = None) -> float:
    """6*N*D (dense) / 6*N_active*D (MoE) for train; 2*N*D per generated
    token for decode/prefill forward-only."""
    n_active = cfg.active_param_count()
    if n_tokens is None:
        n_tokens = shape.global_batch * shape.seq_len if \
            shape.kind in ("train", "prefill") else shape.global_batch
    factor = 6.0 if shape.kind == "train" else 2.0
    return factor * n_active * n_tokens


# ------------------------------------------------------------ the work count
def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _causal_pairs(L: int, window: Optional[int]) -> int:
    """(query, key) pairs of causal attention over L positions, each query
    seeing at most ``window`` keys (itself included)."""
    if not window or window >= L:
        return L * (L + 1) // 2
    return window * (window + 1) // 2 + (L - window) * window


def live_blocks_per_row(mask, seq_len: int, block) -> "np.ndarray":
    """Stored blocks of each block-row of ``mask``'s BCSR at ``seq_len``
    (``models.attention.attention_mask_bcsr``'s row counts), from interval
    arithmetic on the mask's bands instead of its elements, so it costs
    O(block-rows x block-cols) at any length.  A block (i, j) is live when
    some query q of block-row i and key k of block-col j satisfy
    ``core.attention_mask.mask_allowed``: 0 <= k <= q and k > q - c (the
    band: ``bandwidth`` or ``window``, capped by ``window_cap``), or
    k < ``n_global`` and k > q - ``window_cap``."""
    h, w = block
    nbr, nbc = -(-seq_len // h), -(-seq_len // w)
    big = 2 * seq_len + 1                    # no band
    cap = mask.window_cap or big
    band = {"banded": mask.bandwidth, "local_global": mask.window,
            "blockwise_causal": big}[mask.kind]
    g = mask.n_global if mask.kind == "local_global" else 0
    qa = np.arange(nbr)[:, None] * h
    qb = np.minimum(qa + h, seq_len) - 1
    ka = np.arange(nbc)[None, :] * w
    kb = np.minimum(ka + w, seq_len) - 1
    lo = np.maximum(qa, ka)                  # k <= q needs q >= ka
    live = lo <= np.minimum(qb, kb + min(band, cap) - 1)
    kg = np.minimum(kb, g - 1)               # the global keys, k < g
    live |= (ka <= kg) & (lo <= np.minimum(qb, kg + cap - 1))
    return live.sum(axis=1)


def _decode_keys(cfg, cache_len: int) -> int:
    """Cache rows one decode step reads at the last position of a full
    ring: the live pages of the last page-table row (times the page width)
    where the config pages its KV (``models.layers.pages_decode``, given
    the row counts of ``live_blocks_per_row``), else the whole ring."""
    from repro_torch.models import layers as L
    window = cfg.sliding_window
    ring = min(cache_len, window) if window else cache_len
    sparse = cfg.attn_sparsity

    def counts():
        return live_blocks_per_row(L._sparse_mask(cfg, window), cache_len,
                                   tuple(sparse.block))
    if not L.pages_decode(sparse, cache_len, lambda: int(counts().max())):
        return ring
    return min(int(counts()[(cache_len - 1) // sparse.block[0]]) *
               sparse.block[1], ring)


def _attn_pairs(cfg, shape) -> int:
    """(query, key) pairs one head of one layer evaluates over the cell."""
    B, L = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        return B * _decode_keys(cfg, L)
    if cfg.attn_sparsity is not None:
        from repro_torch.models import layers as Lyr
        h, w = cfg.attn_sparsity.block
        nnzb = int(live_blocks_per_row(
            Lyr._sparse_mask(cfg, cfg.sliding_window), L, (h, w)).sum())
        return B * nnzb * h * w
    return B * _causal_pairs(L, cfg.sliding_window)


def _sparse_layers(cfg, device):
    """``[(in_dim, out_dim, meta)]`` of every sparse FFN product of the
    stack, with each layer's true structure meta."""
    from repro_torch.core.sparse_linear import sparse_linear_meta
    from repro_torch.models import layers as Lyr
    d, f, spec = cfg.d_model, cfg.d_ff, cfg.ffn_sparsity
    out = []
    for i in range(cfg.n_layers):
        seed = Lyr.mlp_seed(i)
        for s, i_, o_ in ((seed, d, f), (seed + 1, d, f), (seed + 2, f, d)):
            out.append((i_, o_, sparse_linear_meta(s, i_, o_, spec,
                                                   device=device)))
    return out


def _mla_flops(cfg, shape, tokens: int) -> tuple:
    """(projections, attention) forward flops of the MLA layers."""
    d, h = cfg.d_model, cfg.n_heads
    nope, rope, vd, r = (cfg.nope_head_dim, cfg.rope_head_dim,
                         cfg.v_head_dim, cfg.kv_lora_rank)
    qd = h * (nope + rope)
    qr = cfg.q_lora_rank
    q = d * qr + qr * qd if qr else d * qd
    per_token = q + d * (r + rope) + h * vd * d
    pairs = _attn_pairs(cfg, shape)
    if shape.kind == "decode":          # absorbed: q and ctx through wkv_b
        per_token += h * r * (nope + vd)
        attn = 2.0 * h * (2 * r + rope) * pairs
    else:                               # per-head K and V from the latent
        per_token += r * h * (nope + vd)
        attn = 2.0 * h * (nope + rope + vd) * pairs
    return 2.0 * tokens * per_token * cfg.n_layers, attn * cfg.n_layers


def _moe_flops(cfg, tokens: int) -> float:
    """Forward flops of the MoE layers at their active experts."""
    d, f = cfg.d_model, cfg.expert_d_ff
    active = cfg.moe_top_k + cfg.n_shared_experts
    return 2.0 * tokens * (d * cfg.n_experts + 3 * d * f * active) * \
        cfg.n_layers


def _ssd_dims(cfg) -> tuple:
    d_xbc = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    return d_xbc, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state


def _ssd_flops(cfg, shape, tokens: int) -> tuple:
    """(projections, mixer) forward flops of the SSD layers: the mixer is
    the conv and the chunked scan (in decode, the recurrence step)."""
    d, di = cfg.d_model, cfg.d_inner
    d_xbc, H, P, N = _ssd_dims(cfg)
    proj = 2.0 * tokens * (d * (di + d_xbc + H) + di * d)
    mixer = 2.0 * tokens * cfg.ssm_conv_width * d_xbc
    if shape.kind == "decode":
        mixer += 4.0 * tokens * H * P * N
    else:
        c = min(cfg.ssm_chunk, shape.seq_len)
        pairs = shape.global_batch * (shape.seq_len // c) * c * (c + 1) // 2
        mixer += 2.0 * H * (N + P) * pairs + 4.0 * tokens * H * P * N
    return proj * cfg.n_layers, mixer * cfg.n_layers


def _cache_bytes(cfg, shape, es: int) -> float:
    """Decode-cache bytes the step touches: written by a prefill; read
    (the rows it reads) and written (one row) by a decode step."""
    B, L, nl = shape.global_batch, shape.seq_len, cfg.n_layers
    if shape.kind == "train":
        return 0.0
    if cfg.layout == "ssd":
        d_xbc, H, P, N = _ssd_dims(cfg)
        seq = ((cfg.ssm_conv_width - 1) * d_xbc * es + H * P * N * 4) * nl
        return seq * B * (1 if shape.kind == "prefill" else 2)
    if cfg.layout == "mla_moe":
        row = (cfg.kv_lora_rank + cfg.rope_head_dim) * es * nl
    else:
        row = 2.0 * cfg.n_kv_heads * cfg.head_dim * es * nl   # K and V
    if shape.kind == "prefill":
        ring = min(L, cfg.sliding_window) if cfg.sliding_window else L
        return row * B * ring
    return row * B * (_decode_keys(cfg, L) + 1)


@dataclasses.dataclass(frozen=True)
class WorkCount:
    """``work_count``'s result: whole-step flops and bytes (all devices),
    wire bytes per device, and the terms they sum."""
    flops: float
    bytes: float
    wire_bytes: float
    weight_bytes: float          # the weight reads, inside ``bytes``
    parts: Dict

    def per_device(self, n_devices: int, weight_bytes: float) -> tuple:
        """``(flops, bytes)`` on one of ``n_devices``: the flops and the
        non-weight bytes split evenly, the weight reads replaced by
        ``weight_bytes`` (what one device holds and reads)."""
        n = max(int(n_devices), 1)
        return (self.flops / n,
                (self.bytes - self.weight_bytes) / n + weight_bytes)


_ROUTED = ("w_gate", "w_up", "w_down")


def _is_routed(name: str) -> bool:
    """A routed expert bank's ``state_dict`` name (``blocks.<i>.moe.w_*``;
    the shared experts sit under ``moe.shared``)."""
    parts = name.split(".")
    return len(parts) >= 2 and parts[-2] == "moe" and parts[-1] in _ROUTED


def weight_read_bytes(cfg, shape, leaf_bytes: Dict[str, float]) -> float:
    """Weight bytes the step reads (the rules above) for the floating
    parameter bytes ``leaf_bytes`` ({``state_dict`` name: bytes}; a
    device's share of each, or the whole)."""
    tokens = shape.global_batch * (1 if shape.kind == "decode"
                                   else shape.seq_len)
    total = sum(leaf_bytes.values())
    embed = leaf_bytes.get("embed", 0.0)
    routed = sum(b for k, b in leaf_bytes.items() if _is_routed(k))
    if routed:
        e = cfg.n_experts
        routed_read = routed * min(e, tokens * cfg.moe_top_k) / e
    else:
        routed_read = 0.0
    rest = total - embed - routed + routed_read      # read once a pass
    fwd = rest + embed * min(tokens, cfg.vocab_size) / cfg.vocab_size
    if shape.kind != "train":
        return fwd
    # the backward re-reads all but the embedding; the gradients are
    # written; AdamW reads gradient and parameter and writes the parameter
    return fwd + rest + total + 3 * total


def work_count(cfg, shape, *, n_devices: int = 1,
               device="cuda") -> WorkCount:
    """The analytic flops, bytes and collective bytes of one step of
    ``cfg`` at ``shape`` (the module's rules).  ``n_devices`` is the
    cell's device count (it sets the collective term); ``device`` only
    keys ``shards="auto"``."""
    from repro_torch.core.sparse_linear import (is_sharded,
                                                sparse_param_flops)
    from repro_torch.launch import steps as st
    from repro_torch.models import transformer as T

    B, L = shape.global_batch, shape.seq_len
    tokens = B * (1 if shape.kind == "decode" else L)
    d, V = cfg.d_model, cfg.vocab_size
    H, KV, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    es = getattr(torch, cfg.dtype).itemsize
    nl = cfg.n_layers

    flat = T.flat_specs(T.param_specs(cfg, device=device))
    params = {k: float(_nbytes(v)) for k, v in flat.items()
              if v.is_floating_point()}
    n_float = sum(v.numel() for v in flat.values() if v.is_floating_point())

    sparse = []
    if cfg.layout == "mla_moe":
        proj, attn = _mla_flops(cfg, shape, tokens)
        ffn = _moe_flops(cfg, tokens)
    elif cfg.layout == "ssd":
        proj, attn = _ssd_flops(cfg, shape, tokens)
        ffn = 0.0
    else:
        proj = 2.0 * tokens * (d * H * dh + 2 * d * KV * dh + H * dh * d) * nl
        if cfg.ffn_sparsity is not None:
            sparse = _sparse_layers(cfg, device)
            ffn = float(tokens * sum(sparse_param_flops(m)
                                     for _, _, m in sparse))
        else:
            ffn = 2.0 * tokens * 3 * d * cfg.d_ff * nl
        attn = 4.0 * dh * H * _attn_pairs(cfg, shape) * nl
    head_rows = B * L if shape.kind == "train" else B
    head = 2.0 * head_rows * d * V
    fwd = proj + ffn + attn + head
    flops = 3.0 * fwd if shape.kind == "train" else fwd

    w_bytes = weight_read_bytes(cfg, shape, params)
    inputs = float(sum(_nbytes(t) for t in
                       st.input_specs(cfg, shape).values()))
    logits = 4.0 * head_rows * V
    cache = _cache_bytes(cfg, shape, es)
    # AdamW's m and v, read and written
    state = 16.0 * n_float if shape.kind == "train" else 0.0
    nbytes = w_bytes + inputs + logits + cache + state

    # dist_spmm's all-gathers: one shard a rank over S x shard_cols devices
    wire = 0.0
    spec = cfg.ffn_sparsity
    if spec is not None and is_sharded(spec) and n_devices > 1:
        for in_dim, _, meta in sparse:
            n = meta.n_shards * meta.col_shards
            if n != n_devices:
                continue                        # in-process: no collective
            h, w = meta.block
            gathered = meta.n_shards * meta.rows_per_shard * h * tokens
            if shape.kind == "train":
                gathered += meta.n_shards * in_dim * tokens       # dB
                gathered += meta.n_shards * meta.nnzb_per_shard * h * w
            wire += _wire_factor("all-gather", n) * gathered * es

    return WorkCount(
        flops=flops, bytes=nbytes, wire_bytes=wire, weight_bytes=w_bytes,
        parts={"flops": {"projections": proj, "ffn": ffn, "attention": attn,
                         "head": head,
                         "passes": 3 if shape.kind == "train" else 1},
               "bytes": {"weights": w_bytes, "inputs": inputs,
                         "logits": logits, "kv_cache": cache,
                         "optimizer_state": state}})

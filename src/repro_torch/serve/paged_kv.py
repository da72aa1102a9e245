"""Paged block-sparse KV: the page table IS the mask BCSR.

The serving decode path never needs the whole KV ring: a static attention
mask (``AttnMaskSpec``) tells, per query block-row, exactly which key
blocks can ever score, and that row of the memoized mask BCSR
(``models.attention.decode_page_table``) doubles as the page table of a
paged KV cache with page width = the mask block width.  The gather itself
lives in ``models.layers._paged_decode`` (gated by
``AttnSparsitySpec.paged_decode``, bitwise equal in float32 to the same
fold over the full page table); this module owns what sits above the math:

* the **placement policy** — which pages stay device-resident and which
  are host-offloaded, decided analytically from page demand (how many mask
  block-rows reference each page = the BCSR column counts) under a device
  page budget;
* the **cost model** — expected read time of one decode step at the
  device's and the host link's bandwidths, ``(1/nbr) * sum_p demand[p] *
  page_bytes / bw(p)`` (each step lands in one block-row; a page is read
  iff its column appears in that row);
* the **accounting report** (pages, resident and offloaded bytes per
  layer group) that ``launch.serve`` prints.

It is the JAX package's ``repro.serve.paged_kv``: the same placement,
demand and report, host-side and deterministic in the config.  It is an
*analytic* placement layer: no page is moved off the card.  The default
bandwidths are the card's (``PagePlacementSpec``); pass a spec to model
another part.

>>> from repro_torch.models import attention as A
>>> page_demand(A.banded(32), 64, (16, 16)).tolist()
[3, 3, 2, 1]
>>> spec = PagePlacementSpec(resident_pages=2)
>>> page_placement(A.banded(32), 64, (16, 16), spec).tolist()
[True, True, False, False]
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core import perf_model as pm


@dataclasses.dataclass(frozen=True)
class PagePlacementSpec:
    """Static placement policy (hashable: it keys the memoized placement).

    ``resident_pages`` is the per-layer-group device budget in pages;
    ``None`` keeps everything device-resident.  The bandwidths are the cost
    model's constants: by default the NVIDIA H100 SXM's HBM3
    (``perf_model.HBM_BW``, 3,350 GB/s) and a PCIe Gen5 x16 host link
    (``perf_model.PCIE_BW``, 64 GB/s a direction), the card the port runs
    on ("NVIDIA H100 80GB HBM3, 700.00 W" by ``nvidia-smi --query-gpu=
    name,power.limit``).  The JAX package's defaults (819 and 32 GB/s)
    model another part."""
    policy: str = "greedy"              # greedy | all_device
    resident_pages: Optional[int] = None
    hbm_gbps: float = pm.HBM_BW / 1e9
    host_gbps: float = pm.PCIE_BW / 1e9


@functools.lru_cache(maxsize=None)
def page_demand(mask, seq_len: int, block: Tuple[int, int]) -> np.ndarray:
    """Demand of each KV page = number of mask block-rows referencing it
    (the column counts of the mask BCSR).  Memoized host constant."""
    from repro_torch.models import attention as A
    a = A.attention_mask_bcsr(mask, seq_len, tuple(block))
    meta = A.attention_mask_meta(mask, seq_len, tuple(block))
    d = np.bincount(a.col_ids, minlength=meta.n_block_cols).astype(np.int64)
    d.setflags(write=False)
    return d


@functools.lru_cache(maxsize=None)
def page_placement(mask, seq_len: int, block: Tuple[int, int],
                   pspec: PagePlacementSpec) -> np.ndarray:
    """[n_pages] bool — True where the page is device-resident.  Greedy:
    most-demanded pages first under the budget (ties -> lowest page id,
    ``np.argsort(kind="stable")``: deterministic)."""
    demand = page_demand(mask, seq_len, block)
    n_pages = int(demand.size)
    if pspec.policy == "all_device" or pspec.resident_pages is None:
        budget = n_pages
    elif pspec.policy == "greedy":
        budget = max(0, min(n_pages, int(pspec.resident_pages)))
    else:
        raise ValueError(f"unknown placement policy {pspec.policy!r}")
    order = np.argsort(-demand, kind="stable")
    resident = np.zeros(n_pages, bool)
    resident[order[:budget]] = True
    resident.setflags(write=False)
    return resident


class PagedKVCache:
    """Analytic paged view over a ``ServeEngine``'s KV rings.

    Holds NO tensors: the engine's cache stays the storage and the page
    tables are the memoized mask-BCSR constants.  This object binds a model
    config and a serving shape to a placement spec and renders the
    per-layer-group accounting: page counts, pages touched per decode step
    (= the mask meta's ``max_bpr``), resident/offloaded bytes, and the cost
    model's step-read estimates (paged against a dense ring read).

    Layer groups follow the layouts that own k/v rings, as in the JAX
    package: ``attn_mlp`` is one group (all layers share the config's mask
    and sliding window); ``gemma_pair`` splits into the local halves
    (window-capped, possibly a smaller ring) and the global ones, each
    half decoding through the page table of its own window.
    """

    def __init__(self, cfg, cache_len: int, n_slots: int,
                 placement: Optional[PagePlacementSpec] = None):
        if getattr(cfg, "attn_sparsity", None) is None:
            raise ValueError("PagedKVCache requires cfg.attn_sparsity")
        if cfg.layout not in ("attn_mlp", "gemma_pair"):
            raise ValueError(
                f"layout {cfg.layout!r} has no k/v attention rings to page")
        self.cfg = cfg
        self.cache_len = int(cache_len)
        self.n_slots = int(n_slots)
        self.placement = placement or PagePlacementSpec()

    def _groups(self):
        """[(name, window, n_layers)] — layer groups sharing one mask."""
        cfg = self.cfg
        if cfg.layout == "attn_mlp":
            return [("attn", cfg.sliding_window, cfg.n_layers)]
        half = cfg.n_layers // 2
        return [("local", cfg.sliding_window, half), ("global", None, half)]

    def _cache_len(self, window) -> int:
        return min(self.cache_len, window) if window else self.cache_len

    def group_report(self, name: str, window, n_layers: int) -> dict:
        """Deterministic accounting row for one layer group."""
        from repro_torch.models import attention as A
        from repro_torch.models import layers as L
        cfg = self.cfg
        sc = self._cache_len(window)
        mask = L._sparse_mask(cfg, window)
        h, w = cfg.attn_sparsity.block
        table = L._decode_pages(cfg, window, sc)
        row = {"group": name, "n_layers": n_layers, "cache_len": sc,
               "mask": dataclasses.asdict(mask),
               "paged": table is not None}
        if sc % w != 0:
            return row              # dense-bias fallback: no page grid
        n_pages = sc // w
        demand = page_demand(mask, sc, (h, w))
        resident = page_placement(mask, sc, (h, w), self.placement)
        kv_bytes = getattr(torch, cfg.dtype).itemsize * cfg.n_kv_heads * \
            cfg.head_dim * 2                      # k + v, per position
        page_bytes = int(w * kv_bytes * self.n_slots)
        nbr = -(-sc // h)
        bw = np.where(resident, self.placement.hbm_gbps,
                      self.placement.host_gbps) * 1e9
        est_us = float(np.sum(demand * page_bytes / bw) / nbr * 1e6)
        dense_us = n_pages * page_bytes / (self.placement.hbm_gbps
                                           * 1e9) * 1e6
        meta = None
        if table is not None:
            meta = A.decode_page_table(mask, sc, (h, w))[2]
        row.update({
            "n_pages": n_pages,
            "page_bytes": page_bytes,
            "pages_touched_per_step": int(meta.max_bpr) if meta else n_pages,
            "resident_pages": int(resident.sum()),
            "resident_bytes": int(resident.sum()) * page_bytes * n_layers,
            "offload_bytes": int((~resident).sum()) * page_bytes * n_layers,
            "est_step_read_us": round(est_us * n_layers, 4),
            "est_step_read_us_dense": round(dense_us * n_layers, 4),
        })
        return row

    def table_leaves(self, device="cuda") -> dict:
        """Page tables of every layer group as tensors on ``device``,
        ``{group: {"pages": [nbr, max_bpr] int32, "page_live": bool}}``
        (the JAX package's leaves).  ``"cuda"`` needs a card: without one
        it raises.  The decode path reads its own per-device copy
        (``models.attention.decode_page_tensors``)."""
        from repro_torch.models import attention as A
        from repro_torch.models import layers as L
        from repro_torch.models import transformer as T
        device = T.resolve_device(device)
        out = {}
        for name, window, _ in self._groups():
            sc = self._cache_len(window)
            w = self.cfg.attn_sparsity.block[1]
            if sc % w != 0:
                continue
            mask = L._sparse_mask(self.cfg, window)
            pages, live, _ = A.decode_page_table(
                mask, sc, tuple(self.cfg.attn_sparsity.block))
            out[name] = {"pages": torch.from_numpy(pages.copy()).to(device),
                         "page_live": torch.from_numpy(live.copy()).to(device)}
        return out

    def report(self) -> dict:
        """Per-group rows + totals (the JAX package's serving record)."""
        rows = [self.group_report(*g) for g in self._groups()]
        return {
            "cache_len": self.cache_len,
            "n_slots": self.n_slots,
            "placement": dataclasses.asdict(self.placement),
            "groups": rows,
            "resident_bytes_total": sum(r.get("resident_bytes", 0)
                                        for r in rows),
            "offload_bytes_total": sum(r.get("offload_bytes", 0)
                                       for r in rows),
            "resident_page_counts": [r.get("resident_pages", 0)
                                     for r in rows],
        }

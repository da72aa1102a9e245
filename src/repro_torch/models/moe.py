"""Mixture-of-Experts FFN (DeepSeek-V2 style: shared + routed top-k).

Two dispatch implementations, as in the JAX package:

  * ``gather`` (default): capacity dispatch computed PER BATCH ROW
    (capacity ``C = int(cf * L * k / E) + 1`` a row, so a serving slot's
    routing never depends on another slot's).  A stable sort gives each
    (token, slot) its place in its expert's queue; the ones past ``C``
    drop.  Token movement is gathers; the experts' FFN is the only dense
    compute.
  * ``einsum``: the GShard one-hot dispatch/combine einsums (the JAX
    package's benchmark arm).

The combine is a gather, not a scatter-add: each (token, slot) lands in at
most one (expert, capacity) cell, so a token's output is the sum of its k
kept slots' gate-weighted expert outputs, added in slot order.  That is the
JAX package's scatter-add (``index_add_`` would sum with atomics on the
card, in an order that can change from run to run) with a fixed order, so
greedy streams repeat bit for bit.

The shared experts are one dense gated MLP of width ``expert_d_ff *
n_shared_experts``, dense even for sparse-FFN archs (as in the JAX
package: ``layers.mlp`` dispatches on the module's weights).

Under a split over ``model`` (training: ``launch.constrain.model_split``)
``moe_ffn`` takes this rank's positions and returns them: the sequence is
gathered and every rank routes all of it, so the capacity and the slot
order, and with them the drops, are the unsharded ones.  With the
``gather`` dispatch each rank runs the experts of its slice of the bank
(expert parallelism: the bank's ``DTensor`` shard of dim 0, experts
``index * E/m`` onwards) and combines their cells, reading zero for the
other ranks' ones; the partial sums are reduce-scattered back to the
rank's positions: the JAX package's one psum of [B, L, D].  The
``einsum`` dispatch, and a bank the axis does not divide, run every
expert on every rank and keep the rank's positions.  Shared experts split
by their hidden columns run them on the same gathered sequence, and their
partial sums join the routed ones' reduce-scatter.  The load-balance loss
is each rank's share of its positions' router probabilities, summed over
the model group (``reduce``), so its value is the whole one and its
gradient counts every position once.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
from torch import nn
from torch.nn import functional as F

from repro_torch.launch.constrain import (BATCH, MODEL, constrain,
                                          data_parallel, gather, local_seq,
                                          model_split, psum_data, reduce,
                                          scatter)
from repro_torch.models import layers as L


class MoE(nn.Module):
    """Router (float32) [D, E], routed experts' gated MLPs ``w_gate``/
    ``w_up`` [E, D, F] and ``w_down`` [E, F, D], and ``shared`` (a dense
    ``layers.MLP``) when ``cfg.n_shared_experts`` is set."""

    def __init__(self, cfg, *, dtype, device, generator=None):
        super().__init__()
        d, f, e = cfg.d_model, cfg.expert_d_ff, cfg.n_experts
        s = d ** -0.5
        self.router = L._weight((d, e), s, torch.float32, device, generator)
        self.w_gate = L._weight((e, d, f), s, dtype, device, generator)
        self.w_up = L._weight((e, d, f), s, dtype, device, generator)
        self.w_down = L._weight((e, f, d), f ** -0.5, dtype, device,
                                generator)
        if cfg.n_shared_experts:
            dense = dataclasses.replace(cfg, ffn_sparsity=None)
            self.shared = L.init_mlp(dense, generator, dtype, device=device,
                                     d_ff=f * cfg.n_shared_experts)


def init_moe(cfg, generator, dtype, *, device) -> MoE:
    return MoE(cfg, dtype=dtype, device=device, generator=generator)


def _route(cfg, p, xt):
    """xt [..., T, D] -> (gate_vals, gate_idx, aux): the top-k of the
    router's softmax, renormalised, and the Switch load-balance loss
    ``E * sum_e me_e * f_e``, a product of two token means.  Under a
    data-parallel mesh (``launch.constrain.data_parallel``) both means are
    over the global batch: the expert counts and the token count are summed
    over the data group first, and ``aux`` is this rank's share (its
    tokens' router probabilities over the global count), so the shares sum
    to the global loss.  Under a split over ``model`` ``xt`` is the
    gathered sequence: ``me`` takes the rank's positions and the shares
    are summed over the model group (``reduce``: every rank returns the
    loss, and its gradient reaches each position from one rank)."""
    e, k = cfg.n_experts, cfg.moe_top_k
    logits = torch.einsum("...td,de->...te", xt.to(p.router.dtype),
                          p.router)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = torch.topk(probs, k, dim=-1)
    gate_vals = gate_vals / (gate_vals.sum(-1, keepdim=True) + 1e-9)
    counts = torch.bincount(gate_idx.reshape(-1), minlength=e)
    if data_parallel() or model_split() is not None:
        n_tok = torch.tensor(probs.numel() // e, device=probs.device)
        counts, n_tok = psum_data([counts, n_tok])
        me = local_seq(probs, -2).reshape(-1, e).sum(dim=0) / n_tok
        onehot_mean = counts.float() / (n_tok * k)
        return gate_vals, gate_idx, reduce(e * torch.sum(me * onehot_mean))
    me = probs.reshape(-1, e).mean(dim=0)
    onehot_mean = counts.float() / gate_idx.numel()
    aux = e * torch.sum(me * onehot_mean)
    return gate_vals, gate_idx, aux


def _expert_mlp(cfg, p, xin):
    """xin [..., E, C, D] -> [..., E, C, D]"""
    act = L.mlp_act(cfg)
    h = act(torch.einsum("...ecd,edf->...ecf", xin, p.w_gate)) * \
        torch.einsum("...ecd,edf->...ecf", xin, p.w_up)
    return torch.einsum("...ecf,efd->...ecd", h, p.w_down)


# ------------------------------------------------------------ gather dispatch
def _dispatch_row(e_flat):
    """Slot assignment of one row: ``e_flat`` [Lk] is the expert of each
    (token, slot); returns ``pos`` [Lk], its place in that expert's queue
    (stable order).  Rows of a batched ``e_flat`` [..., Lk] are
    independent."""
    Lk = e_flat.shape[-1]
    order = torch.argsort(e_flat, dim=-1, stable=True)
    sorted_e = e_flat.gather(-1, order).contiguous()
    r = torch.arange(Lk, dtype=torch.int64, device=e_flat.device)
    first = torch.searchsorted(sorted_e, sorted_e, side="left")
    return torch.zeros_like(order).scatter_(-1, order, r - first)


def _slot_tables(cfg, gate_vals, gate_idx, C):
    """``(slot_tok, slot_w, cell)`` of a batch: the token index [B, E, C]
    (``L`` in an empty cell) and gate weight [B, E, C] of each (expert,
    capacity) cell, and the flat cell ``e * C + pos`` of each (token,
    slot) [B, L * k], ``E * C`` where it dropped (``pos >= C``)."""
    B, Lq, k = gate_idx.shape
    e = cfg.n_experts
    e_flat = gate_idx.reshape(B, Lq * k)
    pos = _dispatch_row(e_flat)
    keep = pos < C
    # dropped (token, slot)s go to a dump cell past the table, cut after
    cell = torch.where(keep, e_flat * C + pos, e * C)
    tok = torch.arange(Lq, device=gate_idx.device).repeat_interleave(k)
    slot_tok = torch.full((B, e * C + 1), Lq, dtype=torch.int64,
                          device=gate_idx.device)
    slot_tok.scatter_(1, cell, tok.expand(B, -1))
    slot_w = torch.zeros((B, e * C + 1), dtype=gate_vals.dtype,
                         device=gate_idx.device)
    slot_w.scatter_(1, cell, gate_vals.reshape(B, Lq * k))
    return (slot_tok[:, :e * C].reshape(B, e, C),
            slot_w[:, :e * C].reshape(B, e, C), cell)


def _moe_gather(cfg, p, x):
    """x [B, L, D]; per-row capacity; gather token movement.  With a bank
    split over ``model`` (``p.w_gate`` [E/m, D, F]) only the rank's
    experts run, and the output is their partial sum."""
    B, Lq, D = x.shape
    e, k = cfg.n_experts, cfg.moe_top_k
    C = int(cfg.capacity_factor * Lq * k / e) + 1

    gate_vals, gate_idx, aux = _route(cfg, p, x)          # [B,L,k]
    slot_tok, slot_w, cell = _slot_tables(cfg, gate_vals, gate_idx, C)
    bank = p.w_gate.shape[0]
    if bank < e:
        # this rank's experts' cells; another rank's read the zero row
        first = model_split().index * bank
        slot_tok = slot_tok[:, first:first + bank]
        slot_w = slot_w[:, first:first + bank]
        cell = cell - first * C
        cell = torch.where((cell >= 0) & (cell < bank * C), cell, bank * C)

    x_pad = torch.cat([x, x.new_zeros(B, 1, D)], dim=1)   # row L -> zeros
    rows = torch.arange(B, device=x.device)[:, None]
    xin = x_pad[rows, slot_tok.reshape(B, bank * C)].reshape(B, bank, C, D)
    xin = constrain(xin, BATCH, MODEL)                     # rows x EP
    eout = _expert_mlp(cfg, p, xin)                        # [B, E, C, D]
    eout = constrain(eout, BATCH, MODEL)
    eout = L.checkpoint_name(eout, "moe_eout")
    contrib = eout * slot_w[..., None].to(eout.dtype)

    # combine: each (token, slot) reads its cell (a dropped one the zero
    # row past the table) and a token adds its k slots in slot order
    contrib = torch.cat([contrib.reshape(B, bank * C, D),
                         contrib.new_zeros(B, 1, D)], dim=1)
    got = contrib[rows, cell].reshape(B, Lq, k, D)
    y = got[:, :, 0]
    for j in range(1, k):
        y = y + got[:, :, j]
    y = constrain(y, BATCH)
    return y.to(x.dtype), aux


# ------------------------------------------------------------ einsum dispatch
def _moe_einsum(cfg, p, x):
    """GShard one-hot dispatch (the benchmark arm)."""
    B, Lq, D = x.shape
    e, k = cfg.n_experts, cfg.moe_top_k
    C = int(cfg.capacity_factor * Lq * k / e) + 1
    gate_vals, gate_idx, aux = _route(cfg, p, x)

    onehot = F.one_hot(gate_idx, e).float()                   # [B,L,k,E]
    flat = onehot.reshape(B, Lq * k, e)
    pos = (torch.cumsum(flat, dim=1) - flat).reshape(B, Lq, k, e)
    pos = torch.sum(pos * onehot, dim=-1)                     # [B,L,k]
    keep = pos < C
    # a one-hot that is all zeros past C (jax.nn.one_hot's out of range)
    cs = torch.arange(C, dtype=pos.dtype, device=x.device)
    pos_oh = (pos[..., None] == cs).float() * keep[..., None].float()
    dispatch = torch.einsum("blke,blkc->blec", onehot, pos_oh)
    combine = torch.einsum("blke,blkc,blk->blec", onehot, pos_oh,
                           gate_vals.float())
    xin = torch.einsum("blec,bld->becd", dispatch.to(x.dtype), x)
    eout = _expert_mlp(cfg, p, xin)
    y = torch.einsum("blec,becd->bld", combine.to(x.dtype), eout)
    return y, aux


def moe_ffn(cfg, p, x, dispatch: str = "gather"
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, L, D] -> (y [B, L, D], aux_loss scalar).  Under a split over
    ``model`` ``x`` and ``y`` hold this rank's positions: the routed
    experts run on the gathered sequence, and their output is
    reduce-scattered where the bank is split (the rank's experts' partial
    sums), else the rank's positions kept.  Split shared experts run their
    hidden columns on the same gathered sequence and add their partial
    sums before that one reduce-scatter (one gather and one scatter a
    layer); whole ones run on the rank's positions."""
    xg = gather(x, 1)
    if dispatch == "gather":
        y, aux = _moe_gather(cfg, p, xg)
    else:
        y, aux = _moe_einsum(cfg, p, xg)
    routed_split = p.w_gate.shape[0] < cfg.n_experts
    fs = cfg.expert_d_ff * cfg.n_shared_experts
    if cfg.n_shared_experts and p.shared.w_gate.shape[-1] < fs:
        # the shared experts' hidden columns on the same gathered sequence:
        # their row-parallel partial sums join the routed ones' scatter
        ys = L.dense_mlp(cfg, p.shared, xg)
        if routed_split:
            return scatter(y + ys, 1), aux
        return local_seq(y, 1) + scatter(ys, 1), aux
    y = scatter(y, 1) if routed_split else local_seq(y, 1)
    if cfg.n_shared_experts:
        y = y + L.mlp(cfg, p.shared, x, d_ff=fs)   # whole, on x's positions
    return y, aux

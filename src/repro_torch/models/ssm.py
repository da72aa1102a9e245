"""Mamba2 block: the SSD (state-space duality) algorithm, arXiv:2405.21060.

Chunked linear-time training/prefill path (quadratic only within a chunk)
and an O(1)-state decode path.  Layout per block, as in the JAX package:

  in_proj: x -> [z (d_inner), xBC (d_inner + 2*G*N), dt (H)]
  depthwise causal conv (width 4) over xBC, silu
  split xBC -> x_ssm [H, P], B [G, N], C [G, N]
  SSD recurrence with per-head decay a = exp(dt * A)  (A < 0)
  y = gated_rms_norm(y, z) -> out_proj

Everything after the softplus runs in float32, and the state [B, H, P, N]
is float32 (float64 for a float64 model).  The decode cache is written in place: in decode only the rows
where ``slot_mask`` [B] is True take the new conv window and state (the JAX
engine's ``_merge_cache`` for these leaves).
"""
from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from repro_torch.models import layers as L
from repro_torch.models import unroll as U


class SSD(nn.Module):
    """The mixer's weights, by the JAX package's names: ``w_in``,
    ``conv_w``/``conv_b``, float32 ``A_log`` (A = -exp(A_log)), ``D``,
    ``dt_bias`` and ``norm``, and ``w_out``."""

    def __init__(self, cfg, *, dtype, device, generator=None):
        super().__init__()
        d, di = cfg.d_model, cfg.d_inner
        g, n, hh = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
        cw = cfg.ssm_conv_width
        d_xbc = di + 2 * g * n
        f32 = torch.float32
        self.w_in = L._weight((d, di + d_xbc + hh), d ** -0.5, dtype, device,
                              generator)
        self.conv_w = L._weight((cw, d_xbc), cw ** -0.5, dtype, device,
                                generator)
        self.conv_b = nn.Parameter(torch.zeros(d_xbc, dtype=dtype,
                                               device=device))
        self.A_log = nn.Parameter(torch.zeros(hh, dtype=f32, device=device))
        self.D = nn.Parameter(torch.ones(hh, dtype=f32, device=device))
        self.dt_bias = nn.Parameter(torch.zeros(hh, dtype=f32, device=device))
        self.norm = nn.Parameter(torch.zeros(di, dtype=f32, device=device))
        self.w_out = L._weight((di, d), di ** -0.5, dtype, device, generator)


def init_ssd(cfg, generator, dtype, *, device) -> SSD:
    return SSD(cfg, dtype=dtype, device=device, generator=generator)


def _causal_conv(x, w, b):
    """Depthwise causal conv: x [B, L, C], w [cw, C] -> [B, L, C]."""
    cw, Lq = w.shape[0], x.shape[1]
    x_pad = F.pad(x, (0, 0, cw - 1, 0))
    out = sum(x_pad[:, i:i + Lq] * w[i] for i in range(cw))
    return out + b


def _segsum(l):
    """log-decay cumulative segment sums: l [..., T] ->
    S[..., i, j] = sum_{k=j+1..i} l_k (i >= j), -inf above diagonal."""
    T = l.shape[-1]
    cs = torch.cumsum(l, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]          # sum_{j+1..i}
    mask = torch.tril(torch.ones((T, T), dtype=torch.bool, device=l.device))
    return torch.where(mask, diff, -torch.inf)


def ssd_scan(x, dt, A, B, C, D, chunk: int):
    """Chunked SSD: x [b,L,H,P], dt [b,L,H] (post-softplus), A [H] (negative),
    B,C [b,L,G,N], D [H].  Returns (y [b,L,H,P], final_state [b,H,P,N]),
    both float32 (float64 for a float64 ``x``)."""
    b, Lq, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    rep = H // G
    f = torch.float64 if x.dtype == torch.float64 else torch.float32
    if Lq % chunk:
        raise ValueError(f"sequence length {Lq} is not a multiple of the "
                         f"chunk {chunk}")
    nc = Lq // chunk

    # broadcast groups to heads
    Bh = B.repeat_interleave(rep, dim=2)                 # [b,L,H,N]
    Ch = C.repeat_interleave(rep, dim=2)

    xr = x.reshape(b, nc, chunk, H, P)
    dtr = dt.reshape(b, nc, chunk, H)
    Br = Bh.reshape(b, nc, chunk, H, N).to(f)
    Cr = Ch.reshape(b, nc, chunk, H, N).to(f)

    l_t = (dtr * A).transpose(2, 3)                      # [b,nc,H,c] log-decay
    seg = torch.exp(_segsum(l_t))                        # [b,nc,H,c,c]

    xdt = (xr * dtr[..., None]).to(f)                   # weight inputs by dt

    # ---- intra-chunk (quadratic within chunk)
    scores = torch.einsum("bzihn,bzjhn->bzhij", Cr, Br)
    y_diag = torch.einsum("bzhij,bzjhp->bzihp", scores * seg, xdt)

    # ---- chunk-final states
    cum = torch.cumsum(l_t, dim=-1)
    decay_to_end = torch.exp(cum[..., -1:] - cum)        # [b,nc,H,c]
    states = torch.einsum("bzjhn,bzhj,bzjhp->bzhpn", Br, decay_to_end, xdt)

    # ---- inter-chunk recurrence (scan over chunks)
    chunk_decay = torch.exp(cum[..., -1])                # [b,nc,H]

    def step(h_prev, inp):
        st, dec = inp                                    # [b,H,P,N], [b,H]
        return h_prev * dec[..., None, None] + st, h_prev

    h0 = torch.zeros((b, H, P, N), dtype=f, device=x.device)
    h_final, h_prevs = U.scan(step, h0, (states.transpose(0, 1),
                                         chunk_decay.transpose(0, 1)))
    h_prevs = h_prevs.transpose(0, 1)                    # [b,nc,H,P,N]

    # ---- inter-chunk contribution
    decay_from_start = torch.exp(cum)                    # [b,nc,H,c]
    y_off = torch.einsum("bzihn,bzhi,bzhpn->bzihp", Cr, decay_from_start,
                         h_prevs)

    y = (y_diag + y_off).reshape(b, Lq, H, P)
    y = y + x.to(f) * D[None, None, :, None]
    return y, h_final


def ssd_decode_step(x, dt, A, B, C, D, state):
    """One-token recurrence: x [b,H,P], dt [b,H], B,C [b,G,N],
    state [b,H,P,N] -> (y [b,H,P], new_state), both float32."""
    H = x.shape[1]
    rep = H // B.shape[1]
    Bh = B.repeat_interleave(rep, dim=1).float()         # [b,H,N]
    Ch = C.repeat_interleave(rep, dim=1).float()
    decay = torch.exp(dt * A)                            # [b,H]
    upd = torch.einsum("bhp,bhn->bhpn", (x * dt[..., None]).float(), Bh)
    new_state = state * decay[..., None, None] + upd
    y = torch.einsum("bhpn,bhn->bhp", new_state, Ch)
    y = y + x.float() * D[None, :, None]
    return y, new_state


def ssd_block(cfg, p, x, *, cache=None, pos=None, slot_mask=None):
    """The Mamba2 mixer; returns (y, cache).  ``cache`` = {"conv": [B, cw-1,
    d_xbc], "state": [B, H, P, N]}, written in place: None in training; a
    prefill (L > 1, from an empty state) leaves the last ``cw - 1`` raw
    conv inputs and the final state; decode (L == 1) rolls the conv window
    and takes one recurrence step, for the rows ``slot_mask`` selects
    (all when None).  ``pos`` is not read: the state carries the history."""
    Bt, Lq, _ = x.shape
    di = cfg.d_inner
    g, n, hh = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
    P = cfg.ssm_head_dim
    cw = cfg.ssm_conv_width
    d_xbc = di + 2 * g * n

    zxbcdt = L._dense(x, p.w_in)
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di:di + d_xbc]
    dt_raw = zxbcdt[..., di + d_xbc:]
    A = -torch.exp(p.A_log)
    dt = F.softplus(dt_raw.float() + p.dt_bias)

    if cache is not None and Lq == 1:
        # ---- decode: roll the conv window, single recurrence step
        conv_st, state = cache["conv"], cache["state"]
        window = torch.cat([conv_st, xbc.to(conv_st.dtype)], dim=1)
        conv_out = torch.einsum("btc,tc->bc", window, p.conv_w) + p.conv_b
        xbc_c = F.silu(conv_out)[:, None]                # [B, 1, d_xbc]
        x_ssm = xbc_c[..., :di].reshape(Bt, hh, P)
        Bm = xbc_c[..., di:di + g * n].reshape(Bt, g, n)
        Cm = xbc_c[..., di + g * n:].reshape(Bt, g, n)
        y, new_state = ssd_decode_step(x_ssm, dt[:, 0], A, Bm, Cm, p.D,
                                       state)
        y = y.reshape(Bt, 1, di)
        new_conv = window[:, 1:]
        if slot_mask is not None:
            new_conv = torch.where(slot_mask[:, None, None], new_conv,
                                   conv_st)
            new_state = torch.where(slot_mask[:, None, None, None],
                                    new_state, state)
        conv_st.copy_(new_conv)
        state.copy_(new_state)
    else:
        xbc_c = F.silu(_causal_conv(xbc, p.conv_w, p.conv_b))
        x_ssm = xbc_c[..., :di].reshape(Bt, Lq, hh, P)
        Bm = xbc_c[..., di:di + g * n].reshape(Bt, Lq, g, n)
        Cm = xbc_c[..., di + g * n:].reshape(Bt, Lq, g, n)
        y, final_state = ssd_scan(x_ssm, dt, A, Bm, Cm, p.D,
                                  min(cfg.ssm_chunk, Lq))
        y = y.reshape(Bt, Lq, di)
        if cache is not None:                            # prefill
            if Lq < cw - 1:
                raise ValueError(f"a prefill of {Lq} tokens is shorter than "
                                 f"the conv window's {cw - 1}")
            cache["conv"].copy_(xbc[:, Lq - (cw - 1):])
            cache["state"].copy_(final_state)

    # gated RMS norm then out-projection
    y = y.to(x.dtype) * F.silu(z)
    y = L.rms_norm(y, p.norm)
    return L._dense(y, p.w_out), cache


def init_ssd_cache(cfg, batch, dtype, *, device):
    g, n = cfg.ssm_groups, cfg.ssm_state
    d_xbc = cfg.d_inner + 2 * g * n
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv_width - 1, d_xbc),
                            dtype=dtype, device=device),
        "state": torch.zeros((batch, cfg.ssm_heads, cfg.ssm_head_dim, n),
                             dtype=torch.float32, device=device),
    }

"""A plain decoder: token embedding; per block pre-norm attention (q, k, v
projections, rotary embedding on q and k in halves, causal attention, dense
or inside a band of ``bandwidth`` keys, the output projection) and pre-norm
gated SiLU MLP whose three weights are block-sparse; a final norm and the
LM head.  RMS norms scale by ``1 + s``.

Each sparse weight is made dense from its stored blocks and multiplied
densely.  Attention runs in chunks of ``CHUNK`` queries against the keys
they can see, with the mask applied element by element.  Everything runs
in float32 with TF32 off (``exact_float32``), from the served weights'
values.  ``precision="fp8"`` is the control: the same model with every
matrix product's two operands rounded to float8 e4m3, and in the backward
every product's incoming gradient to e5m2 (each scaled by its largest
magnitude, as an fp8 product is fed), accumulating in float32.
"""
from __future__ import annotations

import contextlib

import torch
from torch.nn import functional as F
from torch.utils import checkpoint

CHUNK = 1024
FP8_MAX = 448.0


@contextlib.contextmanager
def exact_float32():
    """Float32 products in float32: TF32 off for matmuls and cuDNN."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _fp8(x: torch.Tensor, dtype) -> torch.Tensor:
    """``x`` rounded to the fp8 ``dtype`` under a scale that maps its
    largest magnitude to the format's largest, back in float32."""
    top = torch.finfo(dtype).max
    scale = x.abs().amax().clamp_min(1e-30) / top
    return (x / scale).to(dtype).to(torch.float32) * scale


class _Operand(torch.autograd.Function):
    """A product's operand in e4m3; its gradient passes straight."""

    @staticmethod
    def forward(ctx, x):
        return _fp8(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return g


class _Output(torch.autograd.Function):
    """A product's output; the gradient it sends back, the backward
    products' operand, in e5m2 (fp8 training's format for gradients)."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _fp8(g, torch.float8_e5m2)


def to_fp8(x: torch.Tensor) -> torch.Tensor:
    return _Operand.apply(x)


def fp8_out(y: torch.Tensor) -> torch.Tensor:
    return _Output.apply(y)


class Decoder:
    """The reference model over float32 copies of ``weights`` (the
    benchmark's ``inputs.Weights``: dense leaves by parameter name, the
    sparse matrices' block patterns).  With ``train`` its leaves require
    gradients and ``leaves`` holds them by name."""

    def __init__(self, model: dict, weights, precision: str = "float32",
                 train: bool = False):
        if model["mlp_act"] != "silu":
            raise ValueError("the reference's MLP is gated SiLU")
        if precision not in ("float32", "fp8"):
            raise ValueError(f"unknown precision {precision!r}")
        self.model, self.fp8 = model, precision == "fp8"
        self.leaves = {k: v.detach().float().clone().requires_grad_(train)
                       for k, v in weights.dense.items()}
        self.patterns = weights.patterns
        self.shapes = weights.shapes

    # ------------------------------------------------------------- pieces
    def mm(self, a, b):
        if self.fp8:
            return fp8_out(to_fp8(a) @ to_fp8(b))
        return a @ b

    def norm(self, x, s):
        eps = self.model["norm_eps"]
        return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
            * (1.0 + s)

    def rope(self, x, pos):
        dh = x.shape[-1]
        freqs = 1.0 / (self.model["rope_theta"] ** (
            torch.arange(0, dh, 2, dtype=torch.float32, device=x.device)
            / dh))
        ang = pos[:, None].float() * freqs
        sin, cos = ang.sin()[:, None, :], ang.cos()[:, None, :]
        x1, x2 = x.chunk(2, dim=-1)
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)

    def sparse_weight(self, key):
        """The dense [out, in] matrix of a sparse FFN weight."""
        vals = self.leaves[key + ".vals"]
        h, w = vals.shape[-2:]
        out_dim, in_dim = self.shapes[key]
        nbr, nbc = out_dim // h, in_dim // w
        blocks = vals.new_zeros(nbr * nbc, h, w).index_copy(
            0, self.patterns[key], vals)
        return blocks.reshape(nbr, nbc, h, w).permute(0, 2, 1, 3) \
            .reshape(out_dim, in_dim)

    def attention(self, q, k, v):
        """q, k, v [T, H, dh] -> [T, H, dh], causal, inside the band."""
        T, _, dh = q.shape
        attn = self.model["attention"]
        band = attn["bandwidth"] if attn["kind"] == "banded" else None
        out = []
        pos = torch.arange(T, device=q.device)
        for c0 in range(0, T, CHUNK):
            c1 = min(T, c0 + CHUNK)
            lo = 0 if band is None else max(0, c0 - band + 1)
            qp, kp = pos[c0:c1, None], pos[None, lo:c1]
            ok = kp <= qp
            if band is not None:
                ok = ok & (kp > qp - band)
            qc, kc, vc = q[c0:c1], k[lo:c1], v[lo:c1]
            if self.fp8:
                qc, kc, vc = to_fp8(qc), to_fp8(kc), to_fp8(vc)
            s = torch.einsum("qhd,khd->hqk", qc, kc) * dh ** -0.5
            if self.fp8:
                s = fp8_out(s)
            p = torch.softmax(s.masked_fill(~ok, float("-inf")), dim=-1)
            if self.fp8:
                p = to_fp8(p)
            o = torch.einsum("hqk,khd->qhd", p, vc)
            out.append(fp8_out(o) if self.fp8 else o)
        return torch.cat(out, 0)

    def block(self, i, x, kv_positions=None):
        """Block ``i`` on x [T, d]; with ``kv_positions`` also returns the
        block's rotated keys and its values at those positions."""
        P, m = self.leaves, self.model
        pre = f"blocks.{i}"
        T = x.shape[0]
        H, dh = m["n_heads"], m["head_dim"]
        h = self.norm(x, P[pre + ".ln1"])
        pos = torch.arange(T, device=x.device)
        q = self.rope(self.mm(h, P[pre + ".attn.wq"]).view(T, H, dh), pos)
        k = self.rope(self.mm(h, P[pre + ".attn.wk"]).view(T, H, dh), pos)
        v = self.mm(h, P[pre + ".attn.wv"]).view(T, H, dh)
        ctx = self.attention(q, k, v).reshape(T, H * dh)
        x = x + self.mm(ctx, P[pre + ".attn.wo"])
        h = self.norm(x, P[pre + ".ln2"])
        g = self.mm(h, self.sparse_weight(pre + ".mlp.gate").T)
        u = self.mm(h, self.sparse_weight(pre + ".mlp.up").T)
        x = x + self.mm(F.silu(g) * u,
                        self.sparse_weight(pre + ".mlp.down").T)
        if kv_positions is None:
            return x
        return x, k[kv_positions], v[kv_positions]

    def head(self, x):
        return self.mm(self.norm(x, self.leaves["final_norm"]),
                       self.leaves["lm_head"])

    # --------------------------------------------------------- entries
    def prefill(self, tokens, kv_positions):
        """One prompt ``tokens`` [T]: its last position's logits [V] and
        every block's keys and values at ``kv_positions``, each [n_layers,
        P, H, dh]."""
        with torch.no_grad(), exact_float32():
            x = self.leaves["embed"][tokens]
            ks, vs = [], []
            for i in range(self.model["n_layers"]):
                x, k, v = self.block(i, x, kv_positions)
                ks.append(k)
                vs.append(v)
            return self.head(x[-1:])[0], torch.stack(ks), torch.stack(vs)

    def row_loss_sum(self, row):
        """Summed next-token NLL of one row of ``L + 1`` ids, each block
        recomputed in the backward."""
        x = self.leaves["embed"][row[:-1]]
        for i in range(self.model["n_layers"]):
            x = checkpoint.checkpoint(self.block, i, x, use_reentrant=False)
        logits = self.head(x)
        return F.cross_entropy(logits, row[1:], reduction="sum")


def train_steps(model: dict, weights, batches, opt: dict,
                precision: str = "float32") -> dict:
    """AdamW steps of the reference on ``batches`` (each [rows, L + 1]
    ids), one row at a time with the gradients summed: the mean loss over
    every position of each step, each leaf's clipped gradient of the first
    step as the update reads it, and each leaf's change over all the
    steps, as norms."""
    from bench.reference import adamw
    dec = Decoder(model, weights, precision=precision, train=True)
    leaves = dec.leaves
    start = {k: v.detach().clone() for k, v in leaves.items()}
    state = adamw.init(leaves)
    losses, first = [], None
    with exact_float32():
        for step, batch in enumerate(batches, start=1):
            for p in leaves.values():
                p.grad = None
            n = batch.shape[0] * (batch.shape[1] - 1)
            total = 0.0
            for row in batch:
                loss = dec.row_loss_sum(row) / n
                loss.backward()
                total += float(loss.detach())
            losses.append(total)
            grads = {k: p.grad for k, p in leaves.items()}
            clipped = adamw.update(opt, leaves, grads, state, step)
            if first is None:
                first = {k: float(g.norm()) for k, g in clipped.items()}
    delta = {k: float((leaves[k].detach() - start[k]).norm())
             for k in leaves}
    return {"losses": losses, "grad_norms": first, "delta_norms": delta}

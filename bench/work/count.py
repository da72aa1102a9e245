"""Operations of one training step or one batch of prompts of a decoder with a
block-sparse FFN and dense causal or banded block-sparse attention.

A frozen copy of the rules of ``repro_torch.launch.roofline.work_count`` for
the ``attn_mlp`` layout: dense products count 2*m*k*n (the attention
projections; the LM head at the positions whose logits the step needs: all
of them in training, the last in a prefill, which returns only those); a
sparse FFN product counts 2*h*w a token over each stored block; attention
counts 2*dh each for its scores and its context per (query, key) pair a
head evaluates: the lower triangle for dense causal attention, the live
blocks' h*w for a block-sparse mask.  Training counts three times the
forward (forward, dX, dW); recompute is not counted.  Norms, softmax and
elementwise work are left out, as a share of peak should.
"""
from __future__ import annotations


def causal_pairs(seq: int) -> int:
    """(query, key) pairs of causal attention over ``seq`` positions."""
    return seq * (seq + 1) // 2


def banded_row_blocks(seq: int, bandwidth: int, block) -> list:
    """Live blocks of each block-row of a banded causal mask (query q sees
    keys ``(q - bandwidth, q]``) at ``seq`` positions in ``block`` tiles: a
    block (i, j) is live when some q of block-row i and k of block-col j
    have ``k <= q`` and ``k > q - bandwidth``."""
    h, w = block
    nbr, nbc = -(-seq // h), -(-seq // w)
    rows = []
    for i in range(nbr):
        qa, qb = i * h, min(i * h + h, seq) - 1
        live = 0
        for j in range(nbc):
            ka, kb = j * w, min(j * w + w, seq) - 1
            lo = max(qa, ka)                      # k <= q needs q >= ka
            if lo <= min(qb, kb + bandwidth - 1):
                live += 1
        rows.append(live)
    return rows


def attn_pairs(model, seq: int) -> int:
    """(query, key) pairs one head of one layer evaluates on a sequence."""
    attn = model["attention"]
    if attn["kind"] == "dense_causal":
        return causal_pairs(seq)
    h, w = attn["block"]
    return sum(banded_row_blocks(seq, attn["bandwidth"], attn["block"])) \
        * h * w


def forward_flops(model, rows: int, seq: int, head_rows: int) -> float:
    """Forward operations over ``rows`` sequences of ``seq`` positions, the
    LM head at ``head_rows`` positions."""
    d, n = model["d_model"], model["n_layers"]
    H, KV, dh = model["n_heads"], model["n_kv_heads"], model["head_dim"]
    tokens = rows * seq
    proj = 2.0 * tokens * (d * H * dh + 2 * d * KV * dh + H * dh * d) * n
    attn = 4.0 * dh * H * rows * attn_pairs(model, seq) * n
    ffn_model = model["ffn"]
    h, w = ffn_model["block"]
    ffn = float(tokens) * n * 3 * 2 * ffn_model["nnzb"] * h * w
    head = 2.0 * head_rows * d * model["vocab_size"]
    return proj + attn + ffn + head


def train_step_flops(model, rows: int, seq: int) -> float:
    """One training step: three times the forward, logits everywhere."""
    return 3.0 * forward_flops(model, rows, seq, rows * seq)


def prefill_flops(model, rows: int, seq: int) -> float:
    """A batch of ``rows`` prompts of ``seq`` tokens: each row's last
    position's logits only."""
    return forward_flops(model, rows, seq, rows)

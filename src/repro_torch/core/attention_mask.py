"""Static attention-mask specs for block-sparse attention.

Host-side dataclasses and the element-level predicate: the leaf layer of the
attention subsystem, which ``configs`` imports to declare an arch's mask and
``models.attention`` builds the BCSR pipeline and the layer on (and
re-exports, so ``from repro_torch.models import attention as A;
A.banded(...)`` is the user-facing spelling, as in the JAX package).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

NEG_INF = -2.0e38


@dataclasses.dataclass(frozen=True)
class AttnMaskSpec:
    """Static element-level attention mask pattern (hashable).

    ``kind`` picks the predicate; every kind is causal.  ``window_cap``
    intersects an additional sliding-window bound (used when a config
    combines ``sliding_window`` with sparse attention).  Build instances
    with the ``banded`` / ``local_global`` / ``blockwise_causal``
    constructors below.
    """
    kind: str                     # banded | local_global | blockwise_causal
    bandwidth: int = 0            # banded: k > q - bandwidth
    window: int = 0               # local_global: local window
    n_global: int = 0             # local_global: always-visible prefix keys
    window_cap: int = 0           # optional extra sliding-window intersect


def banded(bandwidth: int) -> AttnMaskSpec:
    """Sliding-window (banded) causal mask: query q sees keys
    ``(q - bandwidth, q]``.

    >>> from repro_torch.models import attention as A
    >>> spec = A.banded(32)
    >>> meta = A.attention_mask_meta(spec, seq_len=128, block=(16, 16))
    >>> (meta.shape, meta.nnzb > 0, meta.max_bpr)
    ((128, 128), True, 3)
    """
    if bandwidth < 1:
        raise ValueError(f"bandwidth must be >= 1, got {bandwidth}")
    return AttnMaskSpec(kind="banded", bandwidth=bandwidth)


def local_global(window: int, n_global: int) -> AttnMaskSpec:
    """Local sliding window + a globally visible key prefix (the
    longformer/big-bird shape): query q sees keys ``(q - window, q]`` and
    keys ``< n_global``.

    >>> from repro_torch.models import attention as A
    >>> m_lg = A.attention_mask_meta(A.local_global(32, 16), 128, (16, 16))
    >>> m_b = A.attention_mask_meta(A.banded(32), 128, (16, 16))
    >>> m_lg.nnzb > m_b.nnzb        # the global column strip adds blocks
    True
    """
    if window < 1 or n_global < 0:
        raise ValueError(f"bad local_global({window}, {n_global})")
    return AttnMaskSpec(kind="local_global", window=window,
                        n_global=n_global)


def blockwise_causal() -> AttnMaskSpec:
    """Plain causal attention realized blockwise: every block on or below
    the block diagonal is stored, the diagonal blocks mask element-causally
    inside.  Numerically dense causal attention, at dense-causal cost: the
    correctness anchor; the banded/local_global specs are the sparse ones."""
    return AttnMaskSpec(kind="blockwise_causal")


def mask_allowed(spec: AttnMaskSpec, q_pos, k_pos):
    """Element-level predicate ``[..., Lq, Sk]``: works on numpy arrays
    (host mask construction) and on torch tensors (the decode-step bias)
    alike."""
    q = q_pos[..., :, None]
    k = k_pos[..., None, :]
    ok = (k <= q) & (k >= 0)
    if spec.kind == "banded":
        ok = ok & (k > q - spec.bandwidth)
    elif spec.kind == "local_global":
        ok = ok & ((k > q - spec.window) | (k < spec.n_global))
    elif spec.kind != "blockwise_causal":
        raise ValueError(f"unknown mask kind {spec.kind!r}")
    if spec.window_cap:
        ok = ok & (k > q - spec.window_cap)
    return ok


@dataclasses.dataclass(frozen=True)
class AttnSparsitySpec:
    """Config for block-sparse attention (``ModelConfig.attn_sparsity``).

    The fields are the JAX package's, less ``interpret`` (a Pallas option
    with no meaning on the card).  ``mask`` is the static pattern,
    ``block`` the BCSR tile of the score matrix.  ``backend`` names the
    attention-level path: ``"fused"`` runs kernel B5 (``kernels.bcsr_attn``,
    one launch, composed backward); ``"auto"`` asks the tuner's ``attn``
    family for fused or composed; any ops backend (``nnz_stream``, alias
    ``pallas``, ``row_loop``, ``xla``, ``dense``) runs the composed SDDMM ->
    block softmax -> SpMM path on it.  ``bn`` is the JAX package's TPU tile,
    kept for config parity and not read: the kernels take their own tiles.
    ``shards > 0`` (the partitioned score structure, ROADMAP A5) raises.
    ``paged_decode`` gates the serving decode path: ``"auto"`` reads KV
    through the mask's page table where that reads fewer pages than the
    cache holds, ``"force"`` wherever pages tile the cache, ``"off"`` keeps
    the dense-bias decode (``models.layers._decode_pages``)."""
    mask: AttnMaskSpec = dataclasses.field(default_factory=blockwise_causal)
    block: Tuple[int, int] = (16, 16)
    backend: str = "auto"   # fused | auto | nnz_stream | row_loop | xla | dense
    bn: int = 512
    shards: int = 0                 # >0: row-shard the score structure
    paged_decode: str = "auto"      # auto | force | off (serving decode)

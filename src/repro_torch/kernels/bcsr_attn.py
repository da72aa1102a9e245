"""Hand-written CUDA kernel for fused block-sparse attention (B5), and its
wrapper.

``bcsr_attn_fused`` replaces the Pallas TPU kernel of the same name
(``repro/kernels/bcsr_attn.py:132``, body ``_attn_fused_kernel`` at
``:60``): the SDDMM scores, the masked block softmax and the context SpMM
of block-sparse attention in one launch, over the static (block-row x
slot) schedule of the mask (``ops._sddmm_row_loop_schedule``: padding slots
hold the sentinel entry ``nnzb``).  The kernel is
``csrc/bcsr_attn.cu``; its header says how it is laid out (two passes over
a row's live slots, Q K^T and z V as 3xTF32 on the tensor cores, the mask
as one bit per element) and what bounds it (operations: at smat-attn-1.3b's
full width about 213 GFLOP per launch, 1.29 ms on an H100 SXM at the
3xTF32 rate).  The wrapper dispatches on the device of its operands: a CPU
tensor goes to the plain version ``ref.bcsr_attn_fused_ref``, a CUDA tensor
launches the kernel or raises -- it never falls back.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch
from torch.nn import functional as F

from repro_torch.kernels import _build, ref

# kernel launches since the last reset (a plain integer, reset by
# assignment), read beside ``bcsr_spmm.LAUNCHES``
LAUNCHES = {"attn_fused": 0}

MAX_D = 256        # widest q/k row and v row the kernel holds
MAX_W = 128        # widest mask block the kernel holds

_C, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = ([_C] * 7 +        # q k v ebits flat_idx flat_col out
             [_I] * 10 +       # G lq lk d dv nbr max_bpr h w nnzb
             [_F, _F, _I, _I, _C])  # scale cap use_cap vec stream

# the library's queries for the static analyzer (``query``)
QUERY_ARGTYPES = {"bcsr_attn_fused_smem_bytes": [_I] * 3,   # d h max_bpr
                  "bcsr_attn_fused_threads": [_I]}          # h


def _lib(symbol: str = "bcsr_attn_fused"):
    fn = getattr(_build.load("bcsr_attn"), symbol)
    if fn.argtypes is None:
        fn.argtypes = QUERY_ARGTYPES.get(symbol, _ARGTYPES)
        fn.restype = ctypes.c_int
    return fn


def query(symbol: str, *args) -> int:
    """Call one of the library's plain C queries: ``bcsr_attn_fused_smem_
    bytes(d, h, max_bpr)``, the dynamic shared memory of a launch from the
    constants the launch uses, or ``bcsr_attn_fused_threads(h)``.  No
    kernel is launched; the library is built on first use (the card's
    machine only).  ``analysis.workspace.attn_smem_bytes`` is held to it
    there."""
    return int(_lib(symbol)(*args))


def pack_emask(emask: torch.Tensor) -> torch.Tensor:
    """The element mask ``[nnzb, h, w]`` (nonzero = valid) packed one bit
    per element, as kernel B5 reads it: ``[nnzb + 1, h, ceil(w / 32)]``
    int32, bit ``c % 32`` of word ``c // 32`` holding element ``c`` of a
    row (bits past ``w`` zero), and an all-zero block appended for the
    sentinel entry ``nnzb``.  At 8,192 tokens in 128x128 blocks that is
    3.2 MB a layer in place of the f32 mask's 104 MB.
    ``ref.unpack_ebits`` inverts it.

    >>> import torch
    >>> from repro_torch.kernels import bcsr_attn, ref
    >>> em = torch.zeros(1, 2, 40)
    >>> em[0, 0, 0] = em[0, 1, 31] = em[0, 1, 33] = 1
    >>> bits = bcsr_attn.pack_emask(em)
    >>> bits.shape, bits.dtype
    (torch.Size([2, 2, 2]), torch.int32)
    >>> bits[0].tolist()
    [[1, 0], [-2147483648, 2]]
    >>> bool((ref.unpack_ebits(bits, 40)[:1] == (em != 0)).all())
    True
    """
    nnzb, h, w = emask.shape
    words = -(-w // 32)
    bits = F.pad(emask != 0, (0, 32 * words - w)).reshape(nnzb, h, words, 32)
    weight = torch.ones(32, dtype=torch.int64, device=emask.device) << \
        torch.arange(32, device=emask.device)
    packed = (bits.to(torch.int64) * weight).sum(-1)     # [0, 2**32)
    packed = torch.where(packed >= 2 ** 31, packed - 2 ** 32, packed)
    return torch.cat([packed.to(torch.int32),
                      packed.new_zeros((1, h, words), dtype=torch.int32)])


def _check(q, k, v, emask, ebits, flat_idx, flat_col, n_block_rows,
           n_block_cols, block) -> int:
    """Argument checks of the kernel path; returns ``max_bpr``."""
    h, w = block
    dev = q.device
    for name, t in (("q", q), ("k", k), ("v", v), ("emask", emask)):
        if t.device != dev or t.dtype != torch.float32:
            raise ValueError(f"{name} must be a float32 tensor on {dev}, "
                             f"got {t.dtype} on {t.device}")
    for name, t in (("flat_idx", flat_idx), ("flat_col", flat_col),
                    ("ebits", ebits)):
        if t.device != dev or t.dtype != torch.int32 or \
                not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous int32 tensor on "
                             f"{dev}")
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError("q, k, v must be [G, L, d]")
    G, Lq, d = q.shape
    if k.shape[0] != G or v.shape[0] != G or k.shape[2] != d or \
            v.shape[1] != k.shape[1]:
        raise ValueError(f"shapes do not fit: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if emask.dim() != 3 or tuple(emask.shape[1:]) != (h, w) or \
            not emask.is_contiguous():
        raise ValueError(f"emask must be a contiguous [nnzb, {h}, {w}] "
                         f"tensor, got {tuple(emask.shape)}")
    words = -(-w // 32)
    if tuple(ebits.shape) != (emask.shape[0] + 1, h, words):
        raise ValueError(f"ebits must be [nnzb + 1, {h}, {words}] (the "
                         f"sentinel block included), got "
                         f"{tuple(ebits.shape)}")
    max_bpr = flat_idx.shape[0] // max(n_block_rows, 1)
    if flat_idx.shape != (n_block_rows * max_bpr,) or max_bpr < 1 or \
            flat_col.shape != flat_idx.shape:
        raise ValueError(f"the schedule does not fit {n_block_rows} "
                         f"block-rows: flat_idx {tuple(flat_idx.shape)}, "
                         f"flat_col {tuple(flat_col.shape)}")
    if n_block_rows * h < Lq or n_block_cols * w < k.shape[1]:
        raise ValueError(f"the mask ({n_block_rows}x{n_block_cols} blocks "
                         f"of {block}) does not cover Lq={Lq}, "
                         f"Lk={k.shape[1]}")
    if d > MAX_D or v.shape[2] > MAX_D or w > MAX_W:
        raise ValueError(f"bcsr_attn_fused holds d, dv <= {MAX_D} and block "
                         f"width <= {MAX_W}; got d={d}, dv={v.shape[2]}, "
                         f"w={w}")
    return max_bpr


def bcsr_attn_fused(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    emask: torch.Tensor, flat_idx: torch.Tensor,
                    flat_col: torch.Tensor, *, n_block_rows: int,
                    n_block_cols: int, block, scale: float,
                    cap: Optional[float] = None, out_dtype=None,
                    ebits: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fused block-sparse attention over a static BCSR mask schedule.

    q, k, v   ``[G, Lq, d]`` / ``[G, Lk, d]`` / ``[G, Lk, dv]``, G folded
              (batch * heads) instances sharing one mask structure.
    emask     ``[nnzb, h, w]`` float 0/1: the valid (stored AND allowed AND
              non-padding) elements of each stored block, entries sorted
              row-major.
    flat_idx  ``[nbr * max_bpr]`` entry index per (block-row, slot);
              padding slots hold the sentinel index ``nnzb``.
    flat_col  ``[nbr * max_bpr]`` block-col per (block-row, slot).
    scale     applied to the scores before the optional ``cap`` tanh
              soft-clip, as ``models.attention.block_softmax`` does.
    ebits     optional ``pack_emask(emask)``, the mask the kernel reads
              (``models.attention.mask_tensors`` caches it); packed here
              from ``emask`` when not given.

    Returns ``[G, Lq, dv]`` in ``out_dtype`` (default ``q.dtype``); query
    rows with no valid element get an all-zero context.  The row max is
    taken over all of a row's slots first; then exp(logit - max) is summed
    and multiplied by V together, and the context divided by the sum once
    at the end.  Ragged ``Lq``,
    ``Lk`` and contraction widths need no padded copies: the kernel stages
    what lies past them as zeros.  The kernel takes float32 operands (the
    attention's contract) with d, dv <= 256 and a block width <= 128.

    >>> import numpy as np, torch
    >>> from repro_torch.kernels import bcsr_attn
    >>> L, d = 8, 4
    >>> rng = np.random.default_rng(0)
    >>> q, k, v = (torch.from_numpy(rng.standard_normal((1, L, d))).float()
    ...            for _ in range(3))
    >>> # causal mask on a 2x2 block grid: stored blocks (0,0) (1,0) (1,1)
    >>> qpos = np.arange(L)[:, None]; kpos = np.arange(L)[None, :]
    >>> elem = (kpos <= qpos).reshape(2, 4, 2, 4).transpose(0, 2, 1, 3)
    >>> emask = torch.from_numpy(elem[[0, 1, 1], [0, 0, 1]].astype("f4"))
    >>> flat_idx = torch.tensor([0, 3, 1, 2], dtype=torch.int32)
    >>> flat_col = torch.tensor([0, 0, 0, 1], dtype=torch.int32)
    >>> out = bcsr_attn.bcsr_attn_fused(
    ...     q, k, v, emask, flat_idx, flat_col, n_block_rows=2,
    ...     n_block_cols=2, block=(4, 4), scale=0.5)
    >>> out.shape
    torch.Size([1, 8, 4])
    >>> s = (q[0] @ k[0].T) * 0.5
    >>> p = torch.softmax(s.masked_fill(torch.from_numpy(kpos > qpos),
    ...                                 -2.0e38), dim=-1)
    >>> bool(torch.allclose(out[0], p @ v[0], atol=1e-5))
    True
    """
    out_dtype = out_dtype or q.dtype
    if q.device.type == "cpu":
        return ref.bcsr_attn_fused_ref(
            q, k, v, emask, flat_idx, flat_col, n_block_rows=n_block_rows,
            n_block_cols=n_block_cols, block=block, scale=scale, cap=cap,
            out_dtype=out_dtype, ebits=ebits)
    if q.device.type != "cuda":
        raise ValueError(f"bcsr_attn_fused: no kernel for device {q.device}")
    if ebits is None:
        ebits = pack_emask(emask)
    max_bpr = _check(q, k, v, emask, ebits, flat_idx, flat_col,
                     n_block_rows, n_block_cols, block)
    h, w = block
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    G, Lq, d = q.shape
    Lk, dv = v.shape[1], v.shape[2]
    # 16-byte copies where every row of q, k and v starts aligned
    vec = 16 if (d % 4 == 0 and dv % 4 == 0 and
                 all(t.data_ptr() % 16 == 0 for t in (q, k, v))) else 4
    out = torch.empty((G, Lq, dv), dtype=torch.float32, device=q.device)
    if G and Lq and n_block_rows:
        with torch.cuda.device(q.device):
            err = _lib()(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), ebits.data_ptr(),
                flat_idx.data_ptr(), flat_col.data_ptr(), out.data_ptr(),
                G, Lq, Lk, d, dv, n_block_rows, max_bpr, h, w,
                emask.shape[0], float(scale),
                float(cap) if cap is not None else 0.0, int(cap is not None),
                vec, torch.cuda.current_stream(q.device).cuda_stream)
        if err:
            raise RuntimeError(f"bcsr_attn_fused: kernel launch failed with "
                               f"CUDA error {err}")
        LAUNCHES["attn_fused"] += 1
    return out if out_dtype == torch.float32 else out.to(out_dtype)

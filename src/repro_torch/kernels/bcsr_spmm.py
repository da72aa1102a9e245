"""Hand-written CUDA kernels for BCSR SpMM and SDDMM, and their wrappers.

``bcsr_spmm_nnz_stream`` and ``bcsr_sddmm`` replace the Pallas TPU kernels
of the same names (``repro/kernels/bcsr_spmm.py:67`` and ``:189``).  The
kernels are ``csrc/bcsr_spmm.cu`` and ``csrc/bcsr_sddmm.cu``; their headers
say how they are laid out and what bounds them.  Each wrapper dispatches on
the device of its operands: a CPU tensor goes to the plain version
(``ref.bcsr_spmm_ref``, ``ref.bcsr_sddmm_ref``), a CUDA tensor launches the
kernel or raises — it never falls back.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

# kernel launches since the last reset — a run reads it to show that its
# path went through the kernel (plain integers, reset by assignment)
LAUNCHES = {"nnz_stream": 0, "sddmm": 0}

_TYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_C, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# (source, C symbol) -> argument types of the C interface
_ARGTYPES = {
    ("bcsr_spmm", "bcsr_spmm_nnz_stream"): [
        _C, _C, _C, _C, _C,              # vals rowptr col_ids b out
        _I, _I, _I, _I, _LL, _LL,        # nbr h w N, b's strides
        _I, _I, _I, _C],                 # bn in_type out_type stream
    ("bcsr_sddmm", "bcsr_sddmm"): [
        _C, _C, _C, _C, _C,              # dc b row_ids col_ids out
        _I, _I, _I, _I,                  # nnzb h w N
        _LL, _LL, _LL, _LL,              # dc's strides, b's strides
        _I, _I, _C],                     # in_type out_type stream
}


def _lib(source: str, symbol: str):
    """The C function ``symbol`` of ``csrc/<source>.cu``, built on first
    use."""
    fn = getattr(_build.load(source), symbol)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[(source, symbol)]
        fn.restype = ctypes.c_int
    return fn


def tile_n(n: int) -> int:
    """The kernel's N-tile: the smallest of 8/16/32/64 that covers ``n``
    (decode feeds a handful of tokens), else 64."""
    for bn in (8, 16, 32):
        if n <= bn:
            return bn
    return 64


def rowptr_from_rows(row_ids: torch.Tensor, n_block_rows: int) -> torch.Tensor:
    """Device twin of ``core.bcsr.rowptr_from_rows`` (sorted row ids)."""
    counts = torch.bincount(row_ids.long(), minlength=n_block_rows)
    rowptr = torch.zeros(n_block_rows + 1, dtype=torch.int32,
                         device=row_ids.device)
    rowptr[1:] = counts.cumsum(0)
    return rowptr


def bcsr_spmm_nnz_stream(vals: torch.Tensor, row_ids: torch.Tensor,
                         col_ids: torch.Tensor, b: torch.Tensor,
                         n_block_rows: int, *, rowptr=None,
                         out_dtype=None) -> torch.Tensor:
    """C[nbr*h, N] = A_bcsr @ B.  Entries must be sorted row-major;
    ``rowptr`` [nbr+1] int32 gives each block-row's entry range (built from
    ``row_ids`` when not given).  ``b`` is [K, N] with K a multiple of w and
    may be strided; the result is a new contiguous tensor in ``out_dtype``
    (default ``b.dtype``), accumulated in float32."""
    out_dtype = out_dtype or b.dtype
    if b.device.type == "cpu":
        return ref.bcsr_spmm_ref(vals, row_ids, col_ids, b, n_block_rows,
                                 out_dtype=out_dtype)
    if b.device.type != "cuda":
        raise ValueError(f"bcsr_spmm_nnz_stream: no kernel for device "
                         f"{b.device}")
    nnzb, h, w = vals.shape
    K, N = b.shape
    if rowptr is None:
        rowptr = rowptr_from_rows(row_ids, n_block_rows)
    for name, t in (("vals", vals), ("rowptr", rowptr),
                    ("col_ids", col_ids)):
        if t.device != b.device:
            raise ValueError(f"{name} is on {t.device}, b on {b.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if rowptr.dtype != torch.int32 or col_ids.dtype != torch.int32:
        raise ValueError("rowptr and col_ids must be int32")
    if vals.dtype != b.dtype or vals.dtype not in _TYPE_CODES:
        raise ValueError(f"vals ({vals.dtype}) and b ({b.dtype}) must share "
                         "one type, float32 or bfloat16")
    if out_dtype not in _TYPE_CODES:
        raise ValueError(f"out_dtype {out_dtype} not float32 or bfloat16")
    if K % w or rowptr.shape != (n_block_rows + 1,) or \
            col_ids.shape != (nnzb,):
        raise ValueError(f"shapes do not fit: vals {tuple(vals.shape)}, "
                         f"b {tuple(b.shape)}, rowptr {tuple(rowptr.shape)}, "
                         f"col_ids {tuple(col_ids.shape)}, "
                         f"n_block_rows {n_block_rows}")
    out = torch.empty((n_block_rows * h, N), dtype=out_dtype, device=b.device)
    if N == 0 or n_block_rows == 0:
        return out
    fn = _lib("bcsr_spmm", "bcsr_spmm_nnz_stream")
    with torch.cuda.device(b.device):
        err = fn(vals.data_ptr(), rowptr.data_ptr(), col_ids.data_ptr(),
                 b.data_ptr(), out.data_ptr(), n_block_rows, h, w, N,
                 b.stride(0), b.stride(1), tile_n(N), _TYPE_CODES[vals.dtype],
                 _TYPE_CODES[out_dtype],
                 torch.cuda.current_stream(b.device).cuda_stream)
    if err:
        raise RuntimeError(f"bcsr_spmm_nnz_stream: kernel launch failed with "
                           f"CUDA error {err}")
    LAUNCHES["nnz_stream"] += 1
    return out


def bcsr_sddmm(dc: torch.Tensor, b: torch.Tensor, row_ids: torch.Tensor,
               col_ids: torch.Tensor, h: int, w: int, *,
               out_dtype=None) -> torch.Tensor:
    """dvals[s] = dC[block row_ids[s]] @ B[block col_ids[s]]^T, [nnzb, h, w]:
    the sparse weight gradient, computed only at the stored blocks.  ``dc``
    is [M, N] with M a multiple of h, ``b`` is [K, N] with K a multiple of
    w; both may be strided views.  Accumulated in float32 over N; the
    result is a new contiguous tensor in ``out_dtype`` (default
    ``dc.dtype``)."""
    out_dtype = out_dtype or dc.dtype
    if dc.device.type == "cpu":
        return ref.bcsr_sddmm_ref(dc, b, row_ids, col_ids, h, w,
                                  out_dtype=out_dtype)
    if dc.device.type != "cuda":
        raise ValueError(f"bcsr_sddmm: no kernel for device {dc.device}")
    M, N = dc.shape
    K = b.shape[0]
    nnzb = row_ids.shape[0]
    for name, t in (("b", b), ("row_ids", row_ids), ("col_ids", col_ids)):
        if t.device != dc.device:
            raise ValueError(f"{name} is on {t.device}, dc on {dc.device}")
    for name, t in (("row_ids", row_ids), ("col_ids", col_ids)):
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous int32 tensor")
    if dc.dtype != b.dtype or dc.dtype not in _TYPE_CODES:
        raise ValueError(f"dc ({dc.dtype}) and b ({b.dtype}) must share one "
                         "type, float32 or bfloat16")
    if out_dtype not in _TYPE_CODES:
        raise ValueError(f"out_dtype {out_dtype} not float32 or bfloat16")
    if M % h or K % w or b.shape[1] != N or col_ids.shape != (nnzb,):
        raise ValueError(f"shapes do not fit: dc {tuple(dc.shape)}, b "
                         f"{tuple(b.shape)}, block ({h}, {w}), row_ids "
                         f"{tuple(row_ids.shape)}, col_ids "
                         f"{tuple(col_ids.shape)}")
    out = torch.empty((nnzb, h, w), dtype=out_dtype, device=dc.device)
    if nnzb == 0:
        return out
    fn = _lib("bcsr_sddmm", "bcsr_sddmm")
    with torch.cuda.device(dc.device):
        err = fn(dc.data_ptr(), b.data_ptr(), row_ids.data_ptr(),
                 col_ids.data_ptr(), out.data_ptr(), nnzb, h, w, N,
                 dc.stride(0), dc.stride(1), b.stride(0), b.stride(1),
                 _TYPE_CODES[dc.dtype], _TYPE_CODES[out_dtype],
                 torch.cuda.current_stream(dc.device).cuda_stream)
    if err:
        raise RuntimeError(f"bcsr_sddmm: kernel launch failed with CUDA "
                           f"error {err}")
    LAUNCHES["sddmm"] += 1
    return out

"""Hand-written CUDA kernel for BCSR SpMM, and its wrapper.

``bcsr_spmm_nnz_stream`` replaces the Pallas TPU kernel of the same name
(``repro/kernels/bcsr_spmm.py:67``).  The kernel is
``csrc/bcsr_spmm.cu``; its header says how it is laid out and what bounds it.
The wrapper dispatches on the device of its operands: a CPU tensor goes to
the plain version (``ref.bcsr_spmm_ref``), a CUDA tensor launches the kernel
or raises — it never falls back.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

# kernel launches since the last reset — a run reads it to show that its
# path went through the kernel (plain integers, reset by assignment)
LAUNCHES = {"nnz_stream": 0}

_TYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_C = ctypes.c_void_p
_ARGTYPES = [_C, _C, _C, _C, _C,                       # vals rowptr cols b out
             ctypes.c_int, ctypes.c_int, ctypes.c_int,  # nbr h w
             ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,  # N strides
             ctypes.c_int, ctypes.c_int, ctypes.c_int,  # bn in_type out_type
             _C]                                        # stream


def _lib():
    lib = _build.load("bcsr_spmm")
    fn = lib.bcsr_spmm_nnz_stream
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
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
    fn = _lib()
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

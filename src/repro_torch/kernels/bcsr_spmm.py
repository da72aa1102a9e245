"""Hand-written CUDA kernels for BCSR SpMM and SDDMM, and their wrappers.

``bcsr_spmm_nnz_stream``, ``bcsr_spmm_row_loop``, ``bcsr_sddmm`` and
``bcsr_sddmm_row_loop`` replace the Pallas TPU kernels of the same names
(``repro/kernels/bcsr_spmm.py:67``, ``:124``, ``:189`` and ``:246``).  The
kernels are ``csrc/bcsr_spmm.cu``, ``csrc/bcsr_spmm_row_loop.cu``,
``csrc/bcsr_sddmm.cu`` and ``csrc/bcsr_sddmm_row_loop.cu``; their headers
say how they are laid out and what bounds them.  Each wrapper dispatches on
the device of its operands: a CPU tensor goes to the plain version in
``ref``, a CUDA tensor launches the kernel or raises -- it never falls back.

Each wrapper also takes G instances over one structure (the JAX package's
``vmap`` of the op): ``vals`` ``[G, nnzb, h, w]`` with ``b`` ``[G, K, N]``,
or ``dc`` ``[G, M, N]`` with ``b`` ``[G, K, N]``, and returns the results
stacked on the leading axis.  The index arrays are shared; the dense
operands may be strided views (the folded attention heads), each instance
a batch stride from the last.  Every operand is batched, or none is.  One
launch covers all G instances and counts once in ``LAUNCHES``; its tile
and staging are those of one instance (only the copy width may narrow,
where a batch stride is less aligned than the base address), so it gives
the bits of G single launches.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import _build, ref

# kernel launches since the last reset — a run reads it to show that its
# path went through the kernel (plain integers, reset by assignment)
LAUNCHES = {"nnz_stream": 0, "row_loop": 0, "sddmm": 0, "sddmm_row_loop": 0}

SPMM_TILES = (8, 16, 32, 64)     # the N tiles the SpMM kernels compile
SDDMM_TILES = (32,)              # the N chunk of the SDDMM kernels
SDDMM_TILE = (64, 64)            # the output tile one B2 or B4 CTA owns

_TYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_C, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# (source, C symbol) -> argument types of the C interface
_BATCH = [_I, _LL, _LL, _LL]           # instances, three batch strides
_ARGTYPES = {
    ("bcsr_spmm", "bcsr_spmm_nnz_stream"): [
        _C, _C, _C, _C, _C,              # vals rowptr col_ids b out
        _I, _I, _I, _I, _LL, _LL,        # nbr h w N, b's strides
        _I, _I, _I, _I,                  # bn bm vec kmajor
        _I, _I, *_BATCH, _C],            # in_type out_type, G (vals b out)
    ("bcsr_sddmm", "bcsr_sddmm"): [
        _C, _C, _C, _C, _C,              # dc b row_ids col_ids out
        _I, _I, _I, _I,                  # nnzb h w N
        _LL, _LL, _LL, _LL,              # dc's strides, b's strides
        _I, _I, _I,                      # vec ak bk
        _I, _I, *_BATCH, _C],            # in_type out_type, G (dc b out)
    ("bcsr_spmm_row_loop", "bcsr_spmm_row_loop"): [
        _C, _C, _C, _C, _C, _C,          # vals flat_idx flat_col row_len b out
        _I, _I, _I, _I, _I, _LL, _LL,    # nbr max_bpr h w N, b's strides
        _I, _I, _I, _I,                  # bn bm vec kmajor
        _I, _I, *_BATCH, _C],            # in_type out_type, G (vals b out)
    ("bcsr_sddmm_row_loop", "bcsr_sddmm_row_loop"): [
        _C, _C, _C, _C, _C,              # dc b flat_idx flat_col out
        _I, _I, _I, _I, _I, _I,          # nbr max_bpr nnzb h w N
        _LL, _LL, _LL, _LL,              # dc's strides, b's strides
        _I, _I, _I,                      # vec ak bk
        _I, _I, *_BATCH, _C],            # in_type out_type, G (dc b out)
    # each library's queries for the static analyzer (``query``)
    ("bcsr_spmm", "bcsr_spmm_nnz_stream_smem_bytes"): [_I] * 4,
    ("bcsr_spmm", "bcsr_spmm_nnz_stream_threads"): [_I],
    ("bcsr_spmm_row_loop", "bcsr_spmm_row_loop_smem_bytes"): [_I] * 4,
    ("bcsr_spmm_row_loop", "bcsr_spmm_row_loop_threads"): [_I],
    ("bcsr_sddmm", "bcsr_sddmm_smem_bytes"): [_I] * 3,
    ("bcsr_sddmm", "bcsr_sddmm_threads"): [],
    ("bcsr_sddmm_row_loop", "bcsr_sddmm_row_loop_smem_bytes"): [_I] * 3,
    ("bcsr_sddmm_row_loop", "bcsr_sddmm_row_loop_threads"): [],
}


def _lib(source: str, symbol: str):
    """The C function ``symbol`` of ``csrc/<source>.cu``, built on first
    use."""
    fn = getattr(_build.load(source), symbol)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[(source, symbol)]
        fn.restype = ctypes.c_int
    return fn


def query(source: str, symbol: str, *args) -> int:
    """Call one of a kernel library's plain C queries: ``<kernel>_smem_bytes
    (in_type, bm, bn, kmajor)`` (B1, B3) or ``(in_type, ak, bk)`` (B2,
    B4), the dynamic shared memory of one instantiation from the constants
    its launch uses (-1 for one it does not compile), and
    ``<kernel>_threads``.  No kernel is launched; the library is built on
    first use, so this runs on the card's machine only.  The static
    analyzer's Python mirrors (``analysis.workspace``) are held to it
    there."""
    return int(_lib(source, symbol)(*args))


def tile_n(n: int) -> int:
    """The SpMM kernels' own N-tile: the smallest of ``SPMM_TILES`` that
    covers ``n`` (decode feeds a handful of tokens), else the largest."""
    for bn in SPMM_TILES:
        if n <= bn:
            return bn
    return SPMM_TILES[-1]


def _tile(bn, n: int) -> int:
    if bn is None:
        return tile_n(n)
    if bn not in SPMM_TILES:
        raise ValueError(f"bn={bn} is not a tile the SpMM kernels compile "
                         f"{SPMM_TILES}")
    return bn


def spmm_row_block(n: int, h: int) -> int:
    """The rows of a block-row one B1/B3 CTA owns (``spmm_launch_config``'s
    ``bm``): 16 at decode widths (N <= 16) and for blocks of h <= 64, else
    128."""
    return 16 if n <= 16 or h <= 64 else 128


def spmm_launch_config(n: int, h: int, w: int, dtype, vals_ptr: int,
                       b_ptr: int, sbk: int, sbn: int):
    """``(bm, vec, kmajor)`` of one SpMM launch (``csrc/spmm_tile.cuh``), a
    pure function of the shapes, the strides and the operands' addresses.

    ``bm``: the rows of a block-row one CTA owns -- 16 (one m16 row group,
    its k steps split over 4 warps; taller blocks take more CTAs) at decode
    widths (N <= 16) and for blocks of h <= 64; else 128 (8 warps, so each
    B panel is read once a block-row).  ``kmajor``:
    B is staged k-major (row-major B) unless its k axis is contiguous
    (``sbk == 1``: the x^T view, or N = 1).  ``vec``: the widest copy, in
    bytes, of 16, 8, 4 and the element size, for which both pointers are
    aligned, the staged axis of B is contiguous, and every staged row start
    and chunk edge (B's rows or columns, A's and B's block width ``w``)
    falls on a multiple of it; the element size (a scalar copy) takes any
    strides."""
    esize = torch.finfo(dtype).bits // 8
    bm = spmm_row_block(n, h)
    kmajor = sbk != 1
    for vec in (16, 8, 4):
        if vec <= esize:
            break
        if vals_ptr % vec or b_ptr % vec or w * esize % vec:
            continue
        if kmajor:
            if sbn == 1 and sbk * esize % vec == 0 and n * esize % vec == 0:
                return bm, vec, int(kmajor)
        elif n == 1 or sbn * esize % vec == 0:
            return bm, vec, int(kmajor)
    return bm, esize, int(kmajor)


def _address(t: torch.Tensor, batched: bool) -> int:
    """The address a copy width must divide in every instance of ``t``:
    its data pointer, and for a batched ``t`` the batch stride in bytes too
    (their greatest common divisor)."""
    if not batched:
        return t.data_ptr()
    return math.gcd(t.data_ptr(), t.stride(0) * t.element_size())


def _batch_args(G: Optional[int], *tensors) -> tuple:
    """``(instances, batch strides)`` of the C interfaces: ``(1, 0, ...)``
    for an unbatched call (G None), else G and each tensor's leading
    stride."""
    if G is None:
        return (1,) + (0,) * len(tensors)
    return (G, *(t.stride(0) for t in tensors))


def _launch_config(vals: torch.Tensor, b: torch.Tensor):
    h, w = vals.shape[-2:]
    batched = b.dim() == 3
    return spmm_launch_config(b.shape[-1], h, w, b.dtype,
                              _address(vals, batched), _address(b, batched),
                              b.stride(-2), b.stride(-1))


def sddmm_launch_config(n: int, h: int, w: int, dtype, dc_ptr: int,
                        b_ptr: int, sdm: int, sdn: int, sbk: int, sbn: int):
    """``(tile, vec, ak, bk)`` of one B2 or B4 launch
    (``csrc/sddmm_tile.cuh``), a pure function of the shapes, the strides
    and the operands' addresses.

    ``tile``: the ``(rows, cols)`` of a stored block one CTA owns,
    ``SDDMM_TILE`` (a 128 x 128 block takes four CTAs).  ``ak`` / ``bk``:
    dC / B staged k-major -- along its row axis -- unless its N axis is
    contiguous (``sdn == 1`` / ``sbn == 1``; the FFN backward's transposed
    views take k-major, the attention backward's row-major Q and K not).
    ``vec``: the widest copy, in bytes, of 16, 8, 4 and the element size,
    for which both pointers are aligned, each operand's staged axis is
    contiguous, and every staged row start and edge (the block's h or w
    rows, N) falls on a multiple of it; the element size (a scalar copy)
    takes any strides."""
    esize = torch.finfo(dtype).bits // 8
    ak, bk = int(sdn != 1), int(sbn != 1)

    def fits(vec, ptr, rows, sr, sk, kmaj):
        if ptr % vec:
            return False
        if kmaj:
            return sr == 1 and rows * esize % vec == 0 and \
                (n == 1 or sk * esize % vec == 0)
        return n * esize % vec == 0 and sr * esize % vec == 0

    for vec in (16, 8, 4):
        if vec <= esize:
            break
        if fits(vec, dc_ptr, h, sdm, sdn, ak) and \
                fits(vec, b_ptr, w, sbk, sbn, bk):
            return SDDMM_TILE, vec, ak, bk
    return SDDMM_TILE, esize, ak, bk


def sddmm_launch_args(dc: torch.Tensor, b: torch.Tensor, h: int, w: int,
                      out_dtype) -> tuple:
    """The launch arguments B2 and B4 share, in the order of their C
    interfaces after the entry list or schedule: ``(h, w, N, sdm, sdn, sbk,
    sbn, vec, ak, bk, in_type, out_type)``, with ``vec, ak, bk`` from
    ``sddmm_launch_config``: those of one instance where ``dc`` and ``b``
    carry the instance axis.  A pure function of the operands' shapes,
    strides, types and addresses; it reads no element."""
    n = dc.shape[-1]
    batched = dc.dim() == 3
    _, vec, ak, bk = sddmm_launch_config(
        n, h, w, dc.dtype, _address(dc, batched), _address(b, batched),
        *dc.stride()[-2:], *b.stride()[-2:])
    return (h, w, n, *dc.stride()[-2:], *b.stride()[-2:], vec, ak, bk,
            _TYPE_CODES[dc.dtype], _TYPE_CODES[out_dtype])


def _check_int32(device, **tensors) -> None:
    for name, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, the operands on "
                             f"{device}")
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous int32 tensor")


def _check_vals(vals: torch.Tensor, device) -> None:
    """``vals`` lies on ``device``, each instance contiguous (a batch
    stride of its own is fine)."""
    one = vals[0] if vals.dim() == 4 and vals.shape[0] else vals
    if vals.device != device or not one.is_contiguous():
        raise ValueError(f"vals must be a contiguous tensor on {device} "
                         "(each instance contiguous)")


def _check_types(a, b, out_dtype, names) -> None:
    if a.dtype != b.dtype or a.dtype not in _TYPE_CODES:
        raise ValueError(f"{names[0]} ({a.dtype}) and {names[1]} ({b.dtype}) "
                         "must share one type, float32 or bfloat16")
    if out_dtype not in _TYPE_CODES:
        raise ValueError(f"out_dtype {out_dtype} not float32 or bfloat16")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def rowptr_from_rows(row_ids: torch.Tensor, n_block_rows: int) -> torch.Tensor:
    """Device twin of ``core.bcsr.rowptr_from_rows`` (sorted row ids)."""
    counts = torch.bincount(row_ids.long(), minlength=n_block_rows)
    rowptr = torch.zeros(n_block_rows + 1, dtype=torch.int32,
                         device=row_ids.device)
    rowptr[1:] = counts.cumsum(0)
    return rowptr


def bcsr_spmm_nnz_stream(vals: torch.Tensor, row_ids: torch.Tensor,
                         col_ids: torch.Tensor, b: torch.Tensor,
                         n_block_rows: int, *, rowptr=None, bn=None,
                         out_dtype=None) -> torch.Tensor:
    """C[nbr*h, N] = A_bcsr @ B.  Entries must be sorted row-major;
    ``rowptr`` [nbr+1] int32 gives each block-row's entry range (built from
    ``row_ids`` when not given).  ``b`` is [K, N] with K a multiple of w and
    may be strided; ``bn`` is the N tile (one of ``SPMM_TILES``; default
    ``tile_n(N)``).  The result is a new contiguous tensor in ``out_dtype``
    (default ``b.dtype``), accumulated in float32.  With ``vals`` [G, nnzb,
    h, w] and ``b`` [G, K, N], one launch gives [G, nbr*h, N]."""
    out_dtype = out_dtype or b.dtype
    G = ref.instances(vals, b, 3, ("vals", "b"))
    if b.device.type == "cpu":
        return ref.bcsr_spmm_ref(vals, row_ids, col_ids, b, n_block_rows,
                                 out_dtype=out_dtype)
    if b.device.type != "cuda":
        raise ValueError(f"bcsr_spmm_nnz_stream: no kernel for device "
                         f"{b.device}")
    nnzb, h, w = vals.shape[-3:]
    K, N = b.shape[-2:]
    if rowptr is None:
        rowptr = rowptr_from_rows(row_ids, n_block_rows)
    _check_int32(b.device, rowptr=rowptr, col_ids=col_ids)
    _check_vals(vals, b.device)
    _check_types(vals, b, out_dtype, ("vals", "b"))
    if K % w or rowptr.shape != (n_block_rows + 1,) or \
            col_ids.shape != (nnzb,):
        raise ValueError(f"shapes do not fit: vals {tuple(vals.shape)}, "
                         f"b {tuple(b.shape)}, rowptr {tuple(rowptr.shape)}, "
                         f"col_ids {tuple(col_ids.shape)}, "
                         f"n_block_rows {n_block_rows}")
    out = torch.empty((*b.shape[:-2], n_block_rows * h, N), dtype=out_dtype,
                      device=b.device)
    if out.numel() == 0:
        return out
    fn = _lib("bcsr_spmm", "bcsr_spmm_nnz_stream")
    with torch.cuda.device(b.device):
        err = fn(vals.data_ptr(), rowptr.data_ptr(), col_ids.data_ptr(),
                 b.data_ptr(), out.data_ptr(), n_block_rows, h, w, N,
                 b.stride(-2), b.stride(-1), _tile(bn, N),
                 *_launch_config(vals, b), _TYPE_CODES[vals.dtype],
                 _TYPE_CODES[out_dtype], *_batch_args(G, vals, b, out),
                 _stream(b))
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
    w; both may be strided views, each staged along its contiguous axis
    (``sddmm_launch_config``).  Accumulated in float32 over N (f32 operands
    as 3xTF32 on the tensor cores); the result is a new contiguous tensor
    in ``out_dtype`` (default ``dc.dtype``).  With ``dc`` [G, M, N] and
    ``b`` [G, K, N], one launch gives [G, nnzb, h, w]."""
    out_dtype = out_dtype or dc.dtype
    G = ref.instances(dc, b, 2, ("dc", "b"))
    if dc.device.type == "cpu":
        return ref.bcsr_sddmm_ref(dc, b, row_ids, col_ids, h, w,
                                  out_dtype=out_dtype)
    if dc.device.type != "cuda":
        raise ValueError(f"bcsr_sddmm: no kernel for device {dc.device}")
    M, N = dc.shape[-2:]
    K = b.shape[-2]
    nnzb = row_ids.shape[0]
    if b.device != dc.device:
        raise ValueError(f"b is on {b.device}, dc on {dc.device}")
    _check_int32(dc.device, row_ids=row_ids, col_ids=col_ids)
    _check_types(dc, b, out_dtype, ("dc", "b"))
    if M % h or K % w or b.shape[-1] != N or col_ids.shape != (nnzb,):
        raise ValueError(f"shapes do not fit: dc {tuple(dc.shape)}, b "
                         f"{tuple(b.shape)}, block ({h}, {w}), row_ids "
                         f"{tuple(row_ids.shape)}, col_ids "
                         f"{tuple(col_ids.shape)}")
    out = torch.empty((*dc.shape[:-2], nnzb, h, w), dtype=out_dtype,
                      device=dc.device)
    if out.numel() == 0:
        return out
    fn = _lib("bcsr_sddmm", "bcsr_sddmm")
    with torch.cuda.device(dc.device):
        err = fn(dc.data_ptr(), b.data_ptr(), row_ids.data_ptr(),
                 col_ids.data_ptr(), out.data_ptr(), nnzb,
                 *sddmm_launch_args(dc, b, h, w, out_dtype),
                 *_batch_args(G, dc, b, out), _stream(dc))
    if err:
        raise RuntimeError(f"bcsr_sddmm: kernel launch failed with CUDA "
                           f"error {err}")
    LAUNCHES["sddmm"] += 1
    return out


def bcsr_spmm_row_loop(vals: torch.Tensor, flat_idx: torch.Tensor,
                       flat_col: torch.Tensor, row_len: torch.Tensor,
                       b: torch.Tensor, n_block_rows: int, *, bn=None,
                       out_dtype=None) -> torch.Tensor:
    """C[nbr*h, N] = A_bcsr @ B through SMaT's static schedule: block-row i
    runs slots t = 0 .. max_bpr-1, slot t holding entry ``flat_idx[i *
    max_bpr + t]`` of block-col ``flat_col[i * max_bpr + t]``, live while
    ``t < row_len[i]`` (``ops._row_loop_schedule``).  ``b``, and the
    instance axis, as for ``bcsr_spmm_nnz_stream``; accumulated in
    float32."""
    out_dtype = out_dtype or b.dtype
    G = ref.instances(vals, b, 3, ("vals", "b"))
    if b.device.type == "cpu":
        return ref.bcsr_spmm_row_loop_ref(vals, flat_idx, flat_col, row_len,
                                          b, n_block_rows,
                                          out_dtype=out_dtype)
    if b.device.type != "cuda":
        raise ValueError(f"bcsr_spmm_row_loop: no kernel for device "
                         f"{b.device}")
    nnzb, h, w = vals.shape[-3:]
    K, N = b.shape[-2:]
    _check_int32(b.device, flat_idx=flat_idx, flat_col=flat_col,
                 row_len=row_len)
    _check_vals(vals, b.device)
    _check_types(vals, b, out_dtype, ("vals", "b"))
    max_bpr = flat_idx.shape[0] // max(n_block_rows, 1)
    if K % w or flat_idx.shape != (n_block_rows * max_bpr,) or \
            flat_col.shape != flat_idx.shape or \
            row_len.shape != (n_block_rows,):
        raise ValueError(f"shapes do not fit: vals {tuple(vals.shape)}, "
                         f"b {tuple(b.shape)}, flat_idx "
                         f"{tuple(flat_idx.shape)}, flat_col "
                         f"{tuple(flat_col.shape)}, row_len "
                         f"{tuple(row_len.shape)}, n_block_rows "
                         f"{n_block_rows}")
    out = torch.empty((*b.shape[:-2], n_block_rows * h, N), dtype=out_dtype,
                      device=b.device)
    if out.numel() == 0:
        return out
    fn = _lib("bcsr_spmm_row_loop", "bcsr_spmm_row_loop")
    with torch.cuda.device(b.device):
        err = fn(vals.data_ptr(), flat_idx.data_ptr(), flat_col.data_ptr(),
                 row_len.data_ptr(), b.data_ptr(), out.data_ptr(),
                 n_block_rows, max_bpr, h, w, N, b.stride(-2), b.stride(-1),
                 _tile(bn, N), *_launch_config(vals, b),
                 _TYPE_CODES[vals.dtype], _TYPE_CODES[out_dtype],
                 *_batch_args(G, vals, b, out), _stream(b))
    if err:
        raise RuntimeError(f"bcsr_spmm_row_loop: kernel launch failed with "
                           f"CUDA error {err}")
    LAUNCHES["row_loop"] += 1
    return out


def bcsr_sddmm_row_loop(dc: torch.Tensor, b: torch.Tensor,
                        flat_idx: torch.Tensor, flat_col: torch.Tensor,
                        n_block_rows: int, nnzb: int, h: int, w: int, *,
                        out_dtype=None) -> torch.Tensor:
    """dvals [nnzb, h, w] through the static schedule: slot t of block-row
    i computes dC[block i] @ B[block flat_col[i * max_bpr + t]]^T into
    entry ``flat_idx[i * max_bpr + t]``, where a padding slot's entry is the
    sentinel ``nnzb`` (``ops._sddmm_row_loop_schedule``).  On the card a
    padding slot computes and writes nothing, so the result is allocated
    as ``[nnzb, h, w]`` (the TPU kernel writes the sentinel and slices it
    off: the same values).  ``dc`` [M, N] and ``b`` [K, N] may be strided
    views, staged as B2 stages them (``sddmm_launch_args``); accumulated
    in float32 over N (f32 operands as 3xTF32), bit-equal to
    ``bcsr_sddmm`` on every stored entry.  The instance axis as for
    ``bcsr_sddmm``."""
    out_dtype = out_dtype or dc.dtype
    G = ref.instances(dc, b, 2, ("dc", "b"))
    if dc.device.type == "cpu":
        return ref.bcsr_sddmm_row_loop_ref(dc, b, flat_idx, flat_col,
                                           n_block_rows, nnzb, h, w,
                                           out_dtype=out_dtype)
    if dc.device.type != "cuda":
        raise ValueError(f"bcsr_sddmm_row_loop: no kernel for device "
                         f"{dc.device}")
    M, N = dc.shape[-2:]
    K = b.shape[-2]
    if b.device != dc.device:
        raise ValueError(f"b is on {b.device}, dc on {dc.device}")
    _check_int32(dc.device, flat_idx=flat_idx, flat_col=flat_col)
    _check_types(dc, b, out_dtype, ("dc", "b"))
    max_bpr = flat_idx.shape[0] // max(n_block_rows, 1)
    if M % h or K % w or b.shape[-1] != N or M // h < n_block_rows or \
            flat_idx.shape != (n_block_rows * max_bpr,) or \
            flat_col.shape != flat_idx.shape:
        raise ValueError(f"shapes do not fit: dc {tuple(dc.shape)}, b "
                         f"{tuple(b.shape)}, block ({h}, {w}), flat_idx "
                         f"{tuple(flat_idx.shape)}, flat_col "
                         f"{tuple(flat_col.shape)}, n_block_rows "
                         f"{n_block_rows}")
    out = torch.empty((*dc.shape[:-2], nnzb, h, w), dtype=out_dtype,
                      device=dc.device)
    if flat_idx.numel() and G != 0:
        fn = _lib("bcsr_sddmm_row_loop", "bcsr_sddmm_row_loop")
        with torch.cuda.device(dc.device):
            err = fn(dc.data_ptr(), b.data_ptr(), flat_idx.data_ptr(),
                     flat_col.data_ptr(), out.data_ptr(), n_block_rows,
                     max_bpr, nnzb, *sddmm_launch_args(dc, b, h, w,
                                                       out_dtype),
                     *_batch_args(G, dc, b, out), _stream(dc))
        if err:
            raise RuntimeError(f"bcsr_sddmm_row_loop: kernel launch failed "
                               f"with CUDA error {err}")
        LAUNCHES["sddmm_row_loop"] += 1
    return out

"""Card gate of the PyTorch/CUDA port: run on one NVIDIA H100 as

    python3 chip_smoke.py

It builds every CUDA kernel of the port from ``src/repro_torch/kernels/csrc``
(one ``nvcc`` per source, all at once), holds each against its plain
PyTorch version at small odd shapes and at the main paths' shapes, and
times it.  Then it drives the main paths of ``smat-ffn-1.3b`` at full width
(24 layers, d_model 2048, d_ff 8192, vocab 32000, bf16, FFN 90%
block-sparse in 128x128 blocks): it serves requests through ``ServeEngine``
and trains a few steps through ``train.loop.train``, each through the
streamed kernels (``nnz_stream``) and through the static-schedule ones
(``row_loop``), checks that every sparse FFN product (forward, dB and
dvals) went through the kernels, and that the outputs agree with the plain
path.  Last it drives the SMaT library path (CSR -> BCSR -> Jaccard reorder
-> spmm) on the paper's suite of matrices, ``mip1`` at its published size,
and the autotuner's measured sweep.  Every phase checks its results; any
failure exits non-zero before the last line.

The line before the last lists every ported kernel as JSON; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the rest
of the repository beside it, the script fails and prints no result.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

# Published H100 SXM peaks (NVIDIA data sheet, dense): the least time the
# card could take for some work is the larger of its bytes over the memory
# rate and its operations over the peak rate of their type.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

DEVICE = "cuda"        # the card every phase runs on

# every kernel the port has: where it lives, what TPU kernel it replaces,
# its launch counter, and the timed cases of the main path's shapes
KERNELS = [{
    "name": "bcsr_spmm_nnz_stream",
    "route": "cuda",
    "source": "src/repro_torch/kernels/csrc/bcsr_spmm.cu",
    "build": "bcsr_spmm",
    "replaces": "src/repro/kernels/bcsr_spmm.py:67",
    "counter": "nnz_stream",
}, {
    "name": "bcsr_sddmm",
    "route": "cuda",
    "source": "src/repro_torch/kernels/csrc/bcsr_sddmm.cu",
    "build": "bcsr_sddmm",
    "replaces": "src/repro/kernels/bcsr_spmm.py:189",
    "counter": "sddmm",
}, {
    "name": "bcsr_spmm_row_loop",
    "route": "cuda",
    "source": "src/repro_torch/kernels/csrc/bcsr_spmm_row_loop.cu",
    "build": "bcsr_spmm_row_loop",
    "replaces": "src/repro/kernels/bcsr_spmm.py:124",
    "counter": "row_loop",
}, {
    "name": "bcsr_sddmm_row_loop",
    "route": "cuda",
    "source": "src/repro_torch/kernels/csrc/bcsr_sddmm_row_loop.cu",
    "build": "bcsr_sddmm_row_loop",
    "replaces": "src/repro/kernels/bcsr_spmm.py:246",
    "counter": "sddmm_row_loop",
}, {
    "name": "bcsr_attn_fused",
    "route": "cuda",
    "source": "src/repro_torch/kernels/csrc/bcsr_attn.cu",
    "build": "bcsr_attn",
    "replaces": "src/repro/kernels/bcsr_attn.py:132",
    "counter": "attn_fused",
    "module": "bcsr_attn",
}]
B1, B2, B3, B4, B5 = (k["name"] for k in KERNELS)

N_SLOTS, CACHE_LEN = 4, 256
# training: the JAX package's train_4k cell (4096 x 256 over a pod) cut to
# 2 x 1024 tokens so that one card holds it without remat
TRAIN_SEQ, TRAIN_BATCH, TRAIN_STEPS = 1024, 2, 5
TRAIN_N = TRAIN_SEQ * TRAIN_BATCH
N_REQUESTS, PROMPT_LEN, NEW_TOKENS = 8, 16, 16
ROTATE = 24            # distinct weights per timed loop: 24 x 3.7 MB > L2
PROFILE_STEPS = 5


def log(*args):
    print(*args, flush=True)


def check(ok, what):
    if not ok:
        raise SystemExit(f"chip_smoke FAILED: {what}")


def device_phase():
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke needs a CUDA device; none is available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[device] {torch.cuda.get_device_name(0)} | nvidia-smi: {smi} | "
        f"torch {torch.__version__} cuda {torch.version.cuda} | "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    return smi


def build_phase():
    from repro_torch.kernels import _build
    log(f"[build] nvcc {_build.find_nvcc()} {' '.join(_build.NVCC_FLAGS)}")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:   # one nvcc per source
        list(pool.map(lambda k: _build.load(k["build"]), KERNELS))
    for k in KERNELS:
        info = _build.BUILD_INFO[k["build"]]
        ptxas = [ln.strip() for ln in info["log"].splitlines()
                 if "registers" in ln or "spill" in ln]
        log(f"[build] {k['source']} -> {_build.library_path(k['build'])} in "
            f"{info['seconds']:.2f}s")
        for ln in ptxas:
            log(f"[build]   {ln}")
    log(f"[build] all kernels built in {time.perf_counter() - t0:.2f}s")


# ------------------------------------------------------------------ operands
def _operand(seed, shape, block, nnzb=None, density=None, dtype=torch.float32):
    """Device tensors of a random BCSR with every block-row nonempty."""
    from repro_torch.core import bcsr as B
    if nnzb is not None:
        a = B.random_bcsr_exact(seed, shape, block, nnzb)
    else:
        a = B.random_bcsr(seed, shape, block, density).ensure_nonempty_rows()
    dev = DEVICE
    return {
        "vals": torch.from_numpy(a.vals).to(dev, dtype),
        "row_ids": torch.from_numpy(a.row_ids).to(dev),
        "col_ids": torch.from_numpy(a.col_ids).to(dev),
        "rowptr": torch.from_numpy(a.rowptr).to(dev),
        "nbr": a.n_block_rows, "nbc": a.n_block_cols, "shape": shape,
        "block": block,
    }


def _b(seed, k, n, dtype, transposed=False):
    rng = np.random.default_rng(seed)
    if transposed:     # x^T as the model passes it: a strided view
        return torch.from_numpy(rng.standard_normal((n, k)).astype(
            np.float32)).to(DEVICE, dtype).T
    return torch.from_numpy(rng.standard_normal((k, n)).astype(
        np.float32)).to(DEVICE, dtype)


def _nnz_stream(op, b):
    from repro_torch.kernels import bcsr_spmm
    return bcsr_spmm.bcsr_spmm_nnz_stream(
        op["vals"], op["row_ids"], op["col_ids"], b, op["nbr"],
        rowptr=op["rowptr"])


def _plain(op, b, out_dtype=None):
    from repro_torch.kernels import ref
    return ref.bcsr_spmm_ref(op["vals"], op["row_ids"], op["col_ids"], b,
                             op["nbr"], out_dtype=out_dtype)


FULL_WIDTH = {         # smat-ffn-1.3b's sparse FFN weights: nnzb = 112
    "gate_up": ((8192, 2048), 112),
    "down": ((2048, 8192), 112),
}


def parity_phase():
    """Kernel against its plain version on the card.  f32: rtol = atol =
    1e-4 (FMA order differs from the plain einsum).  bf16 in and out: the
    plain f32 result cast to bf16, rtol = atol = 1e-2 (about 1 bf16 ulp)."""
    small = [((64, 64), (8, 8), 0.5), ((128, 256), (16, 32), 0.3),
             ((256, 128), (32, 16), 0.15), ((96, 160), (16, 16), 0.4)]
    cases = [(f"small{shape}{block}", dict(shape=shape, block=block,
                                           density=d), n)
             for shape, block, d in small for n in (8, 64, 100)]
    cases += [(name, dict(shape=shape, block=(128, 128), nnzb=nnzb), n)
              for name, (shape, nnzb) in FULL_WIDTH.items()
              for n in (4, 64, 1024)]
    max_err = 0.0
    for i, (name, spec, n) in enumerate(cases):
        for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 1e-2)):
            op = _operand(i, dtype=dtype, **spec)
            for transposed in (False, True):
                b = _b(100 + i, spec["shape"][1], n, dtype, transposed)
                got = _nnz_stream(op, b)
                want = _plain(op, b, out_dtype=torch.float32).to(dtype)
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                ok = torch.allclose(got.float(), want.float(), rtol=tol,
                                    atol=tol)
                if name in FULL_WIDTH:
                    max_err = max(max_err, err)
                log(f"[parity] {name} N={n} {str(dtype)[6:]} "
                    f"{'x^T view' if transposed else 'row-major'} "
                    f"max|err|={err:.3g} tol={tol} {'ok' if ok else 'FAIL'}")
                check(ok, f"kernel disagrees with its plain version: {name}")
    return max_err


def _prepared(seed, shape, block, nnzb=None, density=None,
              dtype=torch.float32):
    """``ops.prepare`` of a random BCSR (forward and transpose structure)."""
    from repro_torch.core import bcsr as B
    from repro_torch.kernels import ops
    if nnzb is not None:
        a = B.random_bcsr_exact(seed, shape, block, nnzb)
    else:
        a = B.random_bcsr(seed, shape, block, density)
    return ops.prepare(a, dtype, device=DEVICE)


def sddmm_parity_phase():
    """B2 against its plain version (f32 rtol = atol = 1e-4, bf16 1e-2)
    at the small odd shapes with N in {8, 33, 100} and at both full-width
    shapes with N in {64, 2048}, dC and B row-major and as transposed
    views.  Then B1 on the transpose structure (dB = A^T dC) at the
    full-width backward shapes.  Returns the largest full-width |err| of
    B2 and of B1's backward use."""
    from repro_torch.kernels import bcsr_spmm, ops, ref
    small = [((64, 64), (8, 8), 0.5), ((128, 256), (16, 32), 0.3),
             ((256, 128), (32, 16), 0.15), ((96, 160), (16, 16), 0.4)]
    cases = [(f"small{shape}{block}", dict(shape=shape, block=block,
                                           density=d), n)
             for shape, block, d in small for n in (8, 33, 100)]
    cases += [(name, dict(shape=shape, block=(128, 128), nnzb=nnzb), n)
              for name, (shape, nnzb) in FULL_WIDTH.items()
              for n in (64, TRAIN_N)]
    err_b2 = err_dx = 0.0
    for i, (name, spec, n) in enumerate(cases):
        h, w = spec["block"]
        M, K = spec["shape"]
        for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 1e-2)):
            arrays, meta = _prepared(500 + i, dtype=dtype, **spec)
            for transposed in (False, True):
                # transposed: views, as x^T and the cotangent of C^T
                # reach the kernels in training
                dc = _b(600 + i, meta.n_block_rows * h, n, dtype, transposed)
                x = _b(700 + i, meta.n_block_cols * w, n, dtype, transposed)
                got = bcsr_spmm.bcsr_sddmm(dc, x, arrays.row_ids,
                                           arrays.col_ids, h, w)
                want = ref.bcsr_sddmm_ref(dc, x, arrays.row_ids,
                                          arrays.col_ids, h, w,
                                          out_dtype=torch.float32).to(dtype)
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                ok = torch.allclose(got.float(), want.float(), rtol=tol,
                                    atol=tol)
                if name in FULL_WIDTH:
                    err_b2 = max(err_b2, err)
                log(f"[parity] bcsr_sddmm {name} N={n} {str(dtype)[6:]} "
                    f"{'views' if transposed else 'row-major'} "
                    f"max|err|={err:.3g} (max|plain|="
                    f"{want.float().abs().max().item():.3g}) tol={tol} "
                    f"{'ok' if ok else 'FAIL'}")
                check(ok, f"bcsr_sddmm disagrees with its plain version: "
                      f"{name} N={n}")
                if name not in FULL_WIDTH:
                    continue
                # B1's second use: dB = A^T dC over the transpose structure
                t_vals = ops.transposed_vals(arrays.vals, arrays.t_perm)
                got = bcsr_spmm.bcsr_spmm_nnz_stream(
                    t_vals, arrays.t_row_ids, arrays.t_col_ids, dc,
                    meta.n_block_cols, rowptr=arrays.t_rowptr)
                want = ref.bcsr_spmm_ref(
                    t_vals, arrays.t_row_ids, arrays.t_col_ids, dc,
                    meta.n_block_cols, out_dtype=torch.float32).to(dtype)
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                ok = torch.allclose(got.float(), want.float(), rtol=tol,
                                    atol=tol)
                err_dx = max(err_dx, err)
                log(f"[parity] bcsr_spmm_nnz_stream A^T {name} N={n} "
                    f"{str(dtype)[6:]} {'view' if transposed else 'row-major'}"
                    f" max|err|={err:.3g} tol={tol} {'ok' if ok else 'FAIL'}")
                check(ok, f"nnz_stream on the transpose structure disagrees "
                      f"with its plain version: {name} N={n}")
    return err_b2, err_dx


# -------------------------------------------------------------------- timing
def time_ms(fns, reps=20):
    """Device ms per call of a loop over ``fns``: CUDA events around
    ``reps`` replays of a CUDA graph that holds one call of each (the graph
    takes the host's launch cost out)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for f in fns:
            f()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for f in fns:
            f()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * len(fns))


def bound(nnzb, h, w, k, n, nbr, dtype):
    """(bound_ms, bound_by) of one product: each input read once, the
    output written once; 2 operations per multiply-add of a stored value."""
    esize = torch.finfo(dtype).bits // 8
    nbytes = (nnzb * h * w * esize + nnzb * 4 + (nbr + 1) * 4   # A
              + k * n * esize + nbr * h * n * esize)            # B, C
    flops = 2 * nnzb * h * w * n
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def sddmm_bound(arrays, meta, n, dtype):
    """(bound_ms, bound_by) of one SDDMM: the dC rows and B rows the stored
    blocks touch, each read once, and the blocks written once; 2 operations
    per multiply-add of a stored value."""
    esize = torch.finfo(dtype).bits // 8
    h, w = meta.block
    rows = arrays.row_ids.unique().numel() * h
    cols = arrays.col_ids.unique().numel() * w
    nbytes = ((rows + cols) * n * esize + meta.nnzb * h * w * esize
              + 2 * meta.nnzb * 4)
    flops = 2 * meta.nnzb * h * w * n
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def time_ms_eager(fns, reps=5):
    """Device ms per call of a loop over ``fns``, launched eagerly (their
    host cost included): for library calls that may not be capturable in
    a CUDA graph."""
    for f in fns:
        f()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        for f in fns:
            f()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * len(fns))


def _library(fns_lib, check_one, timer=None):
    """Time a PyTorch library call beside a kernel; its refusal is reported
    as null with the error, and the run goes on."""
    try:
        check_one()
        return (timer or time_ms)(fns_lib, reps=5), None
    except Exception as exc:
        torch.cuda.synchronize()
        return None, f"{type(exc).__name__}: " + \
            str(exc).splitlines()[0][:200]


def train_timing_phase(smi):
    """bf16 kernel times at the training shape (N = TRAIN_N tokens),
    rotating over ROTATE layers' operands so that L2 is cold: B2 (dvals),
    B1 forward (C = A x^T) and B1 on the transpose structure (dB = A^T dC),
    each beside its plain version, its bound, the dense product and the
    library call.  Operands enter as the transposed views training
    passes."""
    from repro_torch.kernels import bcsr_spmm, ops, ref
    dtype, n = torch.bfloat16, TRAIN_N
    results = {}
    for name, (shape, nnzb) in FULL_WIDTH.items():
        M, K = shape
        ops_ = [_prepared(7919 + j, shape, (128, 128), nnzb=nnzb,
                          dtype=dtype) for j in range(ROTATE)]
        arrays0, meta = ops_[0]
        xs = [_b(j, K, n, dtype, transposed=True) for j in range(ROTATE)]
        dcs = [_b(100 + j, M, n, dtype, transposed=True)
               for j in range(ROTATE)]
        t_vals = [ops.transposed_vals(a.vals, a.t_perm) for a, _ in ops_]
        dense = [ops.materialize_dense(a, m) for a, m in ops_]

        def row(case, **kw):
            r = {"case": f"{case} {name} {M}x{K} N={n}", "card": smi, **kw}
            log("[timing] " + json.dumps(r))
            return r

        # ---- B2: dvals = dC x^T at the stored blocks
        ms = time_ms([lambda a=a, d=d, x=x: bcsr_spmm.bcsr_sddmm(
            d, x, a.row_ids, a.col_ids, 128, 128)
            for (a, _), d, x in zip(ops_, dcs, xs)], reps=10)
        plain = time_ms([lambda a=a, d=d, x=x: ref.bcsr_sddmm_ref(
            d, x, a.row_ids, a.col_ids, 128, 128)
            for (a, _), d, x in zip(ops_, dcs, xs)], reps=5)
        dense_ms = time_ms([lambda a=a, d=d, x=x: ref.bcsr_sddmm_dense_ref(
            d, x, a.row_ids, a.col_ids, 128, 128)
            for (a, _), d, x in zip(ops_, dcs, xs)], reps=5)
        # the yardstick: PyTorch's sampled product on the same operands
        lib, lib_note = _sddmm_library(ops_, dcs, xs, meta, shape)
        bound_ms, bound_by = sddmm_bound(arrays0, meta, n, dtype)
        results[("sddmm", name)] = row(
            "bcsr_sddmm", ms=ms, plain_ms=plain, bound_ms=bound_ms,
            bound_by=bound_by, dense_ms=dense_ms, library_ms=lib,
            **lib_note)

        # ---- B1 forward: C = A x^T
        ms = time_ms([lambda a=a, x=x: bcsr_spmm.bcsr_spmm_nnz_stream(
            a.vals, a.row_ids, a.col_ids, x, m.n_block_rows, rowptr=a.rowptr)
            for (a, m), x in zip(ops_, xs)], reps=5)
        plain = time_ms([lambda a=a, m=m, x=x: ref.bcsr_spmm_ref(
            a.vals, a.row_ids, a.col_ids, x, m.n_block_rows)
            for (a, m), x in zip(ops_, xs)], reps=5)
        dense_ms = time_ms([lambda d=d, x=x: d @ x
                            for d, x in zip(dense, xs)], reps=5)
        bsr = [_bsr_library(a, shape) for a, _ in ops_]
        xcs = [x.contiguous() for x in xs]

        def check_fwd():
            if not torch.allclose((bsr[0] @ xcs[0]).float(),
                                  (dense[0] @ xs[0]).float(), rtol=2e-2,
                                  atol=2e-2):
                raise ValueError("sparse_bsr result differs")
        lib, lib_err = _library([lambda a=a, x=x: a @ x
                                 for a, x in zip(bsr, xcs)], check_fwd)
        bound_ms, bound_by = bound(nnzb, 128, 128, K, n, meta.n_block_rows,
                                   dtype)
        results[("fwd", name)] = row(
            "bcsr_spmm_nnz_stream forward", ms=ms, plain_ms=plain,
            bound_ms=bound_ms, bound_by=bound_by, dense_ms=dense_ms,
            library_ms=lib, **({"library_error": lib_err} if lib_err else {}))
        del bsr, xcs

        # ---- B1 on the transpose structure: dB = A^T dC
        ms = time_ms([lambda a=a, m=m, t=t, d=d: bcsr_spmm.bcsr_spmm_nnz_stream(
            t, a.t_row_ids, a.t_col_ids, d, m.n_block_cols,
            rowptr=a.t_rowptr) for (a, m), t, d in zip(ops_, t_vals, dcs)],
            reps=5)
        plain = time_ms([lambda a=a, m=m, t=t, d=d: ref.bcsr_spmm_ref(
            t, a.t_row_ids, a.t_col_ids, d, m.n_block_cols)
            for (a, m), t, d in zip(ops_, t_vals, dcs)], reps=5)
        dense_ms = time_ms([lambda dd=dd, d=d: dd.T @ d
                            for dd, d in zip(dense, dcs)], reps=5)
        bsr_t = [torch.sparse_bsr_tensor(a.t_rowptr, a.t_col_ids, t,
                                         size=(K, M))
                 for (a, _), t in zip(ops_, t_vals)]
        dccs = [d.contiguous() for d in dcs]

        def check_bwd():
            if not torch.allclose((bsr_t[0] @ dccs[0]).float(),
                                  (dense[0].T @ dcs[0]).float(), rtol=2e-2,
                                  atol=2e-2):
                raise ValueError("sparse_bsr result differs")
        lib, lib_err = _library([lambda a=a, d=d: a @ d
                                 for a, d in zip(bsr_t, dccs)], check_bwd)
        bound_ms, bound_by = bound(meta.nnzb_t, 128, 128, M, n,
                                   meta.n_block_cols, dtype)
        results[("dx", name)] = row(
            "bcsr_spmm_nnz_stream dB=A^T dC", ms=ms, plain_ms=plain,
            bound_ms=bound_ms, bound_by=bound_by, dense_ms=dense_ms,
            library_ms=lib, **({"library_error": lib_err} if lib_err else {}))
        del ops_, xs, dcs, t_vals, dense, bsr_t, dccs
        torch.cuda.empty_cache()
    return results


def timing_phase(smi):
    """bf16 kernel times at the main path's shapes, rotating over ROTATE
    layers' weights so that L2 is cold as it is in decode."""
    from repro_torch.kernels import ops
    dtype = torch.bfloat16
    results = {}
    for name, (shape, nnzb) in FULL_WIDTH.items():
        ops_ = [_operand(7919 + j, shape, (128, 128), nnzb=nnzb, dtype=dtype)
                for j in range(ROTATE)]
        for n in (N_SLOTS, 1024):
            bs = [_b(j, shape[1], n, dtype, transposed=True)
                  for j in range(ROTATE)]
            row = {"case": f"{name} {shape[0]}x{shape[1]} N={n}",
                   "card": smi}
            row["ms"] = time_ms(
                [lambda o=o, b=b: _nnz_stream(o, b) for o, b in zip(ops_, bs)])
            row["plain_ms"] = time_ms(
                [lambda o=o, b=b: _plain(o, b) for o, b in zip(ops_, bs)])
            row["bound_ms"], row["bound_by"] = bound(
                nnzb, 128, 128, shape[1], n, ops_[0]["nbr"], dtype)
            dense = [ops.materialize_dense(ops.SparseArrays(
                o["vals"], o["row_ids"], o["col_ids"], None, None, None,
                None), ops.SparseMeta(shape, (128, 128), o["nbr"], o["nbc"],
                                      nnzb, nnzb)) for o in ops_]
            row["dense_ms"] = time_ms(
                [lambda d=d, b=b: d @ b for d, b in zip(dense, bs)])
            del dense
            # the yardstick: PyTorch's own block-sparse product on the same
            # operands (B contiguous, as it prefers); any refusal is reported
            # as null with its error, and the run goes on
            try:
                bsr = [torch.sparse_bsr_tensor(
                    o["rowptr"], o["col_ids"], o["vals"], size=shape)
                    for o in ops_]
                bcs = [b.contiguous() for b in bs]
                got = bsr[0] @ bcs[0]
                want = _plain(ops_[0], bs[0])
                if not torch.allclose(got.float(), want.float(), rtol=2e-2,
                                      atol=2e-2):
                    raise ValueError("sparse_bsr result differs")
                row["library_ms"] = time_ms(
                    [lambda a=a, b=b: a @ b for a, b in zip(bsr, bcs)])
            except Exception as exc:
                torch.cuda.synchronize()
                row["library_ms"] = None
                row["library_error"] = f"{type(exc).__name__}: " + \
                    str(exc).splitlines()[0][:200]
            log("[timing] " + json.dumps(row))
            results[(name, n)] = row
    return results


# ----------------------------------------------------------------- main path
def _requests(cfg):
    from repro_torch.serve.engine import Request
    rng = np.random.default_rng(0)
    return [Request(rid=r, prompt=rng.integers(0, cfg.vocab_size,
                                               size=PROMPT_LEN,
                                               dtype=np.int32),
                    max_new_tokens=NEW_TOKENS) for r in range(N_REQUESTS)]


def _greedy_oracle(cfg, model, prompt, n_new):
    """A direct decode_step loop: request 0 in row 0 of an N_SLOTS-row batch
    (pad elsewhere), as the engine runs it, so row 0 sees the same shapes."""
    from repro_torch.models import transformer as T
    cache = T.init_cache(cfg, N_SLOTS, CACHE_LEN, device=DEVICE)
    toks = torch.zeros(N_SLOTS, dtype=torch.int64, device=DEVICE)
    out, pos = [], 0
    for t in prompt:
        toks[0] = int(t)
        logits, cache = T.decode_step(cfg, model, cache, toks, pos)
        pos += 1
    for _ in range(n_new):
        tok = int(logits[0].float().argmax())
        out.append(tok)
        toks[0] = tok
        logits, cache = T.decode_step(cfg, model, cache, toks, pos)
        pos += 1
    return out


def main_path_phase():
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import ServeEngine

    cfg = get_config("smat-ffn-1.3b")
    t0 = time.perf_counter()
    model = T.init_params(cfg, seed=0, device=DEVICE)
    torch.cuda.synchronize()
    log(f"[main] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, {cfg.dtype}, FFN density "
        f"{cfg.ffn_sparsity.density} in {cfg.ffn_sparsity.block} blocks, "
        f"backend {cfg.ffn_sparsity.backend}; built in "
        f"{time.perf_counter() - t0:.1f}s")
    warm = ServeEngine(cfg, model, n_slots=N_SLOTS, cache_len=CACHE_LEN,
                       device=DEVICE)
    list(warm.generate(_requests(cfg)[:1]))   # first-call set-up, untimed

    engine = ServeEngine(cfg, model, n_slots=N_SLOTS, cache_len=CACHE_LEN,
                         device=DEVICE)
    requests = _requests(cfg)
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    streams = {}
    for rid, tok in engine.generate(requests):
        streams.setdefault(rid, []).append(tok)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = _read_counts()

    n_tok = sum(len(v) for v in streams.values())
    per_call = 3 * cfg.n_layers
    log(f"[main] {len(streams)} requests, {n_tok} new tokens, "
        f"{engine.decode_calls} decode calls in {dt:.3f}s: "
        f"{n_tok / dt:.1f} tok/s (host clock, synchronised; "
        f"{N_SLOTS} slots, prompt {PROMPT_LEN}, new {NEW_TOKENS})")
    log(f"[main] kernel launches {launches}; expected {per_call} per decode "
        f"call x {engine.decode_calls} = {per_call * engine.decode_calls}")
    check(sorted(streams) == list(range(N_REQUESTS)), "requests missing")
    check(all(len(v) == NEW_TOKENS for v in streams.values()),
          "a request got the wrong number of tokens")
    check(all(0 <= t < cfg.vocab_size for v in streams.values() for t in v),
          "a token outside the vocabulary")
    check(launches["bcsr_spmm_nnz_stream"] ==
          per_call * engine.decode_calls > 0,
          f"launch count {launches} != {per_call} x decode calls")
    check(launches == _counts(**{B1: launches[B1]}),
          f"serving launched another kernel than {B1}: {launches}")

    with torch.inference_mode():
        oracle = _greedy_oracle(cfg, model, requests[0].prompt, NEW_TOKENS)
    log(f"[main] request 0: engine {streams[0]}")
    log(f"[main] request 0: decode_step loop {oracle}")
    check(streams[0] == oracle, "engine stream != direct decode_step loop")
    return cfg, model, launches, n_tok / dt, streams[0]


def model_vs_plain_phase(cfg, model):
    """First decode step with the kernel against the plain version, same
    weights.  bf16 at full width: every layer's bf16 output rounds
    differently with the summation order, and 24 layers compound it, so
    the f32 logits are held to the plain path's own rounding noise: the
    ``dense`` backend (the same bf16 weights materialised, multiplied in
    f32: one more summation order) against ``xla`` sets it, and the kernel
    must stay within twice that, or 2e-2 where that is larger.  A 2-layer
    float32 copy at full width: rtol = atol = 1e-4."""
    from repro_torch.models import transformer as T

    def first_step(cfg_, model_, backend):
        cfg_b = dataclasses.replace(cfg_, ffn_sparsity=dataclasses.replace(
            cfg_.ffn_sparsity, backend=backend))
        cache = T.init_cache(cfg_b, N_SLOTS, CACHE_LEN, device=DEVICE)
        toks = torch.as_tensor([r.prompt[0] for r in _requests(cfg_)[:N_SLOTS]],
                               device=DEVICE).long()
        logits, _ = T.decode_step(cfg_b, model_, cache, toks, 0)
        return logits.float()

    with torch.inference_mode():
        a = first_step(cfg, model, "nnz_stream")
        b = first_step(cfg, model, "xla")
        d = first_step(cfg, model, "dense")
        err = (a - b).abs().max().item()
        noise = (d - b).abs().max().item()
        tol = max(2e-2, 2 * noise)
        same_top = (a.argmax(-1) == b.argmax(-1)).sum().item()
        ok = bool(torch.isfinite(a).all()) and err <= tol
        log(f"[model] bf16 full width, kernel vs plain: max|dlogit|={err:.4g}; "
            f"plain's own noise (dense vs plain) {noise:.4g}; tolerance "
            f"max(2e-2, 2 x noise) = {tol:.4g}; logits scale "
            f"max|logit|={b.abs().max().item():.4g}; same argmax in "
            f"{same_top}/{N_SLOTS} rows {'ok' if ok else 'FAIL'}")
        check(ok, "bf16 model disagrees with its plain path")

        cfg32 = dataclasses.replace(cfg, n_layers=2, dtype="float32")
        model32 = T.init_params(cfg32, seed=0, device=DEVICE)
        a = first_step(cfg32, model32, "nnz_stream")
        b = first_step(cfg32, model32, "xla")
        err32 = (a - b).abs().max().item()
        ok = bool(torch.isfinite(a).all()) and torch.allclose(
            a, b, rtol=1e-4, atol=1e-4)
        log(f"[model] f32 2-layer full width, kernel vs plain: "
            f"max|dlogit|={err32:.3g} (rtol=atol=1e-4) "
            f"{'ok' if ok else 'FAIL'}")
        check(ok, "f32 model disagrees with its plain path")
        del model32


def _device_us(event) -> float:
    """Device time of a profiler row that ran on the card (a kernel, a copy
    or a memset); 0 for host rows, whose device time repeats their
    kernels'."""
    if event.device_type != torch.autograd.DeviceType.CUDA:
        return 0.0
    return getattr(event, "self_device_time_total",
                   getattr(event, "self_cuda_time_total", 0.0))


def _profile_summary(prof, wall_ms, units, unit):
    """Device ms per ``unit`` by kernel, the host's busiest ops, launches,
    and the device's idle share of the window (1 - device time / wall
    time; the profiler's own host cost inflates the wall time a little)."""
    events = prof.key_averages()
    device = sorted(((e.key, _device_us(e) / 1e3 / units) for e in events
                     if _device_us(e) > 0), key=lambda kv: -kv[1])
    host = sorted(((e.key, e.self_cpu_time_total / 1e3 / units, e.count //
                    units) for e in events if e.self_cpu_time_total > 0),
                  key=lambda kv: -kv[1])
    dev_ms = sum(ms for _, ms in device)
    launches = sum(e.count for e in events if e.key == "cudaLaunchKernel")
    row = {f"wall_ms_per_{unit}": wall_ms / units,
           f"kernel_launches_per_{unit}": launches / units,
           f"device_ms_per_{unit}": dev_ms,
           "device_idle_share": (1 - dev_ms * units / wall_ms)
           if dev_ms else None,
           f"nnz_stream_ms_per_{unit}": sum(ms for k, ms in device
                                            if "nnz_stream" in k),
           f"sddmm_ms_per_{unit}": sum(ms for k, ms in device
                                       if "sddmm_kernel" in k),
           f"attn_fused_ms_per_{unit}": sum(ms for k, ms in device
                                            if "attn_fused" in k),
           f"top_device_ms_per_{unit}": [[k[:80], ms]
                                         for k, ms in device[:10]],
           f"top_host_ms_per_{unit}": [[k[:60], ms, n]
                                       for k, ms, n in host[:10]]}
    if not dev_ms:
        row["note"] = "torch.profiler recorded no device time: not measured"
    return row


def profile_phase(cfg, model):
    """Where a decode call's time goes: ``torch.profiler`` over
    PROFILE_STEPS engine steps of the full-width engine (4 slots decoding
    together, one decode call per step).  Prints device ms per call by
    kernel, the host's busiest ops, and the device's idle share of the
    window (1 - device time / wall time; the profiler's own host cost
    inflates the wall time a little)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve.engine import ServeEngine
    engine = ServeEngine(cfg, model, n_slots=N_SLOTS, cache_len=CACHE_LEN,
                         device=DEVICE)
    for r in _requests(cfg)[:N_SLOTS]:
        engine.enqueue(r)
    for _ in range(2):
        engine.step()
    torch.cuda.synchronize()
    calls0 = engine.decode_calls
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILE_STEPS):
            engine.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    calls = engine.decode_calls - calls0
    row = {"decode_calls": calls, **_profile_summary(prof, wall_ms, calls,
                                                     "call")}
    log("[profile] " + json.dumps(row))


# ------------------------------------------------------------ training path
def _launches(k):
    """The launch-count dict of kernel ``k``'s wrapper module."""
    import importlib
    return importlib.import_module(
        f"repro_torch.kernels.{k.get('module', 'bcsr_spmm')}").LAUNCHES


def _reset_counts():
    for k in KERNELS:
        _launches(k)[k["counter"]] = 0


def _read_counts():
    return {k["name"]: _launches(k)[k["counter"]] for k in KERNELS}


def _counts(**nonzero):
    """Launch counts of every kernel: the ones given, 0 for the rest."""
    return {k["name"]: nonzero.get(k["name"], 0) for k in KERNELS}


def train_phase(cfg, smi):
    """The training main path at full width: TRAIN_STEPS AdamW steps of
    2 x 1024 tokens, bf16, no remat, through ``train.loop.train`` on the
    port's ``make_batch``.  Checks finite losses and exactly 144 B1 and 72
    B2 launches per step (3 sparse products a layer: forward and dB on B1,
    dvals on B2); then one step with ``remat="full"`` (216 and 72: the
    recomputed forward adds 72 B1), and a ``torch.profiler`` window of one
    step."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.base import ShapeCell
    from repro_torch.data.pipeline import make_batch
    from repro_torch.launch import steps as st
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw
    from repro_torch.train import loop

    shape = ShapeCell("chip", "train", TRAIN_SEQ, TRAIN_BATCH)
    opt_cfg = adamw.AdamWConfig(total_steps=TRAIN_STEPS)
    per_layer = _counts(**{B1: 6, B2: 3})
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    res = loop.train(cfg, shape, device=DEVICE, total_steps=TRAIN_STEPS,
                     opt_cfg=opt_cfg, remat="none")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    steady = res.step_times[1:]
    step_ms = 1e3 * sum(steady) / len(steady)
    log(f"[train] {cfg.name} full width, {TRAIN_BATCH} x {TRAIN_SEQ} tokens "
        f"per step, {cfg.dtype}, remat none, AdamW: losses {res.losses}")
    log(f"[train] step ms (host clock, each ends in a device sync): "
        f"{[round(1e3 * t, 3) for t in res.step_times]}; steady "
        f"{step_ms:.3f} ms = {TRAIN_N / step_ms * 1e3:.1f} tokens/s; "
        f"{wall:.1f}s with model build; peak memory {peak_gb:.2f} GB; "
        f"{smi}")
    want = {name: n * cfg.n_layers * TRAIN_STEPS
            for name, n in per_layer.items()}
    log(f"[train] kernel launches {launches}; expected {want} "
        f"({per_layer} per layer x {cfg.n_layers} layers x {TRAIN_STEPS} "
        f"steps)")
    check(res.final_step == TRAIN_STEPS and
          len(res.losses) == TRAIN_STEPS, "training did not reach its end")
    check(all(np.isfinite(res.losses)), "a training loss is not finite")
    check(launches == want, f"training launch counts {launches} != {want}")

    model = T.init_params(cfg, seed=0, device=DEVICE)
    opt_state = adamw.init(dict(model.named_parameters()))
    batch = loop.batch_to_device(make_batch(cfg, shape, 0), DEVICE)
    step_none = st.make_train_step(cfg, opt_cfg, remat="none")
    step_full = st.make_train_step(cfg, opt_cfg, remat="full")
    model, opt_state, _ = step_none(model, opt_state, batch)   # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    model, opt_state, metrics = step_full(model, opt_state, batch)
    loss_full = float(metrics["loss"])
    remat_counts = _read_counts()
    want_full = _counts(**{B1: 9 * cfg.n_layers, B2: 3 * cfg.n_layers})
    log(f"[train] remat=full step: loss {loss_full:.4f}, launches "
        f"{remat_counts}, expected {want_full}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    check(np.isfinite(loss_full), "remat=full loss is not finite")
    check(remat_counts == want_full,
          f"remat=full launch counts {remat_counts} != {want_full}")

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model, opt_state, metrics = step_none(model, opt_state, batch)
        float(metrics["loss"])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    row = {"train_steps": 1, "card": smi,
           **_profile_summary(prof, wall_ms, 1, "step")}
    log("[train-profile] " + json.dumps(row))
    del model, opt_state, batch
    torch.cuda.empty_cache()
    return launches, {"step_ms": step_ms,
                      "tokens_per_s": TRAIN_N / step_ms * 1e3,
                      "losses": res.losses}


def train_vs_plain_phase(cfg):
    """One training step of a 2-layer float32 copy at full width through
    the kernels and through the plain versions, from the same weights on
    the same batch.  Loss: rtol 1e-5.  Every parameter's gradient: max
    |diff| <= 1e-4 x its max |grad| (float32 sums over 2048 tokens, in
    another order in the kernels than in the plain einsums)."""
    from repro_torch.configs.base import ShapeCell
    from repro_torch.data.pipeline import make_batch
    from repro_torch.models import transformer as T
    from repro_torch.train import loop

    cfg32 = dataclasses.replace(cfg, n_layers=2, dtype="float32")
    model = T.init_params(cfg32, seed=0, device=DEVICE)
    batch = loop.batch_to_device(make_batch(
        cfg32, ShapeCell("chip", "train", TRAIN_SEQ, TRAIN_BATCH), 0), DEVICE)
    out = {}
    for backend in ("nnz_stream", "xla"):
        cfg_b = dataclasses.replace(cfg32, ffn_sparsity=dataclasses.replace(
            cfg32.ffn_sparsity, backend=backend))
        for p in model.parameters():
            p.grad = None
        _reset_counts()
        loss, _ = T.train_loss(cfg_b, model, batch, remat="none")
        loss.backward()
        out[backend] = (float(loss.detach()), _read_counts(),
                        {n: p.grad.clone()
                         for n, p in model.named_parameters()})
    (loss_k, counts_k, g_k), (loss_p, counts_p, g_p) = (out["nnz_stream"],
                                                        out["xla"])
    worst = max(((g_k[n] - g).abs().max().item() /
                 max(g.abs().max().item(), 1e-30), n) for n, g in g_p.items())
    ok = (abs(loss_k - loss_p) <= 1e-5 * abs(loss_p) and worst[0] <= 1e-4
          and counts_k == _counts(**{B1: 12, B2: 6})
          and counts_p == _counts())
    log(f"[train] f32 2-layer full width, kernel vs plain: loss "
        f"{loss_k:.7f} vs {loss_p:.7f} (rtol 1e-5); worst gradient "
        f"max|diff|/max|grad| = {worst[0]:.3g} at {worst[1]} (tolerance "
        f"1e-4); launches {counts_k} vs {counts_p} {'ok' if ok else 'FAIL'}")
    check(ok, "f32 training step disagrees with its plain path")
    del model
    torch.cuda.empty_cache()


def _leaves(tree, prefix=""):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _leaves(value, f"{prefix}{key}/")
        else:
            yield f"{prefix}{key}", value


def restart_phase():
    """Checkpoint/restart on the card at ``:smoke`` size: inject a failure,
    resume from the latest checkpoint, reach the final step; then restore
    that checkpoint, save it again and restore it: every tensor, bf16
    included, is bit-equal."""
    import tempfile

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeCell
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw
    from repro_torch.train import loop

    cfg = get_config("smat-ffn-1.3b:smoke")
    with tempfile.TemporaryDirectory() as tmp:
        res = loop.train_with_restarts(
            cfg, ShapeCell("t", "train", 32, 2), device=DEVICE,
            total_steps=6, ckpt_dir=tmp, ckpt_every=2, fail_at_step=3,
            opt_cfg=adamw.AdamWConfig(lr=1e-3, total_steps=6,
                                      warmup_steps=1))
        mgr = CheckpointManager(tmp, async_save=False)
        model = T.init_params(cfg, seed=0, device=DEVICE)
        like = {"params": model.state_dict(),
                "opt": adamw.init(dict(model.named_parameters()))}
        state, step = mgr.restore(like)
        mgr.save(step + 1, state)
        again, _ = mgr.restore(like, step=step + 1)
        a, b = dict(_leaves(state)), dict(_leaves(again))
        equal = sorted(a) == sorted(b) and all(
            b[k].dtype == v.dtype and b[k].device == v.device and
            torch.equal(b[k], v) for k, v in a.items())
        n_bf16 = sum(v.dtype == torch.bfloat16 for v in a.values())
    ok = (res.final_step == 6 and res.restarts_used == 1 and step == 6
          and equal and all(np.isfinite(res.losses)))
    log(f"[restart] smoke on the card: failure at step 3, resumed, final "
        f"step {res.final_step}, restarts {res.restarts_used}, losses after "
        f"resume {res.losses}; checkpoint step {step} restored and re-saved "
        f"bit-equal over {len(a)} tensors ({n_bf16} bf16): {equal} "
        f"{'ok' if ok else 'FAIL'}")
    check(ok, "checkpoint/restart on the card failed")

# ------------------------------------------------------------ row_loop (B3, B4)
def _b3(arrays, meta, b):
    from repro_torch.kernels import bcsr_spmm
    return bcsr_spmm.bcsr_spmm_row_loop(
        arrays.vals, arrays.flat_idx, arrays.flat_col, arrays.row_len, b,
        meta.n_block_rows)


def _b3_plain(arrays, meta, b, out_dtype=None):
    from repro_torch.kernels import ref
    return ref.bcsr_spmm_row_loop_ref(
        arrays.vals, arrays.flat_idx, arrays.flat_col, arrays.row_len, b,
        meta.n_block_rows, out_dtype=out_dtype)


def _b4(arrays, meta, dc, x):
    from repro_torch.kernels import bcsr_spmm
    h, w = meta.block
    return bcsr_spmm.bcsr_sddmm_row_loop(
        dc, x, arrays.sddmm_flat_idx, arrays.flat_col, meta.n_block_rows,
        meta.nnzb, h, w)


def _b4_plain(arrays, meta, dc, x, out_dtype=None):
    from repro_torch.kernels import ref
    h, w = meta.block
    return ref.bcsr_sddmm_row_loop_ref(
        dc, x, arrays.sddmm_flat_idx, arrays.flat_col, meta.n_block_rows,
        meta.nnzb, h, w, out_dtype=out_dtype)


def row_loop_parity_phase():
    """B3 and B4 against their plain versions (which read the same schedule
    arrays): f32 rtol = atol = 1e-4, bf16 out 1e-2 (about one ulp).  Small
    odd blocks with a ragged N, ``max_bpr`` of 1 (one block a row) and of
    many; then both full-width FFN structures at N = 4 and N = TRAIN_N, with
    the operands as the transposed views the model passes.  Returns the
    largest full-width |err| of B3 and of B4."""
    small = [((64, 64), (8, 8), dict(density=0.6)),
             ((64, 64), (8, 8), dict(nnzb=8)),            # max_bpr 1
             ((128, 256), (16, 32), dict(density=0.3)),
             ((256, 128), (32, 16), dict(density=0.15)),
             ((96, 160), (16, 16), dict(density=0.4))]
    cases = [(f"small{shape}{block}", dict(shape=shape, block=block, **kw), n)
             for shape, block, kw in small for n in (8, 33, 100)]
    cases += [(name, dict(shape=shape, block=(128, 128), nnzb=nnzb), n)
              for name, (shape, nnzb) in FULL_WIDTH.items()
              for n in (N_SLOTS, TRAIN_N)]
    err_b3 = err_b4 = 0.0
    for i, (name, spec, n) in enumerate(cases):
        h, w = spec["block"]
        for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 1e-2)):
            arrays, meta = _prepared(900 + i, dtype=dtype, **spec)
            for view in (False, True):
                x = _b(1000 + i, meta.n_block_cols * w, n, dtype, view)
                dc = _b(1100 + i, meta.n_block_rows * h, n, dtype, view)
                for kname, got, want in (
                        (B3, _b3(arrays, meta, x),
                         _b3_plain(arrays, meta, x, torch.float32)),
                        (B4, _b4(arrays, meta, dc, x),
                         _b4_plain(arrays, meta, dc, x, torch.float32))):
                    want = want.to(dtype)
                    torch.cuda.synchronize()
                    err = (got.float() - want.float()).abs().max().item()
                    ok = got.shape == want.shape and torch.allclose(
                        got.float(), want.float(), rtol=tol, atol=tol)
                    if name in FULL_WIDTH:
                        if kname == B3:
                            err_b3 = max(err_b3, err)
                        else:
                            err_b4 = max(err_b4, err)
                    log(f"[row_loop-parity] {kname} {name} max_bpr="
                        f"{meta.max_bpr} N={n} {str(dtype)[6:]} "
                        f"{'views' if view else 'row-major'} max|err|="
                        f"{err:.3g} tol={tol} {'ok' if ok else 'FAIL'}")
                    check(ok, f"{kname} disagrees with its plain version: "
                          f"{name} N={n}")
    return err_b3, err_b4


def _bsr_library(arrays, shape):
    """``torch.sparse_bsr_tensor`` of an operand (the SpMM yardstick)."""
    return torch.sparse_bsr_tensor(arrays.rowptr, arrays.col_ids,
                                   arrays.vals, size=shape)


def _sddmm_library(ops_, dcs, xs, meta, shape):
    """Time ``torch.sparse.sampled_addmm`` on the stored blocks as the
    SDDMM yardstick: a BSR mask, else the same mask in CSR.  Returns
    (ms or None, note dict)."""
    from repro_torch.kernels import ops, ref
    h, w = meta.block
    arrays0 = ops_[0][0]
    bsr_masks = [torch.sparse_bsr_tensor(a.rowptr, a.col_ids,
                                         torch.ones_like(a.vals), size=shape)
                 for a, _ in ops_]
    want0 = ops.materialize_dense(arrays0._replace(
        vals=ref.bcsr_sddmm_ref(dcs[0], xs[0], arrays0.row_ids,
                                arrays0.col_ids, h, w)), meta)
    errors = []
    for layout in ("bsr", "csr"):
        masks = bsr_masks if layout == "bsr" else [
            m.to_dense().to_sparse_csr() for m in bsr_masks]

        def check_sampled(masks=masks):
            got = torch.sparse.sampled_addmm(masks[0], dcs[0], xs[0].T,
                                             beta=0.0)
            if not torch.allclose(got.to_dense().float(), want0.float(),
                                  rtol=2e-2, atol=2e-2):
                raise ValueError("sampled_addmm result differs")
        lib, err = _library(
            [lambda m=m, d=d, x=x: torch.sparse.sampled_addmm(
                m, d, x.T, beta=0.0) for m, d, x in zip(masks, dcs, xs)],
            check_sampled, timer=time_ms_eager)
        if lib is not None:
            return lib, {"library_mask": layout, "library_timing": "eager"}
        errors.append(f"{layout}: {err}")
    return None, {"library_error": "; ".join(errors)}


def row_loop_timing_phase(smi):
    """bf16 times of B3 and B4 at both full-width FFN structures, at the
    decode (N = N_SLOTS) and training (N = TRAIN_N) widths, rotating over
    ROTATE layers' operands so that L2 is cold, operands as the transposed
    views the model passes; each beside its plain version, its bound, the
    dense product and the library call."""
    from repro_torch.kernels import ops, ref
    dtype = torch.bfloat16
    results = {}
    for name, (shape, nnzb) in FULL_WIDTH.items():
        M, K = shape
        ops_ = [_prepared(7919 + j, shape, (128, 128), nnzb=nnzb,
                          dtype=dtype) for j in range(ROTATE)]
        meta = ops_[0][1]
        dense = [ops.materialize_dense(a, m) for a, m in ops_]
        bsr = [_bsr_library(a, shape) for a, _ in ops_]
        for n in (N_SLOTS, TRAIN_N):
            xs = [_b(j, K, n, dtype, transposed=True) for j in range(ROTATE)]
            dcs = [_b(100 + j, M, n, dtype, transposed=True)
                   for j in range(ROTATE)]

            def row(case, **kw):
                r = {"case": f"{case} {name} {M}x{K} N={n}",
                     "max_bpr": meta.max_bpr, "card": smi, **kw}
                log("[row_loop-timing] " + json.dumps(r))
                return r

            # ---- B3: C = A x^T through the static schedule
            reps = 20 if n == N_SLOTS else 5
            ms = time_ms([lambda a=a, m=m, x=x: _b3(a, m, x)
                          for (a, m), x in zip(ops_, xs)], reps=reps)
            plain = time_ms([lambda a=a, m=m, x=x: _b3_plain(a, m, x)
                             for (a, m), x in zip(ops_, xs)], reps=reps)
            dense_ms = time_ms([lambda d=d, x=x: d @ x
                                for d, x in zip(dense, xs)], reps=reps)
            xcs = [x.contiguous() for x in xs]

            def check_fwd():
                if not torch.allclose((bsr[0] @ xcs[0]).float(),
                                      (dense[0] @ xs[0]).float(), rtol=2e-2,
                                      atol=2e-2):
                    raise ValueError("sparse_bsr result differs")
            lib, lib_err = _library([lambda a=a, x=x: a @ x
                                     for a, x in zip(bsr, xcs)], check_fwd)
            bound_ms, bound_by = bound(nnzb, 128, 128, K, n,
                                       meta.n_block_rows, dtype)
            results[(B3, name, n)] = row(
                B3, ms=ms, plain_ms=plain, bound_ms=bound_ms,
                bound_by=bound_by, dense_ms=dense_ms, library_ms=lib,
                **({"library_error": lib_err} if lib_err else {}))
            del xcs

            # ---- B4: dvals = dC x^T at the stored blocks
            ms = time_ms([lambda a=a, m=m, d=d, x=x: _b4(a, m, d, x)
                          for (a, m), d, x in zip(ops_, dcs, xs)], reps=reps)
            plain = time_ms([lambda a=a, m=m, d=d, x=x: _b4_plain(a, m, d, x)
                             for (a, m), d, x in zip(ops_, dcs, xs)],
                            reps=reps)
            dense_ms = time_ms([lambda a=a, d=d, x=x: ref.bcsr_sddmm_dense_ref(
                d, x, a.row_ids, a.col_ids, 128, 128)
                for (a, _), d, x in zip(ops_, dcs, xs)], reps=reps)
            lib, lib_note = _sddmm_library(ops_, dcs, xs, meta, shape)
            bound_ms, bound_by = sddmm_bound(ops_[0][0], meta, n, dtype)
            results[(B4, name, n)] = row(
                B4, ms=ms, plain_ms=plain, bound_ms=bound_ms,
                bound_by=bound_by, dense_ms=dense_ms, library_ms=lib,
                **lib_note)
            del xs, dcs
        del ops_, dense, bsr
        torch.cuda.empty_cache()
    return results


def _with_backend(cfg, backend, **spec_kw):
    return dataclasses.replace(cfg, ffn_sparsity=dataclasses.replace(
        cfg.ffn_sparsity, backend=backend, **spec_kw))


def serve_row_loop_phase(cfg, model, stream0):
    """Serving at full width with the FFN spec's ``backend="row_loop"``
    (same weights: ``prepare`` built the static schedules beside the
    streamed kernel's ``rowptr``).  Checks exactly 72 B3 launches a decode
    call and no other kernel, engine stream == direct ``decode_step`` loop,
    and the prefill logits of 4 prompts within 2e-2 of the ``nnz_stream``
    run's (printing the largest difference and whether the greedy tokens
    agree)."""
    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import ServeEngine
    cfg_rl = _with_backend(cfg, "row_loop")
    warm = ServeEngine(cfg_rl, model, n_slots=N_SLOTS, cache_len=CACHE_LEN,
                       device=DEVICE)
    list(warm.generate(_requests(cfg)[:1]))
    engine = ServeEngine(cfg_rl, model, n_slots=N_SLOTS, cache_len=CACHE_LEN,
                         device=DEVICE)
    requests = _requests(cfg)
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    streams = {}
    for rid, tok in engine.generate(requests):
        streams.setdefault(rid, []).append(tok)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = _read_counts()
    n_tok = sum(len(v) for v in streams.values())
    per_call = 3 * cfg.n_layers
    log(f"[serve-row_loop] {len(streams)} requests, {n_tok} new tokens, "
        f"{engine.decode_calls} decode calls in {dt:.3f}s: "
        f"{n_tok / dt:.1f} tok/s (host clock, synchronised)")
    log(f"[serve-row_loop] kernel launches {launches}; expected {per_call} "
        f"{B3} per decode call x {engine.decode_calls}")
    check(sorted(streams) == list(range(N_REQUESTS)) and all(
        len(v) == NEW_TOKENS for v in streams.values()),
        "row_loop serving: requests missing or short")
    check(launches == _counts(**{B3: per_call * engine.decode_calls}) and
          engine.decode_calls > 0,
          f"row_loop serving launch counts {launches}")
    with torch.inference_mode():
        oracle = _greedy_oracle(cfg_rl, model, requests[0].prompt, NEW_TOKENS)
        prompts = torch.as_tensor(np.stack([r.prompt for r in
                                            requests[:N_SLOTS]]),
                                  device=DEVICE).long()
        logits = {}
        for c in (cfg, cfg_rl):
            out, _ = T.prefill(c, model, {"tokens": prompts}, CACHE_LEN)
            logits[c.ffn_sparsity.backend] = out.float()
    log(f"[serve-row_loop] request 0: engine {streams[0]}; decode_step loop "
        f"{oracle}; nnz_stream engine {stream0}")
    check(streams[0] == oracle, "row_loop engine stream != decode_step loop")
    diff = (logits["row_loop"] - logits["nnz_stream"]).abs().max().item()
    same = bool((logits["row_loop"].argmax(-1) ==
                 logits["nnz_stream"].argmax(-1)).all())
    ok = bool(torch.isfinite(logits["row_loop"]).all()) and diff <= 2e-2
    log(f"[serve-row_loop] prefill logits ({N_SLOTS} x {PROMPT_LEN} tokens), "
        f"row_loop vs nnz_stream: max|diff|={diff:.4g} (tolerance 2e-2); "
        f"greedy tokens agree at every position: {same} "
        f"{'ok' if ok else 'FAIL'}")
    check(ok, "row_loop prefill logits differ from nnz_stream's")
    return launches, n_tok / dt


def train_row_loop_phase(cfg, smi, losses_nnz):
    """TRAIN_STEPS full-width AdamW steps with ``backend="row_loop"`` (2 x
    1024 tokens, bf16, no remat): per step exactly 72 B3 (forward), 72 B1
    (dB over the transpose structure) and 72 B4 (dvals), no B2; each loss
    within 1e-2 of the ``nnz_stream`` run's."""
    from repro_torch.configs.base import ShapeCell
    from repro_torch.optim import adamw
    from repro_torch.train import loop
    cfg_rl = _with_backend(cfg, "row_loop")
    shape = ShapeCell("chip", "train", TRAIN_SEQ, TRAIN_BATCH)
    _reset_counts()
    torch.cuda.reset_peak_memory_stats()
    res = loop.train(cfg_rl, shape, device=DEVICE, total_steps=TRAIN_STEPS,
                     opt_cfg=adamw.AdamWConfig(total_steps=TRAIN_STEPS),
                     remat="none")
    torch.cuda.synchronize()
    launches = _read_counts()
    steady = res.step_times[1:]
    step_ms = 1e3 * sum(steady) / len(steady)
    want = _counts(**{name: 3 * cfg.n_layers * TRAIN_STEPS
                      for name in (B3, B1, B4)})
    diffs = [abs(a - b) for a, b in zip(res.losses, losses_nnz)]
    log(f"[train-row_loop] losses {res.losses}; nnz_stream run's "
        f"{losses_nnz}; max|diff| {max(diffs):.3g} (tolerance 1e-2)")
    log(f"[train-row_loop] step ms {[round(1e3 * t, 3) for t in res.step_times]}"
        f"; steady {step_ms:.3f} ms = {TRAIN_N / step_ms * 1e3:.1f} tokens/s; "
        f"peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB; {smi}")
    log(f"[train-row_loop] kernel launches {launches}; expected {want}")
    check(res.final_step == TRAIN_STEPS and len(res.losses) == TRAIN_STEPS,
          "row_loop training did not reach its end")
    check(all(np.isfinite(res.losses)) and max(diffs) <= 1e-2,
          "row_loop training losses differ from nnz_stream's")
    check(launches == want, f"row_loop training launch counts {launches}")
    torch.cuda.empty_cache()
    return launches, {"step_ms": step_ms,
                      "tokens_per_s": TRAIN_N / step_ms * 1e3}


def train_row_loop_vs_plain_phase(cfg):
    """One training step of a 2-layer float32 copy at full width with
    ``backend="row_loop"`` and the weights reordered (``reorder="jaccard"``
    at block-row granularity; ``rcm`` if Jaccard leaves the rows in place),
    through the kernels against the plain versions: loss rtol 1e-5, every
    gradient max|diff| <= 1e-4 x its max|grad|.  This runs the reorder
    branches of the spmm/sddmm autograd Functions on the card."""
    from repro_torch.configs.base import ShapeCell
    from repro_torch.data.pipeline import make_batch
    from repro_torch.models import transformer as T
    from repro_torch.train import loop

    for scheme in ("jaccard", "rcm"):
        cfg32 = _with_backend(dataclasses.replace(cfg, n_layers=2,
                                                  dtype="float32"),
                              "row_loop", reorder=scheme)
        model = T.init_params(cfg32, seed=0, device=DEVICE)
        perm = model.blocks[0].mlp.gate.row_perm
        moved = int((perm != torch.arange(perm.numel(), device=DEVICE)).sum())
        log(f"[train-row_loop-vs-plain] reorder={scheme}: layer 0 gate "
            f"row_perm moves {moved} of {perm.numel()} rows")
        if moved:
            break
    check(moved > 0, "no reorder scheme moved a row of the FFN weights")
    batch = loop.batch_to_device(make_batch(
        cfg32, ShapeCell("chip", "train", TRAIN_SEQ, TRAIN_BATCH), 0), DEVICE)
    out = {}
    for backend in ("row_loop", "xla"):
        cfg_b = _with_backend(cfg32, backend)
        for p_ in model.parameters():
            p_.grad = None
        _reset_counts()
        loss, _ = T.train_loss(cfg_b, model, batch, remat="none")
        loss.backward()
        out[backend] = (float(loss.detach()), _read_counts(),
                        {n: p_.grad.clone()
                         for n, p_ in model.named_parameters()})
    (loss_k, counts_k, g_k), (loss_p, counts_p, g_p) = (out["row_loop"],
                                                        out["xla"])
    worst = max(((g_k[n] - g).abs().max().item() /
                 max(g.abs().max().item(), 1e-30), n) for n, g in g_p.items())
    want = _counts(**{B3: 6, B1: 6, B4: 6})
    ok = (abs(loss_k - loss_p) <= 1e-5 * abs(loss_p) and worst[0] <= 1e-4
          and counts_k == want and counts_p == _counts())
    log(f"[train-row_loop-vs-plain] f32 2-layer full width, reorder={scheme}: "
        f"loss {loss_k:.7f} vs {loss_p:.7f} (rtol 1e-5); worst gradient "
        f"max|diff|/max|grad| = {worst[0]:.3g} at {worst[1]} (tolerance "
        f"1e-4); launches {counts_k} (expected {want}) vs {counts_p} "
        f"{'ok' if ok else 'FAIL'}")
    check(ok, "f32 row_loop training step with a reorder disagrees with its "
          "plain path")
    del model
    torch.cuda.empty_cache()


# ------------------------------------------------------------- library path
LIB_N = 8                                  # the paper's N for SpMM
LIB_BLOCK = (16, 16)
LIB_MAX_CANDIDATES = 4096
# SuiteSparse mip1 at its published size (66,463 rows, 10,352,819 nnz), as
# the clustered stand-in of core.topology
MIP1_FULL = dict(n=66463, nnz_target=10_352_819, cluster=64)


def library_phase(smi):
    """The quickstart path on the card: CSR -> ``from_scipy`` at 16x16 ->
    ``prepare(reorder="jaccard", max_candidates=4096)`` and
    ``prepare(reorder="identity")``, for each of the nine ``topology.SUITE``
    stand-ins and for ``mip1`` at its published size.  Prints nnzb and
    max_bpr before and after the reorder, the row_loop schedule length, the
    reorder's host seconds and which Jaccard path ran; runs spmm at N = 8
    through B1 and B3 in f32 against the plain version and against the
    identity-ordered product (rtol = atol = 1e-4); times B1 and B3 in bf16
    against the bound.  Returns the mip1-class host BCSR, reordered, for
    the autotune phase, and the largest |err| of B3."""
    from repro_torch.core import bcsr as B
    from repro_torch.core import native, permute, topology
    from repro_torch.kernels import bcsr_spmm, ops
    jaccard_path = ("native C" if native.get_kernel() is not None
                    else "numpy rounds")
    log(f"[library] Jaccard clustering path: {jaccard_path} "
        f"({native.library_path() if native.get_kernel() else '-'})")
    cases = [(name, gen, kw) for name, (gen, kw, _) in topology.SUITE.items()]
    cases.append(("mip1@published", topology.blocked_random, MIP1_FULL))
    err_b3, mip1_perm = 0.0, None
    rows = {}
    for name, gen, kw in cases:
        t0 = time.perf_counter()
        csr = gen(seed=0, **kw)
        t_gen = time.perf_counter() - t0
        t0 = time.perf_counter()
        a = B.from_scipy(csr, LIB_BLOCK)
        t_block = time.perf_counter() - t0
        t0 = time.perf_counter()
        arr_i, meta_i = ops.prepare(a, torch.float32, device=DEVICE)
        t_ident = time.perf_counter() - t0
        t0 = time.perf_counter()
        arr_j, meta_j = ops.prepare(a, torch.float32, reorder="jaccard",
                                    max_candidates=LIB_MAX_CANDIDATES,
                                    device=DEVICE)
        t_jacc = time.perf_counter() - t0
        b = _b(42, csr.shape[1], LIB_N, torch.float32)
        with torch.inference_mode():
            want_i = ops.spmm(arr_i, meta_i, b, backend="xla")
            want_j = ops.spmm(arr_j, meta_j, b, backend="xla")
            errs = {}
            for backend in ("nnz_stream", "row_loop"):
                _reset_counts()
                got = ops.spmm(arr_j, meta_j, b, backend=backend)
                counts = _read_counts()
                torch.cuda.synchronize()
                errs[backend] = (
                    (got - want_j).abs().max().item(),
                    (got - want_i).abs().max().item())
                ok = (torch.allclose(got, want_j, rtol=1e-4, atol=1e-4) and
                      torch.allclose(got, want_i, rtol=1e-4, atol=1e-4) and
                      counts == _counts(**{B1 if backend == "nnz_stream"
                                           else B3: 1}))
                check(ok, f"library spmm through {backend} on {name}: "
                      f"|err| vs plain {errs[backend][0]:.3g}, vs identity "
                      f"{errs[backend][1]:.3g}, launches {counts}")
            err_b3 = max(err_b3, errs["row_loop"][0])
        # bf16 times of B1 and B3 on the reordered operand, rotating over
        # copies of its blocks so that a large operand is cold in L2
        copies = max(1, min(8, -(-3 * 50_000_000 // max(
            arr_j.vals.numel() * 2, 1))))
        vals16 = [arr_j.vals.to(torch.bfloat16, copy=True)
                  for _ in range(copies)]
        b16 = b.to(torch.bfloat16)
        b16p = torch.nn.functional.pad(            # whole w-row panels of B
            b16, (0, 0, 0, meta_j.n_block_cols * LIB_BLOCK[1] - b16.shape[0]))
        ms_b1 = time_ms([lambda v=v: bcsr_spmm.bcsr_spmm_nnz_stream(
            v, arr_j.row_ids, arr_j.col_ids, b16p, meta_j.n_block_rows,
            rowptr=arr_j.rowptr) for v in vals16], reps=10)
        ms_b3 = time_ms([lambda v=v: _b3(arr_j._replace(vals=v), meta_j, b16p)
                         for v in vals16], reps=10)
        bound_ms, bound_by = bound(meta_j.nnzb, *LIB_BLOCK, csr.shape[1],
                                   LIB_N, meta_j.n_block_rows, torch.bfloat16)
        rows[name] = r = {
            "matrix": name, "shape": list(csr.shape), "nnz": int(csr.nnz),
            "nnzb_identity": meta_i.nnzb, "nnzb_jaccard": meta_j.nnzb,
            "max_bpr_identity": meta_i.max_bpr, "max_bpr_jaccard": meta_j.max_bpr,
            "row_loop_sched_len_identity": meta_i.row_loop_sched_len,
            "row_loop_sched_len_jaccard": meta_j.row_loop_sched_len,
            "host_s": {"generate": t_gen, "block": t_block,
                       "prepare_identity": t_ident,
                       "prepare_jaccard": t_jacc},
            "jaccard_path": jaccard_path,
            "max_abs_err_vs_plain": {k: v[0] for k, v in errs.items()},
            "max_abs_err_vs_identity": {k: v[1] for k, v in errs.items()},
            "bf16_ms": {B1: ms_b1, B3: ms_b3}, "bound_ms": bound_ms,
            "bound_by": bound_by, "card": smi}
        log("[library] " + json.dumps(r))
        if name == "mip1@published":
            t0 = time.perf_counter()
            mip1_perm, _ = permute.permute_bcsr(
                a, "jaccard", max_candidates=LIB_MAX_CANDIDATES)
            log(f"[library] mip1@published reordered host BCSR for the "
                f"autotuner: nnzb {mip1_perm.nnzb} in "
                f"{time.perf_counter() - t0:.2f}s")
            bsr = _bsr_library(arr_j._replace(vals=vals16[0]),
                               (meta_j.n_block_rows * LIB_BLOCK[0],
                                meta_j.n_block_cols * LIB_BLOCK[1]))

            def check_lib():
                got = (bsr @ b16p)[: csr.shape[0]]
                ref_ = ops.spmm(arr_j._replace(vals=vals16[0]), meta_j, b16,
                                backend="xla")
                perm = arr_j.row_perm.long()
                if not torch.allclose(got.float(), ref_[perm].float(),
                                      rtol=2e-2, atol=2e-2):
                    raise ValueError("sparse_bsr result differs")
            lib, lib_err = _library([lambda: bsr @ b16p], check_lib)
            r["library_ms"] = lib
            log(f"[library] mip1@published torch.sparse BSR @ B (bf16): "
                f"{lib} ms{'; ' + lib_err if lib_err else ''}")
        del arr_i, arr_j, vals16, csr, a
        torch.cuda.empty_cache()
    return mip1_perm, err_b3, rows


# ----------------------------------------------------------------- autotune
def autotune_phase(mip1_perm, smi):
    """``Autotuner.tune`` on the card (bf16, a fresh in-memory tuner) for
    the reordered mip1-class operand at N = 8 (row-major operands, as the
    library path passes them) and both full-width FFN structures at N = 4
    and N = TRAIN_N (token-major views, as the model passes them),
    ``op="spmm"`` and ``"sddmm"``.  Prints every candidate's time and the
    winner, which is always a kernel; then ``backend="auto"`` must launch
    that kernel (the launch counters show which ran) and give its output
    bit for bit (the kernels are deterministic).  Where a yardstick (the
    plain or the dense product) beats the winner, that is printed as a
    finding.  Any exception of a candidate propagates."""
    from repro_torch.core import bcsr as B
    from repro_torch.kernels import autotune, ops
    tuner = autotune.Autotuner()
    autotune.set_autotuner(tuner)
    cases = [("mip1@published", mip1_perm, LIB_N, "row_major")]
    for name, (shape, nnzb) in FULL_WIDTH.items():
        a = B.random_bcsr_exact(7919, shape, (128, 128), nnzb)
        cases += [(name, a, N_SLOTS, "token_major"),
                  (name, a, TRAIN_N, "token_major")]
    dtype = torch.bfloat16
    winners = {}
    counters = {"nnz_stream": B1, "row_loop": B3}
    sddmm_counters = {"nnz_stream": B2, "row_loop": B4}
    for name, a, n, layout in cases:
        arrays, meta = ops.prepare(a, dtype, device=DEVICE)
        rng = np.random.default_rng(3)

        def operand(rows):
            shape = (n, rows) if layout == "token_major" else (rows, n)
            t = torch.from_numpy(rng.standard_normal(shape).astype(
                np.float32)).to(DEVICE, dtype)
            return t.T if layout == "token_major" else t
        b, x = operand(meta.shape[1]), operand(meta.shape[0])
        for op in ("spmm", "sddmm"):
            t0 = time.perf_counter()
            choice, timings = tuner.tune(a, n, dtype=dtype, op=op,
                                         layout=layout, warmup=2, iters=10,
                                         device=DEVICE)
            sweep_s = time.perf_counter() - t0
            with torch.inference_mode():
                _reset_counts()
                if op == "spmm":
                    got = ops.spmm(arrays, meta, b, backend="auto")
                    want = ops.spmm(arrays, meta, b, backend=choice.backend,
                                    bn=choice.bn)
                else:
                    got = ops.sddmm(arrays, meta, x, b, backend="auto")
                    want = ops.sddmm(arrays, meta, x, b,
                                     backend=choice.backend, bn=choice.bn)
                torch.cuda.synchronize()
            counts = _read_counts()
            kernel = (counters if op == "spmm" else sddmm_counters).get(
                choice.backend)
            ok = (kernel is not None and torch.equal(got, want)
                  and counts == _counts(**{kernel: 2}))
            label = f"{choice.variant}/bn{choice.bn}"
            yard = {k: v for k, v in timings.items()
                    if not autotune.get_variant(k.split("/")[0]).is_kernel}
            row = {"operand": name, "op": op, "N": n, "layout": layout,
                   "timings_ms": {k: v * 1e3 for k, v in timings.items()},
                   "winner": label, "auto_launches": counts,
                   "sweep_s": sweep_s, "card": smi}
            log("[autotune] " + json.dumps(row))
            check(ok, f"backend='auto' did not launch the tuned kernel "
                  f"{choice.variant} for {name} {op} N={n}: launches {counts}")
            best_yard = min(yard, key=yard.get)
            if yard[best_yard] < timings[label]:
                log(f"[autotune] finding: for {name} {op} N={n} the yardstick "
                    f"{best_yard} ({yard[best_yard] * 1e3:.4f} ms) beats the "
                    f"fastest kernel {label} ({timings[label] * 1e3:.4f} ms)")
            winners[(name, op, n)] = label
        del arrays, b, x
        torch.cuda.empty_cache()
    autotune.set_autotuner(None)
    return winners


# ------------------------------------------- block-sparse attention (B5)
ATTN_ARCH = "smat-attn-1.3b"
# one layer's attention call: batch 1 x 16 heads over 8,192 tokens (the
# training and prefill length: below 4,096 tokens banded(4096) is plain
# causal) and over 32,768 (the JAX package's prefill_32k cell)
ATTN_G, ATTN_SEQ = 16, 8192
ATTN_LONG = 32768     # configs.base.SHAPES["prefill_32k"].seq_len
ATTN_DECODE = 16                       # decode steps after the prefill
ATTN_TRAIN_STEPS = 3
ATTN_PLAIN_CHUNK = 4    # instances a plain B5 call holds at 32768 tokens


def _attn_case(mask, L, block, d, dv, G, cap, seed):
    """Operands of one B5 call: q, k, v drawn from a numpy seed, the mask's
    cached device tensors; returns (mask tensors, args, keywords)."""
    from repro_torch.models import attention as A
    mt = A.mask_tensors(mask, L, block, DEVICE)
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal((G, L, n)).astype(
        np.float32)).to(DEVICE) for n in (d, d, dv))
    kw = dict(n_block_rows=mt.meta.n_block_rows,
              n_block_cols=mt.meta.n_block_cols, block=tuple(block),
              scale=d ** -0.5, cap=cap)
    return mt, (q, k, v, mt.emask, mt.arrays.sddmm_flat_idx,
                mt.arrays.flat_col), kw


def _b5(args, kw):
    from repro_torch.kernels import bcsr_attn
    return bcsr_attn.bcsr_attn_fused(*args, **kw)


def _b5_plain(args, kw):
    from repro_torch.kernels import ref
    return ref.bcsr_attn_fused_ref(*args, **kw)


def _rel(got, want):
    """max|got - want| / max|want|."""
    return (got - want).abs().max().item() / max(
        want.abs().max().item(), 1e-30)


def _composed(args, kw, mask, backend):
    """The composed path on the card's kernels (SDDMM -> block_softmax ->
    SpMM, the B5 backward's route) on B5's operands."""
    from repro_torch.models import attention as A
    spec = A.AttnSparsitySpec(mask=mask, block=kw["block"], backend=backend)
    return A._composed_heads(*args[:3], spec, kw["scale"], kw["cap"])


def attn_parity_phase():
    """B5 against its plain version, f32: max|diff| <= 1e-4 x max|plain|
    (FMA order and expf differ), and two calls bit-equal; at small odd
    shapes (blocks 16-128, d 32-256, L 61 and 1000, cap on and off, the
    three mask kinds, an empty block-row) and at one layer's full width
    (G = 16, d = 128, banded(4096) in 128x128 blocks, L = 8192 and 32768,
    the two lengths the prefill path gives B5).  Also B5 against the
    composed path on its kernels (B2 -> block_softmax -> B1, and B4 -> B3):
    ROADMAP C carve-out 2, 1e-5 x max|composed| (its softmax sums block by
    block, B5 row by row).  Returns (max abs err against plain, worst
    fused-vs-composed relative difference, the mask's build seconds at
    each full-width length)."""
    from repro_torch.models import attention as A
    masks = {"banded": A.banded(100), "local_global": A.local_global(64, 20),
             "blockwise_causal": A.blockwise_causal()}
    cases = [(m, L, blk, d, cap)
             for blk, d in (((16, 16), 32), ((32, 32), 64), ((64, 64), 128),
                            ((128, 128), 256))
             for L in (61, 1000) for m in masks for cap in (None, 30.0)]
    worst, worst_c, max_abs = 0.0, 0.0, 0.0
    for i, (m, L, blk, d, cap) in enumerate(cases):
        _, args, kw = _attn_case(masks[m], L, blk, d, d, 3, cap, seed=i)
        got, again = _b5(args, kw), _b5(args, kw)
        want = _b5_plain(args, kw)
        comp = _composed(args, kw, masks[m], "nnz_stream")
        torch.cuda.synchronize()
        rel, rel_c = _rel(got, want), _rel(got, comp)
        worst, worst_c = max(worst, rel), max(worst_c, rel_c)
        max_abs = max(max_abs, (got - want).abs().max().item())
        check(rel <= 1e-4 and torch.equal(got, again),
              f"B5 vs plain {m} L={L} block={blk} d={d} cap={cap}: "
              f"rel {rel:.3g}, bit-stable {torch.equal(got, again)}")
        check(rel_c <= 1e-5, f"B5 vs composed {m} L={L} block={blk} d={d} "
              f"cap={cap}: rel {rel_c:.3g}")
    log(f"[attn-parity] {len(cases)} small cases: B5 vs plain worst "
        f"{worst:.3g} x max|plain| (tolerance 1e-4), bit-stable; vs composed "
        f"(B2 -> block_softmax -> B1) worst {worst_c:.3g} (tolerance 1e-5)")

    # a block-row whose schedule holds only sentinel slots: zero context
    h = 16
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2 * h, 32)).astype(
        np.float32)).to(DEVICE) for _ in range(3))
    emask = torch.ones((1, h, h), device=DEVICE)
    idx = torch.tensor([0, 1], dtype=torch.int32, device=DEVICE)
    col = torch.zeros(2, dtype=torch.int32, device=DEVICE)
    kw = dict(n_block_rows=2, n_block_cols=2, block=(h, h), scale=0.5)
    out = _b5((q, k, v, emask, idx, col), kw)
    p = torch.softmax((q[0, :h] @ k[0, :h].T) * 0.5, dim=-1)
    torch.cuda.synchronize()
    ok = bool((out[0, h:] == 0).all()) and torch.allclose(
        out[0, :h], p @ v[0, :h], rtol=1e-4, atol=1e-4)
    log(f"[attn-parity] empty block-row: zero context, the other row equals "
        f"softmax(q k^T / 2) v: {'ok' if ok else 'FAIL'}")
    check(ok, "B5 with an empty block-row")

    # full width: one layer of smat-attn-1.3b at both prefill lengths (the
    # mask's first use at each length builds its host BCSR and device
    # tensors: timed, then cached)
    mask = A.banded(4096)
    mask_s = {}
    for L in (ATTN_SEQ, ATTN_LONG):
        t0 = time.perf_counter()
        A.mask_tensors(mask, L, (128, 128), DEVICE)
        mask_s[L] = time.perf_counter() - t0
        mt, args, kw = _attn_case(mask, L, (128, 128), 128, 128, ATTN_G,
                                  None, seed=99)
        got, again = _b5(args, kw), _b5(args, kw)
        # the plain version gathers K, V and the scores for every (instance,
        # block-row, slot): about 0.7 GB an instance at 8192 tokens, 2.8 GB
        # at 32768, so at 32768 it runs ATTN_PLAIN_CHUNK instances at a time
        step = ATTN_G if L == ATTN_SEQ else ATTN_PLAIN_CHUNK
        want = torch.cat([_b5_plain(tuple(t[g:g + step] for t in args[:3])
                                    + args[3:], kw)
                          for g in range(0, ATTN_G, step)])
        torch.cuda.synchronize()
        rel = _rel(got, want)
        max_abs = max(max_abs, (got - want).abs().max().item())
        del want
        comp = {be: _composed(args, kw, mask, be)
                for be in ("nnz_stream", "row_loop")}
        rel_c = {be: _rel(got, c) for be, c in comp.items()}
        worst_c = max(worst_c, *rel_c.values())
        log(f"[attn-parity] full width G={ATTN_G} L={L} d=128 banded(4096) "
            f"128x128 (nnzb {mt.meta.nnzb}, max_bpr {mt.meta.max_bpr}; mask "
            f"built in {mask_s[L]:.3f}s): B5 vs plain ({step} instances a "
            f"call) {rel:.3g} x max|plain|, bit-stable "
            f"{torch.equal(got, again)}; vs composed {rel_c} (B2/B1, B4/B3)")
        check(rel <= 1e-4 and torch.equal(got, again),
              f"B5 disagrees with its plain version at full width L={L}")
        check(max(rel_c.values()) <= 1e-5,
              f"B5 vs composed at full width L={L}: {rel_c}")
        del got, again, comp, args
        torch.cuda.empty_cache()
    return max_abs, worst_c, mask_s


def attn_bound(meta, G, L, d, dv):
    """(bound_ms, bound_by) of one B5 call: q, k, v, the element mask and
    the schedule read once, out written once (f32); the useful work is
    Q K^T and P V once per stored block per instance, 2 operations per
    multiply-add, over the f32 FMA peak."""
    h, w = meta.block
    nbytes = (4 * G * L * (2 * d + 2 * dv) + 4 * meta.nnzb * h * w
              + 8 * meta.n_block_rows * meta.max_bpr)
    flops = G * meta.nnzb * 2 * h * w * (d + dv)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[torch.float32]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def attn_timing_phase(smi, mask_s):
    """B5's ms per launch at one layer's shapes (G = 16, d = 128,
    banded(4096), L = 8192 and 32768), each beside its bound, its plain
    version (at 8192 only: at 32768 it runs in chunks of instances, held
    in ``[attn-parity]``), the composed path on the kernels the tuner
    resolves (launches per call counted; its output held against B5's
    within carve-out 2, 1e-5), the library call
    ``scaled_dot_product_attention`` in f32 with the boolean band mask
    (the one PyTorch call that computes the same function) and, for
    context only, dense causal SDPA in bf16 (a different function).  The
    plain version at 32768 is timed nowhere.  Eager launches timed with CUDA events: a B5
    call takes tens of ms, so the host's share is small."""
    from torch.nn import functional as F

    from repro_torch.models import attention as A
    mask = A.banded(4096)
    rows = {}
    for L in (ATTN_SEQ, ATTN_LONG):
        mt, args, kw = _attn_case(mask, L, (128, 128), 128, 128, ATTN_G,
                                  None, seed=7)
        row = {"case": f"{B5} G={ATTN_G} L={L} d=dv=128 banded(4096) "
                       f"128x128", "nnzb": mt.meta.nnzb,
               "max_bpr": mt.meta.max_bpr, "mask_build_s": mask_s[L],
               "card": smi}
        row["ms"] = time_ms_eager([lambda: _b5(args, kw)], reps=5)
        row["bound_ms"], row["bound_by"] = attn_bound(mt.meta, ATTN_G, L,
                                                      128, 128)
        row["plain_ms"] = time_ms_eager(
            [lambda: _b5_plain(args, kw)], reps=2) if L == ATTN_SEQ else None
        _reset_counts()
        comp = _composed(args, kw, mask, "auto")
        torch.cuda.synchronize()
        row["composed_launches"] = {n: c for n, c in _read_counts().items()
                                    if c}
        row["fused_vs_composed_rel"] = _rel(_b5(args, kw), comp)
        check(row["fused_vs_composed_rel"] <= 1e-5,
              f"B5 vs the composed path on auto at L={L}: "
              f"{row['fused_vs_composed_rel']:.3g}")
        del comp
        row["composed_ms"] = time_ms_eager(
            [lambda: _composed(args, kw, mask, "auto")], reps=2)
        q, k, v = (t[None] for t in args[:3])       # [1, G, L, d]
        pos = torch.arange(L, device=DEVICE)
        allowed = A.mask_allowed(mask, pos, pos)    # [L, L] bool

        def sdpa():
            return F.scaled_dot_product_attention(q, k, v, attn_mask=allowed)

        def check_sdpa():
            ref_out = _b5(args, kw)
            err = _rel(sdpa()[0], ref_out)
            if err > 1e-4:
                raise ValueError(f"SDPA differs from B5 by {err:.3g}")
        row["library_ms"], lib_err = _library([sdpa], check_sdpa,
                                              timer=time_ms_eager)
        if lib_err:
            row["library_error"] = lib_err
        del allowed
        qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
        row["dense_causal_sdpa_bf16_ms"] = time_ms_eager(
            [lambda: F.scaled_dot_product_attention(qb, kb, vb,
                                                    is_causal=True)], reps=5)
        log("[attn-timing] " + json.dumps(row))
        rows[L] = row
        del args, q, k, v, qb, kb, vb
        torch.cuda.empty_cache()
    return rows


def _attn_cfg(**attn_kw):
    """smat-attn-1.3b with the attention spec's fields replaced; decode
    takes the dense-bias path (``paged_decode="off"``: paged KV is ROADMAP
    A6)."""
    from repro_torch.configs import get_config
    cfg = get_config(ATTN_ARCH)
    return dataclasses.replace(cfg, attn_sparsity=dataclasses.replace(
        cfg.attn_sparsity, paged_decode="off", **attn_kw))


def prefill_attn_phase(smi):
    """smat-attn-1.3b at full width and depth (24 layers, random weights
    from seed 0): prefill one 8192-token prompt through
    ``launch/steps.make_prefill_step`` (exactly 24 B5 and 72 B1 launches);
    its last-position logits against the plain path (attention and FFN on
    ``xla``) within max(2e-2, 2 x the plain path's own noise: FFN ``dense``
    against ``xla``, as ``[model]``); then ATTN_DECODE decode steps from that
    cache (72 B1 and no B5 a call: decode applies the mask as a bias),
    each step's logits against the plain path decoding from a copy of the
    cache, by the same rule; the prefill again in float32, where
    the logits hold to the plain path's within 2e-2; then one timed
    32768-token prefill (the prefill_32k cell cut from global batch 32 to
    1 on one card): ms and peak memory."""
    from repro_torch.launch import steps as st
    from repro_torch.models import transformer as T
    cfg = _attn_cfg()
    t0 = time.perf_counter()
    model = T.init_params(cfg, seed=0, device=DEVICE)
    torch.cuda.synchronize()
    log(f"[prefill-attn] {cfg.name}: {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads} heads x {cfg.head_dim}, attention "
        f"{cfg.attn_sparsity.mask} in {cfg.attn_sparsity.block} blocks, "
        f"backend {cfg.attn_sparsity.backend}; FFN backend "
        f"{cfg.ffn_sparsity.backend}; built in {time.perf_counter() - t0:.1f}s")
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, size=(1, ATTN_SEQ))).to(DEVICE)
    cache_len = ATTN_SEQ + 128
    prefill = st.make_prefill_step(cfg, cache_len)
    prefill(model, {"tokens": tokens[:, :4096]})   # first-call set-up
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    logits, cache = prefill(model, {"tokens": tokens})
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = _read_counts()
    want = _counts(**{B5: cfg.n_layers, B1: 3 * cfg.n_layers})
    logits = logits.float()
    ref_logits = {}
    for ffn in ("dense", "xla"):        # the plain path: FFN on xla
        cfg_p = dataclasses.replace(
            _attn_cfg(backend="xla"), ffn_sparsity=dataclasses.replace(
                cfg.ffn_sparsity, backend=ffn))
        ref_logits[ffn] = st.make_prefill_step(cfg_p, cache_len)(
            model, {"tokens": tokens})[0].float()
    err = (logits - ref_logits["xla"]).abs().max().item()
    noise = (ref_logits["dense"] - ref_logits["xla"]).abs().max().item()
    tol = max(2e-2, 2 * noise)
    log(f"[prefill-attn] 1 x {ATTN_SEQ} tokens: {dt * 1e3:.3f} ms (host "
        f"clock, synchronised), {ATTN_SEQ / dt:.1f} tokens/s; launches "
        f"{counts}, expected {want}; last-position logits vs plain: "
        f"max|dlogit|={err:.4g}, plain's own noise {noise:.4g}, tolerance "
        f"{tol:.4g}, max|logit|={ref_logits['xla'].abs().max().item():.4g}, "
        f"same argmax {bool(logits.argmax() == ref_logits['xla'].argmax())}; "
        f"{smi}")
    check(counts == want, f"prefill launch counts {counts} != {want}")
    check(bool(torch.isfinite(logits).all()) and err <= tol,
          "prefill logits disagree with the plain path")
    del ref_logits

    decode = st.make_decode_step(cfg)
    cache0 = {n: t.clone() for n, t in cache.items()}
    tok = logits.argmax(-1)
    fed, step_logits_k = [tok], []
    _reset_counts()
    t0 = time.perf_counter()
    for s in range(ATTN_DECODE):
        step_logits, cache = decode(model, cache, tok, ATTN_SEQ + s)
        step_logits_k.append(step_logits.float())
        tok = step_logits.float().argmax(-1)
        fed.append(tok)
    torch.cuda.synchronize()
    dt_dec = time.perf_counter() - t0
    counts_dec = _read_counts()
    want_dec = _counts(**{B1: 3 * cfg.n_layers * ATTN_DECODE})
    out = [int(t[0]) for t in fed[1:]]
    # the plain path (FFN on xla) decodes from a copy of the same cache,
    # fed the kernel path's tokens: every step's logits within max(2e-2,
    # 2 x the plain path's own decode noise, FFN dense against xla), and
    # its greedy tokens compared
    plain_steps = {}
    for ffn in ("dense", "xla"):
        dec_p = st.make_decode_step(dataclasses.replace(
            cfg_p, ffn_sparsity=dataclasses.replace(cfg.ffn_sparsity,
                                                    backend=ffn)))
        c = {n: t.clone() for n, t in cache0.items()}
        plain_steps[ffn] = []
        for s in range(ATTN_DECODE):
            lp, c = dec_p(model, c, fed[s], ATTN_SEQ + s)
            plain_steps[ffn].append(lp.float())
        del c

    def worst(a, b):
        return max((x - y).abs().max().item() for x, y in zip(a, b))
    dec_err = worst(step_logits_k, plain_steps["xla"])
    dec_noise = worst(plain_steps["dense"], plain_steps["xla"])
    dec_tol = max(2e-2, 2 * dec_noise)
    same = sum(int(lp.argmax(-1)[0]) == t
               for lp, t in zip(plain_steps["xla"], out))
    log(f"[prefill-attn] {ATTN_DECODE} decode steps from the cache "
        f"(positions {ATTN_SEQ}..{ATTN_SEQ + ATTN_DECODE - 1}, cache "
        f"{cache_len}, mask bias): tokens {out}; {dt_dec * 1e3:.3f} ms; "
        f"launches {counts_dec}, expected {want_dec}; against the plain "
        f"path from a copy of the cache: max|dlogit| {dec_err:.4g}, plain's "
        f"own noise {dec_noise:.4g}, tolerance {dec_tol:.4g}; same greedy "
        f"token {same}/{ATTN_DECODE}")
    check(counts_dec == want_dec and all(0 <= t < cfg.vocab_size
                                         for t in out),
          f"decode after prefill: launches {counts_dec} or tokens {out}")
    check(dec_err <= dec_tol, "decode after prefill disagrees with the "
          "plain path")
    del cache, cache0, logits, step_logits_k, plain_steps

    # the same prefill in float32, full depth: kernels against the plain
    # path within 2e-2 (in bf16 the plain path's own noise is above it)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    model32 = T.init_params(cfg32, seed=0, device=DEVICE)
    lg32 = {}
    for name, c in (("kernels", cfg32), ("plain", dataclasses.replace(
            cfg_p, dtype="float32"))):
        lg32[name] = st.make_prefill_step(c, cache_len)(
            model32, {"tokens": tokens})[0].float()
    err32 = (lg32["kernels"] - lg32["plain"]).abs().max().item()
    log(f"[prefill-attn] float32, {cfg.n_layers} layers, 1 x {ATTN_SEQ} "
        f"tokens: last-position logits kernels vs plain max|dlogit| "
        f"{err32:.4g} (tolerance 2e-2), max|logit| "
        f"{lg32['plain'].abs().max().item():.4g}")
    check(bool(torch.isfinite(lg32["kernels"]).all()) and err32 <= 2e-2,
          "float32 prefill logits disagree with the plain path")
    del model32, lg32
    torch.cuda.empty_cache()

    # where a prefill's time goes: torch.profiler over one 8192-token call
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        prefill(model, {"tokens": tokens})
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    log("[prefill-attn-profile] " + json.dumps(
        {"tokens": ATTN_SEQ, "card": smi,
         **_profile_summary(prof, wall_ms, 1, "call")}))
    del prof

    # the prefill_32k cell, one sequence (its mask tensors were built and
    # cached by [attn-timing], so the timed call is the prefill alone)
    from repro_torch.configs.base import SHAPES, cell_applicable
    cell = SHAPES["prefill_32k"]
    check(cell.seq_len == ATTN_LONG and cell_applicable(cfg, cell)[0],
          f"{cell} does not apply to {cfg.name}")
    long_tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, size=(1, ATTN_LONG))).to(DEVICE)
    prefill_long = st.make_prefill_step(cfg, ATTN_LONG)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    long_logits, _ = prefill_long(model, {"tokens": long_tokens})
    torch.cuda.synchronize()
    dt_long = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    counts_long = _read_counts()
    log(f"[prefill-attn] {cell.name} cell (global batch "
        f"{cell.global_batch} cut to 1 on one card), 1 x {ATTN_LONG} tokens: "
        f"{dt_long * 1e3:.3f} ms ({ATTN_LONG / dt_long:.1f} tokens/s), peak "
        f"memory {peak:.2f} GB; launches {counts_long}; {smi}")
    check(bool(torch.isfinite(long_logits).all()) and counts_long == want,
          f"32k prefill: launches {counts_long} or logits not finite")
    del model, long_logits
    torch.cuda.empty_cache()
    return counts, {"prefill_ms": dt * 1e3, "prefill_32k_ms": dt_long * 1e3,
                    "prefill_32k_peak_gb": peak}


def serve_attn_phase():
    """ServeEngine with smat-attn-1.3b at full width (4 slots, cache 256, 8
    requests): prompts go token by token through decode calls, which apply
    the mask as a bias, so each call launches 72 B1 and no B5; the engine's
    stream equals a direct ``decode_step`` loop."""
    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import ServeEngine
    cfg = _attn_cfg()
    model = T.init_params(cfg, seed=0, device=DEVICE)
    warm = ServeEngine(cfg, model, n_slots=N_SLOTS, cache_len=CACHE_LEN,
                       device=DEVICE)
    list(warm.generate(_requests(cfg)[:1]))
    engine = ServeEngine(cfg, model, n_slots=N_SLOTS, cache_len=CACHE_LEN,
                         device=DEVICE)
    requests = _requests(cfg)
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    streams = {}
    for rid, tok in engine.generate(requests):
        streams.setdefault(rid, []).append(tok)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = _read_counts()
    n_tok = sum(len(v) for v in streams.values())
    want = _counts(**{B1: 3 * cfg.n_layers * engine.decode_calls})
    log(f"[serve-attn] {len(streams)} requests, {n_tok} new tokens, "
        f"{engine.decode_calls} decode calls in {dt:.3f}s: {n_tok / dt:.1f} "
        f"tok/s; paged_kv {engine.paged_kv}; launches {launches}, expected "
        f"{want}")
    check(sorted(streams) == list(range(N_REQUESTS)) and all(
        len(v) == NEW_TOKENS for v in streams.values()),
        "attention serving: requests missing or short")
    check(launches == want and engine.decode_calls > 0,
          f"attention serving launch counts {launches} != {want}")
    with torch.inference_mode():
        oracle = _greedy_oracle(cfg, model, requests[0].prompt, NEW_TOKENS)
    log(f"[serve-attn] request 0: engine {streams[0]}; decode_step loop "
        f"{oracle}")
    check(streams[0] == oracle, "attention engine stream != decode_step loop")
    del model, engine, warm
    torch.cuda.empty_cache()
    return launches, n_tok / dt


def _attn_train_counts(cfg, per_step_b5):
    """Launches per training step of smat-attn-1.3b, derived from the code:
    the FFN as in ``[train]`` (B1 forward and dB, B2 dvals), B5 forward,
    and the B5 backward's composed path per head and layer: two SDDMMs
    (scores recomputed, d(probs)) and two SpMMs (context recomputed, dQ)
    on the kernels ``backend="auto"`` resolves for the mask, and two B1
    launches over the transpose structure (dV, dK)."""
    from repro_torch.kernels import ops
    from repro_torch.models import attention as A
    sp = cfg.attn_sparsity
    meta = A.attention_mask_meta(sp.mask, ATTN_SEQ, tuple(sp.block))
    sddmm = {"nnz_stream": B2, "row_loop": B4}[ops.resolve_backend(
        "auto", None, meta, cfg.head_dim, op="sddmm", device=DEVICE)[0]]
    spmm = {"nnz_stream": B1, "row_loop": B3}[ops.resolve_backend(
        "auto", None, meta, cfg.head_dim, op="spmm", device=DEVICE)[0]]
    per_head = {sddmm: 2, spmm: 2}
    per_head[B1] = per_head.get(B1, 0) + 2
    counts = {B5: per_step_b5, B1: 6 * cfg.n_layers, B2: 3 * cfg.n_layers}
    for name, n in per_head.items():
        counts[name] = counts.get(name, 0) + n * cfg.n_heads * cfg.n_layers
    return _counts(**counts), (sddmm, spmm)


def train_attn_phase(smi):
    """ATTN_TRAIN_STEPS AdamW steps of 1 x 8192 tokens of smat-attn-1.3b at
    full width, bf16, no remat, through ``train.loop.train``: finite losses,
    exact launch counts per step (``_attn_train_counts``), step ms,
    tokens/s and peak memory."""
    from repro_torch.configs.base import ShapeCell
    from repro_torch.optim import adamw
    from repro_torch.train import loop
    cfg = _attn_cfg()
    shape = ShapeCell("chip", "train", ATTN_SEQ, 1)
    per_step, (sddmm, spmm) = _attn_train_counts(cfg, cfg.n_layers)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    res = loop.train(cfg, shape, device=DEVICE,
                     total_steps=ATTN_TRAIN_STEPS,
                     opt_cfg=adamw.AdamWConfig(total_steps=ATTN_TRAIN_STEPS),
                     remat="none")
    torch.cuda.synchronize()
    launches = _read_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    steady = res.step_times[1:]
    step_ms = 1e3 * sum(steady) / len(steady)
    want = {n: c * ATTN_TRAIN_STEPS for n, c in per_step.items()}
    log(f"[train-attn] {cfg.name} full width, 1 x {ATTN_SEQ} tokens, bf16, "
        f"remat none, AdamW: losses {res.losses}; step ms "
        f"{[round(1e3 * t, 3) for t in res.step_times]}; steady "
        f"{step_ms:.3f} ms = {ATTN_SEQ / step_ms * 1e3:.1f} tokens/s; peak "
        f"memory {peak:.2f} GB; {smi}")
    log(f"[train-attn] kernel launches {launches}; expected {want} (per "
        f"step {per_step}: the backward's composed path resolves its SDDMM "
        f"to {sddmm} and its SpMM to {spmm})")
    check(res.final_step == ATTN_TRAIN_STEPS and
          len(res.losses) == ATTN_TRAIN_STEPS,
          "attention training did not reach its end")
    check(all(np.isfinite(res.losses)), "an attention training loss is not "
          "finite")
    check(launches == want, f"attention training launch counts {launches} "
          f"!= {want}")

    # where a step's time goes: torch.profiler over one step after a
    # warm-up step, as [train-profile]
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.data.pipeline import make_batch
    from repro_torch.launch import steps as st
    from repro_torch.models import transformer as T
    opt_cfg = adamw.AdamWConfig(total_steps=ATTN_TRAIN_STEPS)
    model = T.init_params(cfg, seed=0, device=DEVICE)
    opt_state = adamw.init(dict(model.named_parameters()))
    batch = loop.batch_to_device(make_batch(cfg, shape, 0), DEVICE)
    step = st.make_train_step(cfg, opt_cfg, remat="none")
    model, opt_state, _ = step(model, opt_state, batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model, opt_state, metrics = step(model, opt_state, batch)
        float(metrics["loss"])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    log("[train-attn-profile] " + json.dumps(
        {"train_steps": 1, "card": smi,
         **_profile_summary(prof, wall_ms, 1, "step")}))
    del model, opt_state, batch, prof
    torch.cuda.empty_cache()
    return launches, {"step_ms": step_ms,
                      "tokens_per_s": ATTN_SEQ / step_ms * 1e3,
                      "peak_gb": peak, "losses": res.losses}


def train_attn_vs_plain_phase():
    """One training step of a 2-layer float32 smat-attn-1.3b at full width
    (1 x 8192 tokens) through B5 and the kernels, and through the plain
    path (attention and FFN on ``xla``), same weights and batch: loss rtol
    1e-5, every gradient max|diff| <= 1e-4 x its max|grad|."""
    from repro_torch.configs.base import ShapeCell
    from repro_torch.data.pipeline import make_batch
    from repro_torch.models import transformer as T
    from repro_torch.train import loop
    cfg32 = dataclasses.replace(_attn_cfg(), n_layers=2, dtype="float32")
    model = T.init_params(cfg32, seed=0, device=DEVICE)
    batch = loop.batch_to_device(make_batch(
        cfg32, ShapeCell("chip", "train", ATTN_SEQ, 1), 0), DEVICE)
    plain = dataclasses.replace(
        _attn_cfg(backend="xla"), n_layers=2, dtype="float32",
        ffn_sparsity=dataclasses.replace(cfg32.ffn_sparsity, backend="xla"))
    out = {}
    for name, cfg_b in (("kernels", cfg32), ("plain", plain)):
        for p in model.parameters():
            p.grad = None
        _reset_counts()
        loss, _ = T.train_loss(cfg_b, model, batch, remat="none")
        loss.backward()
        out[name] = (float(loss.detach()), _read_counts(),
                     {n: p.grad.clone() for n, p in model.named_parameters()})
    (loss_k, counts_k, g_k), (loss_p, counts_p, g_p) = (out["kernels"],
                                                        out["plain"])
    want_k, _ = _attn_train_counts(cfg32, cfg32.n_layers)
    worst = max(((g_k[n] - g).abs().max().item() /
                 max(g.abs().max().item(), 1e-30), n) for n, g in g_p.items())
    ok = (abs(loss_k - loss_p) <= 1e-5 * abs(loss_p) and worst[0] <= 1e-4
          and counts_k == want_k and counts_p == _counts())
    log(f"[train-attn-vs-plain] f32 2-layer full width, 1 x {ATTN_SEQ} "
        f"tokens, kernels vs plain: loss {loss_k:.7f} vs {loss_p:.7f} (rtol "
        f"1e-5); worst gradient max|diff|/max|grad| = {worst[0]:.3g} at "
        f"{worst[1]} (tolerance 1e-4); launches {counts_k} (expected "
        f"{want_k}) vs {counts_p} {'ok' if ok else 'FAIL'}")
    check(ok, "f32 attention training step disagrees with its plain path")
    del model, out
    torch.cuda.empty_cache()


def main():
    t_start = time.perf_counter()

    def phase(fn, *args):
        """Run one phase and log its wall time (the script's whole run must
        stay inside its time limit)."""
        t0 = time.perf_counter()
        out = fn(*args)
        log(f"[time] {fn.__name__}: {time.perf_counter() - t0:.1f}s "
            f"(total {time.perf_counter() - t_start:.1f}s)")
        return out

    smi = device_phase()
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    phase(build_phase)
    max_err = phase(parity_phase)
    err_b2, err_dx = phase(sddmm_parity_phase)
    err_b3, err_b4 = phase(row_loop_parity_phase)
    err_b5, carve_out_2, mask_s = phase(attn_parity_phase)
    timed = phase(timing_phase, smi)
    timed_train = phase(train_timing_phase, smi)
    timed_rl = phase(row_loop_timing_phase, smi)
    timed_attn = phase(attn_timing_phase, smi, mask_s)
    cfg, model, launches, tok_s, stream0 = phase(main_path_phase)
    phase(model_vs_plain_phase, cfg, model)
    phase(profile_phase, cfg, model)
    serve_rl_launches, tok_s_rl = phase(serve_row_loop_phase, cfg, model,
                                        stream0)
    del model
    torch.cuda.empty_cache()
    train_launches, trained = phase(train_phase, cfg, smi)
    train_rl_launches, trained_rl = phase(train_row_loop_phase, cfg, smi,
                                          trained["losses"])
    phase(train_vs_plain_phase, cfg)
    phase(train_row_loop_vs_plain_phase, cfg)
    phase(restart_phase)
    mip1_perm, err_lib, _ = phase(library_phase, smi)
    winners = phase(autotune_phase, mip1_perm, smi)
    prefill_attn_launches, prefilled = phase(prefill_attn_phase, smi)
    serve_attn_launches, tok_s_attn = phase(serve_attn_phase)
    train_attn_launches, trained_attn = phase(train_attn_phase, smi)
    phase(train_attn_vs_plain_phase)

    # a layer runs each kernel twice on the gate/up shape for every once on
    # the down shape: the line's times are that mix, per launch
    def mix(rows, key):
        vals = [rows[s].get(key) for s in ("gate_up", "gate_up", "down")]
        return None if None in vals else sum(vals) / 3
    decode = {s: timed[(s, N_SLOTS)] for s in FULL_WIDTH}
    fwd = {s: timed_train[("fwd", s)] for s in FULL_WIDTH}
    dx = {s: timed_train[("dx", s)] for s in FULL_WIDTH}
    sd = {s: timed_train[("sddmm", s)] for s in FULL_WIDTH}
    rl = {(k, n): {s: timed_rl[(k, s, n)] for s in FULL_WIDTH}
          for k in (B3, B4) for n in (N_SLOTS, TRAIN_N)}
    keys = ("ms", "plain_ms", "bound_ms", "library_ms")
    paths = {"serve": launches, "train": train_launches,
             "serve_row_loop": serve_rl_launches,
             "train_row_loop": train_rl_launches,
             "prefill_attn": prefill_attn_launches,
             "serve_attn": serve_attn_launches,
             "train_attn": train_attn_launches}

    def entry(k, err, rows, **extra):
        by_path = {path: counts[k["name"]] for path, counts in paths.items()}
        return {"name": k["name"], "route": k["route"],
                "source": k["source"], "replaces": k["replaces"],
                "launches": sum(by_path.values()), "max_abs_err": err,
                **{key: mix(rows, key) for key in keys},
                "bound_by": rows["down"]["bound_by"],
                "launches_by_path": by_path, **extra}
    b1, b2, b3, b4, b5 = KERNELS
    attn_keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                 "composed_ms", "composed_launches",
                 "dense_causal_sdpa_bf16_ms")
    line = {"kernels": [
        entry(b1, max(max_err, err_dx), decode,
              train_forward={key: mix(fwd, key) for key in keys},
              train_dB={key: mix(dx, key) for key in keys}),
        entry(b2, err_b2, sd, dense_ms=mix(sd, "dense_ms")),
        entry(b3, max(err_b3, err_lib), rl[(B3, N_SLOTS)],
              train_forward={key: mix(rl[(B3, TRAIN_N)], key)
                             for key in keys}),
        entry(b4, err_b4, rl[(B4, TRAIN_N)],
              dense_ms=mix(rl[(B4, TRAIN_N)], "dense_ms"),
              decode={key: mix(rl[(B4, N_SLOTS)], key) for key in keys}),
        {"name": b5["name"], "route": b5["route"], "source": b5["source"],
         "replaces": b5["replaces"],
         "launches": sum(c[B5] for c in paths.values()),
         "max_abs_err": err_b5,
         **{key: timed_attn[ATTN_SEQ][key] for key in attn_keys},
         "launches_by_path": {p: c[B5] for p, c in paths.items()},
         "fused_vs_composed_rel": max(
             carve_out_2, *(r["fused_vs_composed_rel"]
                            for r in timed_attn.values())),
         "at_32768": {key: timed_attn[ATTN_LONG][key] for key in attn_keys}},
    ]}
    log(f"[main] serving: {tok_s:.1f} tok/s (nnz_stream), {tok_s_rl:.1f} "
        f"tok/s (row_loop); training: {trained['step_ms']:.3f} ms per step, "
        f"{trained['tokens_per_s']:.1f} tokens/s (nnz_stream), "
        f"{trained_rl['step_ms']:.3f} ms, {trained_rl['tokens_per_s']:.1f} "
        f"tokens/s (row_loop).  Autotune winners: "
        f"{ {f'{k[0]} {k[1]} N={k[2]}': v for k, v in winners.items()} }.  "
        f"Kernel times per launch: {B1} and {B3} at the decode shape "
        f"(N={N_SLOTS}; train_forward and train_dB at N={TRAIN_N}), {B2} and "
        f"{B4} at N={TRAIN_N}; each averaged 2:1 over the gate/up and down "
        f"shapes.  {ATTN_ARCH}: prefill {prefilled['prefill_ms']:.3f} ms "
        f"(1 x {ATTN_SEQ}), {prefilled['prefill_32k_ms']:.3f} ms (1 x "
        f"{ATTN_LONG}, peak {prefilled['prefill_32k_peak_gb']:.2f} GB); "
        f"serving {tok_s_attn:.1f} tok/s; training "
        f"{trained_attn['step_ms']:.3f} ms per step, "
        f"{trained_attn['tokens_per_s']:.1f} tokens/s, peak "
        f"{trained_attn['peak_gb']:.2f} GB; {B5} per launch at G={ATTN_G}, "
        f"L={ATTN_SEQ} (at_32768: L={ATTN_LONG}); whole run "
        f"{time.perf_counter() - t_start:.1f}s")
    print(json.dumps(line))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()

"""Card gate of the PyTorch/CUDA port: run on one NVIDIA H100 as

    python3 chip_smoke.py

It builds every CUDA kernel of the port from ``src/repro_torch/kernels/csrc``
(one ``nvcc`` per source, all at once), holds each against its plain
PyTorch version at small odd shapes and at the main paths' shapes, and
times it.  Then it drives both main paths of ``smat-ffn-1.3b`` at full width
(24 layers, d_model 2048, d_ff 8192, vocab 32000, bf16, FFN 90%
block-sparse in 128x128 blocks): it serves requests through ``ServeEngine``
and trains a few steps through ``train.loop.train``, checks that every
sparse FFN product (forward, dB and dvals) went through the kernels, and
that the outputs agree with the plain path.  Every phase checks its
results; any failure exits non-zero before the last line.

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
}]

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
        # the yardstick: PyTorch's sampled product on the same operands,
        # with the stored blocks as a BSR mask, else the same mask in CSR
        bsr_masks = [torch.sparse_bsr_tensor(a.rowptr, a.col_ids,
                                             torch.ones_like(a.vals),
                                             size=shape) for a, _ in ops_]
        want0 = ops.materialize_dense(arrays0._replace(
            vals=ref.bcsr_sddmm_ref(dcs[0], xs[0], arrays0.row_ids,
                                    arrays0.col_ids, 128, 128)), meta)
        lib, errors = None, []
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
                lib_note = {"library_mask": layout, "library_timing": "eager"}
                break
            errors.append(f"{layout}: {err}")
        else:
            lib_note = {"library_error": "; ".join(errors)}
        del bsr_masks, masks
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
        bsr = [torch.sparse_bsr_tensor(a.rowptr, a.col_ids, a.vals,
                                       size=shape) for a, _ in ops_]
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
    from repro_torch.kernels import bcsr_spmm
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
    for k in KERNELS:
        bcsr_spmm.LAUNCHES[k["counter"]] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    streams = {}
    for rid, tok in engine.generate(requests):
        streams.setdefault(rid, []).append(tok)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {k["name"]: bcsr_spmm.LAUNCHES[k["counter"]] for k in KERNELS}

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
    check(launches["bcsr_sddmm"] == 0, "serving launched the SDDMM kernel")

    with torch.inference_mode():
        oracle = _greedy_oracle(cfg, model, requests[0].prompt, NEW_TOKENS)
    log(f"[main] request 0: engine {streams[0]}")
    log(f"[main] request 0: decode_step loop {oracle}")
    check(streams[0] == oracle, "engine stream != direct decode_step loop")
    return cfg, model, launches, n_tok / dt


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
def _reset_counts():
    from repro_torch.kernels import bcsr_spmm
    for k in KERNELS:
        bcsr_spmm.LAUNCHES[k["counter"]] = 0


def _read_counts():
    from repro_torch.kernels import bcsr_spmm
    return {k["name"]: bcsr_spmm.LAUNCHES[k["counter"]] for k in KERNELS}


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
    per_layer = {"bcsr_spmm_nnz_stream": 6, "bcsr_sddmm": 3}
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
    want_full = {"bcsr_spmm_nnz_stream": 9 * cfg.n_layers,
                 "bcsr_sddmm": 3 * cfg.n_layers}
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
          and counts_k == {"bcsr_spmm_nnz_stream": 12, "bcsr_sddmm": 6}
          and counts_p == {"bcsr_spmm_nnz_stream": 0, "bcsr_sddmm": 0})
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


def main():
    smi = device_phase()
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    build_phase()
    max_err = parity_phase()
    err_b2, err_dx = sddmm_parity_phase()
    timed = timing_phase(smi)
    timed_train = train_timing_phase(smi)
    cfg, model, launches, tok_s = main_path_phase()
    model_vs_plain_phase(cfg, model)
    profile_phase(cfg, model)
    del model
    torch.cuda.empty_cache()
    train_launches, trained = train_phase(cfg, smi)
    train_vs_plain_phase(cfg)
    restart_phase()

    # a layer runs each kernel twice on the gate/up shape for every once on
    # the down shape: the line's times are that mix, per launch
    def mix(rows, key):
        vals = [rows[s].get(key) for s in ("gate_up", "gate_up", "down")]
        return None if None in vals else sum(vals) / 3
    decode = {s: timed[(s, N_SLOTS)] for s in FULL_WIDTH}
    fwd = {s: timed_train[("fwd", s)] for s in FULL_WIDTH}
    dx = {s: timed_train[("dx", s)] for s in FULL_WIDTH}
    sd = {s: timed_train[("sddmm", s)] for s in FULL_WIDTH}
    keys = ("ms", "plain_ms", "bound_ms", "library_ms")
    b1, b2 = KERNELS
    line = {"kernels": [{
        "name": b1["name"], "route": b1["route"], "source": b1["source"],
        "replaces": b1["replaces"],
        "launches": launches[b1["name"]] + train_launches[b1["name"]],
        "max_abs_err": max(max_err, err_dx),
        **{key: mix(decode, key) for key in keys},
        "bound_by": decode["down"]["bound_by"],
        "launches_by_path": {"serve": launches[b1["name"]],
                             "train": train_launches[b1["name"]]},
        "train_forward": {key: mix(fwd, key) for key in keys},
        "train_dB": {key: mix(dx, key) for key in keys},
    }, {
        "name": b2["name"], "route": b2["route"], "source": b2["source"],
        "replaces": b2["replaces"],
        "launches": launches[b2["name"]] + train_launches[b2["name"]],
        "max_abs_err": err_b2,
        **{key: mix(sd, key) for key in keys},
        "bound_by": sd["down"]["bound_by"],
        "dense_ms": mix(sd, "dense_ms"),
        "launches_by_path": {"serve": launches[b2["name"]],
                             "train": train_launches[b2["name"]]},
    }]}
    log(f"[main] serving: {tok_s:.1f} tok/s; training: "
        f"{trained['step_ms']:.3f} ms per step, "
        f"{trained['tokens_per_s']:.1f} tokens/s.  Kernel times per launch: "
        f"{b1['name']} at the decode shape (N={N_SLOTS}; train_forward and "
        f"train_dB at N={TRAIN_N}), {b2['name']} at N={TRAIN_N}; each "
        f"averaged 2:1 over the gate/up and down shapes")
    print(json.dumps(line))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()

"""Card gate of the PyTorch/CUDA port: run on one NVIDIA H100 as

    python3 chip_smoke.py

It builds every CUDA kernel of the port from ``src/repro_torch/kernels/csrc``
(one ``nvcc`` per source, all at once), checks with ``cuobjdump -sass`` that
all five run on the tensor cores and with ``ptxas`` that they do not spill
(bf16 instances; every instance of the f32 B5), holds each kernel
against its plain PyTorch
version at small odd shapes and at the main paths' shapes, and times it
(decode, training and prefill widths, and the attention backward's f32
products).  Then it drives the main paths of ``smat-ffn-1.3b`` at full width
(24 layers, d_model 2048, d_ff 8192, vocab 32000, bf16, FFN 90%
block-sparse in 128x128 blocks): it serves requests through ``ServeEngine``
and trains a few steps through ``train.loop.train``, each through the
streamed kernels (``nnz_stream``) and through the static-schedule ones
(``row_loop``), checks that every sparse FFN product (forward, dB and
dvals) went through the kernels, and that the outputs agree with the plain
path.  Then it drives the SMaT library path (CSR -> BCSR -> Jaccard
reorder -> spmm) on the paper's suite of matrices, ``mip1`` at its
published size, and the autotuner's measured sweep; last block-sparse
attention (``smat-attn-1.3b``: kernel B5 and the composed backward on
B1/B2) through prefill, serving and training, and its decode through the
paged block-sparse KV cache (``[prefill-attn]``, ``[serve-attn-paged]``,
``[paged-vs-full]``) and the observability layer (``[obs]``).  The
partitioned SpMM path (``launch.dist_spmm``) runs in ``[dist-parity]``,
``[dist-timing]``, ``[serve-sharded]``, ``[train-sharded]``,
``[prefill-attn-sharded]`` (``shards=4``: every shard's product on the
same kernels, counted by family) and ``[dist-mesh]`` (a one-rank nccl
mesh); ``[train-mesh]`` trains ``smat-ffn-1.3b`` at full width through
``train.loop.train(cfg, shape, mesh)`` on a one-rank nccl ``(data,
model)`` mesh, parameters and AdamW state stored as ``DTensor``s under
the sharding rules (losses bit-equal to ``[train]``'s), then checks a
mesh-agnostic checkpoint and the int8 gradient compression on the card.
Right after ``[build]``, ``[analysis]`` runs the static contract
analyzer (``python -m repro_torch.analysis --all``), holds every kernel
instantiation's shared-memory formula to the library's own query and its
registers (``cuobjdump -res-usage``) to the H100's limits, launches B5 at
its largest ``max_bpr`` and one past it, and runs the
``REPRO_VERIFY_LAUNCH=1`` hook on the main paths.  Last, ``[dryrun]`` runs
``launch.dryrun --all`` and holds every timed path's analytic roofline
(``launch.roofline``) under its measured time and its exact argument bytes
under its measured peak memory, and ``[examples]`` runs the three example
twins (``examples/torch_*.py``) on the card.  ``[batched]`` holds B1-B4
over 16 instances in one launch (the instance axis the composed attention
path and B5's backward run on) bit-equal to 16 single launches and to its
plain version, and times it against them.  The MLA/MoE and SSD layouts (no TPU kernel on their paths, so the B1-B5
counters must read 0): ``[moe-serve]`` and ``[ssd-serve]`` serve
``deepseek-v2-lite-16b`` and ``mamba2-1.3b`` at full width through
``ServeEngine`` (streams == ``decode_step`` loops), ``[moe-model]`` and
``[ssd-model]`` hold a 2-layer float32 copy card against CPU and prefill
against decode, and ``[moe-train]`` (2 layers) and ``[ssd-train]`` train
them at full width (these six run after ``[restart]``); ``[dryrun]`` adds
their roofline shares.  After them, the rest of the JAX package's
layouts and inputs, again with the B1-B5 counters at 0:
``[gemma-serve]`` (``gemma2-27b`` at full width and depth, 28.41 B
parameters), ``[gemma-model]``, ``[gemma-train]`` (one pair; then step 0
under every ``remat`` policy against ``"none"``), ``[hybrid-serve]``,
``[hybrid-model]`` and ``[hybrid-train]`` (``zamba2-7b``),
``[audio-serve]`` and ``[audio-train]`` (``musicgen-medium``, codebook
rows), ``[vlm-prefill]`` (``pixtral-12b``: 1,024 patch embeddings +
1,024 tokens), ``[vlm-model]``, ``[vlm-train]`` and ``[dense-model]``
(``h2o-danube-1.8b``, ``minitron-4b``, ``qwen2.5-14b``).  Every phase
checks its results; any failure exits non-zero before the last line.

The line before the last lists every ported kernel as JSON; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the rest
of the repository beside it, the script fails and prints no result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import re
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
# f32 products run on the tensor cores as 3xTF32 (three TF32 products per f32
# product, B1 and B3): the least time for f32-accurate products is a third of
# the 495 TFLOP/s TF32 rate.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 495e12 / 3}

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
# kernels on the tensor cores: [build] requires HMMA/HGMMA in their SASS and
# no register spills (bf16 instances; every instance of B5)
TENSOR_CORE_KERNELS = (B1, B2, B3, B4, B5)

N_SLOTS, CACHE_LEN = 4, 256
# training: the JAX package's train_4k cell (4096 x 256 over a pod) cut to
# 2 x 1024 tokens so that one card holds it without remat
TRAIN_SEQ, TRAIN_BATCH, TRAIN_STEPS = 1024, 2, 5
TRAIN_N = TRAIN_SEQ * TRAIN_BATCH
PREFILL_N = 8192       # tokens of smat-attn-1.3b's prefill: B1's N there
N_REQUESTS, PROMPT_LEN, NEW_TOKENS = 8, 16, 16
ROTATE = 24            # distinct weights per timed loop: 24 x 3.7 MB > L2
ROTATE_LONG = 4        # at N = PREFILL_N one call moves > 100 MB: L2 is cold
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
    cuobjdump = Path(_build.find_nvcc()).with_name("cuobjdump")
    check(cuobjdump.is_file(), f"cuobjdump not found beside nvcc "
          f"({cuobjdump}): the tensor-core check cannot run")
    for k in KERNELS:
        info = _build.BUILD_INFO[k["build"]]
        ptxas = [ln.strip() for ln in info["log"].splitlines()
                 if "registers" in ln or "spill" in ln]
        # a library found built carries its report (``_build.log_path``):
        # the spill check below never reads an empty one
        check(_spills(info["log"]), f"{k['name']}: no ptxas -v report "
              f"for {_build.library_path(k['build'])}")
        warm = " (built before: its kept ptxas report)" \
            if not info["seconds"] else ""
        log(f"[build] {k['source']} -> {_build.library_path(k['build'])} in "
            f"{info['seconds']:.2f}s{warm}")
        for ln in ptxas:
            log(f"[build]   {ln}")
        # the tensor cores: count the SASS matrix instructions
        sass = subprocess.run(
            [str(cuobjdump), "-sass", str(_build.library_path(k["build"]))],
            capture_output=True, text=True, check=True, timeout=300).stdout
        hmma = len(re.findall(r"\bHMMA\b", sass))
        hgmma = len(re.findall(r"\bHGMMA\b", sass))
        log(f"[build] {k['source']}: {hmma} HMMA, {hgmma} HGMMA instructions "
            f"(cuobjdump -sass)")
        if k["name"] in TENSOR_CORE_KERNELS:
            check(hmma + hgmma > 0, f"{k['name']} has no tensor-core "
                  "instruction (HMMA/HGMMA) in its SASS")
            every = k["name"] == B5       # B5 is f32 only: all instances
            spilled = [(fn, st) for fn, st in _spills(info["log"])
                       if (every or "__nv_bfloat16" in fn) and st]
            check(not spilled, f"{k['name']}: "
                  f"{'its' if every else 'bf16'} instantiations spill "
                  f"registers: {spilled}")
            others = [(fn, st) for fn, st in _spills(info["log"]) if st]
            if others:
                log(f"[build] {k['name']}: f32 instantiations with spill "
                    f"stores (bytes; not gated): {others}")
    log(f"[build] all kernels built in {time.perf_counter() - t0:.2f}s")


def _spills(ptxas_log):
    """(mangled function name, spill-store bytes) of every kernel in
    ``ptxas -v``'s report."""
    out, fn = [], None
    for ln in ptxas_log.splitlines():
        m = re.search(r"Function properties for (\S+)", ln)
        if m:
            fn = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores", ln)
        if m and fn is not None:
            out.append((fn, int(m.group(1))))
            fn = None
    return out


def _ptxas_registers(ptxas_log):
    """{mangled function name: registers} from ``ptxas -v``'s report."""
    out, fn = {}, None
    for ln in ptxas_log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            fn = m.group(1)
            continue
        m = re.search(r"Used (\d+) registers", ln)
        if m and fn is not None:
            out[fn] = int(m.group(1))
            fn = None
    return out


# ------------------------------------------------------------------ analysis
SPMM_SOURCES = {B1: ("bcsr_spmm", "bcsr_spmm_nnz_stream"),
                B3: ("bcsr_spmm_row_loop", "bcsr_spmm_row_loop")}
SDDMM_SOURCES = {B2: ("bcsr_sddmm", "bcsr_sddmm"),
                 B4: ("bcsr_sddmm_row_loop", "bcsr_sddmm_row_loop")}
# B5's shared memory is checked at these (d, h, max_bpr), its boundary at
# these (d, h, w)
ATTN_SMEM_GRID = [(d, h, mb) for d in (32, 64, 100, 128, 256)
                  for h in (8, 16, 100, 128) for mb in (1, 33, 13823)]
ATTN_BOUNDARY = ((128, 128, 128), (64, 16, 16))


def _main_instantiations():
    """The instantiation each kernel runs on its main path (the model's
    operand layouts): B1/B3 read x^T (k contiguous: n-major staging), BM 16
    and BN 8 at decode (N = 4; the entry's headline), BM 128 and BN 64 at
    training (N = 2048); B2/B4 read the transposed cotangent and x^T (both
    k-major) at training; B5 runs d = h = 128 over smat-attn-1.3b's mask
    at 8,192 tokens."""
    from repro_torch.kernels import bcsr_spmm as pk
    from repro_torch.models import attention as A
    from repro_torch.configs import get_config

    def spmm(n):
        bm, _, kmajor = pk.spmm_launch_config(n, 128, 128, torch.bfloat16,
                                              0, 0, 1, 2048)
        return {"dtype": "bfloat16", "bm": bm, "bn": pk.tile_n(n),
                "kmajor": bool(kmajor)}
    sddmm = {"dtype": "bfloat16", "ak": True, "bk": True}
    spec = get_config(ATTN_ARCH).attn_sparsity
    mb = A.attention_mask_meta(spec.mask, ATTN_SEQ, tuple(spec.block)).max_bpr
    return {B1: {"decode": spmm(N_SLOTS), "train": spmm(TRAIN_N)},
            B3: {"decode": spmm(N_SLOTS), "train": spmm(TRAIN_N)},
            B2: {"train": sddmm}, B4: {"train": sddmm},
            B5: {"prefill": {"d": 128, "h": spec.block[0], "max_bpr": mb}}}


def _b5_one_row(d, h, w, max_bpr, seed=0):
    """Operands of a B5 launch with one block-row of ``max_bpr`` slots: slot
    0 holds the one stored block (entry 0, block-col 0), every other slot
    the sentinel entry ``nnzb`` = 1, which the kernel drops from its slot
    list (``bcsr_attn.cu``: ``idx >= nnzb`` adds nothing).  The shared
    memory is the schedule length's; the operands stay one block."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    q = torch.randn(1, h, d, generator=g, device=DEVICE)
    k = torch.randn(1, w, d, generator=g, device=DEVICE)
    v = torch.randn(1, w, d, generator=g, device=DEVICE)
    flat_idx = torch.ones(max_bpr, dtype=torch.int32, device=DEVICE)
    flat_idx[0] = 0
    flat_col = torch.zeros(max_bpr, dtype=torch.int32, device=DEVICE)
    args = (q, k, v, torch.ones(1, h, w, device=DEVICE), flat_idx, flat_col)
    kw = dict(n_block_rows=1, n_block_cols=1, block=(h, w), scale=d ** -0.5)
    want = torch.softmax(q[0] @ k[0].T * d ** -0.5, dim=-1) @ v[0]
    return args, kw, want


def _row_meta(h, w, slots):
    """The meta of one block-row of ``slots`` stored blocks: what B5's
    shared memory sees at that schedule length."""
    from repro_torch.kernels import ops
    return ops.SparseMeta(shape=(h, slots * w), block=(h, w),
                          n_block_rows=1, n_block_cols=slots, nnzb=slots,
                          nnzb_t=slots, max_bpr=slots)


def _hooked(fn, hooked):
    """``fn()`` with ``REPRO_VERIFY_LAUNCH`` set to 1 or unset."""
    import os
    old = os.environ.pop("REPRO_VERIFY_LAUNCH", None)
    if hooked:
        os.environ["REPRO_VERIFY_LAUNCH"] = "1"
    try:
        return fn()
    finally:
        os.environ.pop("REPRO_VERIFY_LAUNCH", None)
        if old is not None:
            os.environ["REPRO_VERIFY_LAUNCH"] = old


def analysis_phase(smi):
    """[analysis] the static contract analyzer (``repro_torch.analysis``) on
    the card: its CLI; every compiled instantiation's shared memory, Python
    formula against the library's own query; each function's registers,
    static shared memory and local memory (``cuobjdump -res-usage``,
    cross-checked with ptxas's registers) against the H100's limits; B5's
    shared-memory boundary predicted exactly (a launch at the largest
    ``max_bpr`` that fits, the kernel's refusal one past it); a grid past
    ``gridDim.y``'s limit flagged on the host; the ``REPRO_VERIFY_LAUNCH``
    hook on a full-width decode call, a training step and an S = 4 decode
    call, outputs bit-equal without it; a planted meta refused with no
    launch.  Returns each kernel's resources at its main path's
    instantiations, and the hook's checked dispatches."""
    from repro_torch.analysis import verify_launch as vl
    from repro_torch.analysis import workspace as ws
    from repro_torch.analysis.__main__ import main as analysis_main
    from repro_torch.kernels import _build, bcsr_attn, ops
    from repro_torch.kernels import bcsr_spmm as pk

    check(analysis_main(["--all"]) == 0,
          "python -m repro_torch.analysis --all found a violated contract")
    log("[analysis] python -m repro_torch.analysis --all: 0 findings")
    props = torch.cuda.get_device_properties(0)
    for attr, want in (("shared_memory_per_block_optin", ws.H100_SMEM_PER_CTA),
                       ("shared_memory_per_multiprocessor",
                        ws.H100_SMEM_PER_SM),
                       ("regs_per_multiprocessor", ws.H100_REGS_PER_SM),
                       ("max_threads_per_multi_processor",
                        ws.H100_THREADS_PER_SM)):
        got = getattr(props, attr, None)
        log(f"[analysis] device {attr} = {got} (workspace: {want})")
        check(got is None or got == want,
              f"the card's {attr} {got} != analysis.workspace's {want}")

    # every instantiation: the Python formula against the library's query
    n_inst = 0
    for name, (src, sym) in SPMM_SOURCES.items():
        for code, dt in ((0, "float32"), (1, "bfloat16")):
            for bm in ws.SPMM_ROW_BLOCKS:
                check(pk.query(src, f"{sym}_threads", bm) ==
                      ws.spmm_threads(bm), f"{name} threads at BM={bm}")
                for bn in pk.SPMM_TILES:
                    for km in (0, 1):
                        got = pk.query(src, f"{sym}_smem_bytes", code, bm,
                                       bn, km)
                        want = ws.spmm_smem_bytes(dt, bm, bn, bool(km))
                        check(got == want, f"{name} {dt} BM={bm} BN={bn} "
                              f"kmajor={km}: library {got} B, formula "
                              f"{want} B")
                        n_inst += 1
        check(pk.query(src, f"{sym}_smem_bytes", 1, 64, 64, 0) == -1,
              f"{name} answers for a row block it does not compile")
    for name, (src, sym) in SDDMM_SOURCES.items():
        check(pk.query(src, f"{sym}_threads") == ws.SDDMM_THREADS,
              f"{name} threads")
        for code, dt in ((0, "float32"), (1, "bfloat16")):
            for ak in (0, 1):
                for bk in (0, 1):
                    got = pk.query(src, f"{sym}_smem_bytes", code, ak, bk)
                    want = ws.sddmm_smem_bytes(dt, bool(ak), bool(bk))
                    check(got == want, f"{name} {dt} ak={ak} bk={bk}: "
                          f"library {got} B, formula {want} B")
                    n_inst += 1
    for d, h, mb in ATTN_SMEM_GRID:
        got = bcsr_attn.query("bcsr_attn_fused_smem_bytes", d, h, mb)
        check(got == ws.attn_smem_bytes(d, h, mb),
              f"{B5} d={d} h={h} max_bpr={mb}: library {got} B, formula "
              f"{ws.attn_smem_bytes(d, h, mb)} B")
        check(bcsr_attn.query("bcsr_attn_fused_threads", h) ==
              ws.attn_threads(h), f"{B5} threads at h={h}")
    log(f"[analysis] shared memory: the Python formula equals the library's "
        f"query for all {n_inst} B1-B4 instantiations and "
        f"{len(ATTN_SMEM_GRID)} B5 (d, h, max_bpr) points")

    # resources: cuobjdump -res-usage against the limits, ptxas cross-check
    main = _main_instantiations()
    attn_main = main[B5]["prefill"]
    resources = {}
    for k in KERNELS:
        lib = _build.library_path(k["build"])
        usage = vl.resource_usage(lib)
        rows, errs = vl.verify_library_resources(
            usage, attn_shape=(attn_main["d"], attn_main["h"],
                               attn_main["max_bpr"]))
        check(rows, f"{k['name']}: cuobjdump -res-usage lists no kernel")
        check(not errs, f"{k['name']}: resources over the H100's limits: "
              f"{errs}")
        ptx = _ptxas_registers(_build.BUILD_INFO[k["build"]]["log"])
        for r in rows:
            check(ptx.get(r["function"]) == r["regs"],
                  f"{r['function']}: cuobjdump says {r['regs']} registers, "
                  f"ptxas {ptx.get(r['function'])}")
            inst = " ".join(f"{key}={r[key]}" for key in
                            ("dtype", "bm", "bn", "kmajor", "ak", "bk")
                            if key in r) or " ".join(
                                f"{key}={val}" for key, val in
                                attn_main.items())
            log(f"[analysis] {k['name']} {inst}: "
                f"smem {r['smem']} B dynamic + {r['static_smem']} B static, "
                f"regs {r['regs']}, local {r['local']} B, threads "
                f"{r['threads']}, CTAs/SM {r['ctas_per_sm']}")
        by_shape = {}
        for shape, want in main[k["name"]].items():
            row = next(r for r in rows
                       if all(r.get(key) == val for key, val in want.items()
                              if key in r))
            by_shape[shape] = {"smem_bytes": row["smem"] + row["static_smem"],
                               "regs": row["regs"],
                               "ctas_per_sm": row["ctas_per_sm"],
                               "instantiation": want}
        resources[k["name"]] = by_shape

    # B5's boundary: the largest max_bpr that fits launches, one more is
    # refused by the kernel, and the verifier says so first
    for d, h, w in ATTN_BOUNDARY:
        limit = ws.attn_max_bpr(d, h)
        args, kw, want = _b5_one_row(d, h, w, limit)
        out = bcsr_attn.bcsr_attn_fused(*args, **kw)
        torch.cuda.synchronize()
        err = _rel(out[0], want)
        check(err <= 1e-5, f"{B5} at max_bpr={limit}: {err:.3g} x max|ref|")
        args1, kw1, _ = _b5_one_row(d, h, w, limit + 1)
        try:
            bcsr_attn.bcsr_attn_fused(*args1, **kw1)
            refused = None
        except RuntimeError as e:
            refused = str(e)
        check(refused is not None and "CUDA error" in refused,
              f"{B5} at max_bpr={limit + 1} was not refused: {refused}")
        again = bcsr_attn.bcsr_attn_fused(*args, **kw)  # no stale error
        torch.cuda.synchronize()
        check(torch.equal(again, out), f"{B5} after a refusal")
        ok = vl.verify_launch(_row_meta(h, w, limit), "fused", n=d,
                              op="attn")
        bad = vl.verify_launch(_row_meta(h, w, limit + 1), "fused", n=d,
                               op="attn")
        check(ok == [] and len(bad) == 1 and "shared memory" in bad[0],
              f"verify_launch at the {B5} boundary: {ok}, {bad}")
        log(f"[analysis] {B5} boundary d={d} h={h} w={w}: max_bpr {limit} "
            f"({ws.attn_smem_bytes(d, h, limit)} B dynamic + "
            f"{ws.ATTN_STATIC_SMEM} B static) launches ({err:.3g} x "
            f"max|ref| against softmax(q k^T) v), {limit + 1} refused by "
            f"the kernel ({refused}); verify_launch flags {limit + 1} only")

    # a grid the card cannot launch, flagged on the host (not launched)
    from repro_torch.core import bcsr as B
    meta = ops.prepare_sparse_meta(B.random_bcsr_exact(
        0, (8192, 2048), (128, 128), 112))
    edge = ws.H100_GRID_YZ * pk.SPMM_TILES[-1]
    check(vl.verify_launch(meta, "nnz_stream", n=edge) == [],
          f"N={edge} flagged")
    errs = vl.verify_launch(meta, "nnz_stream", n=edge + 1)
    check(len(errs) == 1 and "gridDim.y=65536" in errs[0],
          f"N={edge + 1} not flagged: {errs}")
    log(f"[analysis] grid: {B1} at N={edge + 1} (BN 64) is flagged on the "
        f"host ({errs[0]}); N={edge} passes")
    # the instance axis folds into grid x: the attention backward's
    # batched launches over BATCHED_G heads, and a G past gridDim.x
    from repro_torch.models import attention as A
    am = A.attention_mask_meta(A.banded(4096), ATTN_SEQ, (128, 128))
    launches = {B1: ("nnz_stream", "spmm"), B3: ("row_loop", "spmm"),
                B2: ("nnz_stream", "sddmm"), B4: ("row_loop", "sddmm")}
    grids = {name: vl.derive_grid(am, op, 128, backend=be,
                                  instances=BATCHED_G)
             for name, (be, op) in launches.items()}
    want = {B1: (am.n_block_rows * BATCHED_G, 2, 1),
            B3: (am.n_block_rows * BATCHED_G, 2, 1),
            B2: (am.nnzb * BATCHED_G, 2, 2),
            B4: (am.n_block_rows * am.max_bpr * BATCHED_G, 2, 2)}
    check(grids == want, f"batched grids {grids} != {want}")
    for be, op in launches.values():
        check(vl.verify_launch(am, be, n=128, op=op,
                               instances=BATCHED_G) == [],
              f"{be} {op} over {BATCHED_G} instances flagged")
    past = ws.H100_GRID_X // am.n_block_rows + 1
    errs = vl.verify_launch(am, "nnz_stream", n=128, instances=past)
    check(len(errs) == 1 and "gridDim.x" in errs[0],
          f"G={past} not flagged: {errs}")
    log(f"[analysis] batched grids over {BATCHED_G} heads {grids}, each "
        f"within the card's limits; "
        f"G={past} is flagged on the host ({errs[0]})")

    hook = _hook_on_main_paths()
    log(f"[analysis] every check held; {smi}")
    return resources, hook


def _hook_on_main_paths():
    """The ``REPRO_VERIFY_LAUNCH=1`` hook on the main paths at full width:
    one ``smat-ffn-1.3b`` decode call, one training step and one
    ``SparsitySpec(shards=4)`` decode call, each through
    ``verify_launch.assert_launch_ok`` on every ``ops.dispatch`` and
    bit-equal to the same call without the hook; then a planted meta (one
    entry more than its schedule has slots for) raises ``LaunchError``
    before any launch.  Returns the checked dispatches of each path."""
    import dataclasses as dc

    from repro_torch.analysis import verify_launch as vl
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeCell
    from repro_torch.data.pipeline import make_batch
    from repro_torch.kernels import ops
    from repro_torch.launch import steps as st
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw
    from repro_torch.train import loop

    checked = {"n": 0}
    assert_ok = vl.assert_launch_ok

    def counting(*args, **kw):
        checked["n"] += 1
        return assert_ok(*args, **kw)

    def decode(cfg, model):
        cache = T.init_cache(cfg, N_SLOTS, CACHE_LEN, device=DEVICE)
        toks = torch.arange(N_SLOTS, device=DEVICE) * 7 + 1
        with torch.inference_mode():
            logits, _ = T.decode_step(cfg, model, cache, toks, 0)
        torch.cuda.synchronize()
        return logits

    def both(what, fn, expect):
        _reset_counts()
        plain = _hooked(fn, False)
        launches = _read_counts()
        checked["n"] = 0
        _reset_counts()
        hooked = _hooked(fn, True)
        check(_read_counts() == launches and
              sum(launches[name] for name in expect) > 0,
              f"{what}: launches {launches} without the hook, "
              f"{_read_counts()} with it")
        n = checked["n"]
        check(n > 0, f"{what}: the hook checked no dispatch")
        return plain, hooked, n, launches

    vl.assert_launch_ok = counting
    counts = {}
    try:
        cfg = get_config("smat-ffn-1.3b")
        model = T.init_params(cfg, seed=0, device=DEVICE)
        plain, hooked, n, launches = both(
            "decode", lambda: decode(cfg, model), (B1,))
        check(torch.equal(plain, hooked), "decode logits differ under "
              "REPRO_VERIFY_LAUNCH=1")
        counts["decode"] = n
        log(f"[analysis] hook: {cfg.name} decode call ({N_SLOTS} slots) "
            f"passes the verifier on {n} dispatches; logits bit-equal "
            f"without the hook; launches {launches}")

        # the planted fault: an operand of the model's shape whose meta
        # counts one entry more than its schedule has slots for (the entry
        # would sit on the sentinel): refused before any launch
        from repro_torch.core import bcsr as B
        arrays, meta = ops.prepare(B.random_bcsr_exact(
            3, (8192, 2048), (128, 128), 112), torch.bfloat16,
            device=DEVICE)
        bad = dc.replace(meta, nnzb=meta.n_block_rows * meta.max_bpr + 1)
        x = torch.ones(2048, N_SLOTS, dtype=torch.bfloat16, device=DEVICE)
        _reset_counts()
        try:
            _hooked(lambda: ops.spmm(arrays, bad, x, backend="row_loop"),
                    True)
            raised = None
        except vl.LaunchError as e:
            raised = str(e)
        check(raised is not None and "schedule capacity" in raised,
              f"the planted meta was not refused: {raised}")
        check(_read_counts() == _counts(), f"the planted meta launched "
              f"{_read_counts()}")
        log(f"[analysis] planted meta (nnzb {bad.nnzb} > {meta.n_block_rows}"
            f" rows x max_bpr {meta.max_bpr}): LaunchError before any "
            f"launch, counts {_read_counts()}")
        del model, arrays
        torch.cuda.empty_cache()

        shape = ShapeCell("chip", "train", TRAIN_SEQ, TRAIN_BATCH)
        opt_cfg = adamw.AdamWConfig(total_steps=TRAIN_STEPS)
        batch = loop.batch_to_device(make_batch(cfg, shape, 0), DEVICE)

        def train_step():
            m = T.init_params(cfg, seed=0, device=DEVICE)
            opt = adamw.init(dict(m.named_parameters()))
            step = st.make_train_step(cfg, opt_cfg, remat="none")
            m, opt, metrics = step(m, opt, batch)
            torch.cuda.synchronize()
            return ({k: v.clone() for k, v in metrics.items()},
                    {k: v.detach().clone() for k, v in m.state_dict().items()})
        plain, hooked, n, launches = both("train step", train_step, (B2,))
        same = all(torch.equal(plain[0][k], hooked[0][k]) for k in plain[0])
        same &= all(torch.equal(plain[1][k], hooked[1][k]) for k in plain[1])
        check(same, "a training step differs under REPRO_VERIFY_LAUNCH=1")
        counts["train"] = n
        log(f"[analysis] hook: {cfg.name} training step ({TRAIN_BATCH} x "
            f"{TRAIN_SEQ}) passes the verifier on {n} dispatches; loss "
            f"{float(plain[0]['loss']):.6f}, every parameter after the "
            f"update bit-equal without the hook; launches {launches}")
        del plain, hooked
        torch.cuda.empty_cache()

        cfg_sh = _sharded_cfg(cfg)
        model = T.init_params(cfg_sh, seed=0, device=DEVICE)
        plain, hooked, n, launches = both(
            "sharded decode", lambda: decode(cfg_sh, model), (B1, B3))
        check(torch.equal(plain, hooked), "S=4 decode logits differ under "
              "REPRO_VERIFY_LAUNCH=1")
        counts["decode_sharded"] = n
        log(f"[analysis] hook: {cfg_sh.name} shards={SHARDED_S} decode call "
            f"passes the verifier on {n} dispatches; logits bit-equal "
            f"without the hook; launches {launches}")
        del model
        torch.cuda.empty_cache()
    finally:
        vl.assert_launch_ok = assert_ok
    return counts


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


def _b(seed, k, n, dtype, transposed=False, offset=0):
    """B [k, n]: row-major, or the x^T view the model passes; ``offset``
    elements into its storage (a misaligned base: a narrower copy)."""
    rng = np.random.default_rng(seed)
    flat = torch.from_numpy(rng.standard_normal(k * n + offset).astype(
        np.float32)).to(DEVICE, dtype)[offset:]
    return flat.view(n, k).T if transposed else flat.view(k, n)


def _nnz_stream(op, b):
    from repro_torch.kernels import bcsr_spmm
    return bcsr_spmm.bcsr_spmm_nnz_stream(
        op["vals"], op["row_ids"], op["col_ids"], b, op["nbr"],
        rowptr=op["rowptr"])


def _plain(op, b, out_dtype=None):
    from repro_torch.kernels import ref
    return ref.bcsr_spmm_ref(op["vals"], op["row_ids"], op["col_ids"], b,
                             op["nbr"], out_dtype=out_dtype)


def _held(what, fn, want, name=B1):
    """A kernel's bf16 result at a main-path width against its plain
    version (the plain f32 result ``want`` cast to bf16, rtol = atol =
    1e-2, as ``[parity]``) and against a second call, bit for bit; the
    timing phases call it on the operands they time.  Returns max|err|."""
    got, again = fn(), fn()
    want = want.to(got.dtype)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    stable = torch.equal(got, again)
    ok = torch.allclose(got.float(), want.float(), rtol=1e-2,
                        atol=1e-2) and stable
    log(f"{what}: {name} vs plain max|err|={err:.3g} tol=1e-2 bit-stable "
        f"{stable} {'ok' if ok else 'FAIL'}")
    check(ok, f"{what}: {name} disagrees with its plain version or with "
          "itself")
    return err


# block-rows of 300 entries: more than two windows of the kernels' staged
# entry ids (spmm_tile::kWin = 128), so the window refill runs
LONG_ROWS = [((16, 2400), (8, 8), 1.0), ((128, 38400), (128, 128), 1.0)]

FULL_WIDTH = {         # smat-ffn-1.3b's sparse FFN weights: nnzb = 112
    "gate_up": ((8192, 2048), 112),
    "down": ((2048, 8192), 112),
}


def parity_phase():
    """Kernel against its plain version on the card.  f32 (3xTF32 on the
    tensor cores): rtol = atol = 1e-4.  bf16 in and out: the plain f32
    result cast to bf16, rtol = atol = 1e-2 (about 1 bf16 ulp).  B
    row-major and as the x^T view; at the small shapes (and LONG_ROWS) also
    with its base one element off (the narrow copy widths); every result
    bit-equal to a second call."""
    from repro_torch.kernels import bcsr_spmm
    small = [((64, 64), (8, 8), 0.5), ((128, 256), (16, 32), 0.3),
             ((256, 128), (32, 16), 0.15), ((96, 160), (16, 16), 0.4),
             ((256, 384), (128, 128), 0.4)] + LONG_ROWS
    cases = [(f"small{shape}{block}", dict(shape=shape, block=block,
                                           density=d), n)
             for shape, block, d in small for n in (1, 8, 33, 64, 100)]
    cases += [(name, dict(shape=shape, block=(128, 128), nnzb=nnzb), n)
              for name, (shape, nnzb) in FULL_WIDTH.items()
              for n in (4, 64, 1024)]
    max_err, n_cases, widths = 0.0, 0, set()
    for i, (name, spec, n) in enumerate(cases):
        for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 1e-2)):
            op = _operand(i, dtype=dtype, **spec)
            offsets = (0,) if name in FULL_WIDTH else (0, 1)
            for transposed in (False, True):
                for offset in offsets:
                    b = _b(100 + i, spec["shape"][1], n, dtype, transposed,
                           offset)
                    bm, vec, _ = bcsr_spmm._launch_config(op["vals"], b)
                    got, again = _nnz_stream(op, b), _nnz_stream(op, b)
                    want = _plain(op, b, out_dtype=torch.float32).to(dtype)
                    torch.cuda.synchronize()
                    err = (got.float() - want.float()).abs().max().item()
                    ok = torch.allclose(got.float(), want.float(), rtol=tol,
                                        atol=tol) and torch.equal(got, again)
                    if name in FULL_WIDTH:
                        max_err = max(max_err, err)
                    n_cases += 1
                    if name in FULL_WIDTH or not ok:
                        log(f"[parity] {name} N={n} {str(dtype)[6:]} "
                            f"{'x^T view' if transposed else 'row-major'} "
                            f"offset={offset} bm={bm} vec={vec}B max|err|="
                            f"{err:.3g} tol={tol} bit-stable "
                            f"{torch.equal(got, again)} "
                            f"{'ok' if ok else 'FAIL'}")
                    widths.add(vec)
                    check(ok, f"kernel disagrees with its plain version or "
                          f"with itself: {name} N={n} offset={offset}")
    log(f"[parity] {n_cases} cases ok (small odd shapes and block-rows of "
        f"300 entries at N in 1, 8, 33, 64, 100, B offset by 0 and 1 "
        f"element; copy widths run: "
        f"{sorted(widths)} bytes), every result bit-stable")
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


def _sddmm_ok(got, want):
    """(ok, max|err|, tolerance text) of B2 or B4 against its plain
    version: bf16
    rtol = atol = 1e-2 (about one ulp); f32 (3xTF32, whose tensor-core sums
    truncate) carve-out 2, max|err| <= 1e-5 x max|plain| (ROADMAP C)."""
    err = (got.float() - want.float()).abs().max().item()
    if got.dtype == torch.bfloat16:
        return (torch.allclose(got.float(), want.float(), rtol=1e-2,
                               atol=1e-2), err, "1e-2")
    scale = want.abs().max().item()
    return err <= 1e-5 * scale, err, f"1e-5 x {scale:.3g}"


def sddmm_parity_phase():
    """B2 against its plain version (``_sddmm_ok``: bf16 1e-2, f32 carve-out
    2) and against a second call, bit for bit: at the small odd shapes with
    N in {8, 33, 100}, dC and B each row-major or as the transposed view
    (every pairing of the two majorities) at an aligned base and one
    element off (the narrow copies); at both full-width shapes with N in
    {64, TRAIN_N, PREFILL_N} (the FFN training's and the attention
    training's widths), both row-major and as the views.  Then B1 on the
    transpose structure (dB = A^T dC) at the full-width backward shapes
    (rtol = atol = 1e-4 in f32, 1e-2 in bf16).  Returns the largest
    full-width |err| of B2 and of B1's backward use."""
    from repro_torch.kernels import bcsr_spmm, ops, ref
    small = [((64, 64), (8, 8), 0.5), ((128, 256), (16, 32), 0.3),
             ((256, 128), (32, 16), 0.15), ((96, 160), (16, 16), 0.4),
             ((384, 256), (128, 128), 0.4)]
    cases = [(f"small{shape}{block}", dict(shape=shape, block=block,
                                           density=d), n)
             for shape, block, d in small for n in (8, 33, 100)]
    cases += [(name, dict(shape=shape, block=(128, 128), nnzb=nnzb), n)
              for name, (shape, nnzb) in FULL_WIDTH.items()
              for n in (64, TRAIN_N, PREFILL_N)]
    err_b2 = err_dx = 0.0
    n_cases, widths = 0, set()
    for i, (name, spec, n) in enumerate(cases):
        h, w = spec["block"]
        full = name in FULL_WIDTH
        layouts = ([(False, False, 0), (True, True, 0)] if full else
                   [(dv, bv, off) for dv in (False, True)
                    for bv in (False, True) for off in (0, 1)])
        for dtype in (torch.float32, torch.bfloat16):
            arrays, meta = _prepared(500 + i, dtype=dtype, **spec)
            for dc_view, b_view, offset in layouts:
                # views: as x^T and the cotangent of C^T reach the kernels
                # in training
                dc = _b(600 + i, meta.n_block_rows * h, n, dtype, dc_view,
                        offset)
                x = _b(700 + i, meta.n_block_cols * w, n, dtype, b_view,
                       offset)
                _, vec, ak, bk = bcsr_spmm.sddmm_launch_config(
                    n, h, w, dtype, dc.data_ptr(), x.data_ptr(),
                    *dc.stride(), *x.stride())
                got = bcsr_spmm.bcsr_sddmm(dc, x, arrays.row_ids,
                                           arrays.col_ids, h, w)
                again = bcsr_spmm.bcsr_sddmm(dc, x, arrays.row_ids,
                                             arrays.col_ids, h, w)
                want = ref.bcsr_sddmm_ref(dc, x, arrays.row_ids,
                                          arrays.col_ids, h, w,
                                          out_dtype=torch.float32).to(dtype)
                torch.cuda.synchronize()
                ok, err, tol = _sddmm_ok(got, want)
                stable = torch.equal(got, again)
                n_cases += 1
                widths.add(vec)
                if full:
                    err_b2 = max(err_b2, err)
                if full or not (ok and stable):
                    log(f"[sddmm-parity] {B2} {name} N={n} {str(dtype)[6:]} "
                        f"dC {'view' if dc_view else 'row-major'}, B "
                        f"{'view' if b_view else 'row-major'}, offset="
                        f"{offset} vec={vec}B ak={ak} bk={bk} max|err|="
                        f"{err:.3g} tol={tol} bit-stable {stable} "
                        f"{'ok' if ok and stable else 'FAIL'}")
                check(ok and stable, f"{B2} disagrees with its plain version "
                      f"or with itself: {name} N={n} {dtype}")
                if not full:
                    continue
                # B1's second use: dB = A^T dC over the transpose structure
                tol = 1e-4 if dtype == torch.float32 else 1e-2
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
                log(f"[sddmm-parity] {B1} A^T {name} N={n} "
                    f"{str(dtype)[6:]} {'view' if dc_view else 'row-major'}"
                    f" max|err|={err:.3g} tol={tol} {'ok' if ok else 'FAIL'}")
                check(ok, f"nnz_stream on the transpose structure disagrees "
                      f"with its plain version: {name} N={n}")
                del t_vals
            del arrays, dc, x, got, again, want
        torch.cuda.empty_cache()
    log(f"[sddmm-parity] {n_cases} {B2} cases ok and bit-stable (small odd "
        f"blocks with both majorities of each operand, copy widths run: "
        f"{sorted(widths)} bytes; full width at N = 64, {TRAIN_N}, "
        f"{PREFILL_N})")
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


def train_timing_phase(smi, n=TRAIN_N):
    """bf16 kernel times at the training shape (N = TRAIN_N tokens),
    rotating over ROTATE layers' operands so that L2 is cold: B2 (dvals),
    B1 forward (C = A x^T) and B1 on the transpose structure (dB = A^T dC),
    each beside its plain version, its bound, the dense product and the
    library call.  Operands enter as the transposed views training
    passes.  At n = PREFILL_N (the attention training's FFN width) it
    rotates over ROTATE_LONG operands: one call moves more than L2 holds.
    Each kernel is also held to its plain version and to a second call on
    the operands it is timed on (``_held``)."""
    from repro_torch.kernels import bcsr_spmm, ops, ref
    dtype = torch.bfloat16
    rotate = ROTATE if n < PREFILL_N else ROTATE_LONG
    results = {}
    for name, (shape, nnzb) in FULL_WIDTH.items():
        M, K = shape
        ops_ = [_prepared(7919 + j, shape, (128, 128), nnzb=nnzb,
                          dtype=dtype) for j in range(rotate)]
        arrays0, meta = ops_[0]
        xs = [_b(j, K, n, dtype, transposed=True) for j in range(rotate)]
        dcs = [_b(100 + j, M, n, dtype, transposed=True)
               for j in range(rotate)]
        t_vals = [ops.transposed_vals(a.vals, a.t_perm) for a, _ in ops_]
        dense = [ops.materialize_dense(a, m) for a, m in ops_]

        def row(case, **kw):
            r = {"case": f"{case} {name} {M}x{K} N={n}", "card": smi, **kw}
            log("[timing] " + json.dumps(r))
            return r

        # ---- B2: dvals = dC x^T at the stored blocks (N = PREFILL_N: the
        # attention training's FFN)
        err_b2 = _held(
            f"[timing] dvals {name} N={n} dC^T, x^T views",
            lambda: bcsr_spmm.bcsr_sddmm(dcs[0], xs[0], arrays0.row_ids,
                                         arrays0.col_ids, 128, 128),
            ref.bcsr_sddmm_ref(dcs[0], xs[0], arrays0.row_ids,
                               arrays0.col_ids, 128, 128,
                               out_dtype=torch.float32), name=B2)
        ms = time_ms([lambda a=a, d=d, x=x: bcsr_spmm.bcsr_sddmm(
            d, x, a.row_ids, a.col_ids, 128, 128)
            for (a, _), d, x in zip(ops_, dcs, xs)], reps=10)
        plain = time_ms([lambda a=a, d=d, x=x: ref.bcsr_sddmm_ref(
            d, x, a.row_ids, a.col_ids, 128, 128)
            for (a, _), d, x in zip(ops_, dcs, xs)], reps=5)
        dense_ms = time_ms([lambda a=a, d=d, x=x:
                            ref.bcsr_sddmm_dense_ref(
                                d, x, a.row_ids, a.col_ids, 128, 128)
                            for (a, _), d, x in zip(ops_, dcs, xs)], reps=5)
        # the yardstick: PyTorch's sampled product on the same operands
        lib, lib_note = _sddmm_library(ops_, dcs, xs, meta, shape)
        bound_ms, bound_by = sddmm_bound(arrays0, meta, n, dtype)
        results[("sddmm", name)] = row(
            "bcsr_sddmm", max_abs_err=err_b2, ms=ms, plain_ms=plain,
            bound_ms=bound_ms, bound_by=bound_by, dense_ms=dense_ms,
            library_ms=lib, **lib_note)

        # ---- B1 forward: C = A x^T
        a0, m0 = ops_[0]
        err_fwd = _held(
            f"[timing] forward {name} N={n} x^T view",
            lambda: bcsr_spmm.bcsr_spmm_nnz_stream(
                a0.vals, a0.row_ids, a0.col_ids, xs[0], m0.n_block_rows,
                rowptr=a0.rowptr),
            ref.bcsr_spmm_ref(a0.vals, a0.row_ids, a0.col_ids, xs[0],
                              m0.n_block_rows, out_dtype=torch.float32))
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
            "bcsr_spmm_nnz_stream forward", max_abs_err=err_fwd, ms=ms,
            plain_ms=plain,
            bound_ms=bound_ms, bound_by=bound_by, dense_ms=dense_ms,
            library_ms=lib, **({"library_error": lib_err} if lib_err else {}))
        del bsr, xcs

        # ---- B1 on the transpose structure: dB = A^T dC
        err_dx = _held(
            f"[timing] dB=A^T dC {name} N={n} dC^T view",
            lambda: bcsr_spmm.bcsr_spmm_nnz_stream(
                t_vals[0], a0.t_row_ids, a0.t_col_ids, dcs[0],
                m0.n_block_cols, rowptr=a0.t_rowptr),
            ref.bcsr_spmm_ref(t_vals[0], a0.t_row_ids, a0.t_col_ids, dcs[0],
                              m0.n_block_cols, out_dtype=torch.float32))
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
            "bcsr_spmm_nnz_stream dB=A^T dC", max_abs_err=err_dx, ms=ms,
            plain_ms=plain,
            bound_ms=bound_ms, bound_by=bound_by, dense_ms=dense_ms,
            library_ms=lib, **({"library_error": lib_err} if lib_err else {}))
        del ops_, xs, dcs, t_vals, dense, bsr_t, dccs, a0, m0
        torch.cuda.empty_cache()
    return results


def timing_phase(smi):
    """bf16 kernel times at the main path's shapes (decode, N = 1024 and the
    prefill's N = PREFILL_N), rotating over ROTATE layers' weights so that
    L2 is cold as it is in decode (ROTATE_LONG at PREFILL_N, where one call
    moves more bytes than L2 holds).  At each width, and at the 32k
    prefill's N = ATTN_LONG, the kernel is held to its plain version and to
    a second call (``_held``)."""
    from repro_torch.kernels import ops
    dtype = torch.bfloat16
    results = {}
    for name, (shape, nnzb) in FULL_WIDTH.items():
        all_ops = [_operand(7919 + j, shape, (128, 128), nnzb=nnzb,
                            dtype=dtype) for j in range(ROTATE)]
        for n in (N_SLOTS, 1024, PREFILL_N):
            ops_ = all_ops[:ROTATE if n < PREFILL_N else ROTATE_LONG]
            bs = [_b(j, shape[1], n, dtype, transposed=True)
                  for j in range(len(ops_))]
            row = {"case": f"{name} {shape[0]}x{shape[1]} N={n}",
                   "card": smi}
            row["max_abs_err"] = _held(
                f"[timing] {name} N={n} x^T view",
                lambda: _nnz_stream(ops_[0], bs[0]),
                _plain(ops_[0], bs[0], out_dtype=torch.float32))
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
            del bs
            torch.cuda.empty_cache()
        # the prefill_32k cell's width (held, not timed; 512 column tiles)
        b = _b(0, shape[1], ATTN_LONG, dtype, transposed=True)
        results[(name, ATTN_LONG)] = {"max_abs_err": _held(
            f"[timing] {name} N={ATTN_LONG} x^T view",
            lambda: _nnz_stream(all_ops[0], b),
            _plain(all_ops[0], b, out_dtype=torch.float32))}
        del all_ops, b
        torch.cuda.empty_cache()
    return results


# ----------------------------------------------------------------- main path
def _cb_row(cfg) -> tuple:
    """A position's token shape: () or (n_codebooks,)."""
    return (cfg.n_codebooks,) if cfg.input_mode == "codebooks" else ()


def _requests(cfg):
    """N_REQUESTS prompts of PROMPT_LEN positions ([PROMPT_LEN, n_cb] for
    ``codebooks``), seed 0."""
    from repro_torch.serve.engine import Request
    rng = np.random.default_rng(0)
    return [Request(rid=r, prompt=rng.integers(
        0, cfg.vocab_size, size=(PROMPT_LEN,) + _cb_row(cfg),
        dtype=np.int32), max_new_tokens=NEW_TOKENS)
        for r in range(N_REQUESTS)]


def _tok_list(stream):
    """A stream of tokens (ints, or codebook rows) as plain lists."""
    return [np.asarray(t).tolist() for t in stream]


def _greedy_oracle(cfg, model, prompt, n_new, cache_len=CACHE_LEN, row=0):
    """A direct decode_step loop: the request in row ``row`` of an
    N_SLOTS-row batch (pad elsewhere), as the engine runs it in that slot,
    so the row sees the same shapes.  Returns ints, or lists of codebook
    tokens for ``codebooks``."""
    from repro_torch.models import transformer as T
    cache = T.init_cache(cfg, N_SLOTS, cache_len, device=DEVICE)
    toks = torch.zeros((N_SLOTS,) + _cb_row(cfg), dtype=torch.int64,
                       device=DEVICE)
    out, pos = [], 0
    for t in prompt:
        toks[row] = torch.as_tensor(np.asarray(t, np.int64))
        logits, cache = T.decode_step(cfg, model, cache, toks, pos)
        pos += 1
    for _ in range(n_new):
        tok = logits[row].float().argmax(-1)
        out.append(tok.tolist())
        toks[row] = tok
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
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    streams = {}
    for rid, tok in engine.generate(requests):
        streams.setdefault(rid, []).append(tok)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = _read_counts()
    _measured("serve", cfg, "decode", N_SLOTS, CACHE_LEN,
              dt * 1e3 / engine.decode_calls)

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
        return _first_logits(_with_backend(cfg_, backend), model_)

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
           # B1 and B3 are one tile routine told apart by their entry
           # source (csrc/spmm_tile.cuh's spmm_kernel<Source, ...>), B2 and
           # B4 another (csrc/sddmm_tile.cuh's sddmm_kernel<Source, ...>)
           f"nnz_stream_ms_per_{unit}": sum(
               ms for k, ms in device
               if "spmm_kernel" in k and "RowptrSource" in k),
           f"row_loop_ms_per_{unit}": sum(
               ms for k, ms in device
               if "spmm_kernel" in k and "ScheduleSource" in k),
           f"sddmm_ms_per_{unit}": sum(
               ms for k, ms in device
               if "sddmm_kernel" in k and "EntrySource" in k),
           f"sddmm_row_loop_ms_per_{unit}": sum(
               ms for k, ms in device
               if "sddmm_kernel" in k and "ScheduleSource" in k),
           f"attn_fused_ms_per_{unit}": sum(ms for k, ms in device
                                            if "attn_fused" in k),
           f"top_device_ms_per_{unit}": [[k[:80], ms]
                                         for k, ms in device[:10]],
           f"top_host_ms_per_{unit}": [[k[:60], ms, n]
                                       for k, ms, n in host[:10]]}
    if not dev_ms:
        row["note"] = "torch.profiler recorded no device time: not measured"
    return row


def _serve_profile(cfg, model, cache_len):
    """``torch.profiler`` over PROFILE_STEPS engine steps of 4 slots
    decoding together (one decode call a step), after 2 steps of warm-up:
    the ``[profile]`` row of one decode call."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve.engine import ServeEngine
    engine = ServeEngine(cfg, model, n_slots=N_SLOTS, cache_len=cache_len,
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
    row = {"decode_calls": calls,
           **_profile_summary(prof, wall_ms, calls, "call")}
    del engine, prof
    torch.cuda.empty_cache()
    return row


def profile_phase(cfg, model):
    """Where a decode call's time goes: ``torch.profiler`` over
    PROFILE_STEPS engine steps of the full-width engine (4 slots decoding
    together, one decode call per step; ``_serve_profile``).  Prints device
    ms per call by kernel, the host's busiest ops, and the device's idle
    share of the window (1 - device time / wall time; the profiler's own
    host cost inflates the wall time a little)."""
    log("[profile] " + json.dumps(_serve_profile(cfg, model, CACHE_LEN)))


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


# every timed main path, for [dryrun]: its config and cell, its measured ms
# (a step, a decode call or a prefill) and the peak memory allocated since
# its phase reset the count
MEASURED = {}


def _measured(path, cfg, kind, batch, seq, ms):
    MEASURED[path] = {"cfg": cfg, "kind": kind, "batch": batch, "seq": seq,
                      "ms": ms, "peak": torch.cuda.max_memory_allocated()}


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
    _measured("train", cfg, "train", TRAIN_BATCH, TRAIN_SEQ, step_ms)
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
                      "losses": res.losses, "peak_gb": peak_gb}


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
def _b1(arrays, meta, b):
    from repro_torch.kernels import bcsr_spmm
    return bcsr_spmm.bcsr_spmm_nnz_stream(
        arrays.vals, arrays.row_ids, arrays.col_ids, b, meta.n_block_rows,
        rowptr=arrays.rowptr)


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
    arrays) and against a second call, bit for bit: B3 f32 rtol = atol =
    1e-4, bf16 out 1e-2 (about one ulp), and bit-equal to B1 on the same
    entries; B4 as B2 (``_sddmm_ok``: bf16 1e-2, f32 carve-out 2) and
    bit-equal to B2 on the same entries.  Small odd blocks with a ragged N,
    ``max_bpr`` of 1 (one block a row), of many and of 300 (LONG_ROWS: the
    entry-id window refills), operands row-major and as the transposed
    views, at an aligned base and one element off (the narrow copies);
    then both full-width FFN structures (384 and 144 slots for 112 blocks)
    at N = 4 and N = TRAIN_N, with the operands as the transposed views the
    model passes.  Returns the largest full-width |err| of B3 and of B4."""
    from repro_torch.kernels import bcsr_spmm
    small = [((64, 64), (8, 8), dict(density=0.6)),
             ((64, 64), (8, 8), dict(nnzb=8)),            # max_bpr 1
             ((128, 256), (16, 32), dict(density=0.3)),
             ((256, 128), (32, 16), dict(density=0.15)),
             ((96, 160), (16, 16), dict(density=0.4))]
    small += [(shape, block, dict(density=d)) for shape, block, d in LONG_ROWS]
    cases = [(f"small{shape}{block}", dict(shape=shape, block=block, **kw), n)
             for shape, block, kw in small for n in (8, 33, 100)]
    cases += [(name, dict(shape=shape, block=(128, 128), nnzb=nnzb), n)
              for name, (shape, nnzb) in FULL_WIDTH.items()
              for n in (N_SLOTS, TRAIN_N)]
    err_b3 = err_b4 = 0.0
    n_cases, widths = 0, set()
    for i, (name, spec, n) in enumerate(cases):
        h, w = spec["block"]
        full = name in FULL_WIDTH
        for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 1e-2)):
            arrays, meta = _prepared(900 + i, dtype=dtype, **spec)
            for view in (False, True):
                for offset in ((0,) if full else (0, 1)):
                    x = _b(1000 + i, meta.n_block_cols * w, n, dtype, view,
                           offset)
                    dc = _b(1100 + i, meta.n_block_rows * h, n, dtype, view,
                            offset)
                    got3 = _b3(arrays, meta, x)
                    same = (torch.equal(got3, _b3(arrays, meta, x))
                            and torch.equal(got3, _b1(arrays, meta, x)))
                    check(same, f"{B3} is not bit-stable or not bit-equal to "
                          f"{B1} on the same entries: {name} N={n}")
                    got4 = _b4(arrays, meta, dc, x)
                    same4 = (torch.equal(got4, _b4(arrays, meta, dc, x))
                             and torch.equal(got4, bcsr_spmm.bcsr_sddmm(
                                 dc, x, arrays.row_ids, arrays.col_ids, h,
                                 w)))
                    check(same4, f"{B4} is not bit-stable or not bit-equal "
                          f"to {B2} on the same entries: {name} N={n} "
                          f"offset={offset}")
                    _, vec, _, _ = bcsr_spmm.sddmm_launch_config(
                        n, h, w, dtype, dc.data_ptr(), x.data_ptr(),
                        *dc.stride(), *x.stride())
                    widths.add(vec)
                    want3 = _b3_plain(arrays, meta, x,
                                      torch.float32).to(dtype)
                    want4 = _b4_plain(arrays, meta, dc, x,
                                      torch.float32).to(dtype)
                    torch.cuda.synchronize()
                    err3 = (got3.float() - want3.float()).abs().max().item()
                    ok3 = torch.allclose(got3.float(), want3.float(),
                                         rtol=tol, atol=tol)
                    ok4, err4, tol4 = _sddmm_ok(got4, want4)
                    ok4 = ok4 and got4.shape == (meta.nnzb, h, w)
                    n_cases += 1
                    if full:
                        err_b3, err_b4 = max(err_b3, err3), max(err_b4, err4)
                    for kname, ok, err, t in ((B3, ok3, err3, tol),
                                              (B4, ok4, err4, tol4)):
                        if full or not ok:
                            log(f"[row_loop-parity] {kname} {name} max_bpr="
                                f"{meta.max_bpr} N={n} {str(dtype)[6:]} "
                                f"{'views' if view else 'row-major'} offset="
                                f"{offset} max|err|={err:.3g} tol={t} "
                                f"bit-stable, == {B1 if kname == B3 else B2}"
                                f" {'ok' if ok else 'FAIL'}")
                        check(ok, f"{kname} disagrees with its plain version:"
                              f" {name} N={n} offset={offset}")
    log(f"[row_loop-parity] {n_cases} cases ok: {B3} == {B1} and {B4} == "
        f"{B2} bitwise, both bit-stable (small odd blocks at N in 8, 33, "
        f"100, B4 copy widths run: {sorted(widths)} bytes; full width at "
        f"N = {N_SLOTS}, {TRAIN_N})")
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
    decode (N = N_SLOTS), training (N = TRAIN_N) and prefill widths (N =
    PREFILL_N, over ROTATE_LONG operands: the attention training's FFN runs
    its SDDMM there), rotating over ROTATE layers' operands so that L2 is
    cold, operands as the transposed views the model passes; each beside
    its plain version, its bound, the dense product and the library call,
    B4 also beside B2 on the same operands.  On the timed operands at each
    width B3 is held bit-equal to B1, and B4 bit-equal to B2 and to its
    plain version and a second call (``_held``)."""
    from repro_torch.kernels import bcsr_spmm, ops, ref
    dtype = torch.bfloat16
    results = {}
    for name, (shape, nnzb) in FULL_WIDTH.items():
        M, K = shape
        ops_ = [_prepared(7919 + j, shape, (128, 128), nnzb=nnzb,
                          dtype=dtype) for j in range(ROTATE)]
        meta = ops_[0][1]
        dense = [ops.materialize_dense(a, m) for a, m in ops_]
        bsr = [_bsr_library(a, shape) for a, _ in ops_]
        for n in (N_SLOTS, TRAIN_N, PREFILL_N):
            rotate = ROTATE if n < PREFILL_N else ROTATE_LONG
            xs = [_b(j, K, n, dtype, transposed=True) for j in range(rotate)]
            dcs = [_b(100 + j, M, n, dtype, transposed=True)
                   for j in range(rotate)]

            def row(case, **kw):
                r = {"case": f"{case} {name} {M}x{K} N={n}",
                     "max_bpr": meta.max_bpr, "card": smi, **kw}
                log("[row_loop-timing] " + json.dumps(r))
                return r

            # ---- B3: C = A x^T through the static schedule
            a0, m0 = ops_[0]
            check(torch.equal(_b3(a0, m0, xs[0]), _b1(a0, m0, xs[0])),
                  f"{B3} is not bit-equal to {B1}: {name} N={n}")
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

            # ---- B4: dvals = dC x^T at the stored blocks, beside B2
            check(torch.equal(_b4(a0, m0, dcs[0], xs[0]),
                              bcsr_spmm.bcsr_sddmm(dcs[0], xs[0], a0.row_ids,
                                                   a0.col_ids, 128, 128)),
                  f"{B4} is not bit-equal to {B2}: {name} N={n}")
            err = _held(f"[row_loop-timing] dvals {name} N={n} dC^T, x^T "
                        f"views", lambda: _b4(a0, m0, dcs[0], xs[0]),
                        _b4_plain(a0, m0, dcs[0], xs[0], torch.float32),
                        name=B4)
            ms = time_ms([lambda a=a, m=m, d=d, x=x: _b4(a, m, d, x)
                          for (a, m), d, x in zip(ops_, dcs, xs)], reps=reps)
            b2_ms = time_ms([lambda a=a, d=d, x=x: bcsr_spmm.bcsr_sddmm(
                d, x, a.row_ids, a.col_ids, 128, 128)
                for (a, _), d, x in zip(ops_, dcs, xs)], reps=reps)
            plain = time_ms([lambda a=a, m=m, d=d, x=x: _b4_plain(a, m, d, x)
                             for (a, m), d, x in zip(ops_, dcs, xs)],
                            reps=reps)
            dense_ms = time_ms([lambda a=a, d=d, x=x: ref.bcsr_sddmm_dense_ref(
                d, x, a.row_ids, a.col_ids, 128, 128)
                for (a, _), d, x in zip(ops_, dcs, xs)], reps=reps)
            lib, lib_note = _sddmm_library(ops_, dcs, xs, meta, shape)
            bound_ms, bound_by = sddmm_bound(ops_[0][0], meta, n, dtype)
            results[(B4, name, n)] = row(
                B4, max_abs_err=err, ms=ms, b2_ms=b2_ms, plain_ms=plain,
                bound_ms=bound_ms, bound_by=bound_by, dense_ms=dense_ms,
                library_ms=lib, slots=m0.n_block_rows * m0.max_bpr,
                live_slots=m0.nnzb, **lib_note)
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
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    streams = {}
    for rid, tok in engine.generate(requests):
        streams.setdefault(rid, []).append(tok)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = _read_counts()
    _measured("serve_row_loop", cfg_rl, "decode", N_SLOTS, CACHE_LEN,
              dt * 1e3 / engine.decode_calls)
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
    within 1e-2 of the ``nnz_stream`` run's.  Then a ``torch.profiler``
    window of one step after a warm-up step, as ``[train-profile]``."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.base import ShapeCell
    from repro_torch.data.pipeline import make_batch
    from repro_torch.launch import steps as st
    from repro_torch.models import transformer as T
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
    _measured("train_row_loop", cfg_rl, "train", TRAIN_BATCH, TRAIN_SEQ,
              step_ms)
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

    opt_cfg = adamw.AdamWConfig(total_steps=TRAIN_STEPS)
    model = T.init_params(cfg_rl, seed=0, device=DEVICE)
    opt_state = adamw.init(dict(model.named_parameters()))
    batch = loop.batch_to_device(make_batch(cfg_rl, shape, 0), DEVICE)
    step = st.make_train_step(cfg_rl, opt_cfg, remat="none")
    model, opt_state, _ = step(model, opt_state, batch)      # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model, opt_state, metrics = step(model, opt_state, batch)
        float(metrics["loss"])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    log("[train-row_loop-profile] " + json.dumps(
        {"train_steps": 1, "card": smi,
         **_profile_summary(prof, wall_ms, 1, "step")}))
    del model, opt_state, batch, prof
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
# the decode cache after an ATTN_SEQ-token prefill, and [serve-attn-paged]'s:
# banded(4096) in 128-wide pages gives 65 pages, 33 read a step
ATTN_CACHE = ATTN_SEQ + 128
PAGED_POSITIONS = (0, 127, 4096, 8191)   # [paged-vs-full]'s decode positions
ATTN_TRAIN_STEPS = 3
ATTN_PLAIN_CHUNK = 4    # instances a plain B5 call holds at 32768 tokens


def _attn_case(mask, L, block, d, dv, G, cap, seed):
    """Operands of one B5 call: q, k, v drawn from a numpy seed, the mask's
    cached device tensors; returns (mask tensors, args, keywords).  The
    keywords carry the mask's cached bits (``ebits``), as the model passes
    them; ``_b5_plain`` reads the f32 ``emask`` instead."""
    from repro_torch.models import attention as A
    mt = A.mask_tensors(mask, L, block, DEVICE)
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal((G, L, n)).astype(
        np.float32)).to(DEVICE) for n in (d, d, dv))
    kw = dict(n_block_rows=mt.meta.n_block_rows,
              n_block_cols=mt.meta.n_block_cols, block=tuple(block),
              scale=d ** -0.5, cap=cap, ebits=mt.ebits)
    return mt, (q, k, v, mt.emask, mt.arrays.sddmm_flat_idx,
                mt.arrays.flat_col), kw


def _b5(args, kw):
    from repro_torch.kernels import bcsr_attn
    return bcsr_attn.bcsr_attn_fused(*args, **kw)


def _b5_plain(args, kw):
    from repro_torch.kernels import ref
    return ref.bcsr_attn_fused_ref(*args, **{k: v for k, v in kw.items()
                                             if k != "ebits"})


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
    """(bound_ms, bound_by) of one B5 call: q, k, v, the element bitmask
    (``ebits``: one bit an element, the sentinel block included) and the
    schedule read once, out written once (f32); the useful work is Q K^T
    and P V once per stored block per instance, 2 operations per
    multiply-add, over the f32-accurate (3xTF32) peak."""
    h, w = meta.block
    nbytes = (4 * G * L * (2 * d + 2 * dv) + 4 * (meta.nnzb + 1) * h
              * -(-w // 32) + 8 * meta.n_block_rows * meta.max_bpr)
    flops = G * meta.nnzb * 2 * h * w * (d + dv)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[torch.float32]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def attn_timing_phase(smi, mask_s):
    """B5's ms per launch at one layer's shapes (G = 16, d = 128,
    banded(4096), L = 8192 and 32768), each beside its bound, its plain
    version (at 32768 as ATTN_PLAIN_CHUNK-instance calls covering the
    G instances, as ``[attn-parity]`` runs it), the composed path on the
    kernels the tuner resolves (launches per call counted; its output held
    against B5's within carve-out 2, 1e-5), the library call
    ``scaled_dot_product_attention`` in f32 with the boolean band mask
    (the one PyTorch call that computes the same function) and, for
    context only, dense causal SDPA in bf16 (a different function).  Eager
    launches timed with CUDA events: a B5 call takes tens of ms, so the
    host's share is small."""
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
        # at 32768 the plain version holds ATTN_PLAIN_CHUNK instances a
        # call (memory): its time is that of the calls that cover all G
        step = ATTN_G if L == ATTN_SEQ else ATTN_PLAIN_CHUNK
        chunks = [tuple(t[g:g + step] for t in args[:3]) + args[3:]
                  for g in range(0, ATTN_G, step)]
        row["plain_ms"] = time_ms_eager(
            [lambda c=c: _b5_plain(c, kw) for c in chunks],
            reps=2) * len(chunks)
        row["plain_instances_per_call"] = step
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
        else:
            row["faster_than_library"] = row["ms"] < row["library_ms"]
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


def attn_bwd_timing_phase(smi):
    """f32 times of B1, B2 and B4 at the attention backward's shapes: one
    head of ``smat-attn-1.3b`` at L = ATTN_SEQ, ``banded(4096)`` in 128x128
    blocks (1,584 stored), N = d = 128.  B1's context product probs @ V over
    the mask structure (dQ = dS @ K has its shape) and its dK/dV product
    P^T @ g over the transpose structure (the blocks of
    ``ops.transposed_vals``); B2's scores Q K^T (d(probs) = g V^T has its
    shape), and B4's over the mask's static schedule (2,112 slots, 528 of
    them padding: the ``row_loop`` backend's), held bit-equal to B2's.  The
    probabilities are the composed path's own (B2, then
    ``block_softmax``).  Each beside its bound (f32 at the 3xTF32 rate),
    its plain version and the library: ``torch.sparse_bsr_tensor @`` in
    f32 for B1, ``torch.sparse.sampled_addmm`` over the element CSR of the
    stored blocks for B2 and B4 (``_sddmm_library``); each held against
    its plain version (rtol = atol = 1e-4) and a second call, bit for
    bit."""
    from repro_torch.kernels import bcsr_spmm, ops, ref
    from repro_torch.models import attention as A
    L, d = ATTN_SEQ, 128
    mt = A.mask_tensors(A.banded(4096), L, (128, 128), DEVICE)
    a, meta = mt.arrays, mt.meta
    rng = np.random.default_rng(11)
    q, k, v, g = (torch.from_numpy(rng.standard_normal((L, d)).astype(
        np.float32)).to(DEVICE) for _ in range(4))
    scores = bcsr_spmm.bcsr_sddmm(q, k, a.row_ids, a.col_ids, 128, 128)
    probs = A.block_softmax(scores * d ** -0.5, mt.elem_mask, a.row_ids,
                            meta.n_block_rows, flat_idx=a.sddmm_flat_idx)
    t_vals = ops.transposed_vals(probs, a.t_perm)
    f32 = torch.float32
    cases = {
        "context": (
            B1, lambda: bcsr_spmm.bcsr_spmm_nnz_stream(
                probs, a.row_ids, a.col_ids, v, meta.n_block_rows,
                rowptr=a.rowptr),
            lambda: ref.bcsr_spmm_ref(probs, a.row_ids, a.col_ids, v,
                                      meta.n_block_rows),
            (torch.sparse_bsr_tensor(a.rowptr, a.col_ids, probs,
                                     size=(L, L)), v),
            bound(meta.nnzb, 128, 128, L, d, meta.n_block_rows, f32)),
        "dK/dV": (
            B1, lambda: bcsr_spmm.bcsr_spmm_nnz_stream(
                t_vals, a.t_row_ids, a.t_col_ids, g, meta.n_block_cols,
                rowptr=a.t_rowptr),
            lambda: ref.bcsr_spmm_ref(t_vals, a.t_row_ids, a.t_col_ids, g,
                                      meta.n_block_cols),
            (torch.sparse_bsr_tensor(a.t_rowptr, a.t_col_ids, t_vals,
                                     size=(L, L)), g),
            bound(meta.nnzb_t, 128, 128, L, d, meta.n_block_cols, f32)),
        "scores": (
            B2, lambda: bcsr_spmm.bcsr_sddmm(q, k, a.row_ids, a.col_ids, 128,
                                             128),
            lambda: ref.bcsr_sddmm_ref(q, k, a.row_ids, a.col_ids, 128, 128),
            None, sddmm_bound(a, meta, d, f32)),
        "scores row_loop": (
            B4, lambda: bcsr_spmm.bcsr_sddmm_row_loop(
                q, k, a.sddmm_flat_idx, a.flat_col, meta.n_block_rows,
                meta.nnzb, 128, 128),
            lambda: ref.bcsr_sddmm_row_loop_ref(
                q, k, a.sddmm_flat_idx, a.flat_col, meta.n_block_rows,
                meta.nnzb, 128, 128),
            None, sddmm_bound(a, meta, d, f32)),
    }
    rows = {}
    for case, (kname, kernel, plain, lib, (bound_ms, bound_by)) in \
            cases.items():
        got, again, want = kernel(), kernel(), plain()
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        stable = torch.equal(got, again)
        ok = torch.allclose(got, want, rtol=1e-4, atol=1e-4) and stable
        extra = {}
        if kname == B4:
            extra = {"equal_to_b2": torch.equal(got, scores),
                     "slots": meta.n_block_rows * meta.max_bpr}
            ok = ok and extra["equal_to_b2"]
        row = {"case": f"{kname} f32 {case} "
                       f"banded(4096) L={L} nnzb={meta.nnzb} N={d}",
               "max_abs_err": err, "rel_err": _rel(got, want),
               "bit_stable": stable, **extra,
               "ms": time_ms([kernel], reps=20),
               "plain_ms": time_ms([plain], reps=5),
               "bound_ms": bound_ms, "bound_by": bound_by, "card": smi}
        row["faster_than_plain"] = row["ms"] < row["plain_ms"]
        if lib is None:
            # torch.sparse.sampled_addmm over the element CSR of the stored
            # blocks (it refuses a BSR mask)
            row["library_ms"], note = _sddmm_library(
                [(a, meta)], [q], [k], meta, (L, L))
            row.update(note)
        else:
            bsr, rhs = lib

            def check_lib(bsr=bsr, rhs=rhs, want=want):
                if not torch.allclose(bsr @ rhs, want, rtol=1e-3, atol=1e-3):
                    raise ValueError("sparse_bsr result differs")
            row["library_ms"], lib_err = _library(
                [lambda bsr=bsr, rhs=rhs: bsr @ rhs], check_lib)
            if lib_err:
                row["library_error"] = lib_err
        log("[attn-bwd-timing] " + json.dumps(row))
        check(ok, f"{case} at the attention backward's shape disagrees "
              f"with its plain version (or {B4} with {B2}): max|err| "
              f"{err:.3g}")
        rows[case] = row
    del cases, probs, t_vals, scores
    torch.cuda.empty_cache()
    return rows


BATCHED_G = 16         # instances of a [batched] launch: smat-attn-1.3b's heads


def _folded(rng, G, rows, n, dtype, kmajor=False):
    """A [G, rows, n] operand as the model folds its heads: instance g is
    column block g of one [1, rows, G, n] tensor (batch stride n, row
    stride G * n); with ``kmajor`` the x^T view of a [G, n, rows] tensor
    (its row axis contiguous), as the FFN's backward passes x and dC."""
    if kmajor:
        t = rng.standard_normal((G, n, rows)).astype(np.float32)
        return torch.from_numpy(t).to(DEVICE, dtype).transpose(1, 2)
    t = rng.standard_normal((1, rows, G, n)).astype(np.float32)
    return torch.from_numpy(t).to(DEVICE, dtype).transpose(1, 2)[0]


def _block_diagonal_bsr(rowptr, col_ids, vals, shape):
    """The G instances' blocks laid along the diagonal of one [G * M, G * K]
    ``torch.sparse_bsr_tensor``: PyTorch refuses a batched BSR product, and
    this one product by ``b.reshape(G * K, N)`` is the batched SpMM."""
    G, nnzb, h, w = vals.shape
    M, K = shape
    if int(rowptr[-1]) != nnzb or col_ids.shape[0] != nnzb:
        raise ValueError("the structure does not index every stored block")
    g = torch.arange(G, device=vals.device)
    crow = torch.cat([(rowptr[:-1] + g[:, None] * nnzb).reshape(-1),
                      rowptr[-1:] + (G - 1) * nnzb])
    col = (col_ids + g[:, None] * (K // w)).reshape(-1)
    return torch.sparse_bsr_tensor(
        crow.to(rowptr.dtype), col.to(rowptr.dtype),
        vals.reshape(G * nnzb, h, w), size=(G * M, G * K))


def _batched_lib_mask(arrays, shape, G, dtype):
    """The stored blocks' element CSR repeated for G instances: the mask
    of a batched ``torch.sparse.sampled_addmm`` (it refuses a BSR mask)."""
    one = torch.sparse_bsr_tensor(
        arrays.rowptr, arrays.col_ids,
        torch.ones(arrays.col_ids.shape[0], *arrays.vals.shape[-2:],
                   dtype=dtype, device=DEVICE), size=shape).to_dense()
    one = one.to_sparse_csr()
    crow, col, vals = (t.expand(G, -1).contiguous() for t in (
        one.crow_indices(), one.col_indices(), one.values()))
    return torch.sparse_csr_tensor(crow, col, vals, size=(G, *shape))


def batched_phase(smi):
    """B1-B4 over G = BATCHED_G instances in one launch (the instance axis of
    ``ops.spmm`` / ``ops.sddmm``, which the composed attention path and
    B5's backward now take): at the attention backward's shape (16 heads of
    smat-attn-1.3b, L = ATTN_SEQ, banded(4096) in 128x128 blocks, f32, N =
    d = 128; Q, K, V and g as the model's folded-heads views) -- B1's
    context (probs @ V) and dK/dV (P^T g over the transpose structure),
    B3's context, B2's and B4's scores -- and at the FFN's gate/up shape
    in bf16 (8192 x 2048, 112 blocks, N = TRAIN_N, the x^T and dC^T views).
    Each batched call launches once; it must equal the G single launches
    on the instances' views bit for bit, a second call bit for bit, and
    its batched plain version (f32 rtol = atol = 1e-4; bf16 1e-2, about
    one ulp); B3 equals B1 and B4 equals B2 bitwise.  Each is timed (CUDA
    graphs) beside the G single launches, its bound (G times one
    instance's), its plain version and the library's batched call
    (one ``torch.sparse_bsr_tensor`` with the instances' blocks along its
    diagonal @ the instances' dense operands stacked, built outside the
    timed call; ``torch.sparse.sampled_addmm`` over a batched element
    CSR), whose refusal is recorded; B3's and B4's rows carry B1's and
    B2's library time, the same call on the same inputs."""
    from repro_torch.kernels import bcsr_spmm as pk
    from repro_torch.kernels import ops, ref
    from repro_torch.models import attention as A
    G = BATCHED_G
    rng = np.random.default_rng(17)
    L, d = ATTN_SEQ, 128
    f32, bf16 = torch.float32, torch.bfloat16
    mt = A.mask_tensors(A.banded(4096), L, (128, 128), DEVICE)
    a, meta = mt.arrays, mt.meta
    q, k, v, g = (_folded(rng, G, L, d, f32) for _ in range(4))
    scores = pk.bcsr_sddmm(q, k, a.row_ids, a.col_ids, 128, 128)
    probs = A.block_softmax(scores * d ** -0.5, mt.elem_mask, a.row_ids,
                            meta.n_block_rows, flat_idx=a.sddmm_flat_idx)
    t_vals = ops.transposed_vals(probs, a.t_perm)
    fa, fmeta = _prepared(3, FULL_WIDTH["gate_up"][0], (128, 128),
                          nnzb=FULL_WIDTH["gate_up"][1], dtype=bf16)
    (M, K), n = fmeta.shape, TRAIN_N
    fvals = torch.from_numpy(rng.standard_normal(
        (G, *fa.vals.shape)).astype(np.float32)).to(DEVICE, bf16)
    xt, dct = (_folded(rng, G, rows, n, bf16, kmajor=True)
               for rows in (K, M))

    def spmm(kern, vals, arrays, nbr, b, t=False):
        if kern == B1:
            rows = (arrays.t_row_ids, arrays.t_col_ids, arrays.t_rowptr) \
                if t else (arrays.row_ids, arrays.col_ids, arrays.rowptr)
            return lambda s=slice(None): pk.bcsr_spmm_nnz_stream(
                vals[s], rows[0], rows[1], b[s], nbr, rowptr=rows[2])
        return lambda s=slice(None): pk.bcsr_spmm_row_loop(
            vals[s], arrays.flat_idx, arrays.flat_col, arrays.row_len, b[s],
            nbr)

    def sddmm(kern, arrays, m, dc, b):
        h, w = m.block
        if kern == B2:
            return lambda s=slice(None): pk.bcsr_sddmm(
                dc[s], b[s], arrays.row_ids, arrays.col_ids, h, w)
        return lambda s=slice(None): pk.bcsr_sddmm_row_loop(
            dc[s], b[s], arrays.sddmm_flat_idx, arrays.flat_col,
            m.n_block_rows, m.nnzb, h, w)

    def spmm_plain(vals, arrays, nbr, b, t=False, dt=None):
        rows = (arrays.t_row_ids, arrays.t_col_ids) if t else \
            (arrays.row_ids, arrays.col_ids)
        return lambda: ref.bcsr_spmm_ref(vals, *rows, b, nbr, out_dtype=dt)

    def sddmm_plain(arrays, m, dc, b, dt=None):
        return lambda: ref.bcsr_sddmm_ref(dc, b, arrays.row_ids,
                                          arrays.col_ids, *m.block,
                                          out_dtype=dt)

    def spmm_lib(vals, rowptr, col_ids, b, shape):
        bsr = _block_diagonal_bsr(rowptr, col_ids, vals, shape)
        b2 = b.reshape(-1, b.shape[-1]).contiguous()
        return [("block-diagonal sparse_bsr @ b.reshape(G * K, N)",
                 lambda: bsr @ b2)]

    def sddmm_lib(arrays, m, shape, dc, b):
        mask = _batched_lib_mask(arrays, shape, G, dc.dtype)
        return [("sampled_addmm over a batched element CSR",
                 lambda: torch.sparse.sampled_addmm(
                     mask, dc, b.transpose(1, 2), beta=0.0).to_dense())]

    one_b1 = bound(meta.nnzb, 128, 128, L, d, meta.n_block_rows, f32)
    one_b1t = bound(meta.nnzb_t, 128, 128, L, d, meta.n_block_cols, f32)
    one_b2 = sddmm_bound(a, meta, d, f32)
    one_f1 = bound(fmeta.nnzb, 128, 128, K, n, fmeta.n_block_rows, bf16)
    one_f2 = sddmm_bound(fa, fmeta, n, bf16)
    attn = f"f32 banded(4096) L={L} nnzb={meta.nnzb} N={d}"
    ffn = f"bf16 gate_up {M}x{K} nnzb={fmeta.nnzb} N={n}"
    # case -> (kernel, batched call (s: the instances), plain version,
    #          library call or None, one instance's bound, case it equals)
    cases = {
        "attn context": (B1, spmm(B1, probs, a, meta.n_block_rows, v),
                         spmm_plain(probs, a, meta.n_block_rows, v),
                         (probs, a.rowptr, a.col_ids, v, (L, L)),
                         one_b1, None, attn),
        "attn dK/dV": (B1, spmm(B1, t_vals, a, meta.n_block_cols, g, t=True),
                       spmm_plain(t_vals, a, meta.n_block_cols, g, t=True),
                       (t_vals, a.t_rowptr, a.t_col_ids, g, (L, L)),
                       one_b1t, None, attn),
        "attn context row_loop": (B3, spmm(B3, probs, a, meta.n_block_rows,
                                           v),
                                  spmm_plain(probs, a, meta.n_block_rows,
                                             v), None, one_b1,
                                  "attn context", attn),
        "attn scores": (B2, sddmm(B2, a, meta, q, k),
                        sddmm_plain(a, meta, q, k),
                        ("sddmm", a, meta, (L, L), q, k), one_b2, None,
                        attn),
        "attn scores row_loop": (B4, sddmm(B4, a, meta, q, k),
                                 sddmm_plain(a, meta, q, k), None, one_b2,
                                 "attn scores", attn),
        "ffn forward": (B1, spmm(B1, fvals, fa, fmeta.n_block_rows, xt),
                        spmm_plain(fvals, fa, fmeta.n_block_rows, xt,
                                   dt=f32),
                        (fvals, fa.rowptr, fa.col_ids, xt, (M, K)), one_f1,
                        None, ffn),
        "ffn forward row_loop": (B3, spmm(B3, fvals, fa, fmeta.n_block_rows,
                                          xt),
                                 spmm_plain(fvals, fa, fmeta.n_block_rows,
                                            xt, dt=f32), None, one_f1,
                                 "ffn forward", ffn),
        "ffn dvals": (B2, sddmm(B2, fa, fmeta, dct, xt),
                      sddmm_plain(fa, fmeta, dct, xt, dt=f32),
                      ("sddmm", fa, fmeta, (M, K), dct, xt), one_f2,
                      None, ffn),
        "ffn dvals row_loop": (B4, sddmm(B4, fa, fmeta, dct, xt),
                               sddmm_plain(fa, fmeta, dct, xt, dt=f32),
                               None, one_f2, "ffn dvals", ffn),
    }
    rows, results = {}, {}
    for case, (kname, call, plain, lib, (one_ms, by), same_as, what) in \
            cases.items():
        _reset_counts()
        got = call()
        torch.cuda.synchronize()
        launched = _read_counts()
        again = call()
        singles = torch.stack([call(i) for i in range(G)])
        want = plain().to(got.dtype)
        torch.cuda.synchronize()
        tol = 1e-4 if got.dtype == f32 else 1e-2
        err = (got.float() - want.float()).abs().max().item()
        row = {"case": f"{kname} {case} G={G} {what}", "G": G,
               "launches": launched[kname],
               "bit_equal_to_singles": torch.equal(got, singles),
               "bit_stable": torch.equal(got, again), "max_abs_err": err,
               "rel_err": _rel(got.float(), want.float()), "tol": tol}
        if same_as is not None:
            row["equal_to"] = {"kernel": cases[same_as][0],
                               "bitwise": torch.equal(got,
                                                      results[same_as])}
        ok = (launched == _counts(**{kname: 1}) and
              row["bit_equal_to_singles"] and row["bit_stable"] and
              torch.allclose(got.float(), want.float(), rtol=tol, atol=tol)
              and (same_as is None or row["equal_to"]["bitwise"]))
        results[case] = got
        del again, singles, want
        row["ms"] = time_ms([call], reps=10)
        row["singles_ms"] = time_ms(
            [lambda i=i: call(i) for i in range(G)], reps=5) * G
        row["speedup_vs_singles"] = row["singles_ms"] / row["ms"]
        row["plain_ms"] = time_ms([plain], reps=3)
        row["bound_ms"], row["bound_by"] = G * one_ms, by
        row["bound_ms_one_instance"] = one_ms
        if lib is None:
            # B3 (B4) computes B1's (B2's) function on the same inputs: one
            # library call, timed once on that kernel's row
            same = rows[same_as]
            row["library_ms"] = same["library_ms"]
            row.update({k: same[k] for k in ("library_call", "library_error")
                        if k in same})
        else:
            # the first library call that runs and agrees (dense results)
            if lib[0] == "sddmm":
                _, arrays, m, shape, dc, b = lib
                want_lib = ops.materialize_dense(arrays._replace(
                    vals=got.float()), m)
                candidates = sddmm_lib(arrays, m, shape, dc, b)
            else:
                want_lib = got.float()
                candidates = spmm_lib(*lib)
            errors = []
            for lib_name, fn in candidates:
                def check_lib(fn=fn):
                    if not torch.allclose(fn().float().reshape(
                            want_lib.shape), want_lib, rtol=2e-2, atol=2e-2):
                        raise ValueError("its result differs")
                row["library_ms"], lib_err = _library([fn], check_lib,
                                                      timer=time_ms_eager)
                if lib_err is None:
                    row["library_call"] = lib_name
                    break
                errors.append(f"{lib_name}: {lib_err}")
            if row["library_ms"] is None:
                row["library_error"] = "; ".join(errors)
            del candidates, want_lib
        row["card"] = smi
        log("[batched] " + json.dumps(row))
        check(ok, f"[batched] {case}: {kname} over {G} instances is not "
              f"one launch equal to its single launches and within {tol} "
              f"of its plain version (max|err| {err:.3g}, launches "
              f"{launched})")
        rows[case] = row
    del cases, results, probs, t_vals, scores, q, k, v, g, fvals, xt, dct
    torch.cuda.empty_cache()
    return rows


def _attn_cfg(**attn_kw):
    """smat-attn-1.3b with the attention spec's fields replaced.  Decode
    keeps the registered ``paged_decode="auto"`` unless a phase passes
    ``paged_decode="off"``: at ATTN_CACHE it reads KV through the mask's
    page table (65 pages, 33 a step); at CACHE_LEN (2 pages, both touched)
    "auto" keeps the dense bias."""
    from repro_torch.configs import get_config
    cfg = get_config(ATTN_ARCH)
    return dataclasses.replace(cfg, attn_sparsity=dataclasses.replace(
        cfg.attn_sparsity, **attn_kw))


def _page_grid(cfg, cache_len):
    """(pages, pages read a step) of ``cfg``'s paged decode at
    ``cache_len``, or None where it decodes through the dense bias."""
    from repro_torch.models import layers as L
    table = L._decode_pages(cfg, cfg.sliding_window, cache_len)
    if table is None:
        return None
    return cache_len // cfg.attn_sparsity.block[1], table[0].shape[1]


def prefill_attn_phase(smi):
    """smat-attn-1.3b at full width and depth (24 layers, random weights
    from seed 0): prefill one 8192-token prompt through
    ``launch/steps.make_prefill_step`` (exactly 24 B5 and 72 B1 launches);
    its last-position logits against the plain path (attention and FFN on
    ``xla``) within max(2e-2, 2 x the plain path's own noise: FFN ``dense``
    against ``xla``, as ``[model]``); then ATTN_DECODE decode steps from that
    cache (ATTN_CACHE: 72 B1 and no B5 a call) through paged KV (the
    registered ``paged_decode="auto"``: 65 pages, 33 read a step; the
    ``models.paged_decode`` sentinel shows the branch ran), each step's
    logits against the plain path decoding through the dense bias
    (``"off"``) from a copy of the cache, by the same rule; the same steps
    through the kernels and the dense bias, from another copy, give ms per
    step and launches paged and "off"; the prefill again in float32, where
    the logits hold to the plain path's within 2e-2; then one timed
    32768-token prefill (the prefill_32k cell cut from global batch 32 to
    1 on one card): ms and peak memory."""
    from repro_torch.launch import steps as st
    from repro_torch.models import transformer as T
    from repro_torch.obs import shapemon
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
    cache_len = ATTN_CACHE
    grid = _page_grid(cfg, cache_len)
    check(grid is not None and grid[1] < grid[0],
          f"paged_decode='auto' does not page at cache {cache_len}: {grid}")
    prefill = st.make_prefill_step(cfg, cache_len)
    prefill(model, {"tokens": tokens[:, :4096]})   # first-call set-up
    torch.cuda.synchronize()
    _reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    logits, cache = prefill(model, {"tokens": tokens})
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = _read_counts()
    _measured("prefill_attn", cfg, "prefill", 1, ATTN_SEQ, dt * 1e3)
    want = _counts(**{B5: cfg.n_layers, B1: 3 * cfg.n_layers})
    logits = logits.float()
    ref_logits = {}
    for ffn in ("dense", "xla"):        # the plain path: FFN on xla
        cfg_p = dataclasses.replace(
            _attn_cfg(backend="xla", paged_decode="off"),
            ffn_sparsity=dataclasses.replace(cfg.ffn_sparsity, backend=ffn))
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
    cache_off = {n: t.clone() for n, t in cache.items()}
    tok = logits.argmax(-1)
    fed, step_logits_k = [tok], []
    _reset_counts()
    shapemon.reset("models.paged_decode")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for s in range(ATTN_DECODE):
        step_logits, cache = decode(model, cache, tok, ATTN_SEQ + s)
        step_logits_k.append(step_logits.float())
        tok = step_logits.float().argmax(-1)
        fed.append(tok)
    torch.cuda.synchronize()
    dt_dec = time.perf_counter() - t0
    counts_dec = _read_counts()
    paged_sigs = shapemon.trace_count("models.paged_decode")
    want_dec = _counts(**{B1: 3 * cfg.n_layers * ATTN_DECODE})
    out = [int(t[0]) for t in fed[1:]]
    check(paged_sigs == 1, f"the paged decode branch saw {paged_sigs} input "
          "signatures over the decode steps; want 1 (it ran, at one shape)")
    # the same steps through the kernels and the dense bias ("off"), fed
    # the same tokens from a copy of the cache: ms per step and launches
    decode_off = st.make_decode_step(_attn_cfg(paged_decode="off"))
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for s in range(ATTN_DECODE):
        _, cache_off = decode_off(model, cache_off, fed[s], ATTN_SEQ + s)
    torch.cuda.synchronize()
    dt_off = time.perf_counter() - t0
    counts_off = _read_counts()
    check(shapemon.trace_count("models.paged_decode") == 1 and
          counts_off == want_dec, f"the 'off' decode paged, or launched "
          f"{counts_off} != {want_dec}")
    del cache_off
    # the plain path (FFN on xla, the dense bias) decodes from a copy of
    # the same cache, fed the kernel path's tokens: every step's logits
    # within max(2e-2, 2 x the plain path's own decode noise, FFN dense
    # against xla), and its greedy tokens compared
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
        f"{cache_len}, paged KV: {grid[0]} pages, {grid[1]} read a step, "
        f"block-row {ATTN_SEQ // cfg.attn_sparsity.block[0]}): tokens {out}; "
        f"paged {dt_dec * 1e3:.3f} ms ({dt_dec * 1e3 / ATTN_DECODE:.3f} ms "
        f"a step), dense bias 'off' {dt_off * 1e3:.3f} ms "
        f"({dt_off * 1e3 / ATTN_DECODE:.3f} ms a step), host clock, "
        f"synchronised; launches paged {counts_dec}, 'off' {counts_off}, "
        f"expected {want_dec} each; paged_decode signatures {paged_sigs}; "
        f"against the plain path ('off', FFN xla) from a copy of the cache: "
        f"max|dlogit| {dec_err:.4g}, plain's own noise {dec_noise:.4g}, "
        f"tolerance {dec_tol:.4g}; same greedy token {same}/{ATTN_DECODE}; "
        f"{smi}")
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
    _measured("prefill_attn_32k", cfg, "prefill", 1, ATTN_LONG, dt_long * 1e3)
    counts_long = _read_counts()
    log(f"[prefill-attn] {cell.name} cell (global batch "
        f"{cell.global_batch} cut to 1 on one card), 1 x {ATTN_LONG} tokens: "
        f"{dt_long * 1e3:.3f} ms ({ATTN_LONG / dt_long:.1f} tokens/s), peak "
        f"memory {peak:.2f} GB; launches {counts_long}; {smi}")
    check(bool(torch.isfinite(long_logits).all()) and counts_long == want,
          f"32k prefill: launches {counts_long} or logits not finite")
    del model, long_logits
    torch.cuda.empty_cache()
    return counts, counts_dec, {
        "prefill_ms": dt * 1e3, "prefill_32k_ms": dt_long * 1e3,
        "prefill_32k_peak_gb": peak,
        "decode_ms_per_step": {"paged": dt_dec * 1e3 / ATTN_DECODE,
                               "off": dt_off * 1e3 / ATTN_DECODE}}


def serve_attn_phase():
    """ServeEngine with smat-attn-1.3b at full width (4 slots, cache 256, 8
    requests): prompts go token by token through decode calls, which apply
    the mask as a bias (at 256 the registered "auto" reads both pages, so
    it keeps the dense bias), so each call launches 72 B1 and no B5; the
    engine's stream equals a direct ``decode_step`` loop."""
    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import ServeEngine
    cfg = _attn_cfg()
    check(_page_grid(cfg, CACHE_LEN) is None,
          f"paged_decode='auto' pages at cache {CACHE_LEN}")
    model = T.init_params(cfg, seed=0, device=DEVICE)
    warm = ServeEngine(cfg, model, n_slots=N_SLOTS, cache_len=CACHE_LEN,
                       device=DEVICE)
    list(warm.generate(_requests(cfg)[:1]))
    engine = ServeEngine(cfg, model, n_slots=N_SLOTS, cache_len=CACHE_LEN,
                         device=DEVICE)
    requests = _requests(cfg)
    _reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    streams = {}
    for rid, tok in engine.generate(requests):
        streams.setdefault(rid, []).append(tok)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = _read_counts()
    _measured("serve_attn", cfg, "decode", N_SLOTS, CACHE_LEN,
              dt * 1e3 / engine.decode_calls)
    n_tok = sum(len(v) for v in streams.values())
    want = _counts(**{B1: 3 * cfg.n_layers * engine.decode_calls})
    log(f"[serve-attn] {len(streams)} requests, {n_tok} new tokens, "
        f"{engine.decode_calls} decode calls in {dt:.3f}s: {n_tok / dt:.1f} "
        f"tok/s; paged KV {engine.paged_kv.report()['groups'][0]['paged']}; "
        f"launches {launches}, expected {want}")
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


def serve_attn_paged_phase(smi):
    """ServeEngine with smat-attn-1.3b as registered (paged_decode="auto")
    at full width: 4 slots, cache ATTN_CACHE (a 6.5 GB KV cache), the 8
    requests of 16 + 16 tokens.  ``engine.paged_kv`` is set and its report
    printed (the group paged, 65 pages, 33 read a step, resident and
    offload bytes); every decode call launches 72 B1 and no B5; the stream
    equals a direct ``decode_step`` loop at the same cache; the decode call
    (``engine.step_sentinel``) and the paged branch each see one input
    signature over the run.  Prints tok/s and the ``[profile]`` row of a
    decode call, paged and "off" (launches, device ms, idle share)."""
    from repro_torch.models import transformer as T
    from repro_torch.obs import shapemon
    from repro_torch.serve.engine import ServeEngine
    cfg = _attn_cfg()
    grid = _page_grid(cfg, ATTN_CACHE)
    check(grid is not None and grid[1] < grid[0],
          f"paged_decode='auto' does not page at cache {ATTN_CACHE}")
    model = T.init_params(cfg, seed=0, device=DEVICE)
    warm = ServeEngine(cfg, model, n_slots=N_SLOTS, cache_len=ATTN_CACHE,
                       device=DEVICE)
    list(warm.generate(_requests(cfg)[:1]))
    del warm
    torch.cuda.empty_cache()
    engine = ServeEngine(cfg, model, n_slots=N_SLOTS, cache_len=ATTN_CACHE,
                         device=DEVICE)
    check(engine.paged_kv is not None, "the engine built no paged KV cache")
    report = engine.paged_kv.report()
    row = report["groups"][0]
    log(f"[serve-attn-paged] {cfg.name}, {N_SLOTS} slots, cache "
        f"{ATTN_CACHE}: paged KV report {json.dumps(report)}")
    check(row["paged"] and (row["n_pages"], row["pages_touched_per_step"])
          == grid, f"paged KV report {row} != the page grid {grid}")
    requests = _requests(cfg)
    _reset_counts()
    shapemon.reset("models.paged_decode")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    streams = {}
    for rid, tok in engine.generate(requests):
        streams.setdefault(rid, []).append(tok)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = _read_counts()
    calls = engine.decode_calls
    _measured("serve_attn_paged", cfg, "decode", N_SLOTS, ATTN_CACHE,
              dt * 1e3 / calls)
    sigs = {"serve.masked_step": engine.step_sentinel.count,
            "models.paged_decode": shapemon.trace_count(
                "models.paged_decode")}
    n_tok = sum(len(v) for v in streams.values())
    want = _counts(**{B1: 3 * cfg.n_layers * calls})
    log(f"[serve-attn-paged] {len(streams)} requests, {n_tok} new tokens, "
        f"{calls} decode calls in {dt:.3f}s: {n_tok / dt:.1f} tok/s, "
        f"{dt * 1e3 / calls:.3f} ms a call (host clock, synchronised); "
        f"launches {launches}, expected {want} ({3 * cfg.n_layers} {B1} and "
        f"no {B5} a call); input signatures {sigs}; {smi}")
    check(sorted(streams) == list(range(N_REQUESTS)) and all(
        len(v) == NEW_TOKENS for v in streams.values()),
        "paged serving: requests missing or short")
    check(launches == want and calls > 0,
          f"paged serving launch counts {launches} != {want}")
    check(sigs == {"serve.masked_step": 1, "models.paged_decode": 1},
          f"paged serving saw input signatures {sigs}; want one each")
    del engine
    torch.cuda.empty_cache()
    with torch.inference_mode():
        oracle = _greedy_oracle(cfg, model, requests[0].prompt, NEW_TOKENS,
                                ATTN_CACHE)
    log(f"[serve-attn-paged] request 0: engine {streams[0]}; decode_step "
        f"loop {oracle}")
    check(streams[0] == oracle, "paged engine stream != decode_step loop")
    torch.cuda.empty_cache()
    profiles = {mode: _serve_profile(_attn_cfg(paged_decode=mode), model,
                                     ATTN_CACHE) for mode in ("auto", "off")}
    for mode, prof_row in profiles.items():
        log(f"[serve-attn-paged-profile] " + json.dumps(
            {"paged_decode": mode, "cache_len": ATTN_CACHE, "card": smi,
             **prof_row}))
    return model, launches, {"tok_s": n_tok / dt, "decode_calls": calls,
                             "signatures": sigs, "profile": {
                                 mode: {k: r.get(k) for k in (
                                     "kernel_launches_per_call",
                                     "wall_ms_per_call",
                                     "device_ms_per_call",
                                     "device_idle_share")}
                                 for mode, r in profiles.items()}}


def paged_vs_full_phase():
    """smat-attn-1.3b in float32 at full width, 2 layers: ``_paged_decode``
    over the mask's page table equals, bit for bit, the same call over the
    full page table (every page in every row, all live) at positions
    PAGED_POSITIONS, batch 4, cache ATTN_CACHE (the pin the JAX package
    holds inside itself); and a 2-layer engine with ``paged_decode="force"``
    emits the same greedy tokens as one with "off" (8 requests)."""
    from repro_torch.models import attention as A
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import ServeEngine
    cfg = dataclasses.replace(_attn_cfg(paged_decode="force"), n_layers=2,
                              dtype="float32")
    h, w = cfg.attn_sparsity.block
    pages, live = A.decode_page_tensors(L._sparse_mask(cfg, None),
                                        ATTN_CACHE, (h, w), DEVICE)
    n_pages = ATTN_CACHE // w
    full = torch.arange(n_pages, device=DEVICE).expand(pages.shape[0], -1)
    full = full.contiguous()
    g = torch.Generator(device=DEVICE).manual_seed(0)
    B, H, KV, dh = N_SLOTS, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = torch.randn((B, 1, H, dh), generator=g, device=DEVICE)
    kc, vc = (torch.randn((B, ATTN_CACHE, KV, dh), generator=g,
                          device=DEVICE) for _ in range(2))
    worst = []
    for pos in PAGED_POSITIONS:
        got = L._paged_decode(cfg, q, kc, vc, pos, None, None, dh ** -0.5,
                              pages=pages, live=live)
        ref = L._paged_decode(cfg, q, kc, vc, pos, None, None, dh ** -0.5,
                              pages=full, live=torch.ones_like(full,
                                                               dtype=bool))
        worst.append((pos, bool(torch.equal(got, ref)),
                      (got - ref).abs().max().item(),
                      bool(torch.isfinite(got).all())))
    log(f"[paged-vs-full] float32, batch {B}, cache {ATTN_CACHE}: table "
        f"{tuple(pages.shape)} against the full {n_pages}-page table, "
        f"(position, bitwise equal, max|diff|, finite): {worst}")
    check(all(eq and fin for _, eq, _, fin in worst),
          "paged decode != the full-table fold")
    del q, kc, vc
    model = T.init_params(cfg, seed=0, device=DEVICE)
    streams = {}
    for mode in ("force", "off"):
        engine = ServeEngine(dataclasses.replace(
            cfg, attn_sparsity=dataclasses.replace(
                cfg.attn_sparsity, paged_decode=mode)), model,
            n_slots=N_SLOTS, cache_len=ATTN_CACHE, device=DEVICE)
        check((engine.paged_kv.report()["groups"][0]["paged"]) ==
              (mode == "force"), f"paged_decode={mode} paged wrongly")
        streams[mode] = {}
        for rid, tok in engine.generate(_requests(cfg)):
            streams[mode].setdefault(rid, []).append(tok)
        del engine
    same = sum(streams["force"][r] == streams["off"][r]
               for r in range(N_REQUESTS))
    log(f"[paged-vs-full] 2-layer float32 engine, cache {ATTN_CACHE}: "
        f"'force' and 'off' give equal greedy streams for {same}/"
        f"{N_REQUESTS} requests; request 0 {streams['force'][0]}")
    check(streams["force"] == streams["off"],
          "paged and dense-bias engines emit different tokens")
    del model
    torch.cuda.empty_cache()


OBS_NAMES = ("serve.step", "serve.admit", "train.step", "ops.dispatch",
             "autotune.pick")


def obs_phase(model):
    """The observability layer on the card: the 8-request serving run of
    smat-attn-1.3b (``model``, cache CACHE_LEN) with tracing off and under
    ``trace.capture()`` (wall time of each printed, no bound), then one
    training step of a 2-layer full-width smat-attn-1.3b (1 x 1024 tokens;
    its attention backward resolves ``backend="auto"``) under capture.
    Prints each event name and its count; the serving and training events
    OBS_NAMES must all be there."""
    from repro_torch.configs.base import ShapeCell
    from repro_torch.obs import trace
    from repro_torch.optim import adamw
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.train import loop
    cfg = _attn_cfg()
    walls = {}
    for mode in ("off", "capture"):
        engine = ServeEngine(cfg, model, n_slots=N_SLOTS,
                             cache_len=CACHE_LEN, device=DEVICE)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if mode == "off":
            check(not trace.enabled(), "tracing is on (REPRO_TRACE set?)")
            n_tok = len(list(engine.generate(_requests(cfg))))
        else:
            with trace.capture() as cap:
                n_tok = len(list(engine.generate(_requests(cfg))))
        torch.cuda.synchronize()
        walls[mode] = (time.perf_counter() - t0, n_tok, engine.decode_calls)
        del engine
    serve_events = cap.events
    cfg2 = dataclasses.replace(cfg, n_layers=2)
    with trace.capture() as cap_train:
        res = loop.train(cfg2, ShapeCell("chip", "train", 1024, 1),
                         device=DEVICE, total_steps=1,
                         opt_cfg=adamw.AdamWConfig(total_steps=1))
    counts = {}
    for e in serve_events + cap_train.events:
        counts[e.name] = counts.get(e.name, 0) + 1
    log(f"[obs] serving run, {walls['off'][1]} tokens in "
        f"{walls['off'][2]} decode calls: {walls['off'][0] * 1e3:.3f} ms "
        f"with tracing off, {walls['capture'][0] * 1e3:.3f} ms under "
        f"trace.capture() ({len(serve_events)} records); one training step "
        f"(2 layers, 1 x 1024, loss {res.losses[0]:.5f}): "
        f"{len(cap_train.events)} records")
    log(f"[obs] event counts {json.dumps(dict(sorted(counts.items())))}")
    missing = [n for n in OBS_NAMES if n not in counts]
    check(not missing and walls["off"][1] == walls["capture"][1],
          f"[obs] events missing: {missing}")
    torch.cuda.empty_cache()
    return {"serve_ms_off": walls["off"][0] * 1e3,
            "serve_ms_capture": walls["capture"][0] * 1e3}


def _attn_train_counts(cfg, per_step_b5):
    """Launches per training step of smat-attn-1.3b, derived from the code:
    the FFN as in ``[train]`` (B1 forward and dB, B2 dvals), B5 forward,
    and the B5 backward's composed path per layer, each product one launch
    over all the layer's heads: two SDDMMs (scores recomputed, d(probs))
    and two SpMMs (context recomputed, dQ) on the kernels
    ``backend="auto"`` resolves for the mask, and two B1 launches over the
    transpose structure (dV, dK)."""
    from repro_torch.kernels import ops
    from repro_torch.models import attention as A
    sp = cfg.attn_sparsity
    meta = A.attention_mask_meta(sp.mask, ATTN_SEQ, tuple(sp.block))
    sddmm = {"nnz_stream": B2, "row_loop": B4}[ops.resolve_backend(
        "auto", None, meta, cfg.head_dim, op="sddmm", device=DEVICE)[0]]
    spmm = {"nnz_stream": B1, "row_loop": B3}[ops.resolve_backend(
        "auto", None, meta, cfg.head_dim, op="spmm", device=DEVICE)[0]]
    per_layer = {sddmm: 2, spmm: 2}
    per_layer[B1] = per_layer.get(B1, 0) + 2
    counts = {B5: per_step_b5, B1: 6 * cfg.n_layers, B2: 3 * cfg.n_layers}
    for name, n in per_layer.items():
        counts[name] = counts.get(name, 0) + n * cfg.n_layers
    return _counts(**counts), (sddmm, spmm)


# the attention training step while B5's backward looped over the heads
# (one launch a head and product), recorded by this script before the
# instance axis on NVIDIA H100 80GB HBM3, 700.00 W; constants, not measured
# by a run of this version
ATTN_TRAIN_PER_HEAD = {"step_ms": (2735.0, 3020.0), "peak_gb": 38.81}


def train_attn_phase(smi):
    """ATTN_TRAIN_STEPS AdamW steps of 1 x 8192 tokens of smat-attn-1.3b at
    full width, bf16, no remat, through ``train.loop.train``: finite losses,
    exact launch counts per step (``_attn_train_counts``), step ms,
    tokens/s and peak memory, beside the per-head loop's
    (``ATTN_TRAIN_PER_HEAD``)."""
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
    _measured("train_attn", cfg, "train", 1, ATTN_SEQ, step_ms)
    want = {n: c * ATTN_TRAIN_STEPS for n, c in per_step.items()}
    log(f"[train-attn] {cfg.name} full width, 1 x {ATTN_SEQ} tokens, bf16, "
        f"remat none, AdamW: losses {res.losses}; step ms "
        f"{[round(1e3 * t, 3) for t in res.step_times]}; steady "
        f"{step_ms:.3f} ms = {ATTN_SEQ / step_ms * 1e3:.1f} tokens/s; peak "
        f"memory {peak:.2f} GB (recorded earlier, not measured in this run: "
        f"the per-head loop's steady "
        f"{ATTN_TRAIN_PER_HEAD['step_ms'][0]:.0f}-"
        f"{ATTN_TRAIN_PER_HEAD['step_ms'][1]:.0f} ms, peak "
        f"{ATTN_TRAIN_PER_HEAD['peak_gb']:.2f} GB); {smi}")
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


# ------------------------------------- the partitioned SpMM path (A5)
DIST_SHARDS = (1, 2, 4, 8)
DIST_N = (N_SLOTS, TRAIN_N)            # decode and training widths
DIST_CHUNKS = (1, 2, 4)
SHARDED_S = 4                          # [serve-sharded], [train-sharded]


def _ffn_spec(**kw):
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("smat-ffn-1.3b").ffn_sparsity,
                               **kw)


def _ffn_pattern(name, j=0):
    """Host BCSR of layer ``j``'s ``gate`` (``gate_up`` shape) or ``down``
    weight of smat-ffn-1.3b, as ``init_mlp`` draws it."""
    from repro_torch.core import sparse_linear as SL
    from repro_torch.models import layers as L
    (out_dim, in_dim), _ = FULL_WIDTH[name]
    seed = L.mlp_seed(j) + (0 if name == "gate_up" else 2)
    return SL._pattern_for(seed, in_dim, out_dim, _ffn_spec())


def _ffn_sharded(a, n_shards, dtype):
    """The partition ``SparsitySpec(shards=n_shards)`` builds of ``a``:
    the dims-only per-shard budgets (``shard_shapes``), as the model."""
    from repro_torch.core import sparse_linear as SL
    from repro_torch.launch import dist_spmm
    out_dim, in_dim = a.shape
    rps, nnzb_ps, _ = SL.shard_shapes(_ffn_spec(), out_dim, in_dim,
                                      n_shards=n_shards)
    return dist_spmm.prepare_sharded(a, n_shards, rows_per_shard=rps,
                                     nnzb_per_shard=nnzb_ps, dtype=dtype,
                                     device=DEVICE)


def _family(counts):
    """(spmm family B1 + B3, sddmm family B2 + B4) of a launch count."""
    return counts[B1] + counts[B3], counts[B2] + counts[B4]


def _op_ok(got, want):
    """The op rule of a sharded product against the unsharded one: bf16
    rtol = atol = 1e-2 (about one ulp), f32 1e-4."""
    tol = 1e-2 if got.dtype == torch.bfloat16 else 1e-4
    return torch.allclose(got.float(), want.float(), rtol=tol, atol=tol)


def _sharded_grads(arrays, smeta, b, backend, n_chunks, weight):
    """(out, dvals, dB) of one in-process sharded product with the fixed
    cotangent ``weight``."""
    from repro_torch.launch import dist_spmm
    vals = arrays.vals.detach().clone().requires_grad_()
    bb = b.detach().clone().requires_grad_()
    out = dist_spmm.spmm_sharded(arrays._replace(vals=vals), smeta, bb,
                                 backend=backend, n_chunks=n_chunks)
    out.backward(weight.to(out.dtype))
    return out.detach(), vals.grad, bb.grad


def dist_parity_phase():
    """The partitioned product on the card at the full-width FFN shapes
    (seed-0 layer patterns, the model's dims-only budgets), S in {1, 2, 4,
    8}, bf16 and f32, N = 4 and 2048 (the x^T view), backends
    ``nnz_stream``, ``row_loop`` and ``auto``: the in-process
    ``spmm_sharded`` against the unsharded ``ops.spmm`` (bf16 1e-2, f32
    1e-4; whether the bits agree is printed), each shard's kernel against
    its plain version on the shard's operands (as ``[parity]``), and
    chunked (``n_chunks`` 1, 2, 4) == unchunked bit for bit in the forward
    and in the gradients of ``vals`` and B.  Then a ``split_heavy_rows``
    operand with a block-row split in three: against the unsharded product
    (a combine with a fragment dropped or doubled must fail that rule) and
    bit-stable over two runs, forward and gradients."""
    from repro_torch.core import bcsr as B
    from repro_torch.kernels import ops, ref
    from repro_torch.launch import dist_spmm
    worst = {}
    for name in FULL_WIDTH:
        a = _ffn_pattern(name)
        for dtype in (torch.bfloat16, torch.float32):
            arrays0, meta0 = ops.prepare(a, dtype, device=DEVICE)
            for S in DIST_SHARDS:
                arrays, smeta = _ffn_sharded(a, S, dtype)
                blocks = S * smeta.nnzb_per_shard
                for n in DIST_N:
                    b = _b(n, a.shape[1], n, dtype, transposed=True)
                    weight = torch.from_numpy(np.random.default_rng(n)
                                              .standard_normal(
                        (a.shape[0], n)).astype(np.float32)).to(DEVICE)
                    want = ops.spmm(arrays0, meta0, b)
                    for backend in ("nnz_stream", "row_loop", "auto"):
                        picks = dist_spmm._resolve_shard_choices(
                            smeta, n, backend, None, DEVICE)
                        base = _sharded_grads(arrays, smeta, b, backend, 1,
                                              weight)
                        ok = _op_ok(base[0], want)
                        bits = torch.equal(base[0], want)
                        err = (base[0].float() - want.float()).abs().max() \
                            .item()
                        # each shard's kernel against its plain version
                        vals_ext = dist_spmm._vals_ext(arrays.vals)
                        run = dist_spmm._Run(smeta, (), 1)
                        shard_err = 0.0
                        for s, (be, bn) in enumerate(picks):
                            arr = run._shard(arrays, s, vals_ext)
                            m = smeta.shard_metas[s]
                            got_s = ops._fwd_impl(ops.SpmmConfig(be, bn),
                                                  m, arr, b)
                            plain = ref.bcsr_spmm_row_loop_ref(
                                arr.vals, arr.flat_idx, arr.flat_col,
                                arr.row_len, b, m.n_block_rows,
                                out_dtype=torch.float32) \
                                if be == "row_loop" else ref.bcsr_spmm_ref(
                                arr.vals, arr.row_ids, arr.col_ids, b,
                                m.n_block_rows, out_dtype=torch.float32)
                            ok = ok and _op_ok(got_s, plain)
                            shard_err = max(shard_err, (
                                got_s.float() - plain).abs().max().item())
                        chunk_bits = True
                        for k in DIST_CHUNKS[1:]:
                            got = _sharded_grads(arrays, smeta, b, backend,
                                                 k, weight)
                            chunk_bits = chunk_bits and all(
                                torch.equal(g, w) for g, w in zip(got, base))
                        ok = ok and chunk_bits and bool(
                            torch.isfinite(base[1].float()).all())
                        key = (name, str(dtype)[6:], S, n, backend)
                        worst[key] = err
                        log(f"[dist-parity] {name} {str(dtype)[6:]} S={S} "
                            f"N={n} {backend}: picks "
                            f"{sorted(set(picks))}; {blocks} blocks "
                            f"streamed (unsharded {meta0.nnzb}); vs "
                            f"unsharded max|err|={err:.3g} bits equal "
                            f"{bits}; shards vs plain max|err|="
                            f"{shard_err:.3g}; chunked {DIST_CHUNKS[1:]} == "
                            f"unchunked (fwd, dvals, dB) bitwise "
                            f"{chunk_bits} {'ok' if ok else 'FAIL'}")
                        check(ok, f"[dist-parity] {key} failed")
                    del b, weight
                del arrays
            del arrays0
            torch.cuda.empty_cache()
    # a block-row of 60 blocks over 4 shards: cap ceil(90 / 4) = 23, so it
    # splits in three fragments of 20 (split_dst repeats its rows twice)
    dense = np.zeros((16 * 128, 64 * 128), np.float32)
    rng = np.random.default_rng(11)
    dense[::128, ::4096] = 1.0
    dense[128:256, :60 * 128] = rng.standard_normal((128, 60 * 128))
    a = B.from_dense(dense, (128, 128))
    for dtype in (torch.bfloat16, torch.float32):
        arrays, smeta = dist_spmm.prepare_sharded(
            a, 4, split_heavy_rows=True, dtype=dtype, device=DEVICE)
        arrays0, meta0 = ops.prepare(a, dtype, device=DEVICE)
        b = _b(3, a.shape[1], 64, dtype, transposed=True)
        weight = torch.ones((a.shape[0], 64), device=DEVICE)
        first = _sharded_grads(arrays, smeta, b, "nnz_stream", 2, weight)
        again = _sharded_grads(arrays, smeta, b, "nnz_stream", 2, weight)
        stable = all(torch.equal(g, w) for g, w in zip(first, again))
        # against the unsharded product: f32 rtol = atol = 1e-4; bf16
        # 2e-2 x max|product| -- each fragment's partial sum is rounded to
        # bf16 before the fragments are added (as in the JAX package), so
        # where they cancel the error is an ulp of the partials, not of
        # the sum
        want = ops.spmm(arrays0, meta0, b, out_dtype=torch.float32)
        scale = want.abs().max().item()

        def close(out):
            if dtype == torch.float32:
                return torch.allclose(out.float(), want, rtol=1e-4,
                                      atol=1e-4)
            return (out.float() - want).abs().max().item() <= 2e-2 * scale

        rule = ("rtol = atol = 1e-4" if dtype == torch.float32
                else f"2e-2 x {scale:.4g}")
        err = (first[0].float() - want).abs().max().item()
        # planted faults in the combine, which the rule must reject: the
        # second extra fragment of every split row dropped, and the first
        # added twice
        dst = arrays.split_dst.cpu().numpy()
        firsts = torch.as_tensor(np.sort(np.unique(dst, return_index=True)[1]),
                                 device=DEVICE)
        src1, dst1 = arrays.split_src[firsts], arrays.split_dst[firsts]
        planted = {}
        for fault, (src, dst_) in {
                "dropped": (src1, dst1),
                "doubled": (torch.cat([arrays.split_src, src1]),
                            torch.cat([arrays.split_dst, dst1]))}.items():
            bad = dist_spmm.spmm_sharded(
                arrays._replace(split_src=src, split_dst=dst_), smeta, b,
                backend="nnz_stream", n_chunks=2)
            planted[fault] = ((bad.float() - want).abs().max().item(),
                              close(bad))
        ok = (stable and close(first[0]) and smeta.n_split_fragments == 2
              and not any(caught for _, caught in planted.values()))
        log(f"[dist-parity] split_heavy_rows {str(dtype)[6:]}: "
            f"{smeta.n_split_fragments} extra fragments, vs unsharded "
            f"max|err|={err:.3g} ({rule}; max|product| {scale:.4g}); "
            f"planted faults max|err| " + ", ".join(
                f"{f} {e:.3g} ({'passes: FAIL' if c else 'rejected'})"
                for f, (e, c) in planted.items()) +
            f"; bit-stable over two runs (fwd, dvals, dB) {stable} "
            f"{'ok' if ok else 'FAIL'}")
        check(ok, "[dist-parity] split rows disagree or are not stable")
    torch.cuda.empty_cache()
    return worst


def dist_timing_phase(smi):
    """ms and launches a product of the in-process partitioned product at
    S in {1, 2, 4, 8} against the unsharded B1 (``ops.spmm``), bf16, at
    N = 4 and 2048 over ROTATE layers' weights (L2 cold as in
    ``[timing]``): device ms (``time_ms``: a CUDA graph of the calls) and
    the eager ms with the host's issue cost.  Then ``tune_shard_count``
    on the gate/up shape at N = 2048 (``max_shards`` 8): its measured
    winner beside the analytic pick."""
    from repro_torch.kernels import autotune, ops
    from repro_torch.launch import dist_spmm
    dtype = torch.bfloat16
    rows = {}
    for name, (shape, nnzb) in FULL_WIDTH.items():
        pats = [_ffn_pattern(name, j) for j in range(ROTATE)]
        flat = [ops.prepare(a, dtype, device=DEVICE) for a in pats]
        for n in DIST_N:
            bs = [_b(j, shape[1], n, dtype, transposed=True)
                  for j in range(ROTATE)]
            bnd, bnd_by = bound(nnzb, 128, 128, shape[1], n,
                                shape[0] // 128, dtype)
            fns = [lambda a_=a_, m=m, b=b: ops.spmm(a_, m, b)
                   for (a_, m), b in zip(flat, bs)]
            row = {"case": f"{name} N={n}", "card": smi,
                   "unsharded_ms": time_ms(fns),
                   "unsharded_eager_ms": time_ms_eager(fns),
                   "bound_ms": bnd, "bound_by": bnd_by}
            for S in DIST_SHARDS:
                shd = [_ffn_sharded(a, S, dtype) for a in pats]
                fns = [lambda s_=s_, b=b: dist_spmm.spmm_sharded(
                    s_[0], s_[1], b, backend="nnz_stream",
                    n_chunks=_ffn_spec().shard_chunks)
                       for s_, b in zip(shd, bs)]
                _reset_counts()
                fns[0]()
                launches = _read_counts()[B1]
                row[f"S{S}"] = {"ms": time_ms(fns),
                                "eager_ms": time_ms_eager(fns),
                                "launches": launches,
                                "blocks": S * shd[0][1].nnzb_per_shard}
                del shd
            log("[dist-timing] " + json.dumps(row))
            rows[(name, n)] = row
            del bs
            torch.cuda.empty_cache()
        del flat
    a = _ffn_pattern("gate_up")
    meta = ops.prepare_sparse_meta(a)
    analytic = autotune.analytic_shard_choice(meta, TRAIN_N, max_shards=8)
    measured = dist_spmm.tune_shard_count(
        a, TRAIN_N, max_shards=8, backend="nnz_stream", dtype=dtype,
        iters=5, tuner=autotune.Autotuner(), device=DEVICE)
    log(f"[dist-timing] tune_shard_count gate/up N={TRAIN_N} max_shards 8: "
        f"measured winner S={measured.n_shards} "
        f"({measured.predicted_us:.1f} us); analytic pick "
        f"S={analytic.n_shards} ({analytic.predicted_us:.1f} us "
        f"predicted); {smi}")
    rows["tune"] = {"measured": measured.n_shards,
                    "analytic": analytic.n_shards}
    torch.cuda.empty_cache()
    return rows


def _sharded_cfg(cfg, n_shards=SHARDED_S, **kw):
    return dataclasses.replace(cfg, ffn_sparsity=dataclasses.replace(
        cfg.ffn_sparsity, shards=n_shards, backend="auto", **kw))


def _first_logits(cfg, model):
    """Logits of the first decode step of 4 prompts (``[model]``'s)."""
    from repro_torch.models import transformer as T
    cache = T.init_cache(cfg, N_SLOTS, CACHE_LEN, device=DEVICE)
    toks = torch.as_tensor([r.prompt[0] for r in _requests(cfg)[:N_SLOTS]],
                           device=DEVICE).long()
    return T.decode_step(cfg, model, cache, toks, 0)[0].float()


def serve_sharded_phase(cfg, model0, smi):
    """``smat-ffn-1.3b`` at full width and depth with
    ``SparsitySpec(shards=4, backend="auto")`` and the default
    ``shard_chunks=2`` (same seed: the same weights as ``model0``), served
    through ``ServeEngine`` as ``[main]``: tok/s; exactly 24 x 3 x 4 x 2 =
    576 spmm-family launches (B1 + B3) and nothing else a decode call;
    engine == ``decode_step`` loop; the first decode step's logits against
    the unsharded model within max(2e-2, 2 x the plain path's noise, FFN
    ``dense`` against ``xla`` on the unsharded model); the per-shard picks;
    and a ``torch.profiler`` row of a decode call."""
    from repro_torch.launch import dist_spmm
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import ServeEngine
    cfg_s = _sharded_cfg(cfg)
    t0 = time.perf_counter()
    model = T.init_params(cfg_s, seed=0, device=DEVICE)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    metas = L.mlp_sparse_metas(cfg_s.ffn_sparsity, cfg.d_model, cfg.d_ff,
                               (0,), torch.device(DEVICE))
    for label, m in zip(("gate/up", "down"), metas):
        picks = dist_spmm._resolve_shard_choices(m, N_SLOTS, "auto", None,
                                                 DEVICE)
        log(f"[serve-sharded] {label}: S={m.n_shards}, {m.rows_per_shard} "
            f"block-rows and {m.nnzb_per_shard} entries a shard, per-shard "
            f"max_bpr {[sm.max_bpr for sm in m.shard_metas]}; picks at "
            f"N={N_SLOTS}: {list(picks)}")
    warm = ServeEngine(cfg_s, model, n_slots=N_SLOTS, cache_len=CACHE_LEN,
                       device=DEVICE)
    list(warm.generate(_requests(cfg)[:1]))
    engine = ServeEngine(cfg_s, model, n_slots=N_SLOTS, cache_len=CACHE_LEN,
                         device=DEVICE)
    requests = _requests(cfg)
    _reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    streams = {}
    for rid, tok in engine.generate(requests):
        streams.setdefault(rid, []).append(tok)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = _read_counts()
    _measured("serve_sharded", cfg_s, "decode", N_SLOTS, CACHE_LEN,
              dt * 1e3 / engine.decode_calls)
    n_tok = sum(len(v) for v in streams.values())
    per_call = 3 * cfg.n_layers * SHARDED_S * cfg_s.ffn_sparsity.shard_chunks
    spmm_n, sddmm_n = _family(launches)
    log(f"[serve-sharded] built in {build_s:.1f}s; {len(streams)} requests, "
        f"{n_tok} new tokens, {engine.decode_calls} decode calls in "
        f"{dt:.3f}s: {n_tok / dt:.1f} tok/s, {dt * 1e3 / engine.decode_calls:.3f}"
        f" ms a call (host clock, synchronised); launches {launches}: "
        f"{spmm_n} spmm-family, expected {per_call} a call x "
        f"{engine.decode_calls}; {smi}")
    check(sorted(streams) == list(range(N_REQUESTS)) and all(
        len(v) == NEW_TOKENS for v in streams.values()),
        "sharded serving: requests missing or short")
    check(spmm_n == per_call * engine.decode_calls > 0 and sddmm_n == 0 and
          launches[B5] == 0, f"sharded serving launch counts {launches}")
    with torch.inference_mode():
        oracle = _greedy_oracle(cfg_s, model, requests[0].prompt, NEW_TOKENS)
        got = _first_logits(cfg_s, model)
        want = _first_logits(cfg, model0)
        noise = (_first_logits(_with_backend(cfg, "dense"), model0) -
                 _first_logits(_with_backend(cfg, "xla"), model0)).abs() \
            .max().item()
    check(streams[0] == oracle, "sharded engine stream != decode_step loop")
    err = (got - want).abs().max().item()
    tol = max(2e-2, 2 * noise)
    ok = bool(torch.isfinite(got).all()) and err <= tol
    log(f"[serve-sharded] request 0: engine {streams[0]}; decode_step loop "
        f"{oracle}; first-step logits vs the unsharded model: max|dlogit|="
        f"{err:.4g}, plain's own noise {noise:.4g}, tolerance {tol:.4g}, "
        f"same argmax in {(got.argmax(-1) == want.argmax(-1)).sum().item()}"
        f"/{N_SLOTS} rows {'ok' if ok else 'FAIL'}")
    check(ok, "sharded model logits disagree with the unsharded model's")
    calls = engine.decode_calls
    del warm, engine
    row = _serve_profile(cfg_s, model, CACHE_LEN)
    log("[serve-sharded-profile] " + json.dumps({"card": smi, **row}))
    del model
    torch.cuda.empty_cache()
    return launches, {"tok_s": n_tok / dt, "ms_per_call": dt * 1e3 / calls,
                      "profile": row}


def train_sharded_phase(cfg, smi, losses_nnz):
    """TRAIN_STEPS full-width AdamW steps of 2 x 1024 tokens with
    ``SparsitySpec(shards=4, backend="auto")`` through ``train.loop.train``:
    ms a step, tokens/s, the losses beside ``[train]``'s; per step exactly
    576 spmm-family launches forward (24 x 3 x 4 shards x 2 chunks) + 288
    for dB (B1), and 288 sddmm-family (dvals): the backward re-runs no
    forward product.  A ``torch.profiler`` row of one step; then one
    2-layer f32 step, sharded against unsharded from the same weights:
    loss rtol 1e-5, every gradient within 1e-4 x its max|grad|."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.base import ShapeCell
    from repro_torch.data.pipeline import make_batch
    from repro_torch.launch import steps as st
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw
    from repro_torch.train import loop
    cfg_s = _sharded_cfg(cfg)
    shape = ShapeCell("chip", "train", TRAIN_SEQ, TRAIN_BATCH)
    opt_cfg = adamw.AdamWConfig(total_steps=TRAIN_STEPS)
    _reset_counts()
    torch.cuda.reset_peak_memory_stats()
    res = loop.train(cfg_s, shape, device=DEVICE, total_steps=TRAIN_STEPS,
                     opt_cfg=opt_cfg, remat="none")
    torch.cuda.synchronize()
    launches = _read_counts()
    steady = res.step_times[1:]
    step_ms = 1e3 * sum(steady) / len(steady)
    _measured("train_sharded", cfg_s, "train", TRAIN_BATCH, TRAIN_SEQ,
              step_ms)
    per_layer = 3 * SHARDED_S
    want_spmm = (per_layer * cfg_s.ffn_sparsity.shard_chunks + per_layer) * \
        cfg.n_layers * TRAIN_STEPS
    want_sddmm = per_layer * cfg.n_layers * TRAIN_STEPS
    spmm_n, sddmm_n = _family(launches)
    diffs = [abs(x - y) for x, y in zip(res.losses, losses_nnz)]
    log(f"[train-sharded] losses {res.losses}; [train]'s {losses_nnz}; "
        f"max|diff| {max(diffs):.3g}")
    log(f"[train-sharded] step ms {[round(1e3 * t, 3) for t in res.step_times]}"
        f"; steady {step_ms:.3f} ms = {TRAIN_N / step_ms * 1e3:.1f} tokens/s; "
        f"peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB; "
        f"launches {launches}: spmm-family {spmm_n} (expected {want_spmm}), "
        f"sddmm-family {sddmm_n} (expected {want_sddmm}); {smi}")
    check(res.final_step == TRAIN_STEPS and all(np.isfinite(res.losses)),
          "sharded training did not finish with finite losses")
    check(spmm_n == want_spmm and sddmm_n == want_sddmm and
          launches[B5] == 0, f"sharded training launch counts {launches}")

    model = T.init_params(cfg_s, seed=0, device=DEVICE)
    opt_state = adamw.init(dict(model.named_parameters()))
    batch = loop.batch_to_device(make_batch(cfg_s, shape, 0), DEVICE)
    step = st.make_train_step(cfg_s, opt_cfg, remat="none")
    model, opt_state, _ = step(model, opt_state, batch)      # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model, opt_state, metrics = step(model, opt_state, batch)
        float(metrics["loss"])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    row = {"train_steps": 1, "card": smi,
           **_profile_summary(prof, wall_ms, 1, "step")}
    log("[train-sharded-profile] " + json.dumps(row))
    del model, opt_state, prof

    cfg32 = dataclasses.replace(cfg, n_layers=2, dtype="float32")
    out = {}
    for label, c in (("sharded", _sharded_cfg(cfg32)), ("unsharded", cfg32)):
        m = T.init_params(c, seed=0, device=DEVICE)
        loss, _ = T.train_loss(c, m, batch, remat="none")
        loss.backward()
        out[label] = (float(loss.detach()), {
            n: p.grad.clone() for n, p in m.named_parameters()})
        del m
    (loss_s, g_s), (loss_u, g_u) = out["sharded"], out["unsharded"]
    worst = max(((g_s[n] - g).abs().max().item() /
                 max(g.abs().max().item(), 1e-30), n) for n, g in g_u.items())
    ok = abs(loss_s - loss_u) <= 1e-5 * abs(loss_u) and worst[0] <= 1e-4 \
        and set(g_s) == set(g_u)
    log(f"[train-sharded] f32 2-layer full width, sharded vs unsharded: loss "
        f"{loss_s:.7f} vs {loss_u:.7f} (rtol 1e-5); worst gradient "
        f"max|diff|/max|grad| = {worst[0]:.3g} at {worst[1]} (tolerance "
        f"1e-4) {'ok' if ok else 'FAIL'}")
    check(ok, "f32 sharded training step disagrees with the unsharded one")
    del batch, out
    torch.cuda.empty_cache()
    return launches, {"step_ms": step_ms,
                      "tokens_per_s": TRAIN_N / step_ms * 1e3,
                      "losses": res.losses, "profile": row}


def prefill_attn_sharded_phase(smi):
    """smat-attn-1.3b at full width and depth with
    ``AttnSparsitySpec(shards=4)`` (always composed): one 8,192-token
    prefill, exactly 24 x 16 x 4 = 1,536 context products on the
    spmm-family kernels (one a head and shard; plus the FFN's 72 B1) and 24
    score SDDMMs (one a layer over its 16 heads); its
    last-position logits against the ``shards=0`` composed prefill (the
    same kernels, unpartitioned) within max(2e-2, 2 x that path's own
    noise: FFN ``dense`` against ``nnz_stream``)."""
    from repro_torch.launch import steps as st
    from repro_torch.models import attention as A
    from repro_torch.models import transformer as T
    cfg = _attn_cfg(shards=4)
    check(A.resolve_attn_impl(cfg.attn_sparsity, ATTN_SEQ, cfg.head_dim,
                              device=DEVICE) == "composed",
          "shards > 0 must run the composed path")
    model = T.init_params(cfg, seed=0, device=DEVICE)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(1, ATTN_SEQ))).to(DEVICE)
    t0 = time.perf_counter()
    A.mask_sharded(cfg.attn_sparsity.mask, ATTN_SEQ,
                   tuple(cfg.attn_sparsity.block), 4, DEVICE)
    part_s = time.perf_counter() - t0
    prefill = st.make_prefill_step(cfg, ATTN_SEQ)
    prefill(model, {"tokens": tokens})                 # first-call set-up
    torch.cuda.synchronize()
    _reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    logits = prefill(model, {"tokens": tokens})[0].float()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = _read_counts()
    _measured("prefill_attn_sharded", cfg, "prefill", 1, ATTN_SEQ, dt * 1e3)
    spmm_n, sddmm_n = _family(counts)
    want_spmm = cfg.n_layers * cfg.n_heads * 4 + 3 * cfg.n_layers
    want_sddmm = cfg.n_layers
    refs = {}
    for ffn in ("nnz_stream", "dense"):
        c = dataclasses.replace(_attn_cfg(backend="nnz_stream"),
                                ffn_sparsity=dataclasses.replace(
                                    cfg.ffn_sparsity, backend=ffn))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        refs[ffn] = st.make_prefill_step(c, ATTN_SEQ)(
            model, {"tokens": tokens})[0].float()
        torch.cuda.synchronize()
        if ffn == "nnz_stream":
            dt0 = time.perf_counter() - t0
    err = (logits - refs["nnz_stream"]).abs().max().item()
    noise = (refs["dense"] - refs["nnz_stream"]).abs().max().item()
    tol = max(2e-2, 2 * noise)
    ok = bool(torch.isfinite(logits).all()) and err <= tol and \
        spmm_n == want_spmm and sddmm_n == want_sddmm and counts[B5] == 0
    log(f"[prefill-attn-sharded] 1 x {ATTN_SEQ} tokens, shards=4 (mask "
        f"partition built in {part_s:.2f}s): {dt * 1e3:.3f} ms (host clock, "
        f"synchronised; the shards=0 composed prefill {dt0 * 1e3:.3f} ms); "
        f"launches {counts}: spmm-family {spmm_n} (expected "
        f"{want_spmm}), sddmm-family {sddmm_n} (expected {want_sddmm}); "
        f"logits vs the shards=0 composed prefill max|dlogit|={err:.4g}, "
        f"its own noise {noise:.4g}, tolerance {tol:.4g} "
        f"{'ok' if ok else 'FAIL'}; {smi}")
    check(ok, "[prefill-attn-sharded] failed")
    del model, refs
    torch.cuda.empty_cache()
    return counts, {"prefill_ms": dt * 1e3, "unsharded_ms": dt0 * 1e3}


@contextlib.contextmanager
def _one_rank_nccl():
    """A one-rank ``nccl`` process group on the card (any free local port;
    ``gloo`` when a rehearsal sets DEVICE to the CPU), destroyed on the way
    out."""
    import socket

    import torch.distributed as dist
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    if DEVICE == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group("nccl" if DEVICE == "cuda" else "gloo",
                            init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    try:
        yield
    finally:
        dist.destroy_process_group()


def dist_mesh_phase():
    """A one-rank ``nccl`` group on the card: ``spmm_sharded`` through a
    ``(1,)`` ``"spmm"`` mesh, bit for bit equal to the in-process S = 1
    run (forward and both gradients), at the gate/up shape in bf16, N =
    64.  This runs the collectives' code path on the card; the multi-rank
    mode is held on the CPU (``tests/test_torch_dist_mesh.py``)."""
    from repro_torch.launch import dist_spmm
    with _one_rank_nccl():
        mesh = dist_spmm.make_spmm_mesh(1)
        a = _ffn_pattern("gate_up")
        arrays, smeta = _ffn_sharded(a, 1, torch.bfloat16)
        b = _b(5, a.shape[1], 64, torch.bfloat16, transposed=True)
        weight = torch.ones((a.shape[0], 64), device=DEVICE)
        local = _sharded_grads(arrays, smeta, b, "auto", 2, weight)
        vals = arrays.vals.detach().clone().requires_grad_()
        bb = b.detach().clone().requires_grad_()
        with dist_spmm.use_spmm_mesh(mesh):
            out = dist_spmm.spmm_sharded(
                arrays._replace(vals=vals), smeta, bb, backend="auto",
                mesh=dist_spmm.current_spmm_mesh(), n_chunks=2)
        out.backward(weight.to(out.dtype))
        same = [torch.equal(g, w) for g, w in
                zip((out.detach(), vals.grad, bb.grad), local)]
        log(f"[dist-mesh] one-rank nccl mesh {mesh}: forward, dvals, dB "
            f"bitwise equal to in-process {same} "
            f"{'ok' if all(same) else 'FAIL'}")
        check(all(same), "[dist-mesh] mesh mode differs from in-process")


def _first_difference(cfg, shape, mesh, opt_cfg):
    """``(step, parameter)`` of the first difference between the plain
    step and the mesh step, run side by side from the same weights on the
    same batches (None if every parameter stays bit-equal)."""
    from repro_torch.data.pipeline import make_batch
    from repro_torch.launch import sharding as sh
    from repro_torch.launch import steps as st
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw
    from repro_torch.train import loop
    model = T.init_params(cfg, seed=0, device=DEVICE)
    opt = adamw.init(dict(model.named_parameters()))
    sharded = st.shard_model(T.init_params(cfg, seed=0, device=DEVICE), mesh)
    sharded_opt = st.init_opt_state(sharded)
    b_specs = sh.batch_shardings(mesh, st.input_specs(cfg, shape))
    plain_step = st.make_train_step(cfg, opt_cfg, remat="none")
    mesh_step = st.make_train_step(cfg, opt_cfg, remat="none", mesh=mesh)
    for step in range(TRAIN_STEPS):
        batch = loop.batch_to_device(make_batch(cfg, shape, step), DEVICE)
        model, opt, _ = plain_step(model, opt, batch)
        sharded, sharded_opt, _ = mesh_step(
            sharded, sharded_opt, sh.distribute_tree(mesh, batch, b_specs))
        for name, p in model.named_parameters():
            if not torch.equal(p, sh.full(sharded.shards[name])):
                return step, name
    return None


def train_mesh_phase(cfg, smi, trained):
    """The training mesh (A11) on the card: a one-rank ``nccl`` group, a
    ``(data, model) = (1, 1)`` mesh, and ``smat-ffn-1.3b`` at full width
    and depth through ``train.loop.train(cfg, shape, mesh)``: TRAIN_STEPS
    steps of 2 x 1024 tokens, bf16, ``nnz_stream``, the batches and seed of
    ``[train]``.  Parameters and AdamW state are ``DTensor``s under the
    sharding rules; a step gathers them, so the gathered parameters sit
    beside the stored ones.  Every collective of one rank is an identity:
    the losses must equal ``[train]``'s bit for bit (otherwise the phase
    steps both paths side by side and names the first step and parameter
    that differ), with ``[train]``'s 144 B1 and 72 B2 launches a step.  ms
    a step and peak memory beside ``[train]``'s.  At ``:smoke`` size: a
    checkpoint written on the mesh is byte-identical to one written without
    it, and restores onto the mesh (``mesh=``, ``specs=``), is saved again
    and restores bit-equal; ``ef_compress_grads`` over the one-rank group on a
    card tensor equals the same function on the CPU (a one-rank ``gloo``
    group) bit for bit."""
    import tempfile

    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeCell
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import sharding as sh
    from repro_torch.launch import steps as st
    from repro_torch.launch.constrain import use_mesh
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw, compress
    from repro_torch.train import loop

    shape = ShapeCell("chip", "train", TRAIN_SEQ, TRAIN_BATCH)
    opt_cfg = adamw.AdamWConfig(total_steps=TRAIN_STEPS)
    with _one_rank_nccl():
        mesh = mesh_lib.make_mesh((1, 1), ("data", "model"),
                                  device_type=DEVICE)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        t0 = time.perf_counter()
        res = loop.train(cfg, shape, mesh, total_steps=TRAIN_STEPS,
                         opt_cfg=opt_cfg, remat="none")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _read_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        steady = res.step_times[1:]
        step_ms = 1e3 * sum(steady) / len(steady)
        _measured("train_mesh", cfg, "train", TRAIN_BATCH, TRAIN_SEQ,
                  step_ms)
        want = {name: n * cfg.n_layers * TRAIN_STEPS
                for name, n in _counts(**{B1: 6, B2: 3}).items()}
        same = res.losses == trained["losses"]
        log(f"[train-mesh] {cfg.name} full width on a one-rank nccl mesh "
            f"{mesh_lib.axis_sizes(mesh)}: losses {res.losses}; [train]'s "
            f"{trained['losses']}; bit-equal {same}")
        log(f"[train-mesh] step ms {[round(1e3 * t, 3) for t in res.step_times]}"
            f"; steady {step_ms:.3f} ms = {TRAIN_N / step_ms * 1e3:.1f} "
            f"tokens/s ([train] {trained['step_ms']:.3f} ms); peak memory "
            f"{peak_gb:.2f} GB ([train] {trained['peak_gb']:.2f} GB); "
            f"{wall:.1f}s with model build; launches {launches}, expected "
            f"{want}; {smi}")
        if not same:
            log(f"[train-mesh] first (step, parameter) that differs: "
                f"{_first_difference(cfg, shape, mesh, opt_cfg)}")
        check(res.final_step == TRAIN_STEPS and same,
              "[train-mesh] losses differ from [train]'s")
        check(launches == want,
              f"[train-mesh] launch counts {launches} != {want}")

        smoke = get_config("smat-ffn-1.3b:smoke")
        small = ShapeCell("t", "train", 32, 2)
        kw = dict(total_steps=2, ckpt_every=2, opt_cfg=adamw.AdamWConfig(
            lr=1e-3, total_steps=2, warmup_steps=1))
        with tempfile.TemporaryDirectory() as tmp:
            loop.train(smoke, small, mesh, ckpt_dir=f"{tmp}/mesh", **kw)
            loop.train(smoke, small, device=DEVICE, ckpt_dir=f"{tmp}/plain",
                       **kw)
            written = {d: [(Path(tmp) / d / "step_00000002" / f).read_bytes()
                           for f in ("arrays.npz", "manifest.json")]
                       for d in ("mesh", "plain")}
            model = st.shard_model(T.init_params(smoke, seed=0,
                                                 device=DEVICE), mesh)
            opt = st.init_opt_state(model)
            like = {"params": model.state_dict(), "opt": opt}
            specs = st.state_specs(model, opt)
            mgr = CheckpointManager(f"{tmp}/mesh", async_save=False)
            state, step = mgr.restore(like, mesh=mesh, specs=specs)
            mgr.save(step + 1, state)
            again, _ = mgr.restore(like, step=step + 1, mesh=mesh,
                                   specs=specs)
            a, b = dict(_leaves(state)), dict(_leaves(again))
            restored = (sorted(a) == sorted(b) and all(
                type(b[k]) is type(v) and b[k].dtype == v.dtype and
                torch.equal(sh.full(b[k]), sh.full(v)) for k, v in a.items())
                and hasattr(state["params"]["embed"], "full_tensor"))
        bytes_equal = written["mesh"] == written["plain"]
        log(f"[train-mesh] smoke checkpoint at step 2: written on the mesh "
            f"== written without it, byte for byte: {bytes_equal}; restored "
            f"onto the mesh as DTensors, re-saved and restored bit-equal "
            f"over {len(a)} tensors: {restored}")
        check(bytes_equal and restored, "[train-mesh] checkpoint on the "
              "mesh is not mesh-agnostic or does not restore bit-equal")

        rng = np.random.default_rng(5)
        grads = {"w": torch.from_numpy(rng.standard_normal(
                     (2048, 512)).astype(np.float32)),
                 "b": torch.from_numpy(rng.standard_normal(
                     8192).astype(np.float32)).to(torch.bfloat16)}
        out = {}
        cpu_mesh = DeviceMesh.from_group(dist.new_group([0], backend="gloo"),
                                         "cpu", mesh_dim_names=("data",))
        card_mesh = mesh_lib.make_mesh((1,), ("data",), device_type=DEVICE)
        for label, m, dev in (("card", card_mesh, DEVICE),
                              ("cpu", cpu_mesh, "cpu")):
            g = {k: v.to(dev) for k, v in grads.items()}
            with use_mesh(m):
                r = compress.init_residual(g)
                for _ in range(2):           # the second step carries r
                    g_hat, r = compress.ef_compress_grads(g, r, "data")
            out[label] = {**{"g_hat/" + k: v.cpu() for k, v in g_hat.items()},
                          **{"r/" + k: v.cpu() for k, v in r.items()}}
        equal = all(torch.equal(out["card"][k], v)
                    for k, v in out["cpu"].items())
        log(f"[train-mesh] ef_compress_grads, 2 steps over the one-rank "
            f"group: card == CPU bit for bit over {len(out['cpu'])} "
            f"tensors: {equal}")
        check(equal, "[train-mesh] gradient compression differs on the card")
    torch.cuda.empty_cache()
    return launches, {"step_ms": step_ms, "peak_gb": peak_gb,
                      "losses": res.losses}


# ------------------------------------------- the MLA/MoE and SSD layouts
MOE_ARCH, SSD_ARCH = "deepseek-v2-lite-16b", "mamba2-1.3b"
# the 16.21 B-parameter model does not fit AdamW on one card: [moe-train]
# keeps its full width at 2 of its 27 layers (1.59 B parameters)
MOE_TRAIN_LAYERS, MOE_TRAIN_STEPS = 2, 3
SSD_TRAIN_STEPS = 5
# [ssd-train]'s remat: without it the step's peak memory reads 69.5 GB on
# an H100 80GB HBM3 (700 W) alone and 71.3 GB after this script's earlier
# phases (1.9 GB still allocated), past the 70 GB line above which "full"
# is taken; the phase logs the memory allocated before it and its peak
SSD_TRAIN_REMAT = "full"
MODEL_CHECK_LEN = {MOE_ARCH: 16, SSD_ARCH: 512}   # [*-model] tokens a row


def layout_serve_phase(arch, tag, smi):
    """``arch`` at full width with seed-0 weights drawn on the card, served
    through ``ServeEngine`` (N_SLOTS slots, N_REQUESTS requests of
    PROMPT_LEN + NEW_TOKENS tokens, as ``[main]``): tok/s, ms a decode
    call, peak memory, and a ``torch.profiler`` row (launches a call, the
    device's idle share).  Every request's stream must equal a
    ``decode_step`` loop's with the request in the slot the engine gave it,
    and the B1-B5 counters must read 0 (no TPU kernel on this path)."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import ServeEngine

    cfg = get_config(arch)
    before_gb = torch.cuda.memory_allocated() / 1e9
    t0 = time.perf_counter()
    model = T.init_params(cfg, seed=0, device=DEVICE)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[{tag}] {cfg.name}: layout {cfg.layout}, {cfg.n_layers} layers, "
        f"d_model {cfg.d_model}, vocab {cfg.vocab_size}, {cfg.dtype}, "
        f"{n_params / 1e9:.3f} B parameters "
        f"({cfg.param_count() / 1e9:.3f} B by param_count); built in "
        f"{time.perf_counter() - t0:.1f}s, "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB on the card "
        f"({before_gb:.2f} GB allocated before the phase)")
    warm = ServeEngine(cfg, model, n_slots=N_SLOTS, cache_len=CACHE_LEN,
                       device=DEVICE)
    list(warm.generate(_requests(cfg)[:1]))   # first-call set-up, untimed
    del warm

    engine = ServeEngine(cfg, model, n_slots=N_SLOTS, cache_len=CACHE_LEN,
                         device=DEVICE)
    requests = _requests(cfg)
    _reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    streams = {}
    for rid, tok in engine.generate(requests):
        streams.setdefault(rid, []).append(tok)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = _read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    calls = engine.decode_calls
    ms_call = dt * 1e3 / calls
    _measured(tag, cfg, "decode", N_SLOTS, CACHE_LEN, ms_call)
    n_tok = sum(len(v) for v in streams.values())
    prefix = engine.scheduler.config.prefix_cache
    log(f"[{tag}] {len(streams)} requests, {n_tok} new tokens, "
        f"{calls} decode calls in {dt:.3f}s: "
        f"{n_tok / dt:.1f} tok/s, {ms_call:.3f} ms a decode call (host "
        f"clock, synchronised; {N_SLOTS} slots, prompt {PROMPT_LEN}, new "
        f"{NEW_TOKENS}); peak memory {peak_gb:.2f} GB; prefix reuse "
        f"{prefix} ({engine.scheduler.prefix_hits} hits); kernel launches "
        f"{launches}; {smi}")
    check(sorted(streams) == list(range(N_REQUESTS)), f"[{tag}] requests "
          "missing")
    check(all(len(v) == NEW_TOKENS for v in streams.values()),
          f"[{tag}] a request got the wrong number of tokens")
    check(all(np.all((0 <= np.asarray(t)) & (np.asarray(t) < cfg.vocab_size))
              and np.shape(t) == _cb_row(cfg)
              for v in streams.values() for t in v),
          f"[{tag}] a token outside the vocabulary or of the wrong shape")
    check(launches == _counts(), f"[{tag}] a B1-B5 kernel launched on a "
          f"path that has none: {launches}")
    # the Mamba2 state is not indexed by position: no prefix reuse there
    check(prefix == (cfg.layout not in ("ssd", "zamba")),
          f"[{tag}] prefix reuse {prefix} for layout {cfg.layout}")
    slot_of = {r["rid"]: r["slot"] for r in engine.scheduler.trace
               if r["event"] == "admit"}
    with torch.inference_mode():
        same = {rid: _greedy_oracle(cfg, model, requests[rid].prompt,
                                    NEW_TOKENS, row=slot_of[rid]) ==
                _tok_list(streams[rid]) for rid in streams}
    log(f"[{tag}] request 0: engine {_tok_list(streams[0])}")
    log(f"[{tag}] engine == decode_step loop (request in its engine slot "
        f"{slot_of}): {same}")
    check(all(same.values()), f"[{tag}] engine stream != decode_step loop")
    del engine
    prof = _serve_profile(cfg, model, CACHE_LEN)
    log(f"[{tag}-profile] " + json.dumps({"card": smi, **prof}))
    del model
    torch.cuda.empty_cache()
    return {"tok_s": n_tok / dt, "ms_per_call": ms_call, "peak_gb": peak_gb,
            "decode_calls": calls, "params": n_params, "profile": prof,
            "launches": launches}


@contextlib.contextmanager
def _recorded_routes():
    """Record the top-k expert indices of every ``moe._route`` call (a
    test-side wrapper around the module function, restored after)."""
    from repro_torch.models import moe as M
    seen, orig = [], M._route

    def rec(cfg, p, xt):
        out = orig(cfg, p, xt)
        seen.append(out[1].cpu())
        return out
    M._route = rec
    try:
        yield seen
    finally:
        M._route = orig


def layout_model_phase(arch, tag, cut=None, patches=0):
    """A float32 copy of ``arch`` at full width, cut to ``cut`` (config
    fields; default 2 layers deep), with the same weights on the card and
    on the CPU (TF32 off): the forward's logits within 1e-4 x max|CPU
    logit| (MoE: the routing indices equal), then on the card the
    prefill's logits against a token-by-token decode loop's, within the
    same bound.  With ``patches`` > 0 (``tokens+patches``) that many patch
    embeddings go in front of the tokens, and the decode loop starts from
    a prefill of the patches and the first token.  The MoE copy takes
    capacity_factor = E / k, so that C = L + 1 and no (token, slot) drops
    in the prefill: a drop is a prefill-only event (decode routes one
    token a row), and would make the two differ by design."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(get_config(arch), dtype="float32",
                              **(cut or {"n_layers": 2}))
    if cfg.layout == "mla_moe":
        cfg = dataclasses.replace(
            cfg, capacity_factor=cfg.n_experts / cfg.moe_top_k)
    L_ = MODEL_CHECK_LEN.get(arch, 16)
    # a ring at least as long as the prompt: a longer prefill keeps the
    # reference's ring layout, which decode does not read back (C7)
    cache_len = max(CACHE_LEN, patches + L_)
    model = T.init_params(cfg, seed=0, device=DEVICE)
    cpu = T.Transformer(cfg, device="cpu")
    cpu.load_state_dict(model.state_dict())
    rng = np.random.default_rng(1)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (2, L_) + _cb_row(cfg)))
    batch = {"tokens": tokens}
    if patches:
        batch["patch_embeds"] = torch.from_numpy(rng.standard_normal(
            (2, patches, cfg.d_model)).astype(np.float32))

    def on_card(b):
        return {k: v.to(DEVICE) for k, v in b.items()}
    with torch.inference_mode():
        with _recorded_routes() as r_card:
            card, _, aux_card = model(on_card(batch))
        with _recorded_routes() as r_cpu:
            ref, _, aux_cpu = cpu(batch)
        del cpu
        scale = ref.abs().max().item()
        err = (card.float().cpu() - ref).abs().max().item()
        routes_equal = len(r_card) == len(r_cpu) and all(
            torch.equal(a, b) for a, b in zip(r_card, r_cpu))
        logits, cache = T.prefill(cfg, model, on_card(batch), cache_len)
        if patches:
            # the patches and the first token, then token by token
            first, cache = T.prefill(cfg, model, on_card(
                dict(batch, tokens=tokens[:, :1])), cache_len)
            steps, logits = [first[:, -1]], logits[:, patches:]
        else:
            cache = T.init_cache(cfg, 2, cache_len, device=DEVICE)
            steps = []
        for j in range(len(steps), L_):
            step, cache = T.decode_step(cfg, model, cache,
                                        tokens[:, j].to(DEVICE),
                                        patches + j)
            steps.append(step)
        dec = torch.stack(steps, dim=1)
        err_dec = (dec - logits).abs().max().item()
    tol = 1e-4 * scale
    what = ", ".join(f"{k}={v}" for k, v in (cut or {"n_layers": 2}).items())
    log(f"[{tag}] {cfg.name} f32 at full width ({what}), 2 x {L_} tokens"
        f"{f' after {patches} patch embeddings' if patches else ''}, "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}: card "
        f"vs CPU max|dlogit| {err:.4g} (limit 1e-4 x {scale:.4g} = "
        f"{tol:.4g}); aux card {float(aux_card):.6g} CPU "
        f"{float(aux_cpu):.6g}; routing indices equal: {routes_equal} "
        f"({len(r_card)} route calls); prefill vs token-by-token decode "
        f"max|dlogit| {err_dec:.4g}")
    check(bool(torch.isfinite(card).all()), f"[{tag}] non-finite logits")
    check(err <= tol, f"[{tag}] card and CPU logits differ by {err}")
    check(routes_equal, f"[{tag}] the card routes tokens otherwise than the "
          "CPU")
    check(err_dec <= tol, f"[{tag}] prefill and decode differ by {err_dec}")
    del model, cache
    torch.cuda.empty_cache()
    return {"card_vs_cpu": err, "prefill_vs_decode": err_dec, "scale": scale}


def layout_train_phase(arch, tag, smi, cut, steps, remat,
                       seq=TRAIN_SEQ, batch=TRAIN_BATCH):
    """``arch`` at full width (cut to ``cut``, config fields, when given)
    trained for ``steps`` AdamW steps of ``batch`` x ``seq`` positions in
    bf16 through ``train.loop.train``: losses and MoE aux losses (finite),
    steady step ms, peak memory; no B1-B5 launch."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeCell
    from repro_torch.optim import adamw
    from repro_torch.train import loop

    cfg = dataclasses.replace(get_config(arch), **(cut or {}))
    shape = ShapeCell("chip", "train", seq, batch)
    n_tok = seq * batch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before_gb = torch.cuda.memory_allocated() / 1e9
    _reset_counts()
    t0 = time.perf_counter()
    res = loop.train(cfg, shape, device=DEVICE, total_steps=steps,
                     opt_cfg=adamw.AdamWConfig(total_steps=steps),
                     remat=remat)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    steady = res.step_times[1:]
    step_ms = 1e3 * sum(steady) / len(steady)
    _measured(tag, cfg, "train", batch, seq, step_ms)
    what = ", ".join(f"{k}={v}" for k, v in (cut or {}).items()) or \
        "full depth"
    log(f"[{tag}] {cfg.name} full width ({what}), {cfg.n_layers} layers "
        f"({cfg.param_count() / 1e9:.3f} B parameters), {batch} x "
        f"{seq} positions a step, {cfg.dtype}, remat {remat}, AdamW: "
        f"losses {res.losses}; aux losses {res.aux_losses}")
    log(f"[{tag}] step ms {[round(1e3 * t, 3) for t in res.step_times]}; "
        f"steady {step_ms:.3f} ms = {n_tok / step_ms * 1e3:.1f} positions/s; "
        f"{wall:.1f}s with model build; peak memory {peak_gb:.2f} GB "
        f"({before_gb:.2f} GB allocated before the phase); kernel launches "
        f"{launches}; {smi}")
    check(res.final_step == steps and len(res.losses) == steps,
          f"[{tag}] training did not reach its end")
    check(all(np.isfinite(res.losses)) and all(np.isfinite(res.aux_losses)),
          f"[{tag}] a loss is not finite")
    check((min(res.aux_losses) > 0) == (cfg.layout == "mla_moe"),
          f"[{tag}] aux losses {res.aux_losses} for layout {cfg.layout}")
    check(launches == _counts(), f"[{tag}] a B1-B5 kernel launched: "
          f"{launches}")
    torch.cuda.empty_cache()
    return {"step_ms": step_ms, "tokens_per_s": n_tok / step_ms * 1e3,
            "peak_gb": peak_gb, "losses": res.losses,
            "aux_losses": res.aux_losses, "remat": remat,
            "launches": launches}


# ------------- the gemma_pair, zamba, codebooks and tokens+patches families
GEMMA_ARCH, HYBRID_ARCH = "gemma2-27b", "zamba2-7b"
AUDIO_ARCH, VLM_ARCH = "musicgen-medium", "pixtral-12b"
DENSE_ARCHS = ("h2o-danube-1.8b", "minitron-4b", "qwen2.5-14b")
# gemma2-27b (28.41 B parameters) does not fit AdamW on one card: its
# [gemma-model] and [gemma-train] keep one pair (2 of its 46 layers)
GEMMA_CUT, GEMMA_TRAIN_STEPS = {"n_layers": 2}, 3
# zamba2-7b's AdamW state alone would take about 69 GB: [hybrid-train]
# keeps 2 of its 13 units (and the tail of 3); [hybrid-model] 1 unit of 2
# Mamba2 layers and a tail of 1, with the shared block.  n_layers counts
# as the config does: units x (unit_len + the shared block) + tail
HYBRID_TRAIN_CUT = {"hybrid_n_units": 2, "n_layers": 2 * 6 + 3}
HYBRID_TRAIN_STEPS = 3
HYBRID_MODEL_CUT = {"hybrid_n_units": 1, "hybrid_unit_len": 2,
                    "hybrid_tail": 1, "n_layers": 1 * 3 + 1}
AUDIO_TRAIN_STEPS, AUDIO_TRAIN_REMAT = 5, "none"
VLM_TEXT, VLM_DECODE = 1024, 16   # [vlm-prefill]: after 1,024 patches
VLM_TRAIN_SEQ, VLM_TRAIN_STEPS = 2048, 3      # 1,024 patches + 1,024 text
VLM_MODEL_PATCHES = 16            # [vlm-model]'s patch embeddings a row
MODEL_CHECK_LEN[HYBRID_ARCH] = 512           # past one 256-token SSD chunk


def remat_policy_phase(arch, tag, cut):
    """Step 0 of ``arch`` at full width (cut to ``cut``), TRAIN_BATCH x
    TRAIN_SEQ, seed-0 bf16 weights, under each ``remat`` policy: the loss
    must equal ``"none"``'s and every gradient be within 1e-5 x its leaf's
    max |grad| of ``"none"``'s.  Logs each policy's step ms and peak
    memory above what was allocated before its step (the weights, and
    ``"none"``'s gradients kept for the comparison): the expected order
    is full <= names <= dots <= none, and an exception to it is logged
    with its numbers."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeCell
    from repro_torch.data import pipeline
    from repro_torch.models import transformer as T
    from repro_torch.train import loop

    cfg = dataclasses.replace(get_config(arch), **cut)
    model = T.init_params(cfg, seed=0, device=DEVICE)
    batch = loop.batch_to_device(pipeline.make_batch(
        cfg, ShapeCell("chip", "train", TRAIN_SEQ, TRAIN_BATCH), 0), DEVICE)
    _reset_counts()
    rows, ref = {}, None
    for remat in T.REMAT:
        for p in model.parameters():
            p.grad = None
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        loss, _ = T.train_loss(cfg, model, batch, remat=remat)
        loss.backward()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated()
        grads = {n: p.grad for n, p in model.named_parameters()}
        row = {"loss": float(loss.detach()), "ms": ms, "peak_gb": peak / 1e9,
               "above_base_gb": (peak - base) / 1e9}
        if ref is None:
            ref = row["loss"], grads
            row["grad_rel_err"] = 0.0
        else:
            row["grad_rel_err"] = max(
                ((g.float() - ref[1][n].float()).abs().max() /
                 ref[1][n].float().abs().max().clamp_min(1e-30)).item()
                for n, g in grads.items())
        rows[remat] = row
        log(f"[{tag}] remat {remat}: step 0 loss {row['loss']!r}, "
            f"forward + backward {ms:.3f} ms (host clock, synchronised), "
            f"peak {row['peak_gb']:.3f} GB ({row['above_base_gb']:.3f} GB "
            f"above the {base / 1e9:.3f} GB allocated before), gradients "
            f"vs none max rel {row['grad_rel_err']:.3g}")
        del loss, grads
    launches = _read_counts()
    order = ("full", "names", "dots", "none")
    peaks = [rows[r]["above_base_gb"] for r in order]
    log(f"[{tag}] step-0 peak above the allocated base by policy: "
        + ", ".join(f"{r} {rows[r]['above_base_gb']:.3f} GB" for r in order)
        + (" (full <= names <= dots <= none)" if peaks == sorted(peaks)
           else " -- finding: not in the order full <= names <= dots <= "
           "none"))
    check(all(rows[r]["loss"] == rows["none"]["loss"] for r in order),
          f"[{tag}] a remat policy changed the step-0 loss: {rows}")
    check(all(rows[r]["grad_rel_err"] <= 1e-5 for r in order),
          f"[{tag}] a remat policy changed the gradients: {rows}")
    check(launches == _counts(), f"[{tag}] a B1-B5 kernel launched: "
          f"{launches}")
    del model, ref, batch
    torch.cuda.empty_cache()
    return rows


def vlm_prefill_phase(smi, tag="vlm-prefill"):
    """``pixtral-12b`` at full width and depth (seed-0 bf16 weights drawn
    on the card): one prompt of ``patch_tokens`` (1,024) patch embeddings
    and VLM_TEXT tokens through ``T.prefill`` (a warm-up prefill and
    decode step first, then a timed prefill), then VLM_DECODE greedy
    ``decode_step`` calls from the
    prefilled cache: ms of each, peak memory, finite logits, tokens in the
    vocabulary, no B1-B5 launch."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T

    cfg = get_config(VLM_ARCH)
    P = cfg.patch_tokens
    model = T.init_params(cfg, seed=0, device=DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (1, VLM_TEXT),
                                     generator=gen, device=DEVICE),
             "patch_embeds": torch.randn((1, P, cfg.d_model), generator=gen,
                                         device=DEVICE)}
    cache_len = P + VLM_TEXT + VLM_DECODE
    with torch.inference_mode():
        # warm-up: the prefill's and a decode step's first calls (cuBLAS
        # picks its kernels for each new shape)
        logits, cache = T.prefill(cfg, model, batch, cache_len)
        T.decode_step(cfg, model, cache, logits[:, -1].argmax(-1),
                      P + VLM_TEXT)
        del logits, cache
        _reset_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        logits, cache = T.prefill(cfg, model, batch, cache_len)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        _measured(tag, cfg, "prefill", 1, P + VLM_TEXT, prefill_ms)
        finite = bool(torch.isfinite(logits).all())
        tok = logits[:, -1].argmax(-1)
        out = [int(tok)]
        t0 = time.perf_counter()
        for i in range(VLM_DECODE):
            step, cache = T.decode_step(cfg, model, cache, tok,
                                        P + VLM_TEXT + i)
            tok = step.argmax(-1)
            out.append(int(tok))
            finite &= bool(torch.isfinite(step).all())
        decode_ms = (time.perf_counter() - t0) * 1e3 / VLM_DECODE
    launches = _read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"[{tag}] {cfg.name} full width and depth ({cfg.n_layers} layers, "
        f"{cfg.param_count() / 1e9:.3f} B parameters, bf16): prefill of "
        f"{P} patch embeddings + {VLM_TEXT} tokens {prefill_ms:.3f} ms; "
        f"{VLM_DECODE} greedy decode steps {decode_ms:.3f} ms a step (host "
        f"clock, synchronised at the end); peak memory {peak_gb:.2f} GB; "
        f"tokens {out}; kernel launches {launches}; {smi}")
    check(finite, f"[{tag}] non-finite logits")
    check(all(0 <= t < cfg.vocab_size for t in out), f"[{tag}] a token "
          "outside the vocabulary")
    check(launches == _counts(), f"[{tag}] a B1-B5 kernel launched: "
          f"{launches}")
    del model, cache, logits
    torch.cuda.empty_cache()
    return {"prefill_ms": prefill_ms, "decode_ms_per_step": decode_ms,
            "peak_gb": peak_gb, "launches": launches}


def dryrun_phase(smi):
    """The dry-run (``launch.dryrun``, A10) on the card's machine: ``--all``
    at full size (both archs x the four shape cells, no allocation), then
    ``run_cell`` at the batch and length of every path this script timed
    (``MEASURED``).  Each path's roofline time (the analytic work count's
    bound) is printed beside its measured time, with share = roofline /
    measured; a share above 1 means the count is wrong, and fails.  The
    cell's exact argument bytes must not exceed the peak memory its phase
    measured."""
    from repro_torch.configs.base import ShapeCell
    from repro_torch.launch import dryrun
    t0 = time.perf_counter()
    rc = dryrun.main(["--all", "--device", DEVICE])
    log(f"[dryrun] --all at full size: exit {rc} in "
        f"{time.perf_counter() - t0:.1f}s")
    check(rc == 0, f"dryrun --all exited {rc}")
    rows = {}
    for path, m in MEASURED.items():
        cell = ShapeCell(path, m["kind"], m["seq"], m["batch"])
        rec = dryrun.run_cell(m["cfg"], cell, device=DEVICE, remat="none",
                              verbose=False)
        roof = rec["roofline"]
        bound_ms = rec["t_bound_s"] * 1e3
        share = bound_ms / m["ms"]
        args = rec["memory"]["argument_bytes"]
        rows[path] = {"kind": m["kind"], "batch": m["batch"],
                      "seq": m["seq"], "flops": roof["flops_per_device"],
                      "bytes": roof["bytes_per_device"],
                      "bound_ms": bound_ms,
                      "bound_by": roof["bottleneck"],
                      "measured_ms": m["ms"], "share": share,
                      "argument_bytes": args, "peak_bytes": m["peak"]}
        log(f"[dryrun] {path} ({m['cfg'].name}, {m['kind']} {m['batch']} x "
            f"{m['seq']}): flops {roof['flops_per_device']:.4e}, bytes "
            f"{roof['bytes_per_device']:.4e}; roofline {bound_ms:.4f} ms "
            f"({roof['bottleneck']}), measured {m['ms']:.3f} ms, share "
            f"{share:.4f}; argument_bytes {args} <= peak {m['peak']}")
        check(share <= 1, f"[dryrun] {path}: the roofline {bound_ms} ms "
              f"exceeds the measured {m['ms']} ms: the count is wrong")
        check(args <= m["peak"], f"[dryrun] {path}: argument_bytes {args} "
              f"> the measured peak {m['peak']}")
    log("[dryrun] " + json.dumps({"card": smi, "paths": rows}))
    return rows


# the example twins, each in its own process on the card; the training one
# at EXAMPLE_TRAIN_STEPS steps of its default 4 x 128 tokens
EXAMPLE_TRAIN_STEPS = 30
EXAMPLES = (("examples/torch_quickstart.py",),
            ("examples/torch_serve_decode.py",),
            ("examples/torch_train_sparse_lm.py", "--steps",
             str(EXAMPLE_TRAIN_STEPS)))


def examples_phase():
    """Run the three example twins on the card (``--device`` left at its
    default, ``cuda``), all at once, each in a subprocess with ``src`` on
    the path (most of each one's time is its start-up): each must exit 0
    and print ``OK`` last; their output's tail is logged.  Every process
    is ended before the phase returns or fails."""
    import os
    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    t0 = time.perf_counter()
    procs = [(cmd, subprocess.Popen([sys.executable, *cmd], cwd=root,
                                    env=env, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True))
             for cmd in EXAMPLES]
    try:
        for cmd, proc in procs:
            out, err = proc.communicate(timeout=600)
            dt = time.perf_counter() - t0
            lines = out.strip().splitlines()
            for line in lines[-8:]:
                log(f"[examples] {cmd[0]}: {line}")
            log(f"[examples] {' '.join(cmd)}: exit {proc.returncode} "
                f"{dt:.1f}s after the start")
            check(proc.returncode == 0 and lines and lines[-1] == "OK",
                  f"{' '.join(cmd)} failed: {err[-2000:]}")
    finally:
        for _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()


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
    resources, hook_counts = phase(analysis_phase, smi)
    max_err = phase(parity_phase)
    err_b2, err_dx = phase(sddmm_parity_phase)
    err_b3, err_b4 = phase(row_loop_parity_phase)
    err_b5, carve_out_2, mask_s = phase(attn_parity_phase)
    timed = phase(timing_phase, smi)
    timed_train = phase(train_timing_phase, smi)
    timed_prefill = phase(train_timing_phase, smi, PREFILL_N)
    timed_rl = phase(row_loop_timing_phase, smi)
    phase(dist_parity_phase)
    timed_dist = phase(dist_timing_phase, smi)
    timed_attn = phase(attn_timing_phase, smi, mask_s)
    timed_bwd = phase(attn_bwd_timing_phase, smi)
    timed_batched = phase(batched_phase, smi)
    cfg, model, launches, tok_s, stream0 = phase(main_path_phase)
    phase(model_vs_plain_phase, cfg, model)
    phase(profile_phase, cfg, model)
    serve_rl_launches, tok_s_rl = phase(serve_row_loop_phase, cfg, model,
                                        stream0)
    serve_sh_launches, served_sh = phase(serve_sharded_phase, cfg, model,
                                         smi)
    del model
    torch.cuda.empty_cache()
    train_launches, trained = phase(train_phase, cfg, smi)
    train_rl_launches, trained_rl = phase(train_row_loop_phase, cfg, smi,
                                          trained["losses"])
    train_sh_launches, trained_sh = phase(train_sharded_phase, cfg, smi,
                                          trained["losses"])
    train_mesh_launches, trained_mesh = phase(train_mesh_phase, cfg, smi,
                                              trained)
    phase(train_vs_plain_phase, cfg)
    phase(train_row_loop_vs_plain_phase, cfg)
    phase(restart_phase)
    # the MLA/MoE and SSD layouts (no TPU kernel on their paths), before
    # the attention phases, whose cached mask tensors stay on the card
    served_moe = phase(layout_serve_phase, MOE_ARCH, "moe-serve", smi)
    model_moe = phase(layout_model_phase, MOE_ARCH, "moe-model")
    trained_moe = phase(layout_train_phase, MOE_ARCH, "moe-train", smi,
                        {"n_layers": MOE_TRAIN_LAYERS}, MOE_TRAIN_STEPS,
                        "none")
    served_ssd = phase(layout_serve_phase, SSD_ARCH, "ssd-serve", smi)
    model_ssd = phase(layout_model_phase, SSD_ARCH, "ssd-model")
    trained_ssd = phase(layout_train_phase, SSD_ARCH, "ssd-train", smi,
                        None, SSD_TRAIN_STEPS, SSD_TRAIN_REMAT)
    # the gemma_pair, zamba, codebooks and tokens+patches families (no TPU
    # kernel on their paths either); gemma2-27b's 56.8 GB of weights first,
    # every earlier model freed
    served_gemma = phase(layout_serve_phase, GEMMA_ARCH, "gemma-serve", smi)
    model_gemma = phase(layout_model_phase, GEMMA_ARCH, "gemma-model",
                        GEMMA_CUT)
    trained_gemma = phase(layout_train_phase, GEMMA_ARCH, "gemma-train", smi,
                          GEMMA_CUT, GEMMA_TRAIN_STEPS, "none")
    policies = phase(remat_policy_phase, GEMMA_ARCH, "gemma-train",
                     GEMMA_CUT)
    served_hybrid = phase(layout_serve_phase, HYBRID_ARCH, "hybrid-serve",
                          smi)
    model_hybrid = phase(layout_model_phase, HYBRID_ARCH, "hybrid-model",
                         HYBRID_MODEL_CUT)
    trained_hybrid = phase(layout_train_phase, HYBRID_ARCH, "hybrid-train",
                           smi, HYBRID_TRAIN_CUT, HYBRID_TRAIN_STEPS, "none")
    served_audio = phase(layout_serve_phase, AUDIO_ARCH, "audio-serve", smi)
    trained_audio = phase(layout_train_phase, AUDIO_ARCH, "audio-train", smi,
                          None, AUDIO_TRAIN_STEPS, AUDIO_TRAIN_REMAT)
    prefilled_vlm = phase(vlm_prefill_phase, smi)
    model_vlm = phase(layout_model_phase, VLM_ARCH, "vlm-model", None,
                      VLM_MODEL_PATCHES)
    trained_vlm = phase(layout_train_phase, VLM_ARCH, "vlm-train", smi,
                        {"n_layers": 2}, VLM_TRAIN_STEPS, "none",
                        VLM_TRAIN_SEQ)
    model_dense = {a: phase(layout_model_phase, a, "dense-model")
                   for a in DENSE_ARCHS}
    mip1_perm, err_lib, _ = phase(library_phase, smi)
    winners = phase(autotune_phase, mip1_perm, smi)
    prefill_attn_launches, paged_dec_launches, prefilled = phase(
        prefill_attn_phase, smi)
    prefill_sh_launches, prefilled_sh = phase(prefill_attn_sharded_phase,
                                              smi)
    serve_attn_launches, tok_s_attn = phase(serve_attn_phase)
    attn_model, serve_paged_launches, served_paged = phase(
        serve_attn_paged_phase, smi)
    obs_walls = phase(obs_phase, attn_model)
    del attn_model
    torch.cuda.empty_cache()
    phase(paged_vs_full_phase)
    train_attn_launches, trained_attn = phase(train_attn_phase, smi)
    phase(train_attn_vs_plain_phase)
    phase(dist_mesh_phase)
    phase(dryrun_phase, smi)
    phase(examples_phase)

    # a layer runs each kernel twice on the gate/up shape for every once on
    # the down shape: the line's times are that mix, per launch
    def mix(rows, key):
        vals = [rows[s].get(key) for s in ("gate_up", "gate_up", "down")]
        return None if None in vals else sum(vals) / 3
    decode = {s: timed[(s, N_SLOTS)] for s in FULL_WIDTH}
    fwd = {s: timed_train[("fwd", s)] for s in FULL_WIDTH}
    dx = {s: timed_train[("dx", s)] for s in FULL_WIDTH}
    pre_fwd = {s: timed_prefill[("fwd", s)] for s in FULL_WIDTH}
    pre_dx = {s: timed_prefill[("dx", s)] for s in FULL_WIDTH}
    sd = {s: timed_train[("sddmm", s)] for s in FULL_WIDTH}
    rl = {(k, n): {s: timed_rl[(k, s, n)] for s in FULL_WIDTH}
          for k in (B3, B4) for n in (N_SLOTS, TRAIN_N, PREFILL_N)}
    bwd_keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    keys = ("ms", "plain_ms", "bound_ms", "library_ms")
    paths = {"serve": launches, "train": train_launches,
             "serve_row_loop": serve_rl_launches,
             "train_row_loop": train_rl_launches,
             "prefill_attn": prefill_attn_launches,
             "prefill_attn_paged_decode": paged_dec_launches,
             "serve_attn": serve_attn_launches,
             "serve_attn_paged": serve_paged_launches,
             "train_attn": train_attn_launches,
             "serve_sharded": serve_sh_launches,
             "train_sharded": train_sh_launches,
             "train_mesh": train_mesh_launches,
             "prefill_attn_sharded": prefill_sh_launches,
             # the paths without a TPU kernel: 0 launches each
             **{path: r["launches"] for path, r in (
                 ("moe_serve", served_moe), ("moe_train", trained_moe),
                 ("ssd_serve", served_ssd), ("ssd_train", trained_ssd),
                 ("gemma_serve", served_gemma),
                 ("gemma_train", trained_gemma),
                 ("hybrid_serve", served_hybrid),
                 ("hybrid_train", trained_hybrid),
                 ("audio_serve", served_audio),
                 ("audio_train", trained_audio),
                 ("vlm_prefill", prefilled_vlm),
                 ("vlm_train", trained_vlm))}}

    def entry(k, err, rows, **extra):
        by_path = {path: counts[k["name"]] for path, counts in paths.items()}
        return {"name": k["name"], "route": k["route"],
                "source": k["source"], "replaces": k["replaces"],
                "launches": sum(by_path.values()), "max_abs_err": err,
                **{key: mix(rows, key) for key in keys},
                "bound_by": rows["down"]["bound_by"],
                "launches_by_path": by_path, **extra}
    b1, b2, b3, b4, b5 = KERNELS

    # each kernel's [batched] rows: one launch over BATCHED_G instances
    def batched(name):
        return {case: {key: r[key] for key in (
            "G", "launches", *bwd_keys, "singles_ms", "speedup_vs_singles",
            "max_abs_err", "bit_equal_to_singles") if key in r}
            for case, r in timed_batched.items()
            if r["case"].startswith(name + " ")}
    attn_keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                 "composed_ms", "composed_launches",
                 "dense_causal_sdpa_bf16_ms")
    held = [r["max_abs_err"] for key, r in (*timed.items(),
                                            *timed_train.items(),
                                            *timed_prefill.items())
            if "max_abs_err" in r and key[0] != "sddmm"]
    held_b2 = [timed_train[("sddmm", s)]["max_abs_err"] for s in FULL_WIDTH]
    held_b2 += [timed_prefill[("sddmm", s)]["max_abs_err"]
                for s in FULL_WIDTH]
    sd_pre = {s: timed_prefill[("sddmm", s)] for s in FULL_WIDTH}
    # the paged decode path (no kernel of its own: it runs B1 in the FFN):
    # its decode calls, input signatures and launches, paged against "off"
    paged_decode = {
        "serve_attn_paged_decode_calls": served_paged["decode_calls"],
        "serve_attn_paged_signatures": served_paged["signatures"],
        "prefill_attn_decode_steps": ATTN_DECODE,
        "decode_ms_per_step_after_prefill": prefilled["decode_ms_per_step"],
        "serve_profile_per_call": served_paged["profile"]}
    line = {"kernels": [
        entry(b1, max(max_err, err_dx, *held), decode,
              paged_decode=paged_decode,
              sharded_in_process={
                  f"{k[0]} N={k[1]}": v for k, v in timed_dist.items()
                  if k != "tune"},
              train_forward={key: mix(fwd, key) for key in keys},
              train_dB={key: mix(dx, key) for key in keys},
              prefill_forward={key: mix(pre_fwd, key) for key in keys},
              prefill_dB={key: mix(pre_dx, key) for key in keys},
              attn_bwd_f32_context={key: timed_bwd["context"][key]
                                    for key in bwd_keys},
              attn_bwd_f32_dKdV={key: timed_bwd["dK/dV"][key]
                                 for key in bwd_keys},
              batched=batched(B1)),
        entry(b2, max(err_b2, *held_b2), sd, dense_ms=mix(sd, "dense_ms"),
              prefill_width={key: mix(sd_pre, key) for key in keys},
              attn_bwd_f32_scores={key: timed_bwd["scores"][key]
                                   for key in bwd_keys},
              batched=batched(B2)),
        entry(b3, max(err_b3, err_lib), rl[(B3, N_SLOTS)],
              train_forward={key: mix(rl[(B3, TRAIN_N)], key)
                             for key in keys},
              prefill_forward={key: mix(rl[(B3, PREFILL_N)], key)
                               for key in keys},
              batched=batched(B3)),
        entry(b4, max(err_b4, *(rl[(B4, n)][s]["max_abs_err"]
                                for n in (N_SLOTS, TRAIN_N, PREFILL_N)
                                for s in FULL_WIDTH)),
              rl[(B4, TRAIN_N)],
              dense_ms=mix(rl[(B4, TRAIN_N)], "dense_ms"),
              b2_ms=mix(rl[(B4, TRAIN_N)], "b2_ms"),
              decode={key: mix(rl[(B4, N_SLOTS)], key) for key in keys},
              prefill_width={key: mix(rl[(B4, PREFILL_N)], key)
                             for key in (*keys, "b2_ms")},
              attn_bwd_f32_scores={key: timed_bwd["scores row_loop"][key]
                                   for key in bwd_keys},
              batched=batched(B4)),
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
    # each kernel's shared memory, registers and CTAs an SM ([analysis]) at
    # the instantiation of its headline shape, and at its other main paths'
    headline = {B1: "decode", B3: "decode", B2: "train", B4: "train",
                B5: "prefill"}
    for e in line["kernels"]:
        res = resources[e["name"]]
        e.update({key: res[headline[e["name"]]][key]
                  for key in ("smem_bytes", "regs", "ctas_per_sm")},
                 resources_by_shape=res)
    dense_err = {a: r["card_vs_cpu"] for a, r in model_dense.items()}
    log(f"[main] REPRO_VERIFY_LAUNCH=1 hook: {hook_counts} dispatches "
        "checked, outputs bit-equal without it")
    log(f"[main] serving: {tok_s:.1f} tok/s (nnz_stream), {tok_s_rl:.1f} "
        f"tok/s (row_loop); training: {trained['step_ms']:.3f} ms per step, "
        f"{trained['tokens_per_s']:.1f} tokens/s (nnz_stream), "
        f"{trained_rl['step_ms']:.3f} ms, {trained_rl['tokens_per_s']:.1f} "
        f"tokens/s (row_loop); on a one-rank (1, 1) mesh "
        f"{trained_mesh['step_ms']:.3f} ms per step, peak "
        f"{trained_mesh['peak_gb']:.2f} GB ([train] "
        f"{trained['peak_gb']:.2f} GB).  Autotune winners: "
        f"{ {f'{k[0]} {k[1]} N={k[2]}': v for k, v in winners.items()} }.  "
        f"Kernel times per launch: {B1} and {B3} at the decode shape "
        f"(N={N_SLOTS}; train_forward and train_dB at N={TRAIN_N}, "
        f"prefill_* at N={PREFILL_N}, attn_bwd_f32_* one head at "
        f"L={ATTN_SEQ}, N=128; batched: {BATCHED_G} instances a launch), "
        f"{B2} and "
        f"{B4} at N={TRAIN_N} (their prefill_width at N={PREFILL_N}, "
        f"the attention training's FFN); each averaged 2:1 over the gate/up "
        f"and down shapes.  {ATTN_ARCH}: prefill {prefilled['prefill_ms']:.3f} ms "
        f"(1 x {ATTN_SEQ}), {prefilled['prefill_32k_ms']:.3f} ms (1 x "
        f"{ATTN_LONG}, peak {prefilled['prefill_32k_peak_gb']:.2f} GB); "
        f"serving {tok_s_attn:.1f} tok/s (cache {CACHE_LEN}, dense bias), "
        f"{served_paged['tok_s']:.1f} tok/s (cache {ATTN_CACHE}, paged KV); "
        f"serving run with tracing off {obs_walls['serve_ms_off']:.3f} ms, "
        f"under capture {obs_walls['serve_ms_capture']:.3f} ms; training "
        f"{trained_attn['step_ms']:.3f} ms per step, "
        f"{trained_attn['tokens_per_s']:.1f} tokens/s, peak "
        f"{trained_attn['peak_gb']:.2f} GB; {B5} per launch at G={ATTN_G}, "
        f"L={ATTN_SEQ} (at_32768: L={ATTN_LONG}).  Partitioned path "
        f"(S={SHARDED_S}, shard_chunks 2, auto): serving "
        f"{served_sh['tok_s']:.1f} tok/s, training "
        f"{trained_sh['step_ms']:.3f} ms per step, "
        f"{trained_sh['tokens_per_s']:.1f} tokens/s, attention prefill "
        f"{prefilled_sh['prefill_ms']:.3f} ms; tune_shard_count winner "
        f"S={timed_dist['tune']['measured']} (analytic "
        f"S={timed_dist['tune']['analytic']}).  {MOE_ARCH}: serving "
        f"{served_moe['tok_s']:.1f} tok/s, {served_moe['ms_per_call']:.3f} "
        f"ms a decode call, peak {served_moe['peak_gb']:.2f} GB; training "
        f"({MOE_TRAIN_LAYERS} layers) {trained_moe['step_ms']:.3f} ms a "
        f"step, peak {trained_moe['peak_gb']:.2f} GB; f32 card vs CPU "
        f"{model_moe['card_vs_cpu']:.3g}.  {SSD_ARCH}: serving "
        f"{served_ssd['tok_s']:.1f} tok/s, {served_ssd['ms_per_call']:.3f} "
        f"ms a decode call; training {trained_ssd['step_ms']:.3f} ms a step "
        f"(remat {trained_ssd['remat']}), peak {trained_ssd['peak_gb']:.2f} "
        f"GB; f32 card vs CPU {model_ssd['card_vs_cpu']:.3g}.  {GEMMA_ARCH}: "
        f"serving {served_gemma['tok_s']:.1f} tok/s, "
        f"{served_gemma['ms_per_call']:.3f} ms a decode call, peak "
        f"{served_gemma['peak_gb']:.2f} GB; training (1 pair) "
        f"{trained_gemma['step_ms']:.3f} ms a step, peak "
        f"{trained_gemma['peak_gb']:.2f} GB; step-0 peaks above the base "
        f"by remat "
        f"{ {r: round(v['above_base_gb'], 3) for r, v in policies.items()} }"
        f" GB; "
        f"f32 card vs CPU {model_gemma['card_vs_cpu']:.3g}.  {HYBRID_ARCH}: "
        f"serving {served_hybrid['tok_s']:.1f} tok/s, "
        f"{served_hybrid['ms_per_call']:.3f} ms a decode call; training (2 "
        f"units) {trained_hybrid['step_ms']:.3f} ms a step; f32 card vs CPU "
        f"{model_hybrid['card_vs_cpu']:.3g}.  {AUDIO_ARCH}: serving "
        f"{served_audio['tok_s']:.1f} tok/s (codebook rows), training "
        f"{trained_audio['step_ms']:.3f} ms a step (remat "
        f"{trained_audio['remat']}), peak {trained_audio['peak_gb']:.2f} GB."
        f"  {VLM_ARCH}: prefill {prefilled_vlm['prefill_ms']:.3f} ms, "
        f"decode {prefilled_vlm['decode_ms_per_step']:.3f} ms a step; "
        f"training (2 layers) {trained_vlm['step_ms']:.3f} ms a step; f32 "
        f"card vs CPU {model_vlm['card_vs_cpu']:.3g}; dense f32 card vs CPU "
        f"{dense_err}; whole run "
        f"{time.perf_counter() - t_start:.1f}s")
    print(json.dumps(line))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()

"""Host C kernel of the packed-bitmask Jaccard row clustering.

The numpy path in ``core.permute`` amortizes the greedy scan into
vectorized rounds; this module compiles (once, at first use, with the
system C compiler, into ``build/repro_torch/`` at the root of the checkout)
a ~40-line C function that runs the EXACT reference algorithm --
``reorder.jaccard_rows`` semantics bit for bit -- over the same packed
uint64 bitmasks.  It runs on the host, not on the card: the reorder is a
one-time preprocessing step.

Without a C compiler every entry point returns ``None`` and callers take
the numpy rounds (same tau/max_candidates meaning, marginally different
greedy tie-walking), as the JAX package's ``repro.core.native`` does.  The
same switch pins both packages: ``REPRO_NO_NATIVE_JACCARD=1`` forces the
numpy rounds.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

from repro_torch.kernels import _build as kbuild

_SRC = r"""
#include <stdint.h>

/* Greedy Jaccard row clustering over packed block-column bitmasks.
   Inputs are in scan order (rows pre-sorted by first block-column):
     packed [n*W] uint64, pop [n] int64.
   Exact `reorder.jaccard_rows` semantics: open a cluster at the first
   unclustered row, scan the (at most max_candidates) unclustered rows
   after it in order, join when 1 - inter/union < tau with the union
   growing as rows join.  Writes the position permutation to perm. */
long jaccard_cluster(const uint64_t* packed, const int64_t* pop,
                     long n, long W, double tau, long max_candidates,
                     uint64_t* pc, unsigned char* clustered, long* perm)
{
    long out = 0;
    long start = 0;
    while (start < n) {
        while (start < n && clustered[start]) start++;
        if (start >= n) break;
        long seed = start;
        clustered[seed] = 1;
        perm[out++] = seed;
        int64_t pc_pop = pop[seed];
        for (long w = 0; w < W; ++w) pc[w] = packed[seed * W + w];
        long scanned = 0;
        for (long c = seed + 1; c < n; ++c) {
            if (clustered[c]) continue;
            if (max_candidates >= 0 && ++scanned > max_candidates) break;
            const uint64_t* row = packed + c * W;
            int64_t inter = 0;
            for (long w = 0; w < W; ++w)
                inter += (int64_t)__builtin_popcountll(row[w] & pc[w]);
            int64_t uni = pop[c] + pc_pop - inter;
            double dist = (uni == 0) ? 0.0
                                     : 1.0 - (double)inter / (double)uni;
            if (dist < tau) {
                clustered[c] = 1;
                perm[out++] = c;
                pc_pop = 0;
                for (long w = 0; w < W; ++w) {
                    pc[w] |= row[w];
                    pc_pop += (int64_t)__builtin_popcountll(pc[w]);
                }
            }
        }
    }
    return out;
}
"""

_lib: Optional[ctypes.CDLL] = None
_tried = False


def _cflags() -> list:
    """The compile flags: the kernel needs only the popcount instruction,
    which every x86-64 CPU this code targets has, so the library is built
    for the ISA and not for the host (no ``-march=native``)."""
    flags = ["-O3", "-shared", "-fPIC"]
    if platform.machine() in ("x86_64", "AMD64"):
        flags.append("-mpopcnt")
    return flags


def library_path() -> Path:
    """The library's file: its tag hashes the source, the flags and the
    machine type, so a tree copied to another kind of host rebuilds it."""
    ident = "\0".join([_SRC, *_cflags(), platform.machine()])
    tag = hashlib.sha256(ident.encode()).hexdigest()[:16]
    return kbuild.BUILD_DIR / f"libjaccard-{tag}.so"


def _compile(out: Path) -> bool:
    """Compile ``_SRC`` into ``out`` (atomically); False when no C compiler
    can."""
    out.parent.mkdir(parents=True, exist_ok=True)
    pid = os.getpid()
    src_path = out.with_suffix(f".{pid}.c")
    tmp_out = out.with_suffix(f".{pid}.tmp")
    src_path.write_text(_SRC)
    try:
        try:
            r = subprocess.run(["cc", *_cflags(), str(src_path), "-o",
                                str(tmp_out)], capture_output=True,
                               timeout=120)
        except (OSError, subprocess.SubprocessError):
            return False
        if r.returncode != 0:
            return False
        os.replace(tmp_out, out)   # atomic: concurrent builders race safely
        return True
    finally:
        src_path.unlink(missing_ok=True)
        tmp_out.unlink(missing_ok=True)


def _load() -> Optional[ctypes.CDLL]:
    """The compiled kernel (built on first use); None when it cannot be
    built or loaded."""
    out = library_path()
    try:
        if not out.exists() and not _compile(out):
            return None
        lib = ctypes.CDLL(str(out))
    except OSError:
        return None
    fn = lib.jaccard_cluster
    fn.restype = ctypes.c_long
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long,
                   ctypes.c_long, ctypes.c_double, ctypes.c_long,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    return lib


def get_kernel() -> Optional[ctypes.CDLL]:
    """The native kernel, or None (no C compiler, or
    ``REPRO_NO_NATIVE_JACCARD`` set)."""
    global _lib, _tried
    if os.environ.get("REPRO_NO_NATIVE_JACCARD"):
        return None
    if not _tried:
        _tried = True
        _lib = _load()
    return _lib


def jaccard_cluster(packed: np.ndarray, pop: np.ndarray, tau: float,
                    max_candidates: Optional[int]) -> Optional[np.ndarray]:
    """Run the native greedy clustering; returns the position permutation
    (indices into the scan-ordered inputs) or None when there is no
    kernel."""
    lib = get_kernel()
    if lib is None:
        return None
    n, w = packed.shape
    packed = np.ascontiguousarray(packed)
    pop = np.ascontiguousarray(pop, dtype=np.int64)
    pc = np.zeros(w, np.uint64)
    clustered = np.zeros(n, np.uint8)
    perm = np.empty(n, dtype=np.int64 if ctypes.sizeof(ctypes.c_long) == 8
                    else np.int32)
    count = lib.jaccard_cluster(
        packed.ctypes.data, pop.ctypes.data, n, w, float(tau),
        -1 if max_candidates is None else int(max_candidates),
        pc.ctypes.data, clustered.ctypes.data, perm.ctypes.data)
    if count != n:
        raise RuntimeError(f"jaccard_cluster placed {count} of {n} rows")
    return perm.astype(np.int64, copy=False)

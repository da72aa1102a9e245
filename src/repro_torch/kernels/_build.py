"""Build the CUDA sources under ``csrc/`` into shared libraries and load them.

Each source is compiled at first use with ``nvcc`` for ``sm_90a`` into
``build/repro_torch/`` at the root of the checkout (``.gitignore`` lists
``build/``), under a name keyed by a hash of the source and the shared
headers (``csrc/*.cuh``), and loaded with
``ctypes``.  The sources have a plain C interface and include no PyTorch
header, so a build takes seconds.  Nothing is built when a module is
imported: the wrappers call :func:`load` when they first launch a kernel.
nvcc's output (``ptxas -v``'s register, shared-memory and spill report)
is kept beside each library (``log_path``), so a process that finds the
library built still reads its report.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
DEFAULT_CUDA_HOME = "/usr/local/cuda"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
# name -> {"seconds": build time (0.0 when the library was already built),
#          "log": nvcc's output, ptxas register/shared-memory report included
#                 (read back from ``log_path`` when the library was built)}
BUILD_INFO: Dict[str, dict] = {}


def find_nvcc() -> str:
    """Path of ``nvcc``: on PATH, else under ``$CUDA_HOME`` or
    ``DEFAULT_CUDA_HOME``.  Raises when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), DEFAULT_CUDA_HOME):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError(
        "cannot build the CUDA kernels: nvcc was not found on PATH, under "
        "$CUDA_HOME or under /usr/local/cuda")


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to: the name carries a hash of the
    source, of every header under ``csrc/`` (a source may include any of
    them) and of the flags, so an edit to any of them builds anew."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode() + b"\0" + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def log_path(name: str) -> Path:
    """Where nvcc's output for ``library_path(name)`` is kept, beside it."""
    return library_path(name).with_suffix(".log")


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless a library of this exact source
    exists with its build log; returns the library's path."""
    out, log_file = library_path(name), log_path(name)
    if out.exists() and log_file.exists():
        BUILD_INFO[name] = {"seconds": 0.0, "log": log_file.read_text()}
        return out
    nvcc = find_nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
        capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed to build {name}.cu:\n{log}")
    # the log first, then the library, each atomically: a library that
    # exists always has its log, and concurrent builders never see half
    tmp_log = log_file.with_suffix(f".{os.getpid()}.tmp.log")
    tmp_log.write_text(log)
    os.replace(tmp_log, log_file)
    os.replace(tmp, out)
    BUILD_INFO[name] = {"seconds": time.perf_counter() - t0, "log": log}
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = _LIBS[name] = ctypes.CDLL(str(build(name)))
        return lib

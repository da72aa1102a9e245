"""Rules of the PyTorch/CUDA port that no numeric test shows.

* ``src/repro_torch`` and ``chip_smoke.py`` import neither JAX nor the JAX
  package, and every port module imports in a process where both are
  blocked.
* Entry points default to the card and raise without one; they never run on
  the CPU unless asked to.  (``optim.adamw`` and ``checkpoint.manager`` take
  no device: they work on the tensors they are given, where those lie.)
* The kernel wrappers take their plain versions for CPU tensors only, and
  the build helper says clearly when ``nvcc`` is missing and keys a build
  by the shared headers too; each wrapper's ctypes argument list matches
  its kernel's C prototype.
* The library path's entry points (``ops.prepare``, ``init_sparse_linear``,
  the ``Autotuner``'s ``pick`` and ``tune``) default to the card too, and
  the host Jaccard kernel builds beside the CUDA kernels.
* So do block-sparse attention's (``smat-attn-1.3b``, ``resolve_attn_impl``
  under ``backend="auto"``, the mask's device tensors), and kernel B5's
  wrapper takes its plain version for CPU tensors only.
* So do the paged KV cache's tables and the engine that pages; no
  ``repro_torch.obs`` call sits inside an autograd ``Function``'s
  ``forward``/``backward``, and the kernel wrappers import no obs module.
* So do the partitioned path's (``dist_spmm.prepare_sharded``,
  ``make_spmm_mesh``, an engine given an ``spmm_mesh``)."""
import ast
import ctypes
import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.configs import get_config
from repro_torch.kernels import _build, bcsr_attn, bcsr_spmm
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import ShapeCell
from repro_torch.core import bcsr as tb
from repro_torch.core import native
from repro_torch.core.sparse_linear import SparsitySpec, init_sparse_linear
from repro_torch.kernels import autotune, ops
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.models import attention as A
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from repro_torch.serve.engine import ServeEngine
from repro_torch.train import loop

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
PORT_FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
PORT_MODULES = sorted(
    ".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
    .removesuffix(".__init__") for p in PORT.rglob("*.py"))


def _forbidden(name: str) -> bool:
    return any(name == top or name.startswith(top + ".")
               for top in ("jax", "jaxlib", "repro"))


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_no_jax_or_repro_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if _forbidden(node.module or ""):
                bad.append(node.module)
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_lazy_exports_stay_in_the_port():
    assert all(m.startswith("repro_torch.")
               for m in repro_torch._EXPORTS.values())
    assert sorted(repro_torch.__all__) == sorted(repro_torch._EXPORTS)


def test_every_module_imports_with_jax_and_repro_blocked():
    code = (
        "import importlib, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        f"for name in {PORT_MODULES!r}:\n"
        "    importlib.import_module(name)\n"
        "import repro_torch\n"
        "for name in repro_torch.__all__:\n"
        "    getattr(repro_torch, name)\n"
        "loaded = [m for m, v in sys.modules.items() if v is not None and\n"
        "          (m.split('.')[0] in ('jax', 'jaxlib') or\n"
        "           m.split('.')[0] == 'repro')]\n"
        "assert not loaded, loaded\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert len(PORT_MODULES) >= 20


@pytest.fixture
def no_card(monkeypatch):
    """Make the test read 'no CUDA device' wherever it runs."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_default_to_the_card(no_card):
    cfg = get_config("smat-ffn-1.3b:smoke")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.init_params(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.init_cache(cfg, 1, 8)
    model = T.init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(cfg, model)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_cli.main(["--arch", "smat-ffn-1.3b:smoke"])


def test_training_entry_points_default_to_the_card(no_card, tmp_path):
    cfg = get_config("smat-ffn-1.3b:smoke")
    shape = ShapeCell("t", "train", 8, 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(["--arch", "smat-ffn-1.3b:smoke", "--steps", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        loop.train(cfg, shape, total_steps=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        loop.train_with_restarts(cfg, shape, total_steps=1)
    # asked for the CPU, the same entry points run there, and the optimizer
    # state and a checkpoint restore stay with the tensors they are given
    res = loop.train(cfg, shape, device="cpu", total_steps=1,
                     ckpt_dir=str(tmp_path))
    assert res.final_step == 1 and np.isfinite(res.losses).all()
    model = T.init_params(cfg, device="cpu")
    state = adamw.init(dict(model.named_parameters()))
    assert all(m.device.type == "cpu" for m in state["m"].values())
    restored, step = CheckpointManager(str(tmp_path)).restore(
        {"params": model.state_dict(), "opt": state})
    assert step == 1
    assert all(t.device.type == "cpu" for t in restored["params"].values())


def test_library_entry_points_default_to_the_card(no_card):
    a = tb.random_bcsr_exact(0, (64, 64), (8, 8), 16)
    meta = ops.prepare(a, meta_only=True)
    tuner = autotune.Autotuner()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tuner.pick(meta, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tuner.tune(a, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        autotune.device_name("cuda")
    # torch without CUDA raises AssertionError, torch with it RuntimeError
    with pytest.raises((RuntimeError, AssertionError)):
        ops.prepare(a)
    with pytest.raises((RuntimeError, AssertionError)):
        init_sparse_linear(0, 64, 64, SparsitySpec(block=(8, 8)))
    # asked for the CPU, they run there
    arrays, _ = ops.prepare(a, torch.float32, reorder="jaccard",
                            device="cpu")
    assert all(t.device.type == "cpu" for t in arrays)
    assert tuner.pick(meta, 8, device="cpu").variant in \
        autotune.variant_names()


def test_native_jaccard_builds_beside_the_kernels():
    assert native.library_path().parent == _build.BUILD_DIR


def _small_operand():
    rng = np.random.default_rng(0)
    vals = torch.from_numpy(rng.standard_normal((3, 8, 8)).astype(np.float32))
    row_ids = torch.tensor([0, 0, 1], dtype=torch.int32)
    col_ids = torch.tensor([0, 1, 1], dtype=torch.int32)
    b = torch.from_numpy(rng.standard_normal((16, 5)).astype(np.float32))
    return vals, row_ids, col_ids, b


def test_wrapper_takes_the_plain_version_on_cpu(monkeypatch):
    calls = []
    plain = bcsr_spmm.ref.bcsr_spmm_ref

    def spy(*args, **kwargs):
        calls.append(kwargs.get("out_dtype"))
        return plain(*args, **kwargs)

    def no_build(name):
        raise AssertionError("a CPU tensor must not build the kernel")

    monkeypatch.setattr(bcsr_spmm.ref, "bcsr_spmm_ref", spy)
    monkeypatch.setattr(bcsr_spmm._build, "load", no_build)
    before = bcsr_spmm.LAUNCHES["nnz_stream"]
    vals, row_ids, col_ids, b = _small_operand()
    got = bcsr_spmm.bcsr_spmm_nnz_stream(vals, row_ids, col_ids, b, 2)
    assert calls == [torch.float32]
    assert bcsr_spmm.LAUNCHES["nnz_stream"] == before
    np.testing.assert_allclose(
        got.numpy(), plain(vals, row_ids, col_ids, b, 2).numpy())


def test_sddmm_wrapper_takes_the_plain_version_on_cpu(monkeypatch):
    def no_build(name):
        raise AssertionError("a CPU tensor must not build the kernel")

    monkeypatch.setattr(bcsr_spmm._build, "load", no_build)
    before = bcsr_spmm.LAUNCHES["sddmm"]
    rng = np.random.default_rng(5)
    dc = torch.from_numpy(rng.standard_normal((16, 5)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((24, 5)).astype(np.float32))
    rows = torch.tensor([0, 1, 1], dtype=torch.int32)
    cols = torch.tensor([2, 0, 1], dtype=torch.int32)
    got = bcsr_spmm.bcsr_sddmm(dc, b, rows, cols, 8, 8)
    assert bcsr_spmm.LAUNCHES["sddmm"] == before
    full = dc.numpy() @ b.numpy().T
    for s, (r, c) in enumerate(zip(rows.tolist(), cols.tolist())):
        np.testing.assert_allclose(
            got[s].numpy(), full[8 * r:8 * r + 8, 8 * c:8 * c + 8],
            rtol=1e-5, atol=1e-5)


def test_sddmm_wrapper_refuses_a_device_without_a_kernel():
    meta_t = torch.zeros(8, 4, device="meta")
    idx = torch.zeros(1, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        bcsr_spmm.bcsr_sddmm(meta_t, meta_t, idx, idx, 8, 8)


def test_wrapper_refuses_a_device_without_a_kernel():
    vals, row_ids, col_ids, b = _small_operand()
    with pytest.raises(ValueError, match="no kernel for device meta"):
        bcsr_spmm.bcsr_spmm_nnz_stream(vals.to("meta"), row_ids.to("meta"),
                                       col_ids.to("meta"), b.to("meta"), 2)


def test_build_raises_clearly_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(_build, "DEFAULT_CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc was not found"):
        _build.find_nvcc()
    with pytest.raises(RuntimeError, match="nvcc was not found"):
        _build.build("bcsr_spmm")
    assert not (tmp_path / "build").exists() or \
        not any((tmp_path / "build").iterdir())


def test_library_path_covers_the_shared_headers(monkeypatch, tmp_path):
    """A library's name hashes every ``csrc/*.cuh`` beside its source, so an
    edit to a shared header (``spmm_tile.cuh``) never reuses a stale
    build; an edit elsewhere in the tree leaves the name alone."""
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text('#include "tile.cuh"\nint f();\n')
    (tmp_path / "tile.cuh").write_text("#pragma once\n")
    (tmp_path / "notes.txt").write_text("a\n")
    first = _build.library_path("k")
    (tmp_path / "notes.txt").write_text("b\n")
    assert _build.library_path("k") == first
    (tmp_path / "tile.cuh").write_text("#pragma once\n// edited\n")
    second = _build.library_path("k")
    assert second != first and second.name.startswith("libk-")
    (tmp_path / "k.cu").write_text('#include "tile.cuh"\nint g();\n')
    assert _build.library_path("k") not in (first, second)
    # the real sources: both SpMM kernels include the shared tile header,
    # both SDDMM kernels theirs
    for name, header in (("bcsr_spmm", "spmm_tile.cuh"),
                         ("bcsr_spmm_row_loop", "spmm_tile.cuh"),
                         ("bcsr_sddmm", "sddmm_tile.cuh"),
                         ("bcsr_sddmm_row_loop", "sddmm_tile.cuh")):
        src = (PORT / "kernels" / "csrc" / f"{name}.cu").read_text()
        assert f'#include "{header}"' in src


C_INTERFACES = [(source, symbol, types)
                for (source, symbol), types in bcsr_spmm._ARGTYPES.items()]
C_INTERFACES.append(("bcsr_attn", "bcsr_attn_fused", bcsr_attn._ARGTYPES))


@pytest.mark.parametrize("source,symbol,types", C_INTERFACES,
                         ids=[s for _, s, _ in C_INTERFACES])
def test_c_interfaces_match_their_argtypes(source, symbol, types):
    """Each wrapper's ctypes argument list matches the C prototype in its
    source, parameter by parameter (a pointer is ``c_void_p``, ``int``
    ``c_int``, ``long long`` ``c_longlong``, ``float`` ``c_float``): the
    kernels build only on the card, so a mismatch would show there first,
    as garbage arguments."""
    src = (PORT / "kernels" / "csrc" / f"{source}.cu").read_text()
    m = re.search(r'extern "C" int ' + symbol + r"\((.*?)\)\s*\{", src,
                  re.S)
    assert m, f"no C entry point {symbol} in {source}.cu"
    params = [" ".join(p.split()) for p in m.group(1).split(",")]

    def ctype(param):
        if "*" in param:
            return ctypes.c_void_p
        return {"int": ctypes.c_int, "long long": ctypes.c_longlong,
                "float": ctypes.c_float}[param.rsplit(" ", 1)[0]]
    assert [ctype(p) for p in params] == list(types), params


def test_attention_entry_points_default_to_the_card(no_card):
    cfg = get_config("smat-attn-1.3b:smoke")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.init_params(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_cli.main(["--arch", "smat-attn-1.3b:smoke"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(["--arch", "smat-attn-1.3b:smoke", "--steps", "1"])
    spec = dataclasses.replace(cfg.attn_sparsity, backend="auto")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        A.resolve_attn_impl(spec, 64, 32)
    # torch without CUDA raises AssertionError, torch with it RuntimeError
    with pytest.raises((RuntimeError, AssertionError)):
        A.mask_tensors(spec.mask, 64, spec.block, "cuda")
    # asked for the CPU, they run there
    assert A.resolve_attn_impl(spec, 64, 32, device="cpu") in ("fused",
                                                                "composed")
    mt = A.mask_tensors(spec.mask, 64, spec.block, "cpu")
    assert all(t.device.type == "cpu" for t in mt.arrays)


def test_attn_wrapper_takes_the_plain_version_on_cpu(monkeypatch):
    calls = []
    plain = bcsr_attn.ref.bcsr_attn_fused_ref

    def spy(*args, **kwargs):
        calls.append(kwargs["scale"])
        return plain(*args, **kwargs)

    def no_build(name):
        raise AssertionError("a CPU tensor must not build the kernel")

    monkeypatch.setattr(bcsr_attn.ref, "bcsr_attn_fused_ref", spy)
    monkeypatch.setattr(bcsr_attn._build, "load", no_build)
    before = dict(bcsr_attn.LAUNCHES)
    mt = A.mask_tensors(A.banded(16), 32, (8, 8), "cpu")
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 32, 8)).astype(
        np.float32)) for _ in range(3))
    out = bcsr_attn.bcsr_attn_fused(
        q, k, v, mt.emask, mt.arrays.sddmm_flat_idx, mt.arrays.flat_col,
        n_block_rows=4, n_block_cols=4, block=(8, 8), scale=0.25)
    assert calls == [0.25] and out.shape == (2, 32, 8)
    assert bcsr_attn.LAUNCHES == before


def test_no_obs_call_sits_in_an_autograd_function_body():
    """The port's form of the JAX lint rule R7: ``repro_torch.obs`` names
    appear in no ``forward``/``backward`` of a ``torch.autograd.Function``,
    and the kernel wrappers import no obs module."""
    wrappers = {"bcsr_spmm.py", "bcsr_attn.py", "ref.py", "_build.py"}
    checked = []
    for path in sorted(PORT.rglob("*.py")):
        tree = ast.parse(path.read_text(), filename=str(path))
        obs_names = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom) and (node.module or "") \
                    .startswith("repro_torch.obs"):
                obs_names |= {a.asname or a.name for a in node.names}
            elif isinstance(node, ast.Import):
                obs_names |= {a.asname or a.name for a in node.names
                              if a.name.startswith("repro_torch.obs")}
        if path.parent.name == "kernels" and path.name in wrappers:
            assert not obs_names, f"{path.name} imports {obs_names}"
        for cls in (n for n in ast.walk(tree) if isinstance(n, ast.ClassDef)):
            if not any(ast.unparse(b).endswith("Function") for b in cls.bases):
                continue
            for fn in cls.body:
                if isinstance(fn, ast.FunctionDef) and fn.name in (
                        "forward", "backward"):
                    checked.append(f"{cls.name}.{fn.name}")
                    used = {n.id for n in ast.walk(fn)
                            if isinstance(n, ast.Name)} & obs_names
                    assert not used, (f"{path.relative_to(ROOT)}: "
                                      f"{cls.name}.{fn.name} uses {used}")

    # ops' _Spmm and _Sddmm, attention's _AttnFused: forward and backward
    assert len(checked) >= 6, checked


def test_paged_kv_entry_points_default_to_the_card(no_card):
    """The paged KV cache's tables and an engine on smat-attn-1.3b (whose
    decode pages) default to the card and raise without one."""
    from repro_torch.serve.paged_kv import PagedKVCache
    cfg = get_config("smat-attn-1.3b:smoke")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PagedKVCache(cfg, 64, 2).table_leaves()
    assert PagedKVCache(cfg, 64, 2).table_leaves(device="cpu")
    model = T.init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(cfg, model, cache_len=64)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_cli.main(["--arch", "smat-attn-1.3b:smoke", "--cache-len", "64"])


def test_partitioned_entry_points_default_to_the_card(no_card):
    """``prepare_sharded``, ``make_spmm_mesh`` and ``ServeEngine(spmm_mesh=
    ...)`` default to the card and raise without one; asked for the CPU,
    the first two run (the mesh then wants its process group)."""
    from repro_torch.launch import dist_spmm
    a = tb.random_bcsr_exact(0, (64, 64), (8, 8), 16)
    # torch without CUDA raises AssertionError, torch with it RuntimeError
    with pytest.raises((RuntimeError, AssertionError)):
        dist_spmm.prepare_sharded(a, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dist_spmm.make_spmm_mesh(2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dist_spmm.resolve_n_shards(a)
    arrays, _ = dist_spmm.prepare_sharded(a, 2, device="cpu")
    assert all(t.device.type == "cpu" for t in arrays if t is not None)
    with pytest.raises(ValueError, match="spmm mesh needs 2 ranks"):
        dist_spmm.make_spmm_mesh(2, device_type="cpu")
    cfg = dataclasses.replace(get_config("smat-ffn-1.3b:smoke"),
                              ffn_sparsity=dataclasses.replace(
                                  get_config("smat-ffn-1.3b:smoke")
                                  .ffn_sparsity, shards=2))
    model = T.init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(cfg, model, spmm_mesh=object())
    engine = ServeEngine(cfg, model, cache_len=16, device="cpu")
    assert engine.spmm_mesh is None

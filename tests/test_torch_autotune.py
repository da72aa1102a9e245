"""The port's autotuner against the JAX package's (``tests/test_autotune.py``
is the model): the registry and fingerprints equal JAX's (the key is JAX's
v7 key plus ``|dev=...``), ``core.perf_model`` equals JAX's given the same
constants (rtol 1e-12), analytic picks are the argmin of the port's model,
and the measured sweep, its JSON cache and ``backend="auto"`` work on the
CPU.  A candidate that raises makes ``tune`` raise."""
# ruff: noqa: E402
import pytest

pytest.importorskip("torch")

import dataclasses
import json
import time

import jax.numpy as jnp
import numpy as np
import torch

from repro.core import bcsr as jb
from repro.core import perf_model as jpm
from repro.kernels import autotune as jat
from repro.kernels import ops as jops
from repro_torch.analysis import workspace
from repro_torch.core import bcsr as tb
from repro_torch.core import perf_model as tpm
from repro_torch.core.sparse_linear import (SparsitySpec,
                                            apply_sparse_linear,
                                            init_sparse_linear)
from repro_torch.kernels import autotune, ops

CPU = "cpu"


@pytest.fixture(autouse=True)
def _fresh_tuner():
    """Isolate the process-wide tuner per test."""
    autotune.set_autotuner(autotune.Autotuner())
    yield
    autotune.set_autotuner(None)


def _mk(seed=0, shape=(96, 128), block=(16, 16), density=0.3, mod=tb):
    return mod.random_bcsr(seed, shape, block, density).ensure_nonempty_rows()


def _meta(**kw):
    return ops.prepare(_mk(**kw), torch.float32, device=CPU)[1]


# ------------------------------------------------------------------ registry
def test_registry_names_and_families_equal_jax():
    for op in ("spmm", "sddmm", "attn", None):
        assert autotune.variant_names(op) == jat.variant_names(op)
    for name in autotune.variant_names(None):
        v, jv = autotune.get_variant(name), jat.get_variant(name)
        assert v.op == jv.op
        assert ops._BACKEND_ALIASES.get(jv.backend, jv.backend) == \
            v.backend or v.op == "attn"
        assert v.bn_candidates
        if v.op != "attn":
            assert v.backend in ops.BACKENDS
            assert set(v.bn_candidates) == set(
                ops.kernel_tiles(v.backend, v.op) or autotune.NO_TILE)


def test_register_duplicate_rejected():
    with pytest.raises(ValueError):
        autotune.register_variant(autotune.get_variant("xla"))


# --------------------------------------------------------------- fingerprint
@pytest.mark.parametrize("reorder", ["identity", "jaccard"])
@pytest.mark.parametrize("op", ["spmm", "sddmm", "attn"])
@pytest.mark.parametrize("n", [1, 8, 65, 2048])
def test_fingerprint_equals_jax_plus_device(reorder, op, n):
    ja, ta = _mk(seed=2, mod=jb), _mk(seed=2)
    j_meta = jops.prepare(ja, meta_only=True, reorder=reorder)
    t_meta = ops.prepare(ta, meta_only=True, reorder=reorder)
    jfp = jat.fingerprint(j_meta, n, op=op)
    tfp = autotune.fingerprint(t_meta, n, op=op, device="NVIDIA H100")
    fields = dataclasses.asdict(tfp)
    assert fields.pop("device") == "NVIDIA H100"
    assert fields == dataclasses.asdict(jfp)
    assert tfp.key() == jfp.key() + "|dev=NVIDIA H100"
    assert autotune.fingerprint(t_meta, n, op=op).key() == \
        jfp.key() + "|dev=cpu"
    assert autotune.fingerprint_bcsr(ta, n, reorder, op=op).key() == \
        jat.fingerprint_bcsr(ja, n, reorder, op=op).key() + "|dev=cpu"


def test_fingerprint_meta_matches_bcsr_and_buckets_n():
    a = _mk()
    meta = ops.prepare(a, torch.float32, device=CPU)[1]
    assert autotune.fingerprint(meta, 64).key() == \
        autotune.fingerprint_bcsr(a, 64).key()
    assert autotune.fingerprint(meta, 65).key() == \
        autotune.fingerprint(meta, 128).key()
    assert autotune.fingerprint(meta, 64).key() != \
        autotune.fingerprint(meta, 128).key()
    assert autotune.device_name(CPU) == "cpu"


# ---------------------------------------------------------------- perf model
TPU = dict(peak_flops=197e12, hbm_bw=819e9)


@pytest.mark.parametrize("h,w,n", [(16, 16, 8), (128, 128, 2048),
                                   (8, 32, 100)])
def test_perf_model_equals_jax_given_the_same_constants(h, w, n):
    kw = dict(rtol=1e-12)
    np.testing.assert_allclose(tpm.block_mma_time(h, w, n, **TPU),
                               jpm.block_mma_time(h, w, n), **kw)
    np.testing.assert_allclose(tpm.spmm_model_time(37, h, w, n, **TPU),
                               jpm.spmm_model_time(37, h, w, n), **kw)
    np.testing.assert_allclose(tpm.dense_gemm_time(h * 9, w * 7, n, **TPU),
                               jpm.dense_gemm_time(h * 9, w * 7, n), **kw)
    np.testing.assert_allclose(
        tpm.csr_spmm_time(h * w * 5, n, hbm_bw=TPU["hbm_bw"]),
        jpm.csr_spmm_time(h * w * 5, n), **kw)
    np.testing.assert_allclose(tpm.spmm_effective_gflops(1000, n, 1e-3),
                               jpm.spmm_effective_gflops(1000, n, 1e-3), **kw)
    x, y = [1, 2, 3, 5], [1.5, 2.4, 3.7, 6.1]
    assert dataclasses.asdict(tpm.fit(x, y)) == \
        pytest.approx(dataclasses.asdict(jpm.fit(x, y)), rel=1e-12)


def test_perf_model_constants_are_the_h100s():
    assert (tpm.PEAK_FLOPS_BF16, tpm.HBM_BW, tpm.NVLINK_BW) == \
        (989e12, 3.35e12, 450e9)
    assert (tpm.A100_PEAK_FP16_TC, tpm.A100_HBM_BW) == \
        (jpm.A100_PEAK_FP16_TC, jpm.A100_HBM_BW)
    assert not hasattr(tpm, "ICI_BW")
    assert workspace.H100_SMEM_PER_CTA == 232448
    assert workspace.spmm_cell_bytes((16, 16), 512) == 49664


# ------------------------------------------------------------ analytic picks
@pytest.mark.parametrize("op", ["spmm", "sddmm"])
@pytest.mark.parametrize("n", [4, 64, 2048])
def test_analytic_pick_is_the_argmin_of_the_model(op, n):
    meta = _meta(seed=1)
    c = autotune.analytic_choice(meta, n, op=op)
    v = autotune.get_variant(c.variant)
    assert v.op == op and v.supported(meta) and c.source == "analytic"
    assert c.bn in v.bn_candidates
    assert v.is_kernel
    times = {name: autotune.get_variant(name).model_time(
        meta, n, autotune.pick_bn(meta, n,
                                  autotune.get_variant(name).bn_candidates))
        for name in autotune.variant_names(op)
        if autotune.get_variant(name).is_kernel}
    assert c.variant == min(times, key=times.get)
    assert c.predicted_us == pytest.approx(times[c.variant] * 1e6)


def test_only_the_kernels_are_dispatchable():
    # both attention variants run kernels (B5, or the SDDMM/SpMM kernels)
    kernels = {n for n in autotune.variant_names(None)
               if autotune.get_variant(n).is_kernel}
    assert kernels == {"nnz_stream", "row_loop", "sddmm_stream",
                       "sddmm_row_loop", "attn_fused", "attn_composed"}
    assert autotune.analytic_choice(_meta(), 64, op="attn").variant in \
        ("attn_fused", "attn_composed")
    with pytest.raises(ValueError, match="unknown kernel family"):
        autotune.analytic_choice(_meta(), 64, op="conv")


def test_pick_bn_is_the_widest_tile_that_n_needs():
    meta = _meta()
    tiles = autotune.get_variant("nnz_stream").bn_candidates
    assert autotune.pick_bn(meta, 4, tiles) == 8
    assert autotune.pick_bn(meta, 20, tiles) == 16
    assert autotune.pick_bn(meta, 2048, tiles) == 64
    assert autotune.pick_bn(meta, 2048, autotune.NO_TILE) == 0


def _block_meta(block, nbr=16, nbc=16, nnzb=16):
    return ops.SparseMeta(shape=(nbr * block[0], nbc * block[1]), block=block,
                          n_block_rows=nbr, n_block_cols=nbc, nnzb=nnzb,
                          nnzb_t=nnzb)


def test_pick_bn_budgets_the_cuda_kernels_shared_memory():
    """ROADMAP C4, Difference 3: ``pick_bn`` budgets B1/B3's CTA (the row
    block and staging ``spmm_launch_config`` picks) against the H100's
    232,448 B, not the TPU cell.  256 x 256 blocks at N = 2048: the CTA
    (BM 128, BN 64) takes 111,616 B whatever the block, so the pick is 64;
    the reference picks 1,024, one of its TPU tiles."""
    meta = _block_meta((256, 256), nbr=8, nbc=8)
    tiles = autotune.get_variant("nnz_stream").bn_candidates
    assert autotune.pick_bn(meta, 2048, tiles) == 64
    assert not workspace.fits_vmem((256, 256), min(tiles))   # was BN = 8
    assert workspace.spmm_smem_bytes(torch.bfloat16, 128, 64, True) + \
        workspace.SPMM_STATIC_SMEM == 111616
    jmeta = jops.SparseMeta(shape=meta.shape, block=meta.block,
                            n_block_rows=8, n_block_cols=8, nnzb=16,
                            nnzb_t=16)
    assert jat.pick_bn(jmeta, 2048,
                       jat.get_variant("nnz_stream").bn_candidates) == 1024
    # the same CTA in either type and either staging of B
    assert {workspace.spmm_smem_bytes(dt, 128, 64, km)
            for dt in (torch.bfloat16, torch.float32)
            for km in (True, False)} == {110592}


@pytest.mark.parametrize("block", [(16, 16), (128, 128)])
def test_pick_bn_is_unchanged_at_the_models_blocks(block):
    """Every pick at the models' blocks is the one the TPU-cell predicate
    (``workspace.fits_vmem``) gave, for every family's candidates."""
    meta = _block_meta(block)

    def old_pick(n, candidates):
        feasible = [bn for bn in candidates
                    if workspace.fits_vmem(block, bn)] or [min(candidates)]
        fit_n = [bn for bn in feasible if bn <= max(n, min(feasible))]
        return max(fit_n or feasible)
    for name in autotune.variant_names(None):
        tiles = autotune.get_variant(name).bn_candidates
        for n in (1, 4, 8, 16, 20, 64, 100, 128, 512, 2048, 8192):
            assert autotune.pick_bn(meta, n, tiles) == old_pick(n, tiles)


def test_pick_bn_falls_back_to_the_narrowest_tile(monkeypatch):
    meta = _block_meta((16, 16))
    monkeypatch.setattr(workspace, "H100_SMEM_PER_CTA", 1024)
    tiles = autotune.get_variant("nnz_stream").bn_candidates
    assert not autotune.tile_fits(meta, 2048, 64)
    assert autotune.pick_bn(meta, 2048, tiles) == min(tiles)
    assert autotune.tile_fits(meta, 2048, 0)          # no tile


def test_analytic_choice_skips_row_loop_without_max_bpr():
    meta = ops.SparseMeta(shape=(128, 128), block=(16, 16), n_block_rows=8,
                          n_block_cols=8, nnzb=16, nnzb_t=16)
    for op in ("spmm", "sddmm"):
        assert autotune.get_variant(
            autotune.analytic_choice(meta, 128, op=op).variant).backend != \
            "row_loop"
    # an explicit request cannot be honored: it raises; auto never picks it
    with pytest.raises(ValueError, match="max_bpr"):
        ops.resolve_backend("row_loop", None, meta, 128, device=CPU)
    assert ops.resolve_backend("auto", None, meta, 128,
                               device=CPU)[0] != "row_loop"


def test_stale_row_loop_pick_falls_back_for_a_meta_without_max_bpr():
    meta = ops.SparseMeta(shape=(128, 128), block=(16, 16), n_block_rows=8,
                          n_block_cols=8, nnzb=16, nnzb_t=16)
    tuner = autotune.get_autotuner()
    tuner.put(autotune.fingerprint(meta, 64, device="cpu"),
              autotune.KernelChoice("row_loop", 16, source="measured"))
    assert ops.resolve_backend("auto", None, meta, 64, device=CPU) == \
        ("nnz_stream", 16)


def test_pick_caches_in_memory_per_device():
    meta = _meta()
    t = autotune.get_autotuner()
    c1 = t.pick(meta, 64, device=CPU)
    assert len(t) == 1
    assert t.pick(meta, 64, device=CPU) is c1
    t.pick(meta, 64, op="sddmm", device=CPU)
    assert len(t) == 2


# ----------------------------------------------------------- measured sweeps
def test_tune_never_slower_than_default_and_persists(tmp_path):
    cache = tmp_path / "autotune.json"
    tuner = autotune.Autotuner(cache_path=str(cache))
    a = _mk(seed=2, shape=(128, 128), density=0.2)
    choice, timings = tuner.tune(a, 64, iters=2, device=CPU)
    assert choice.source == "measured"
    default_label = f"{autotune.DEFAULT_VARIANT}/bn{autotune.DEFAULT_BN}"
    assert default_label in timings
    assert timings[f"{choice.variant}/bn{choice.bn}"] <= \
        timings[default_label] * 1.02
    assert {f"row_loop/bn{bn}" for bn in (8, 16, 32, 64)} <= set(timings)
    payload = json.loads(cache.read_text())
    assert payload["version"] == 1 and payload["entries"]
    assert all(k.endswith("|dev=cpu") for k in payload["entries"])
    hit = autotune.Autotuner(cache_path=str(cache)).get(
        autotune.fingerprint_bcsr(a, 64))
    assert (hit.variant, hit.bn, hit.source) == (choice.variant, choice.bn,
                                                 "measured")


@pytest.mark.parametrize("op", ["spmm", "sddmm"])
def test_tune_times_the_yardsticks_and_picks_a_kernel(op, tmp_path):
    """xla and dense are timed beside the kernels but never picked, even
    where they are faster (slow them down: the kernels must still win);
    neither a cache file nor ``put`` can make ``auto`` dispatch one."""
    real = (ops.spmm, ops.sddmm)

    def fast_yardstick(fn):
        def call(*args, backend="nnz_stream", **kw):
            if backend in ("xla", "dense"):
                return None
            time.sleep(0.002)
            return fn(*args, backend=backend, **kw)
        return call
    a = _mk(seed=8)
    tuner = autotune.Autotuner(cache_path=str(tmp_path / "c.json"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ops, "spmm", fast_yardstick(real[0]))
        mp.setattr(ops, "sddmm", fast_yardstick(real[1]))
        choice, timings = tuner.tune(a, 32, iters=1, op=op, device=CPU)
    yard = "" if op == "spmm" else "sddmm_"
    assert {f"{yard}xla/bn0", f"{yard}dense/bn0"} <= set(timings)
    assert min(timings, key=timings.get).split("/")[0] in (
        f"{yard}xla", f"{yard}dense")
    assert autotune.get_variant(choice.variant).is_kernel
    meta = ops.prepare(a, torch.float32, device=CPU)[1]
    assert ops.resolve_backend("auto", None, meta, 32, op=op, device=CPU)[0] \
        in ("nnz_stream", "row_loop")
    fp = autotune.fingerprint(meta, 32, op=op)
    with pytest.raises(ValueError, match="yardstick"):
        tuner.put(fp, autotune.KernelChoice(f"{yard}xla", 0))
    payload = json.loads((tmp_path / "c.json").read_text())
    payload["entries"][fp.key()]["variant"] = f"{yard}dense"
    (tmp_path / "c.json").write_text(json.dumps(payload))
    assert autotune.Autotuner(cache_path=str(tmp_path / "c.json")).get(
        fp) is None


@pytest.mark.parametrize("op", ["spmm", "sddmm"])
@pytest.mark.parametrize("layout", ["row_major", "token_major"])
def test_tune_times_the_callers_layout(op, layout, monkeypatch):
    """``token_major`` times the transposed views ``apply_sparse_linear``
    and its backward pass; ``row_major`` contiguous operands."""
    seen = []
    real = getattr(ops, op)

    def spy(arrays, meta, *dense, **kw):
        seen.append(tuple(t.stride() for t in dense))
        return real(arrays, meta, *dense, **kw)
    monkeypatch.setattr(ops, op, spy)
    a = _mk(seed=9)
    autotune.get_autotuner().tune(a, 24, iters=1, op=op, layout=layout,
                                  device=CPU)
    M, K = a.shape
    rows = (K,) if op == "spmm" else (M, K)
    want = tuple((1, r) if layout == "token_major" else (24, 1)
                 for r in rows)
    assert seen and set(seen) == {want}
    with pytest.raises(ValueError, match="layout"):
        autotune.get_autotuner().tune(a, 24, op=op, layout="col",
                                      device=CPU)


def test_tune_sddmm_family():
    a = _mk(seed=5)
    choice, timings = autotune.get_autotuner().tune(a, 16, op="sddmm",
                                                    iters=1, device=CPU)
    assert autotune.get_variant(choice.variant).op == "sddmm"
    assert "sddmm_row_loop/bn32" in timings and "sddmm_stream/bn0" in timings


def test_cache_file_comes_from_the_port_variable(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "jax.json"))
    monkeypatch.setenv(autotune.CACHE_ENV, str(tmp_path / "torch.json"))
    assert autotune.CACHE_ENV == "REPRO_TORCH_AUTOTUNE_CACHE"
    assert autotune.Autotuner().cache_path == str(tmp_path / "torch.json")


def test_corrupt_cache_tolerated(tmp_path):
    cache = tmp_path / "bad.json"
    cache.write_text("{not json")
    assert len(autotune.Autotuner(cache_path=str(cache))) == 0


def test_a_candidate_that_raises_makes_tune_raise(monkeypatch):
    """The JAX package's tune skips a candidate that raises; the port's
    does not, so a kernel that fails to build or launch is not hidden."""
    real = ops.spmm

    def broken(arrays, meta, b, *, backend="nnz_stream", bn=None,
               out_dtype=None):
        if backend == "row_loop":
            raise RuntimeError("kernel launch failed")
        return real(arrays, meta, b, backend=backend, bn=bn,
                    out_dtype=out_dtype)
    monkeypatch.setattr(ops, "spmm", broken)
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        autotune.get_autotuner().tune(_mk(seed=3), 16, iters=1, device=CPU)


def test_tune_skips_only_unsupported_candidates(monkeypatch):
    row_loop = autotune.get_variant("row_loop")
    monkeypatch.setitem(autotune._REGISTRY, "row_loop", dataclasses.replace(
        row_loop, supported=lambda meta: False))
    _, timings = autotune.get_autotuner().tune(_mk(seed=3), 16, iters=1,
                                               device=CPU)
    assert not any(k.startswith("row_loop/") for k in timings)
    assert "nnz_stream/bn16" in timings


# ---------------------------------------------------------------- ops wiring
def test_spmm_auto_matches_oracle():
    a = _mk(seed=3)
    arrays, meta = ops.prepare(a, torch.float32, device=CPU)
    b = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (a.shape[1], 64)).astype(np.float32))
    torch.testing.assert_close(ops.spmm(arrays, meta, b, backend="auto"),
                               ops.spmm(arrays, meta, b, backend="xla"),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("op", ["spmm", "sddmm"])
def test_auto_uses_the_measured_entry(op):
    a = _mk(seed=4)
    arrays, meta = ops.prepare(a, torch.float32, device=CPU)
    n = 64
    choice, _ = autotune.get_autotuner().tune(a, n, iters=1, op=op,
                                              device=CPU)
    assert ops.resolve_backend("auto", None, meta, n, op=op, device=CPU) == \
        (choice.backend, choice.bn or None)
    # a pick for the card is another entry: the CPU's never serves it
    fp_card = autotune.fingerprint(meta, n, op=op, device="NVIDIA H100")
    assert autotune.get_autotuner().get(fp_card) is None


def test_sparse_linear_auto_backend_tunes_at_init():
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2, 8, 64)).astype(np.float32))
    n_tokens = x.shape[0] * x.shape[1]
    spec = SparsitySpec(density=0.3, block=(16, 16), backend="auto",
                        tune_n=n_tokens, reorder="rcm")
    params, meta = init_sparse_linear(0, 64, 96, spec, torch.float32,
                                      device=CPU)
    warmed = autotune.get_autotuner().pick(meta, n_tokens, device=CPU)
    assert warmed.source == "measured"
    y = apply_sparse_linear(params, meta, x, spec)
    assert y.shape == (2, 8, 96)
    y_ref = apply_sparse_linear(params, meta, x,
                                dataclasses.replace(spec, backend="xla"))
    torch.testing.assert_close(y, y_ref, rtol=1e-4, atol=1e-4)


def test_shard_choice_uses_nvlink():
    meta = _meta(seed=6, shape=(512, 512), density=0.2)
    c = autotune.analytic_shard_choice(meta, 4096, max_shards=8, n_chunks=2)
    assert c.n_shards in autotune.shard_candidates(8, meta.n_block_rows)
    t = autotune.get_autotuner()
    assert t.pick_shards(meta, 4096, max_shards=8, n_chunks=2,
                         device=CPU) == c
    jmeta = jops.prepare(_mk(seed=6, shape=(512, 512), density=0.2, mod=jb),
                         meta_only=True)
    assert autotune.shard_candidates(8, 3) == jat.shard_candidates(8, 3)
    assert autotune._pipeline_time(2.0, 3.0, 4) == \
        jat._pipeline_time(2.0, 3.0, 4)
    assert jmeta.n_block_rows == meta.n_block_rows

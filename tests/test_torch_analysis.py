"""The port's static contract analyzer (``repro_torch.analysis``) against
the JAX package's (``repro.analysis``), on the same numpy-seeded inputs.

Every comparison here is exact: host index arrays, metas and schedules
are equal element for element, finding lists and rendered diagnostics
equal string for string (where the port restates a check for the H100 --
shared memory and CUDA grids in place of TPU VMEM -- both packages must
flag the same plant, each in its own words), byte counts equal the
hand-computed values of the kernels' C++ constants.  The launch hook runs
the ``smat-ffn-1.3b:smoke`` model on the CPU with and without
``REPRO_VERIFY_LAUNCH=1``: outputs bit-equal."""
# ruff: noqa: E402
import pytest

pytest.importorskip("torch")

import dataclasses
import json
import os
import sys
import textwrap

import numpy as np
import torch

from repro.analysis import fingerprint_audit as jfpa
from repro.analysis import report as jreport
from repro.analysis import verify_launch as jvl
from repro.core import bcsr as jbcsr
from repro.kernels import autotune as jautotune
from repro.kernels import ops as jops
from repro_torch.analysis import fingerprint_audit as fpa
from repro_torch.analysis import lint_rules as lint
from repro_torch.analysis import report
from repro_torch.analysis import verify_launch as vl
from repro_torch.analysis import workspace as ws
from repro_torch.analysis.__main__ import main as cli
from repro_torch.core import bcsr as tbcsr
from repro_torch.kernels import _build, autotune, ops
from repro_torch.kernels import bcsr_spmm as pk

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "src", "repro_torch")
H100 = "NVIDIA H100 80GB HBM3"


def _src(text):
    return textwrap.dedent(text)


# ================================================================ report
FINDINGS = [("traced-numpy", "src/x.py", 7, "numpy call"),
            ("launch-verify", "zoo:a", 0, "m — with a dash"),
            ("r", "b.py", 2, "m")]


@pytest.mark.parametrize("f", FINDINGS, ids=[f[0] for f in FINDINGS])
def test_finding_renders_as_jax(f):
    assert str(report.Finding(*f)) == str(jreport.Finding(*f))


def test_render_sorts_as_jax():
    fs = [report.Finding(*f) for f in FINDINGS]
    jfs = [jreport.Finding(*f) for f in FINDINGS]
    assert report.render(fs) == jreport.render(jfs)
    assert report.render([]) == jreport.render([]) == ""


# ======================================================== structure zoo
ZOO = ("rand_uniform_256", "rand_ragged_250x200", "rand_wide_block_32x16",
       "rand_skew_identity", "rand_skew_jaccard", "mask_banded",
       "mask_local_global", "mask_causal", "sharded_4", "sharded_4_padded",
       "linear_d30_64x96")


@pytest.fixture(scope="module")
def zoos():
    return ({c.name: c for c in vl.structure_zoo()},
            {c.name: c for c in jvl.structure_zoo()})


def _meta_dict(meta):
    return dataclasses.asdict(meta)


def test_zoo_has_the_jax_cases(zoos):
    port, jax_ = zoos
    assert tuple(port) == tuple(jax_) == ZOO


@pytest.mark.parametrize("name", ZOO)
def test_zoo_case_equals_jax(zoos, name):
    """Meta, entry list and every family's schedule exactly JAX's."""
    case, jcase = zoos[0][name], zoos[1][name]
    assert _meta_dict(case.meta) == _meta_dict(jcase.meta)
    assert case.families == jcase.families
    sharded = hasattr(case.meta, "shard_metas")
    metas = zip(case.meta.shard_metas, jcase.meta.shard_metas,
                case.row_ids, jcase.row_ids, case.col_ids, jcase.col_ids) \
        if sharded else [(case.meta, jcase.meta, case.row_ids,
                          jcase.row_ids, case.col_ids, jcase.col_ids)]
    for m, jm, rows, jrows, cols, jcols in metas:
        for got, want in ((rows, jrows), (cols, jcols)):
            got, want = np.asarray(got), np.asarray(want)
            assert got.dtype == want.dtype and np.array_equal(got, want)
        for family in case.families:
            sched = vl.build_schedule(family, rows, cols, m)
            jsched = jvl.build_schedule(family, jrows, jcols, jm)
            for got, want in zip(sched, jsched):
                if want is None:
                    assert got is None
                else:
                    assert got.dtype == want.dtype
                    assert np.array_equal(got, want)
            assert vl.verify_schedule(family, *sched[:2], rows, cols, m,
                                      row_len=sched[2]) == \
                jvl.verify_schedule(family, *jsched[:2], jrows, jcols, jm,
                                    row_len=jsched[2]) == []


def test_run_verify_clean_in_both():
    assert vl.run_verify() == []
    assert jvl.run_verify() == []


def test_schedule_mirrors_equal_the_producers():
    """The verifier's mirrors re-derive what ``ops`` builds."""
    a = tbcsr.random_bcsr_exact(4, (200, 176), (16, 16), 37)
    host, meta = ops._prepare_sparse_host(
        a, reorder="identity", reorder_granularity="element", tau=0.7,
        max_candidates=None, n_shards=1)
    fi, fc, rl = vl.spmm_row_loop_schedule_host(
        host["row_ids"], host["col_ids"], meta.n_block_rows, meta.max_bpr)
    assert np.array_equal(fi, host["flat_idx"])
    assert np.array_equal(fc, host["flat_col"])
    assert np.array_equal(rl, host["row_len"])
    sfi, sfc = vl.sddmm_row_loop_schedule_host(
        host["row_ids"], host["col_ids"], meta.n_block_rows, meta.max_bpr)
    assert np.array_equal(sfi, host["sddmm_flat_idx"])
    assert np.array_equal(sfc, host["flat_col"])


# ======================================================= planted faults
@pytest.fixture(scope="module")
def rand_pair():
    """The JAX test's operand (``tests/test_analysis.py:229``) through both
    packages' producers."""
    a = tbcsr.random_bcsr_exact(0, (256, 256), (16, 16), 64)
    ja = jbcsr.random_bcsr_exact(0, (256, 256), (16, 16), 64)
    assert np.array_equal(a.row_ids, ja.row_ids)
    assert np.array_equal(a.col_ids, ja.col_ids)
    meta, jmeta = ops.prepare_sparse_meta(a), jops.prepare_sparse_meta(ja)
    assert _meta_dict(meta) == _meta_dict(jmeta)
    return a, meta, ja, jmeta


def _both(fn_name, plant, rand_pair, family):
    """Run ``verify_schedule`` on the same planted schedule in both
    packages; return (port findings, JAX findings)."""
    a, meta, ja, jmeta = rand_pair
    builder = "spmm_row_loop_schedule_host" if family == "spmm" else \
        "sddmm_row_loop_schedule_host"
    sched = list(getattr(vl, builder)(a.row_ids, a.col_ids,
                                      meta.n_block_rows, meta.max_bpr))
    sched = plant(sched, meta)
    rl = sched[2] if family == "spmm" else None
    got = vl.verify_schedule(family, sched[0], sched[1], a.row_ids,
                             a.col_ids, meta, row_len=rl)
    want = jvl.verify_schedule(family, sched[0], sched[1], ja.row_ids,
                               ja.col_ids, jmeta, row_len=rl)
    return got, want


def _dec_row_len(s, meta):
    rl = s[2].copy()
    rl[int(np.argmax(rl))] -= 1
    return [s[0], s[1], rl]


def _zero_live(s, meta):
    fi = s[0].copy()
    fi[np.flatnonzero(fi != 0)[0]] = 0
    return [fi, s[1], s[2]]


def _sentinel_live(s, meta):
    fi = s[0].copy()
    fi[np.flatnonzero(fi != meta.nnzb)[3]] = meta.nnzb
    return [fi, s[1]]


def _wrong_col(s, meta):
    fc = s[1].copy()
    live = np.flatnonzero(s[0] != meta.nnzb)
    fc[live[0]] = (fc[live[0]] + 1) % meta.n_block_cols
    return [s[0], fc]


def _dropped(s, meta):
    fi = s[0].copy()
    live = np.flatnonzero(fi != meta.nnzb)
    fi[live[1]] = int(fi[live[0]])
    return [fi, s[1]]


PLANTS = [("spmm", "row_len_short", _dec_row_len),
          ("spmm", "dup_on_live", _zero_live),
          ("sddmm", "sentinel_on_live", _sentinel_live),
          ("sddmm", "wrong_col", _wrong_col),
          ("sddmm", "dropped_slot", _dropped),
          ("attn", "sentinel_on_live", _sentinel_live),
          ("attn", "dropped_slot", _dropped)]


@pytest.mark.parametrize("family,name,plant", PLANTS,
                         ids=[f"{f}-{n}" for f, n, _ in PLANTS])
def test_planted_schedule_fault_flagged_as_jax(rand_pair, family, name,
                                               plant):
    got, want = _both("verify_schedule", plant, rand_pair, family)
    assert got and got == want


META_PLANTS = [("clean", {}), ("nnzb_x100", {"nnzb": 6400}),
               ("nnzb_t_short", {"nnzb_t": 63}),
               ("max_bpr_past_nbc", {"max_bpr": 17}),
               ("padding_pct", {"padding_ratio_pct": 101}),
               ("n_shards_0", {"n_shards": 0})]


@pytest.mark.parametrize("name,kw", META_PLANTS,
                         ids=[n for n, _ in META_PLANTS])
def test_meta_invariants_match_jax(rand_pair, name, kw):
    _, meta, _, jmeta = rand_pair
    got = vl.verify_meta(dataclasses.replace(meta, **kw))
    want = jvl.verify_meta(dataclasses.replace(jmeta, **kw))
    assert got == want
    assert bool(got) == (name != "clean")


@pytest.mark.parametrize("plant", ["clean", "nnzb_t_short", "one_row",
                                   "shard_nnzb"])
def test_sharded_meta_invariants_match_jax(plant):
    from repro.launch import dist_spmm as jdist
    from repro_torch.launch import dist_spmm
    a = tbcsr.random_bcsr_exact(7, (320, 256), (16, 16), 80)
    ja = jbcsr.random_bcsr_exact(7, (320, 256), (16, 16), 80)
    sm = dist_spmm.prepare_sharded_meta(a, 4)
    jsm = jdist.prepare_sharded_meta(ja, 4)
    assert _meta_dict(sm) == _meta_dict(jsm)

    def plant_in(m):
        if plant == "nnzb_t_short":
            return dataclasses.replace(
                m, nnzb_t_per_shard=m.nnzb_t_per_shard - 1)
        if plant == "one_row":
            return dataclasses.replace(m, rows_per_shard=1)
        if plant == "shard_nnzb":
            metas = list(m.shard_metas)
            metas[1] = dataclasses.replace(metas[1], nnzb=metas[1].nnzb + 1)
            return dataclasses.replace(m, shard_metas=tuple(metas))
        return m
    got = vl.verify_sharded_meta(plant_in(sm))
    assert got == jvl.verify_sharded_meta(plant_in(jsm))
    assert bool(got) == (plant != "clean")


def test_dims_only_meta_tolerated_but_not_schedulable():
    from repro.core.sparse_linear import SparsitySpec, sparse_linear_specs
    _, jmeta = sparse_linear_specs(
        96, 64, SparsitySpec(density=0.3, block=(16, 16)))
    meta = ops.SparseMeta(**_meta_dict(jmeta))
    assert meta.max_bpr == 0
    assert vl.verify_meta(meta) == jvl.verify_meta(jmeta) == []
    got = vl.verify_launch(meta, "row_loop", n=64)
    assert got == jvl.verify_launch(jmeta, "row_loop", n=64)
    assert got and "dims-only" in got[0]
    assert vl.verify_launch(meta, "xla", n=64) == []
    assert vl.verify_launch(meta, "nnz_stream", n=64) == []   # B1 streams


CHUNK_PLANTS = [("overlap", [(0, 3), (2, 6), (6, 10)], 10),
                ("gap", [(0, 3), (4, 10)], 10),
                ("empty", [(0, 6), (6, 6), (6, 10)], 10),
                ("descending", [(0, 8), (8, 7)], 10),
                ("wrong_span", [(1, 6), (6, 9)], 10),
                ("none", [], 10), ("not_pairs", "nope", 10)]


@pytest.mark.parametrize("name,bounds,n", CHUNK_PLANTS,
                         ids=[c[0] for c in CHUNK_PLANTS])
def test_chunk_schedule_faults_match_jax(name, bounds, n):
    got = vl.verify_chunk_schedule(bounds, n)
    assert got and got == jvl.verify_chunk_schedule(bounds, n)


def test_chunk_schedules_of_the_builder_pass_and_budget_flags():
    from repro.launch.dist_spmm import chunk_schedule as jchunks
    from repro_torch.launch.dist_spmm import chunk_schedule
    for n in (1, 7, 64, 512):
        for k in (1, 2, 4, 8):
            assert chunk_schedule(n, k) == jchunks(n, k)
            assert vl.verify_chunk_schedule(chunk_schedule(n, k), n,
                                            block=(16, 16)) == []
    # a budget under one CTA's shared memory flags every chunk in both
    sched = chunk_schedule(512, 4)
    got = vl.verify_chunk_schedule(sched, 512, block=(16, 16),
                                   vmem_budget=1024)
    want = jvl.verify_chunk_schedule(sched, 512, block=(16, 16),
                                     vmem_budget=1024)
    assert len(got) == len(want) == 4
    assert all("shared memory" in e for e in got)
    assert all("VMEM" in e for e in want)


@pytest.mark.parametrize("budget", [None, 2, 0])
def test_page_tables_verify_as_jax(budget):
    for mname, spec, seq in vl._zoo_masks():
        from repro.core import attention_mask as jam
        jspec = getattr(jam, spec.kind)(*{
            "banded": (spec.bandwidth,),
            "local_global": (spec.window, spec.n_global),
            "blockwise_causal": ()}[spec.kind])
        got = vl.verify_page_table(spec, seq, (16, 16),
                                   resident_pages=budget)
        assert got == jvl.verify_page_table(jspec, seq, (16, 16),
                                            resident_pages=budget) == []


def test_page_table_fault_flagged(monkeypatch):
    """A page table that drops a live page is flagged."""
    from repro_torch.core.attention_mask import banded
    from repro_torch.models import attention as A
    real = A.decode_page_table

    def dropping(spec, seq_len, block):
        pages, live, meta = real(spec, seq_len, block)
        live = live.copy()
        live[-1, 0] = False
        return pages, live, meta
    monkeypatch.setattr(A, "decode_page_table", dropping)
    errs = vl.verify_page_table(banded(32), 128, (16, 16))
    assert errs and "row 7" in errs[0]


def test_verify_summary_matches_jax(rand_pair):
    _, meta, _, jmeta = rand_pair
    assert vl.verify_summary(meta, 512) == jvl.verify_summary(jmeta, 512)
    bad, jbad = (dataclasses.replace(m, nnzb_t=m.nnzb - 1)
                 for m in (meta, jmeta))
    got = vl.verify_summary(bad, 64, op="sddmm")
    assert got == jvl.verify_summary(jbad, 64, op="sddmm")
    assert not got["ok"]


# ===================================================== shared memory, grids
SMEM = [  # (kernel, args, bytes): spmm_tile.cuh / sddmm_tile.cuh by hand
    ("spmm", ("bfloat16", 128, 64, True), 110592),
    ("spmm", ("float32", 128, 64, True), 110592),
    ("spmm", ("bfloat16", 16, 8, False), 26112),
    ("spmm", ("bfloat16", 16, 8, True), 25600),
    ("spmm", ("bfloat16", 128, 8, True), 77824),
    ("spmm", ("bfloat16", 128, 8, False), 78336),
    ("sddmm", ("bfloat16", True, True), 55296),
    ("sddmm", ("bfloat16", False, True), 55296),
    ("sddmm", ("float32", True, False), 55296),
    ("sddmm", ("float32", False, False), 55296),
    ("attn", (128, 128, 0), 121856),
    ("attn", (128, 128, 33), 121856 + 8 * 33),
    ("attn", (64, 16, 0), 56832),
]


@pytest.mark.parametrize("kernel,args,want", SMEM,
                         ids=[f"{k}-{a}" for k, a, _ in SMEM])
def test_smem_formulas_equal_the_hand_computed_bytes(kernel, args, want):
    fn = {"spmm": ws.spmm_smem_bytes, "sddmm": ws.sddmm_smem_bytes,
          "attn": ws.attn_smem_bytes}[kernel]
    assert fn(*args) == want


def test_thread_counts_mirror_the_kernels():
    assert [ws.spmm_threads(bm) for bm in (16, 128)] == [128, 256]
    assert ws.SDDMM_THREADS == 128
    assert [ws.attn_threads(h) for h in (8, 16, 17, 100, 128, 512)] == \
        [32, 32, 64, 224, 256, 256]


@pytest.mark.parametrize("d,h,limit", [(128, 128, 13822), (64, 16, 21950)])
def test_b5_boundary_predicted(d, h, limit):
    """The largest max_bpr that fits 232,448 B with B5's 16 B of static
    shared memory (ptxas's report on the card); ``verify_launch`` flags
    one more and not the limit."""
    assert ws.attn_max_bpr(d, h) == limit
    assert ws.attn_smem_bytes(d, h, limit) + ws.ATTN_STATIC_SMEM <= \
        ws.H100_SMEM_PER_CTA < \
        ws.attn_smem_bytes(d, h, limit + 1) + ws.ATTN_STATIC_SMEM

    def row(slots):
        return ops.SparseMeta(shape=(h, slots * h), block=(h, h),
                              n_block_rows=1, n_block_cols=slots,
                              nnzb=slots, nnzb_t=slots, max_bpr=slots)
    assert vl.verify_launch(row(limit), "fused", n=d, op="attn") == []
    errs = vl.verify_launch(row(limit + 1), "fused", n=d, op="attn")
    assert len(errs) == 1 and "shared memory" in errs[0]


def _ffn_meta():
    a = tbcsr.random_bcsr_exact(0, (8192, 2048), (128, 128), 112)
    return ops.prepare_sparse_meta(a)


def test_grid_past_the_card_limit_flagged():
    """``ceil(N / BN)`` past 65,535 (gridDim.y) is flagged on the host."""
    meta = _ffn_meta()
    edge = ws.H100_GRID_YZ * pk.SPMM_TILES[-1]
    assert vl.derive_grid(meta, "spmm", edge) == (64, 65535, 1)
    assert vl.verify_launch(meta, "nnz_stream", n=edge) == []
    errs = vl.verify_launch(meta, "nnz_stream", n=edge + 1)
    assert len(errs) == 1 and "gridDim.y=65536" in errs[0]
    assert vl.verify_launch(meta, "row_loop", n=edge + 1)
    assert vl.verify_launch(meta, "xla", n=edge + 1) == []   # no kernel


def test_grids_follow_the_kernels():
    meta = _ffn_meta()
    assert vl.derive_grid(meta, "spmm", 4) == (64, 1, 8)         # BM 16
    assert vl.derive_grid(meta, "spmm", 2048) == (64, 32, 1)     # BM 128
    assert vl.derive_grid(meta, "sddmm", 2048,
                          backend="nnz_stream") == (112, 2, 2)
    assert vl.derive_grid(meta, "sddmm", 2048) == \
        (64 * meta.max_bpr, 2, 2)
    mask = dataclasses.replace(meta, block=(100, 100))
    assert vl.derive_grid(mask, "attn", 128, instances=16) == (64, 16, 1)
    assert vl.derive_grid(mask, "attn", 256, instances=1) == (64, 1, 2)


@pytest.mark.parametrize("backend,op", [("nnz_stream", "spmm"),
                                        ("row_loop", "spmm"),
                                        ("nnz_stream", "sddmm"),
                                        ("row_loop", "sddmm")])
def test_smem_budget_flags_every_kernel(rand_pair, backend, op):
    _, meta, _, jmeta = rand_pair
    assert vl.verify_launch(meta, backend, n=512, op=op) == []
    errs = vl.verify_launch(meta, backend, n=512, op=op, vmem_budget=1024)
    assert len(errs) == 1 and "shared memory" in errs[0]
    jbackend = "pallas" if backend == "nnz_stream" else backend
    assert any("VMEM" in e for e in jvl.verify_launch(
        jmeta, jbackend, n=512, op=op, vmem_budget=1024))


def test_b5_widths_flagged():
    meta = _ffn_meta()
    assert vl.verify_launch(meta, "fused", n=128, op="attn") == []
    errs = vl.verify_launch(meta, "fused", n=512, op="attn")
    assert errs and "d, dv <= 256" in errs[0]


def test_ctas_per_sm():
    assert ws.ctas_per_sm(128, 119, 55296) == 4     # B2: 4 fit
    assert ws.ctas_per_sm(256, 124, 110592 + 1024) == 2
    assert ws.ctas_per_sm(256, 255, 1024) == 1      # registers bind
    assert ws.ctas_per_sm(32, 16, 0) == 32          # the CTA cap binds


# ======================================================= lint rules (torch)
LINT_FIRES = {
    "traced-numpy": """
        import torch
        class F(torch.autograd.Function):
            @staticmethod
            def forward(ctx, x):
                return helper(x)
            @staticmethod
            def backward(ctx, g):
                return g
        def helper(x):
            return x * x.sum().item()
        """,
    "lru-cache-static": """
        import functools
        @functools.lru_cache(maxsize=None)
        def f(n, xs=[]):
            return n
        """,
    "custom-vjp-pairing": """
        import torch
        class F(torch.autograd.Function):
            @staticmethod
            def forward(ctx, a, b, x):
                return x
            @staticmethod
            def backward(ctx, g):
                return (None, g)
        """,
    "static-aux-frozen": """
        import dataclasses
        @dataclasses.dataclass
        class FooMeta:
            n: int
        """,
    "obs-host-only": """
        import torch
        from repro_torch.obs import trace as obs_trace
        class F(torch.autograd.Function):
            @staticmethod
            def forward(ctx, x):
                return x
            @staticmethod
            def backward(ctx, g):
                record()
                return g
        def record():
            obs_trace.event("bwd")
        """,
}
LINT_CLEAN = {
    "traced-numpy": """
        import functools
        import numpy as np
        import torch
        class F(torch.autograd.Function):
            @staticmethod
            def forward(ctx, x):
                return x + host(3)
            @staticmethod
            def backward(ctx, g):
                return g
        @functools.lru_cache(maxsize=None)
        def host(n):
            return float(np.ones(n).sum())
        def outside(x):
            return x.item()
        """,
    "lru-cache-static": """
        import functools
        @functools.lru_cache(maxsize=None)
        def f(spec, d: int, hints: tuple):
            return (spec, d, hints)
        """,
    "custom-vjp-pairing": """
        import torch
        class F(torch.autograd.Function):
            @staticmethod
            def forward(ctx, a, x, y):
                return x * y, x + y
            @staticmethod
            def backward(ctx, g1, g2):
                return (None, *torch.autograd.grad(g1, g2))
        class G(torch.autograd.Function):
            @staticmethod
            def forward(ctx, a, x):
                return x
            @staticmethod
            def backward(ctx, g):
                return None, g
        """,
    "static-aux-frozen": """
        import dataclasses
        @dataclasses.dataclass(frozen=True)
        class FooMeta:
            n: int
        @dataclasses.dataclass
        class ScratchBuffer:
            xs: list
        """,
    "obs-host-only": """
        import torch
        from repro_torch.obs import trace as obs_trace
        class F(torch.autograd.Function):
            @staticmethod
            def forward(ctx, x):
                return x
            @staticmethod
            def backward(ctx, g):
                return g
        def apply(x):
            with obs_trace.span("op"):
                return F.apply(x)
        """,
}


@pytest.mark.parametrize("rule", sorted(LINT_FIRES))
def test_lint_rule_fires(rule):
    fs = lint.lint_source(_src(LINT_FIRES[rule]), "fix.py")
    assert [f.rule for f in fs] == [rule]
    assert fs[0].path == "fix.py" and fs[0].line > 0


@pytest.mark.parametrize("rule", sorted(LINT_CLEAN))
def test_lint_rule_clean_fixture_passes(rule):
    assert lint.lint_source(_src(LINT_CLEAN[rule]), "fix.py") == []


@pytest.mark.parametrize("call", ["x.cpu()", "x.tolist()", "x.numpy()",
                                  "torch.cuda.synchronize()",
                                  "np.asarray(x)"])
def test_traced_numpy_flags_each_host_call(call):
    fs = lint.lint_source(_src(f"""
        import numpy as np
        import torch
        class F(torch.autograd.Function):
            @staticmethod
            def forward(ctx, x):
                return x
            @staticmethod
            def backward(ctx, g):
                return step(g)
        class Run:
            def step(self, x):
                {call}
                return x
        def step(x):
            return Run().step(x)
        """), "fix.py")
    assert [f.rule for f in fs] == ["traced-numpy"]


@pytest.mark.parametrize("use", ["obs_trace.event('x')", "sink = obs_trace",
                                 "repro_torch.obs.trace.event('x')"])
def test_obs_host_only_flags_each_use(use):
    fs = lint.lint_source(_src(f"""
        import torch
        import repro_torch.obs.trace
        from repro_torch.obs import trace as obs_trace
        class F(torch.autograd.Function):
            @staticmethod
            def forward(ctx, x):
                {use}
                return x
            @staticmethod
            def backward(ctx, g):
                return g
        """), "fix.py")
    assert [f.rule for f in fs] == ["obs-host-only"]


def test_autograd_pairing_checks():
    fs = lint.lint_source(_src("""
        import torch
        class F(torch.autograd.Function):
            def forward(ctx, x):
                return x, x
            @staticmethod
            def backward(ctx, g):
                return g
        class G(torch.autograd.Function):
            @staticmethod
            def forward(ctx, x):
                return x
        """), "fix.py")
    msgs = [f.message for f in fs]
    assert len(fs) == 3 and all(f.rule == "custom-vjp-pairing" for f in fs)
    assert any("staticmethod" in m for m in msgs)
    assert any("takes 2 args, want 3" in m for m in msgs)
    assert any("both forward and backward" in m for m in msgs)


def test_obs_import_in_a_kernel_wrapper_flagged(tmp_path):
    wrapper = tmp_path / "repro_torch" / "kernels" / "bcsr_spmm.py"
    wrapper.parent.mkdir(parents=True)
    wrapper.write_text("from repro_torch.obs import trace\n")
    fs = lint.lint_file(str(wrapper))
    assert [f.rule for f in fs] == ["obs-host-only"]


def test_fingerprint_fields_rule():
    ops_src = _src("""
        import dataclasses
        @dataclasses.dataclass(frozen=True)
        class SparseMeta:
            nnzb: int
            max_bpr: int
        """)
    fires = lint.check_fingerprint_fields(ops_src, _src("""
        import dataclasses
        @dataclasses.dataclass(frozen=True)
        class Fingerprint:
            nnzb: int
            device: str
            def key(self):
                return f"v7|nnzb={self.nnzb}"
        def fingerprint(meta, n, device="cpu"):
            return Fingerprint(nnzb=meta.nnzb, device=device)
        """))
    assert sorted(f.message.split()[0] for f in fires) == \
        ["Fingerprint.device", "SparseMeta.max_bpr"]
    with open(os.path.join(PORT, "kernels", "ops.py")) as f:
        real_ops = f.read()
    with open(os.path.join(PORT, "kernels", "autotune.py")) as f:
        real_at = f.read()
    assert lint.check_fingerprint_fields(real_ops, real_at) == []


def test_package_facade_rule(tmp_path):
    init = tmp_path / "__init__.py"
    init.write_text('__all__ = ["spmm", "no_such_name"]\n')
    fs = lint.check_package_facade(str(init))
    assert [f.rule for f in fs] == ["package-facade"]
    assert "no_such_name" in fs[0].message
    assert lint.check_package_facade(os.path.join(PORT, "__init__.py")) == []


def test_lint_tree_zero_findings_on_the_port():
    findings = lint.lint_tree(PORT)
    assert findings == [], "\n".join(str(f) for f in findings)


# ====================================================== fingerprint audit
def _meta():
    return ops.prepare_sparse_meta(
        tbcsr.random_bcsr_exact(0, (256, 256), (16, 16), 64))


@pytest.mark.parametrize("device", ["cpu", H100, "NVIDIA H200",
                                    "a:b=c d"])
@pytest.mark.parametrize("op", ["spmm", "sddmm", "attn"])
def test_key_round_trips(device, op):
    fp = autotune.fingerprint(_meta(), 512, op=op, n_chunks=2,
                              device=device)
    assert fpa.parse_key(fp.key()) == fp
    back_max, back = fpa.parse_shard_key(autotune.shard_entry_key(fp, 8))
    assert (back_max, back) == (8, fp)


def test_stale_keys_raise():
    key = autotune.fingerprint(_meta(), 512, device=H100).key()
    with pytest.raises(fpa.StaleKeyError, match="v5.*v7"):
        fpa.parse_key("v5" + key[2:])
    with pytest.raises(fpa.StaleKeyError):      # v6: no nk= field
        fpa.parse_key("v6" + key[2:].split("|nk=")[0])


def test_a_jax_key_is_refused():
    ja = jbcsr.random_bcsr_exact(0, (256, 256), (16, 16), 64)
    jkey = jautotune.fingerprint(jops.prepare_sparse_meta(ja), 512).key()
    assert jfpa.parse_key(jkey)                  # a valid JAX key
    with pytest.raises(ValueError, match=r"\|dev=") as ei:
        fpa.parse_key(jkey)
    assert not isinstance(ei.value, fpa.StaleKeyError)
    port_key = autotune.fingerprint(_meta(), 512).key()
    assert port_key == jkey + "|dev=cpu"


@pytest.mark.parametrize("device", ["a|b", ""])
def test_key_refuses_a_device_that_cannot_round_trip(device):
    fp = autotune.fingerprint(_meta(), 512, device=device)
    with pytest.raises(ValueError, match="cannot be keyed"):
        fp.key()


def test_malformed_keys_rejected():
    for key in ("v7|op=spmm|nbr=oops", "not a key",
                autotune.fingerprint(_meta(), 64).key() + "|extra=1"):
        with pytest.raises(ValueError):
            fpa.parse_key(key)


def test_injectivity_over_the_sampled_space():
    fps = fpa.sample_fingerprints()
    assert {fp.device for fp in fps} == set(fpa.AUDIT_DEVICES)
    assert fpa.audit_injectivity() == []


def test_audit_files_reads_the_port_cache(tmp_path, monkeypatch):
    cache = tmp_path / "tuned.json"
    monkeypatch.setenv(autotune.CACHE_ENV, str(cache))
    tuner = autotune.Autotuner()
    meta = _meta()
    for op in ("spmm", "sddmm"):
        tuner.pick(meta, 64, op=op, device="cpu")
    tuner.pick_shards(meta, 64, max_shards=4, device="cpu")
    tuner.save()
    data = json.loads(cache.read_text())
    assert len(data["entries"]) == 2 and len(data["shard_entries"]) == 1
    assert fpa.audit_files(str(tmp_path)) == []
    assert fpa.audit_files(ROOT) == []          # the repo's own files
    # planted: a JAX key, a stale key and a yardstick variant
    key = next(iter(data["entries"]))
    entry = data["entries"][key]
    data["entries"][key.rsplit("|dev=", 1)[0]] = entry
    data["entries"]["v5" + key[2:]] = entry
    data["entries"][key] = dict(entry, variant="xla")
    data["shard_entries"]["shards|max=4|" + key] = {"n_shards": 0}
    cache.write_text(json.dumps(data))
    msgs = [f.message for f in fpa.audit_files(str(tmp_path))]
    assert len(msgs) == 4
    assert any("JAX package's v7 key" in m for m in msgs)
    assert any("stale fingerprint grammar v5" in m for m in msgs)
    assert any("'xla'" in m for m in msgs)
    assert any("n_shards=0" in m for m in msgs)


def test_jax_baselines_are_not_read(monkeypatch):
    monkeypatch.delenv(autotune.CACHE_ENV, raising=False)
    assert fpa.audit_files(ROOT) == []
    assert jfpa.audit_files(ROOT) == []          # they hold JAX keys


# ====================================================================== CLI
def test_cli_all_green_on_the_port(monkeypatch):
    monkeypatch.delenv(autotune.CACHE_ENV, raising=False)
    assert cli(["--all"]) == 0


def test_cli_nonzero_with_diagnostics_on_a_bad_tree(tmp_path, capsys):
    bad = tmp_path / "bad.py"
    bad.write_text(_src("""
        import dataclasses
        @dataclasses.dataclass
        class BadMeta:
            n: int
        """))
    rc = cli(["--lint", "--src", str(tmp_path)])
    out = capsys.readouterr().out
    assert rc == 1
    assert f"{bad}:4: [static-aux-frozen]" in out


def test_cli_smem_budget(capsys):
    assert cli(["--verify-launch", "--smem-budget", "4096"]) == 1
    out = capsys.readouterr().out
    assert "[launch-verify]" in out and "shared memory" in out


def test_cli_runs_as_a_module_without_jax(tmp_path):
    """``python -m repro_torch.analysis`` in a process where importing jax
    or repro fails, as on the card's machine."""
    import subprocess
    blocker = tmp_path / "block"
    blocker.mkdir()
    for name in ("jax", "repro"):
        (blocker / name).mkdir()
        (blocker / name / "__init__.py").write_text(
            f"raise ImportError('{name} is blocked')\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(blocker), os.path.join(ROOT, "src")]))
    env.pop(autotune.CACHE_ENV, None)
    proc = subprocess.run([sys.executable, "-m", "repro_torch.analysis",
                           "--all"], capture_output=True, text=True,
                          env=env, cwd=str(tmp_path), timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "OK: all static contracts hold" in proc.stderr


# ===================================================================== hook
def test_resolve_backend_hook(monkeypatch, rand_pair):
    _, meta, _, _ = rand_pair
    monkeypatch.setenv("REPRO_VERIFY_LAUNCH", "1")
    assert ops.resolve_backend("row_loop", None, meta, 64) == \
        ("row_loop", None)
    bad = dataclasses.replace(meta, nnzb=meta.nnzb * 100)
    with pytest.raises(vl.LaunchError):
        ops.resolve_backend("row_loop", None, bad, 64)
    monkeypatch.delenv("REPRO_VERIFY_LAUNCH")
    ops.resolve_backend("row_loop", None, bad, 64)   # opt-in: no check


@pytest.mark.parametrize("backend", ["nnz_stream", "row_loop"])
def test_planted_meta_raises_before_the_product(monkeypatch, backend):
    """One entry more than the schedule has slots for: ``LaunchError``
    before the plain SpMM (the CPU's kernel) runs."""
    a = tbcsr.random_bcsr_exact(2, (96, 64), (16, 16), 12)
    arrays, meta = ops.prepare(a, torch.float32, device="cpu")
    bad = dataclasses.replace(meta, nnzb=meta.n_block_rows * meta.max_bpr
                              + 1)
    calls = []
    for name in ("bcsr_spmm_nnz_stream", "bcsr_spmm_row_loop"):
        real = getattr(pk, name)
        monkeypatch.setattr(pk, name, lambda *a, _r=real, **k:
                            calls.append(1) or _r(*a, **k))
    b = torch.ones(64, 8)
    monkeypatch.setenv("REPRO_VERIFY_LAUNCH", "1")
    with pytest.raises(vl.LaunchError, match="schedule capacity"):
        ops.spmm(arrays, bad, b, backend=backend)
    assert calls == []
    assert torch.equal(ops.spmm(arrays, meta, b, backend=backend),
                       ops.spmm(arrays, meta, b, backend="xla"))
    assert calls == [1]


def _smoke_runs(cfg):
    from repro_torch.configs.base import ShapeCell
    from repro_torch.data.pipeline import make_batch
    from repro_torch.launch import steps as st
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw
    from repro_torch.train import loop

    def decode():
        model = T.init_params(cfg, seed=0, device="cpu")
        cache = T.init_cache(cfg, 2, 16, device="cpu")
        with torch.inference_mode():
            logits, _ = T.decode_step(cfg, model, cache,
                                      torch.tensor([3, 5]), 0)
        return [logits]

    def train():
        model = T.init_params(cfg, seed=0, device="cpu")
        opt = adamw.init(dict(model.named_parameters()))
        batch = loop.batch_to_device(
            make_batch(cfg, ShapeCell("t", "train", 16, 2), 0), "cpu")
        step = st.make_train_step(cfg, adamw.AdamWConfig(total_steps=2),
                                  remat="none")
        model, opt, metrics = step(model, opt, batch)
        return [metrics["loss"], metrics["grad_norm"],
                *[p.detach() for p in model.parameters()]]
    return {"decode": decode, "train": train}


@pytest.mark.parametrize("shards", [0, 4])
@pytest.mark.parametrize("path", ["decode", "train"])
def test_hook_on_the_smoke_model_is_bit_neutral(monkeypatch, shards, path):
    """``REPRO_VERIFY_LAUNCH=1`` checks every dispatch of a decode call and
    a training step of ``smat-ffn-1.3b:smoke`` (and with
    ``SparsitySpec(shards=4)``) and changes no output bit."""
    from repro_torch.configs import get_config
    cfg = get_config("smat-ffn-1.3b:smoke")
    if shards:
        cfg = dataclasses.replace(cfg, ffn_sparsity=dataclasses.replace(
            cfg.ffn_sparsity, shards=shards, backend="auto"))
    run = _smoke_runs(cfg)[path]
    monkeypatch.delenv("REPRO_VERIFY_LAUNCH", raising=False)
    plain = run()
    checked = []
    real = vl.assert_launch_ok
    monkeypatch.setattr(vl, "assert_launch_ok",
                        lambda *a, **k: checked.append(a) or real(*a, **k))
    monkeypatch.setenv("REPRO_VERIFY_LAUNCH", "1")
    hooked = run()
    per_call = 3 * cfg.n_layers * (shards or 1)
    assert len(checked) == per_call
    assert len(plain) == len(hooked)
    assert all(torch.equal(p, h) for p, h in zip(plain, hooked))


# ============================================================ resources
# ``cuobjdump -res-usage`` on the built libraries, captured on the card
# (NVIDIA H100 80GB HBM3, CUDA 12.8): B1's decode and training
# instantiations, two of B2's and B5's, with the tool's own headers.
RES_USAGE = """
Fatbin elf code:
================
arch = sm_90a
code version = [1,7]
host = linux
compile_size = 64bit

Resource usage:
 Common:
  GLOBAL:0
 Function _ZN9spmm_tile11spmm_kernelIN45_GLOBAL__N__12ade638_12_bcsr_spmm_cu_ec9321b112RowptrSourceE13__nv_bfloat16Li128ELi64ELb0EEEvT_NS_4ArgsE:
  REG:124 STACK:0 SHARED:2048 LOCAL:0 CONSTANT[0]:616 TEXTURE:0 SURFACE:0 SAMPLER:0
 Function _ZN9spmm_tile11spmm_kernelIN45_GLOBAL__N__12ade638_12_bcsr_spmm_cu_ec9321b112RowptrSourceE13__nv_bfloat16Li16ELi8ELb0EEEvT_NS_4ArgsE:
  REG:40 STACK:0 SHARED:2048 LOCAL:0 CONSTANT[0]:616 TEXTURE:0 SURFACE:0 SAMPLER:0
 Function _ZN10sddmm_tile12sddmm_kernelIN46_GLOBAL__N__8398cac4_13_bcsr_sddmm_cu_513e7db111EntrySourceE13__nv_bfloat16Lb1ELb1EEEvT_NS_4ArgsE:
  REG:92 STACK:0 SHARED:1024 LOCAL:0 CONSTANT[0]:632 TEXTURE:0 SURFACE:0 SAMPLER:0
 Function _ZN10sddmm_tile12sddmm_kernelIN46_GLOBAL__N__8398cac4_13_bcsr_sddmm_cu_513e7db111EntrySourceEfLb0ELb1EEEvT_NS_4ArgsE:
  REG:119 STACK:0 SHARED:1024 LOCAL:0 CONSTANT[0]:632 TEXTURE:0 SURFACE:0 SAMPLER:0

Fatbin elf code:
================
arch = sm_90a
code version = [1,7]
host = linux
compile_size = 64bit

Resource usage:
 Common:
  GLOBAL:0
 Function _ZN45_GLOBAL__N__063873d4_12_bcsr_attn_cu_3a8eaa2a17attn_fused_kernelENS_4ArgsE:
  REG:241 STACK:8 SHARED:1040 LOCAL:0 CONSTANT[0]:648 TEXTURE:0 SURFACE:0 SAMPLER:0
"""


def test_res_usage_parses_the_card_output():
    usage = vl.parse_res_usage(RES_USAGE)
    assert len(usage) == 5
    regs = sorted(u["REG"] for u in usage.values())
    assert regs == [40, 92, 119, 124, 241]
    insts = sorted((vl.instantiation(n)["family"], u["REG"])
                   for n, u in usage.items())
    assert insts == [("attn", 241), ("sddmm", 92), ("sddmm", 119),
                     ("spmm", 40), ("spmm", 124)]
    spmm = [vl.instantiation(n) for n in usage if "spmm_kernel" in n]
    assert {(i["dtype"], i["bm"], i["bn"], i["kmajor"]) for i in spmm} == \
        {("bfloat16", 128, 64, False), ("bfloat16", 16, 8, False)}
    sddmm = [vl.instantiation(n) for n in usage if "sddmm_kernel" in n]
    assert {(i["dtype"], i["ak"], i["bk"]) for i in sddmm} == \
        {("bfloat16", True, True), ("float32", False, True)}
    assert vl.instantiation("_Z6helperv") is None


def test_library_resources_pass_the_h100_limits():
    """Static shared memory: cuobjdump's SHARED less the 1 KB a CTA
    reserves -- B1 1,024 B, B2 0, B5 16 (ptxas: 1024, none, 16 bytes
    smem)."""
    rows, errs = vl.verify_library_resources(
        vl.parse_res_usage(RES_USAGE), attn_shape=(128, 128, 33))
    assert errs == []
    got = {(r["family"], r.get("bm"), r.get("dtype")):
           (r["static_smem"], r["threads"], r["ctas_per_sm"]) for r in rows}
    assert got == {("spmm", 128, "bfloat16"): (1024, 256, 2),
                   ("spmm", 16, "bfloat16"): (1024, 128, 8),
                   ("sddmm", None, "bfloat16"): (0, 128, 4),
                   ("sddmm", None, "float32"): (0, 128, 4),
                   ("attn", None, None): (16, 256, 1)}


@pytest.mark.parametrize("plant,needle", [
    ("REG:92 ", "__launch_bounds__(128, 4)"),   # B2 at 129 registers
    ("SHARED:1040", "static shared memory"),    # B5's static changed
    ("REG:241", "registers a thread > 255"),    # B5 at 256 registers
])
def test_library_resources_planted_faults(plant, needle):
    repl = {"REG:92 ": "REG:129 ", "SHARED:1040": "SHARED:1056",
            "REG:241": "REG:256"}[plant]
    _, errs = vl.verify_library_resources(
        vl.parse_res_usage(RES_USAGE.replace(plant, repl)),
        attn_shape=(128, 128, 33))
    assert errs and any(needle in e for e in errs), errs


def test_b5_resources_refused_past_the_boundary():
    usage = vl.parse_res_usage(RES_USAGE)
    b5 = next(u for n, u in usage.items() if "attn_fused" in n)
    limit = ws.attn_max_bpr(128, 128)
    ok, ctas = vl.verify_resources(b5, 256, ws.attn_smem_bytes(128, 128,
                                                                limit))
    assert ok == [] and ctas == 1
    errs, _ = vl.verify_resources(b5, 256, ws.attn_smem_bytes(128, 128,
                                                              limit + 1))
    assert errs and "shared memory" in errs[0]


def test_build_log_is_kept_beside_the_library(monkeypatch, tmp_path):
    """A library found built still gives ptxas's report (``[build]``'s
    spill check reads it), and a missing log rebuilds."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text("int f();\n")
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(
        f"#!{sys.executable}\n"
        "import sys\n"
        "out = sys.argv[sys.argv.index('-o') + 1]\n"
        "open(out, 'w').write('lib')\n"
        "print(\"ptxas info    : Compiling entry function '_Z1kv'\", "
        "file=sys.stderr)\n"
        "print('ptxas info    : Used 40 registers', file=sys.stderr)\n")
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "find_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build, "BUILD_INFO", {})
    lib = _build.build("k")
    cold = _build.BUILD_INFO["k"]
    assert lib.exists() and "Used 40 registers" in cold["log"]
    assert _build.log_path("k").read_text() == cold["log"]
    _build.BUILD_INFO.clear()
    assert _build.build("k") == lib
    assert _build.BUILD_INFO["k"] == {"seconds": 0.0, "log": cold["log"]}
    _build.log_path("k").unlink()           # no report: build again
    _build.build("k")
    assert _build.BUILD_INFO["k"]["seconds"] > 0.0
    assert _build.log_path("k").exists()

"""Quickstart on the PyTorch/CUDA port: the SMaT SpMM library end to end.

CSR in -> Jaccard row reorder (inside ``ops.prepare``) -> BCSR -> SpMM on
the hand-written CUDA kernel, checked against dense; the autotuned pick,
the partitioned product, the sparse layer on the model path, and
block-sparse attention (kernel B5).  The steps of ``examples/quickstart.py``.

  PYTHONPATH=src python examples/torch_quickstart.py            # the card
  PYTHONPATH=src python examples/torch_quickstart.py --device cpu

On the CPU every kernel wrapper runs its plain PyTorch version.
"""
import argparse

import numpy as np
import torch

from repro_torch.core import bcsr as bcsr_lib
from repro_torch.core import topology
from repro_torch.core.sparse_linear import (SparsitySpec, apply_sparse_linear,
                                            init_sparse_linear,
                                            sparse_linear_meta)
from repro_torch.kernels import autotune, ops
from repro_torch.launch import dist_spmm
from repro_torch.models import attention as A
from repro_torch.models.transformer import resolve_device


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    device = resolve_device(ap.parse_args(argv).device)
    out = {}

    # 1. an unstructured sparse matrix in CSR (clustered, scattered)
    csr = topology.blocked_random(n=1024, nnz_target=30_000, cluster=32,
                                  seed=0)
    out["nnz"] = int(csr.nnz)
    print(f"matrix: {csr.shape}, nnz={csr.nnz}, "
          f"sparsity={1 - csr.nnz / (csr.shape[0] * csr.shape[1]):.3%}")

    # 2. the block-densifying row permutation, one argument of ops.prepare;
    # spmm returns the ORIGINAL row order, so nothing downstream knows
    block = (16, 16)
    a = bcsr_lib.from_scipy(csr, block)
    arrays, meta = ops.prepare(a, torch.float32, reorder="jaccard",
                               device=device)
    arrays_id, meta_id = ops.prepare(a, torch.float32, device=device)
    out["nnzb"] = (meta_id.nnzb, meta.nnzb)
    print(f"BCSR blocks: {meta_id.nnzb} -> {meta.nnzb} "
          f"({meta_id.nnzb / meta.nnzb:.2f}x reduction from reorder="
          f"{meta.reorder!r})")

    # 3. SpMM on the streamed kernel (B1), held to the dense product
    b = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (meta.shape[1], 64)).astype(np.float32)).to(device)
    y_kernel = ops.spmm(arrays, meta, b, backend="nnz_stream")
    y_dense = ops.spmm(arrays_id, meta_id, b, backend="dense")
    err = float((y_kernel - y_dense).abs().max())
    print(f"reordered nnz_stream vs identity dense max err: {err:.2e}")
    assert err < 1e-3

    # 4. autotuned dispatch: (variant, N tile) from the structure's
    # fingerprint, which includes the reorder scheme and the device
    n = int(b.shape[1])
    fp = autotune.fingerprint(meta, n,
                              device=autotune.device_name(device))
    choice = autotune.get_autotuner().pick(meta, n, device=device)
    out["pick"] = (choice.variant, choice.bn)
    print(f"autotune pick for {fp.key()}: "
          f"{choice.variant}/bn{choice.bn} ({choice.source})")
    y_auto = ops.spmm(arrays, meta, b, backend="auto")
    assert float((y_auto - y_dense).abs().max()) < 1e-3

    # 5. the partitioned product: load-balanced block-row shards, each with
    # its own pick, in-process on one device
    n_shards = 4
    sharr, smeta = dist_spmm.prepare(a, n_shards, dtype=torch.float32,
                                     device=device)
    y_sharded = dist_spmm.spmm_sharded(sharr, smeta, b, backend="auto")
    stats = dist_spmm.shard_balance_stats(a, n_shards)
    err_s = float((y_sharded - y_dense).abs().max())
    out["loads"] = stats["loads"]
    out["imbalance"] = stats["imbalance"]
    print(f"sharded over {n_shards} slices (local): loads={stats['loads']} "
          f"(imbalance {stats['imbalance']}x), max err {err_s:.2e}")
    assert err_s < 1e-3

    # 6. the MODEL path: the same partitioned product as a layer spec; its
    # structure meta is a pure function of (seed, dims, spec)
    spec = SparsitySpec(density=0.2, block=(16, 16), backend="auto",
                        shards=n_shards)
    params, lmeta = init_sparse_linear(0, 256, 512, spec,
                                       dtype=torch.float32, device=device)
    assert sparse_linear_meta(0, 256, 512, spec, device=device) == lmeta
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 8, 256)).astype(np.float32)).to(device)
    with dist_spmm.use_spmm_mesh(None):                 # in-process
        y = apply_sparse_linear(params, lmeta, x, spec)
    picks = [A.pick_label(*ops.resolve_backend("auto", None, m, 16,
                                               device=device))
             for m in lmeta.shard_metas]
    out["layer_shape"] = tuple(y.shape)
    print(f"model-path sharded layer: y {tuple(y.shape)}, per-shard auto "
          f"picks {picks}")

    # 7. the second workload: block-sparse ATTENTION on a static banded
    # mask; backend="auto" arbitrates the whole layer (the fused kernel B5
    # or the composed SDDMM -> softmax -> SpMM triple)
    rngq = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rngq.standard_normal(
        (1, 128, 4, 16)).astype(np.float32)).to(device) for _ in range(3))
    aspec = A.AttnSparsitySpec(mask=A.banded(48), block=(16, 16),
                               backend="auto")
    attn = A.block_sparse_attention(q, k, v, aspec)
    mmeta = A.attention_mask_meta(aspec.mask, 128, aspec.block)
    rep = A.attention_mask_report(aspec, 128, device=device)
    composed = A.block_sparse_attention(
        q, k, v, A.AttnSparsitySpec(mask=aspec.mask, block=aspec.block,
                                    backend="nnz_stream"))
    # fused == composed within 1e-5 x max (the port's carve-out 2: B5 sums
    # each row in its own order)
    rel = float((attn - composed).abs().max() / composed.abs().max())
    pos = torch.arange(128, device=device)
    ok_mask = A.mask_allowed(aspec.mask, pos, pos)
    s = torch.einsum("blhd,bshd->bhls", q, k) * (16 ** -0.5)
    p = torch.softmax(torch.where(ok_mask, s, A.NEG_INF), dim=-1)
    want = torch.einsum("bhls,bshd->blhd", p, v)
    err_a = float((attn - want).abs().max())
    out["mask_report"] = rep
    print(f"block-sparse attention: mask nnzb={mmeta.nnzb} "
          f"({rep['block_density_vs_causal']:.0%} of dense-causal blocks), "
          f"impl={rep['attn_impl']} (pick {rep['attn_pick']}), "
          f"picks sddmm={rep['sddmm_pick']} spmm={rep['spmm_pick']}, "
          f"fused vs composed {rel:.2e} of max, max err vs dense-masked "
          f"{err_a:.2e}")
    assert rep["attn_impl"] == "fused" and rep["attn_pick"] == "attn_fused"
    assert rel <= 1e-5 and err_a < 1e-4
    print("OK")
    return out


if __name__ == "__main__":
    main()

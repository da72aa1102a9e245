"""The port's partitioned SpMM over a ``torch.distributed`` mesh of CPU
ranks (``gloo``), against its own in-process mode.

Each test starts one group of 2 or 4 processes (``torch.multiprocessing``,
a ``FileStore`` under the test's ``tmp_path``; no TCP port).  Every rank
runs the same program on the same numpy-seeded operand:

* forward: mesh mode == in-process mode, bit for bit (the shards' products
  are the same computations; the all-gather moves bytes), chunked too;
* gradients of ``vals`` and B: bit for bit with one column block (every
  rank gathers every shard's partial and sums them in ascending shard order,
  as the in-process mode does); with a column split (a (2, 2) mesh) within
  1e-6 x max|grad| in f32, since a shard's dvals then sum its column
  blocks' partials;
* a mesh whose ``spmm`` axis does not match the operand raises.

The file imports no JAX: ``spawn`` re-imports it in every worker.
"""
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.core import bcsr as tb
from repro_torch.launch import dist_spmm

SHAPE, BLOCK, N = (23 * 16 + 5, 160), (16, 16), 24


def _operand(split=False):
    if split:       # one dominant block-row: it splits into fragments
        dense = np.zeros((8 * 16, 12 * 16), np.float32)
        rng = np.random.default_rng(3)
        dense[16:32] = rng.standard_normal((16, 12 * 16))
        dense[::7, ::5] = 1.0
        return tb.from_dense(dense, BLOCK)
    return tb.random_bcsr(0, SHAPE, BLOCK, 0.3)


def _run(arrays, smeta, b, mesh, backend, n_chunks):
    """(out, dvals, dB) of one sharded product with a fixed cotangent."""
    vals = arrays.vals.clone().requires_grad_()
    bb = b.clone().requires_grad_()
    out = dist_spmm.spmm_sharded(arrays._replace(vals=vals), smeta, bb,
                                 backend=backend, mesh=mesh,
                                 n_chunks=n_chunks)
    weight = torch.arange(out.numel(), dtype=torch.float32).reshape(
        out.shape).sin()
    (out * weight).sum().backward()
    return out.detach(), vals.grad, bb.grad


def _worker(rank, world, store_path, out_dir, case):
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    try:
        results = {}
        n_shards, col_shards = case["mesh"]
        mesh = dist_spmm.make_spmm_mesh(n_shards, col_shards,
                                        device_type="cpu")
        for name, split in case["operands"]:
            a = _operand(split)
            arrays, smeta = dist_spmm.prepare_sharded(
                a, n_shards, col_shards=col_shards, dtype=torch.float32,
                split_heavy_rows=split, device="cpu")
            b = torch.from_numpy(np.random.default_rng(1).standard_normal(
                (a.shape[1], N)).astype(np.float32))
            for backend in case["backends"]:
                for n_chunks in (1, 3):
                    key = f"{name}/{backend}/{n_chunks}"
                    results[key + "/mesh"] = _run(arrays, smeta, b, mesh,
                                                  backend, n_chunks)
                    results[key + "/local"] = _run(arrays, smeta, b, None,
                                                   backend, n_chunks)
        if case.get("mismatch"):
            arrays, smeta = dist_spmm.prepare_sharded(
                _operand(), world * 2, dtype=torch.float32, device="cpu")
            try:
                dist_spmm.spmm_sharded(arrays, smeta, torch.ones(
                    SHAPE[1], 4), mesh=mesh)
                results["mismatch"] = "no error"
            except ValueError as exc:
                results["mismatch"] = str(exc)
        torch.save(results, f"{out_dir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def _spawn(tmp_path, world, case):
    mp.spawn(_worker, args=(world, str(tmp_path / "store"), str(tmp_path),
                            case), nprocs=world, join=True)
    return [torch.load(tmp_path / f"rank{r}.pt") for r in range(world)]


def _check(ranks, bitwise_grads):
    worst = 0.0
    for results in ranks:
        for key in results:
            if not key.endswith("/mesh"):
                continue
            mesh, local = results[key], results[key[:-5] + "/local"]
            assert torch.equal(mesh[0], local[0]), key
            for leaf, got, want in zip(("dvals", "dB"), mesh[1:], local[1:]):
                if bitwise_grads:
                    assert torch.equal(got, want), (key, leaf)
                else:
                    diff = (got - want).abs()
                    rel = (diff.max() /
                           want.abs().max().clamp_min(1e-30)).item()
                    worst = max(worst, rel)
                    at = np.unravel_index(int(diff.argmax()), diff.shape)
                    assert rel <= 1e-6, (key, leaf, rel, at, got[at].item(),
                                         want[at].item())
        # every rank holds the same (replicated) results
        for key, value in results.items():
            if isinstance(value, tuple):
                for got, want in zip(value, ranks[0][key]):
                    assert torch.equal(got, want), key
    return worst


def test_two_ranks_match_in_process_bitwise(tmp_path):
    ranks = _spawn(tmp_path, 2, {
        "mesh": (2, 1), "backends": ("nnz_stream", "row_loop"),
        "operands": (("ragged", False), ("split", True)), "mismatch": True})
    _check(ranks, bitwise_grads=True)
    assert all("must have size 4" in r["mismatch"] for r in ranks)


def test_four_ranks_match_in_process_bitwise(tmp_path):
    ranks = _spawn(tmp_path, 4, {
        "mesh": (4, 1), "backends": ("auto", "xla"),
        "operands": (("ragged", False),)})
    _check(ranks, bitwise_grads=True)


def test_column_split_mesh_matches_in_process(tmp_path):
    """A (2, 2) mesh: two row shards, each over two column blocks of B
    (N = 24 split 12 + 12).  Forward bitwise; gradients within 1e-6 of
    max|grad| (a shard's dvals sum its two column blocks' partials)."""
    ranks = _spawn(tmp_path, 4, {
        "mesh": (2, 2), "backends": ("nnz_stream",),
        "operands": (("ragged", False),)})
    assert _check(ranks, bitwise_grads=False) <= 1e-6


def test_mesh_needs_the_process_group():
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="spmm mesh needs 2 ranks"):
        dist_spmm.make_spmm_mesh(2, device_type="cpu")

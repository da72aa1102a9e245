"""Dry-run: every (arch x shape x mesh) cell from specs, with nothing
allocated and nothing launched, to its memory and roofline record.

The JAX package lowers and compiles each cell's step with XLA over fake
devices and asks the compiler for its memory and cost.  Here a cell's
arguments are ``meta``-device tensors (``models.transformer.param_specs``,
``cache_specs``, ``launch.steps.input_specs``, ``opt_specs``): their bytes
are exact, and the work comes from ``launch.roofline.work_count``.  There
is no compiler to ask for a step's temporaries or for lowering and compile
times, so ``temp_bytes``, ``peak_bytes_per_device``, ``lower_s`` and
``compile_s`` are recorded as null.  The analytic count covers every layer,
so the JAX package's unrolled extrapolation has nothing to do here:
``--no-extrapolate`` is recorded, not acted on.

Per-device numbers divide each leaf by its placement under the rule tables
of ``launch.sharding`` (``param_shardings``, ``opt_state_shardings``,
``batch_shardings``, ``cache_shardings``) for ``--mesh-shape`` (default
``1,1``: one card); the flops and the non-weight bytes split evenly over
the devices.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --device cpu
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smat-ffn-1.3b \\
      --shape train_4k --batch 2 --seq 1024 [--out records.json]
  PYTHONPATH=src python -m repro_torch.launch.dryrun \\
      --arch smat-attn-1.3b:smoke --mesh-shape 2,2 --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import traceback

import numpy as np

from repro_torch.configs import SHAPES, cell_applicable, get_config, list_archs
from repro_torch.configs.base import ShapeCell
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import roofline as rl
from repro_torch.launch import sharding as sh
from repro_torch.launch import steps as st
from repro_torch.models import transformer as T
from repro_torch.obs import export as obs_export
from repro_torch.obs import trace as obs_trace


def make_mesh(mesh_shape=(1, 1)) -> mesh_lib.AbstractMesh:
    """The cell's mesh (shape and axis names only): ``(data, model)``, or
    ``(pod, data, model)`` for three sizes."""
    shape = tuple(int(x) for x in mesh_shape)
    axes = ("pod", "data", "model")[-len(shape):] if len(shape) == 3 \
        else ("data", "model")
    return mesh_lib.make_abstract_mesh(shape, axes)


def _mesh_name(mesh) -> str:
    return "x".join(str(s) for s in mesh_lib.axis_sizes(mesh).values())


def _placement(mesh, spec) -> int:
    """How many pieces a leaf is cut into under ``spec`` (the product of
    the sizes of the mesh axes it is sharded over)."""
    sizes = mesh_lib.axis_sizes(mesh)
    n = 1
    for a in spec:
        for name in (a if isinstance(a, tuple) else (a,)):
            if name is not None:
                n *= sizes[name]
    return n


def _leaf_bytes(t) -> int:
    return t.numel() * t.element_size()


def _per_device_bytes(mesh, leaves: dict, specs: dict) -> dict:
    """``{name: bytes one device holds}`` of flat ``leaves`` under their
    flat partition ``specs``."""
    return {k: _leaf_bytes(v) / _placement(mesh, specs[k])
            for k, v in leaves.items()}


def _cell_leaves(cfg, shape: ShapeCell, mesh, seq_shard_long: bool,
                 device):
    """``(arguments, outputs, weight_share)``: flat ``{name: per-device
    bytes}`` of the step's arguments and outputs, and of the floating
    parameters (the weights a device reads)."""
    params = T.flat_specs(T.param_specs(cfg, device=device))
    # inference cells use serve-mode weight rules (TP only, no FSDP) when
    # the batch amortizes the replicas, as the JAX package's dry-run does
    p_mode = "serve" if (shape.kind != "train" and
                         shape.global_batch >= 8) else "train"
    p_shard = sh.param_shardings(mesh, params, mode=p_mode)
    p_bytes = _per_device_bytes(mesh, params, p_shard)
    weights = {k: p_bytes[k] for k, v in params.items()
               if v.is_floating_point()}
    args = {"params." + k: b for k, b in p_bytes.items()}
    outs = {}
    batch = st.input_specs(cfg, shape)
    B = shape.global_batch
    cb = cfg.n_codebooks if cfg.input_mode == "codebooks" else 1
    if shape.kind == "train":
        opt = st.opt_specs(cfg, params)
        o_shard = sh.opt_state_shardings(mesh, opt, p_shard)
        o_flat, o_spec = T.flat_specs(opt), _flat_specs_of(o_shard)
        b_bytes = _per_device_bytes(mesh, batch,
                                   sh.batch_shardings(mesh, batch))
        args.update({"opt." + k: b for k, b in
                     _per_device_bytes(mesh, o_flat, o_spec).items()})
        args.update({"batch." + k: b for k, b in b_bytes.items()})
        # the step returns the updated params and state (in place: the
        # arguments' storage) and five 0-d float32 metrics
        outs.update({k: v for k, v in args.items()
                     if not k.startswith("batch.")})
        outs["metrics"] = 5 * 4
    elif shape.kind == "prefill":
        b_bytes = _per_device_bytes(mesh, batch,
                                   sh.batch_shardings(mesh, batch))
        args.update({"batch." + k: b for k, b in b_bytes.items()})
        cache = T.cache_specs(cfg, B, shape.seq_len)
        c_bytes = _per_device_bytes(mesh, T.flat_specs(cache), _flat_specs_of(
            sh.cache_shardings(mesh, cache, cfg)))
        outs.update({"cache." + k: b for k, b in c_bytes.items()})
        outs["logits"] = B * cfg.vocab_size * 4 * cb
    else:
        seq_shard = seq_shard_long and B < 8
        tok_spec = sh.batch_shardings(mesh, batch)["tokens"] if B >= 8 \
            else sh.P()
        args["batch.tokens"] = _leaf_bytes(batch["tokens"]) / \
            _placement(mesh, tok_spec)
        cache = T.cache_specs(cfg, B, shape.seq_len)
        c_bytes = _per_device_bytes(
            mesh, T.flat_specs(cache), _flat_specs_of(sh.cache_shardings(
                mesh, cache, cfg, seq_shard=seq_shard)))
        args.update({"cache." + k: b for k, b in c_bytes.items()})
        outs.update({"cache." + k: b for k, b in c_bytes.items()})
        outs["logits"] = B * cfg.vocab_size * 4 * cb
    return args, outs, weights


def _flat_specs_of(tree, prefix: str = "") -> dict:
    """``{dotted path: PartitionSpec}`` of a nested spec tree (a
    ``PartitionSpec`` is a tuple, so ``flat_specs`` would walk into it)."""
    if isinstance(tree, sh.PartitionSpec):
        return {prefix: tree}
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_specs_of(v, f"{prefix}.{k}" if prefix
                                      else str(k)))
        return out
    raise TypeError(f"not a spec tree: {type(tree).__name__}")


def run_cell(cfg, shape: ShapeCell, mesh=None, *, remat: str = "full",
             seq_shard_long: bool = True, donate: bool = True,
             extrapolate: bool = True, verbose: bool = True,
             device="cuda") -> dict:
    """One cell's record (the JAX package's keys): exact argument and
    output bytes per device from the specs, and the roofline of the
    analytic work count.  ``device`` keys the autotuner's ``shards="auto"``
    picks (``"cuda"`` needs a card).  ``remat``, ``donate`` and
    ``extrapolate`` are recorded: the count is the step's least work
    (forward + dX + dW; a recomputed forward is not counted)."""
    T.resolve_device(device)
    mesh = mesh if mesh is not None else make_mesh()
    n_dev = int(np.prod(list(mesh_lib.axis_sizes(mesh).values())))
    args, outs, weights = _cell_leaves(cfg, shape, mesh, seq_shard_long,
                                       device)
    work = rl.work_count(cfg, shape, n_devices=n_dev, device=device)
    w_dev = rl.weight_read_bytes(cfg, shape, weights)
    flops, nbytes = work.per_device(n_dev, w_dev)
    coll = {"counts": {}, "wire_bytes": work.wire_bytes,
            "mode": "analytic"}
    if work.wire_bytes:
        coll["counts"] = {"all-gather": (3 if shape.kind == "train" else 1)
                          * 3 * cfg.n_layers}
    model_flops = rl.model_flops_for(cfg, shape)
    roof = rl.compute_roofline(flops, nbytes, work.wire_bytes, n_dev,
                               model_flops, collectives=coll)
    rec = {
        "arch": cfg.name,
        "shape": shape.name,
        "mesh": _mesh_name(mesh),
        "n_devices": n_dev,
        "status": "ok",
        "remat": remat,
        "donate": donate,
        "extrapolate": extrapolate,
        "batch": shape.global_batch,
        "seq_len": shape.seq_len,
        "lower_s": None,
        "compile_s": None,
        "memory": {
            "argument_bytes": int(round(sum(args.values()))),
            "output_bytes": int(round(sum(outs.values()))),
            "temp_bytes": None,
            "peak_bytes_per_device": None,
        },
        "roofline": roof.to_dict(),
        "t_bound_s": roof.t_bound,
        "work": work.parts,
    }
    if verbose:
        print(f"[dryrun] {cfg.name} x {shape.name} ({shape.global_batch} x "
              f"{shape.seq_len}) @ {rec['mesh']}: args/dev="
              f"{rec['memory']['argument_bytes'] / 2**30:.3f}GiB "
              f"Tc={roof.t_compute * 1e3:.3f}ms "
              f"Tm={roof.t_memory * 1e3:.3f}ms "
              f"Tx={roof.t_collective * 1e3:.3f}ms -> {roof.bottleneck}")
        sys.stdout.flush()
    return rec


def sparse_shard_report(cfg, n_tokens: int = 512, device="cuda") -> dict:
    """Per-shard nnzb balance and ``auto`` kernel picks of the arch's
    partitioned sparse FFN (``SparsitySpec(shards=...)``); empty when it
    has none.  The picks come from the metas the model path dispatches on
    (``models.layers.mlp_sparse_metas``, merged over the stack), resolved
    on ``device`` for an ``n_tokens``-wide panel, each beside the static
    contract check (``verify_launch.verify_summary``)."""
    spec = cfg.ffn_sparsity
    from repro_torch.core import sparse_linear as sl
    if spec is None or not sl.is_sharded(spec):
        return {}
    from repro_torch.analysis import verify_launch as vl
    from repro_torch.kernels import ops as kops
    from repro_torch.launch import dist_spmm
    from repro_torch.models import attention as A
    from repro_torch.models import layers as L
    hints = tuple(range(cfg.n_layers))
    # balance and picks describe the SAME structures: the first layer's
    # gate and down pattern seeds
    seed0 = L.mlp_seed(hints[0])
    rep = {
        "gate_up": sl.shard_balance_report(cfg.d_model, cfg.d_ff, spec,
                                           seed=seed0, device=device),
        "down": sl.shard_balance_report(cfg.d_ff, cfg.d_model, spec,
                                        seed=seed0 + 2, device=device),
    }
    n_chunks = max(spec.shard_chunks, 1)
    for lname, (od, idim) in (("gate_up", (cfg.d_ff, cfg.d_model)),
                              ("down", (cfg.d_model, cfg.d_ff))):
        rep[lname]["resolved_shards"] = sl.resolved_shards(
            spec, od, idim, device=device)
        rep[lname]["shards_auto"] = spec.shards == "auto"
        rep[lname]["n_chunks"] = n_chunks
        rep[lname]["chunk_schedule"] = [
            list(c) for c in dist_spmm.chunk_schedule(n_tokens, n_chunks)]
    meta_in, meta_out = L.mlp_sparse_metas(spec, cfg.d_model, cfg.d_ff,
                                           hints, device)
    for lname, m in (("gate_up", meta_in), ("down", meta_out)):
        rep[lname]["auto_picks"] = [
            A.pick_label(*kops.resolve_backend("auto", None, sm, n_tokens,
                                               device=device))
            for sm in m.shard_metas]
        rep[lname]["verify"] = vl.verify_summary(m, n_tokens)
    return rep


def sparse_attention_report(cfg, seq_len: int = 512, device="cuda") -> dict:
    """Mask structure and kernel picks of the arch's block-sparse attention
    (``cfg.attn_sparsity``); empty when it has none: the mask report at
    ``seq_len`` (at least two block-rows) and the arch's head dim, the
    composed path's workspace and the fused path's running state, and the
    static contract check of the mask meta."""
    spec = getattr(cfg, "attn_sparsity", None)
    if spec is None:
        return {}
    from repro_torch.analysis import verify_launch as vl
    from repro_torch.analysis import workspace
    from repro_torch.models import attention as A
    seq = max(seq_len, spec.block[0] * 2)
    rep = A.attention_mask_report(spec, seq, head_dim=cfg.head_dim,
                                  device=device)
    meta = A.attention_mask_meta(spec.mask, seq, tuple(spec.block))
    rep["composed_workspace_bytes"] = \
        workspace.attn_composed_workspace_bytes(meta)
    rep["fused_state_bytes"] = \
        workspace.attn_fused_state_bytes(tuple(spec.block), cfg.head_dim)
    rep["verify"] = vl.verify_summary(meta, cfg.head_dim, op="attn")
    return rep


def paged_kv_report(cfg, cache_len: int = 512, n_slots: int = 4) -> dict:
    """Paged block-sparse KV accounting for serving (``serve.paged_kv``);
    empty when the arch has no ``attn_sparsity`` or no k/v attention rings
    (a layout other than ``attn_mlp`` and ``gemma_pair``).  Also places the page tables through
    ``sharding.cache_shardings`` on a one-card mesh, so the page-table
    leaf rules stay read."""
    spec = getattr(cfg, "attn_sparsity", None)
    if spec is None or cfg.layout not in ("attn_mlp", "gemma_pair"):
        return {}
    from repro_torch.serve.paged_kv import PagedKVCache  # local: layering
    paged = PagedKVCache(cfg, cache_len, n_slots)
    rep = paged.report()
    leaves = paged.table_leaves(device="meta")
    if leaves:
        shardings = sh.cache_shardings(make_mesh(), leaves, cfg)
        rep["table_leaf_specs"] = {
            g: {k: str(s) for k, s in d.items()}
            for g, d in shardings.items()}
    return rep


def _print_reports(cfg, shard_rep, attn_rep, kv_rep) -> None:
    for lname, r in shard_rep.items():
        print(f"[dryrun] {cfg.name} sparse shard balance [{lname}]: "
              f"{r['n_shards']} shards, nnzb loads {r['loads']} "
              f"(imbalance {r['imbalance']}x vs contiguous "
              f"{r['contig_imbalance']}x), auto picks {r['auto_picks']}")
    if attn_rep:
        print(f"[dryrun] {cfg.name} sparse attention mask: "
              f"{attn_rep['mask']['kind']} nnzb={attn_rep['nnzb']} "
              f"({attn_rep['block_density_vs_causal']}x of dense-causal "
              f"blocks at seq {attn_rep['seq_len']}), "
              f"impl={attn_rep['attn_impl']} "
              f"(attn={attn_rep['attn_pick']}), picks "
              f"sddmm={attn_rep['sddmm_pick']} spmm={attn_rep['spmm_pick']}")
    for g in kv_rep.get("groups", ()):
        extra = ("" if not g.get("paged") else
                 f", {g['pages_touched_per_step']}/{g['n_pages']} "
                 "pages/step")
        print(f"[dryrun] {cfg.name} paged KV [{g['group']}]: "
              f"{g.get('n_pages', 0)} pages x {g.get('page_bytes', 0)} B, "
              f"resident {g.get('resident_bytes', 0)} B over "
              f"{g['n_layers']} layers (paged={g['paged']}{extra})")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--mesh-shape", default="1,1",
                    help="axes data,model (e.g. 2,4) or pod,data,model")
    ap.add_argument("--remat", default="full",
                    choices=["none", "full", "dots", "names"])
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--no-seq-shard-long", action="store_true")
    ap.add_argument("--no-extrapolate", action="store_true",
                    help="recorded only: the analytic count needs no "
                         "unrolled extrapolation")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = T.resolve_device(args.device)
    mesh = make_mesh(args.mesh_shape.split(","))
    archs = list_archs() if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    records = []
    for a in archs:
        cfg = get_config(a)
        with obs_trace.span("dryrun.shard_report", arch=cfg.name):
            shard_rep = sparse_shard_report(cfg, device=device)
        with obs_trace.span("dryrun.attention_report", arch=cfg.name):
            attn_rep = sparse_attention_report(cfg, device=device)
        with obs_trace.span("dryrun.paged_kv_report", arch=cfg.name):
            kv_rep = paged_kv_report(cfg)
        _print_reports(cfg, shard_rep, attn_rep, kv_rep)
        for status, rep in (("sparse_shards", shard_rep),
                            ("sparse_attention", attn_rep),
                            ("paged_kv", kv_rep)):
            if rep:
                records.append({"arch": cfg.name, "status": status,
                                status: rep})
        for s in shapes:
            cell = SHAPES[s]
            if args.batch or args.seq:
                cell = dataclasses.replace(
                    cell, global_batch=args.batch or cell.global_batch,
                    seq_len=args.seq or cell.seq_len)
            ok, why = cell_applicable(cfg, cell)
            if not ok:
                records.append({"arch": cfg.name, "shape": cell.name,
                                "mesh": _mesh_name(mesh), "status": "skip",
                                "reason": why})
                print(f"[dryrun] SKIP {cfg.name} x {cell.name}: {why}")
                continue
            try:
                with obs_trace.span("dryrun.cell", arch=cfg.name,
                                    shape=cell.name):
                    records.append(run_cell(
                        cfg, cell, mesh, remat=args.remat,
                        seq_shard_long=not args.no_seq_shard_long,
                        extrapolate=not args.no_extrapolate, device=device))
            except Exception as e:  # noqa: BLE001 -- recorded, exit 1
                traceback.print_exc()
                records.append({"arch": cfg.name, "shape": cell.name,
                                "status": "error", "error": repr(e)})

    if args.out:
        with open(args.out, "w") as f:
            json.dump(records, f, indent=1)
        print(f"[dryrun] wrote {len(records)} records -> {args.out}")
    if obs_trace.enabled():
        print("[dryrun] trace summary:")
        print(obs_export.summary_tree(obs_trace.get_events()))
    n_err = sum(r["status"] == "error" for r in records)
    n_ok = sum(r["status"] == "ok" for r in records)
    print(f"[dryrun] {n_ok} cells ok, {n_err} errors")
    return 1 if n_err else 0


if __name__ == "__main__":
    sys.exit(main())

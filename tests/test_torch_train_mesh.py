"""The port's training mesh over ``torch.distributed`` CPU ranks (``gloo``),
against its own unsharded ``train(..., mesh=None)`` and against the JAX
package's loop, ``train(cfg, shape, make_mesh((1, 1), ("data", "model")))``
(GSPMD gives the same result on any mesh), from the same JAX seed-0
weights.

One group of 4 processes (``torch.multiprocessing``, a ``FileStore`` under
a temporary directory; no TCP port) runs every case; each test reads its
case's results (rank by rank).  Beside it, a child process runs the JAX
side (``jax_mesh_reference.py``): it writes the weights every run starts
from and the R = 4 ranks' gradients first, then the JAX losses, step-0
gradients and error feedback outputs.  This process runs the unsharded
runs (and the same runs in float64, for the floors below) and a one-rank
``(1, 1)`` gloo mesh meanwhile.

* compute split over ``model`` (``launch.steps.split_leaves``):
  ``smat-ffn-1.3b:smoke`` on ``(1, 4)`` (2 kv heads: ``wk``/``wv`` stay
  whole) and ``(2, 2)``, ``smat-attn-1.3b:smoke`` and ``minitron-4b:smoke``
  (a dense FFN, and two variants whose heads, hidden or vocab the axis
  does not divide) on ``(1, 4)``, float32, 4 steps;
  ``deepseek-v2-lite-16b:smoke`` (``mla_moe``: MLA's heads, the routed
  experts over ``model``, the shared experts' hidden columns) on ``(1,
  4)`` and ``(2, 2)``, ``mamba2-1.3b:smoke`` (``ssd``, under
  ``remat="full"``), ``deepseek-v2-236b:smoke`` (a ``q_lora_rank``) and two
  MoE variants whose routed bank stays whole (6 experts; the ``einsum``
  dispatch), ``gemma2-27b:smoke`` (``gemma_pair``: both halves),
  ``zamba2-7b:smoke`` (the shared block's shards in every unit),
  ``musicgen-medium:smoke`` (``codebooks``: each table split on its
  vocab), ``pixtral-12b:smoke`` (``tokens+patches``: 8 patches and 24
  tokens on the carry) and its vocab-514 variant (the loss of the rank's
  text positions) on ``(1, 4)``, 2 steps; against the unsharded run: losses
  within 1e-5 relative; step-0 gradients, gathered over ``model``, within
  1e-6 x max|grad| plus the leaf's float32 floor (the unsharded float32
  gradient's distance from the float64 one: up to 2e-6 x max on
  ``wk``/``wq``, where the heads' partial sums meet in another order);
  the MoE load-balance loss within 1e-6 at step 0; the final parameters
  within 1e-5 x max plus twice their float64 floor (AdamW turns float32
  noise in a near-zero gradient into a step-sized difference); against
  the JAX loop's losses (1e-5) and ``jax.grad`` (1e-6 x max plus twice
  the floor); per rank, the gathered shapes (1/model of the head-,
  hidden-, expert- and vocab-split leaves), B1/B2 on 1/model of the tokens
  and B5 and the batched products on 1/model of the heads, with the
  unsharded step's number of calls; the collectives and their backwards
  against their definitions, and which leaves split;
* the split ``_embed`` of ``gemma2-27b:smoke``, ``musicgen-medium:smoke``
  and ``pixtral-12b:smoke`` on ``(1, 4)``, float32 and bfloat16: each
  rank's rows bit-equal to its positions of the unsharded ``_embed``;
* ``(1, 4)`` with ``gemma2-27b:smoke`` on 4 x 30 tokens (the axis does not
  divide the sequence, so the compute stays replicated over ``model``):
  losses, step-0 gradients and the final checkpoint (parameters and AdamW
  state) bit-equal to the unsharded run's, the checkpoint byte for byte;
  the one-rank ``(1, 1)`` mesh's losses bit-equal too;
* ``(2, 2, 1)`` (pod, data, model) and ``(4, 1)``, data-parallel only:
  losses within 1e-5 relative, the step-0 gradients summed over the data
  group within 1e-6 x max|grad|;
* storage: each rank's bytes of every parameter, buffer, AdamW leaf and
  batch leaf equal ``launch.dryrun``'s per-device bytes at that mesh
  (``_cell_leaves``, which divides by ``_per_device_bytes``), for the
  ``smat-ffn-1.3b`` meshes, the split MoE and the split gemma_pair;
* ``deepseek-v2-lite-16b:smoke`` on ``(4, 1)``: loss and MoE ``aux_loss``
  within 1e-5 (the global means of ``lm_loss`` and ``moe._route``);
* a batch of 2 on ``(4, 1)``: the data axes do not divide it, so it is
  replicated and the losses are unchanged (1e-5);
* an injected failure on ``(2, 2)``, a relaunch through ``mesh_factory``
  onto ``(4, 1)``: the losses after resuming within 1e-5 of the
  uninterrupted run's;
* a ``(pod, data, model) = (2, 2, 1)`` mesh: a dim sharded over ``("pod",
  "data")`` takes the JAX order (pod major) and gathers back; a dim over
  the size-1 ``model`` axis gathers to the shard itself (no copy);
* against the JAX package, within 1e-4 (the ROADMAP's tolerance for model
  loss: the packages sum in float32 in different orders): the JAX loop's
  losses for the ``smat-ffn-1.3b`` cases on 4 x 32 tokens and the
  one-rank mesh, and for the MoE on ``(4, 1)`` (its step-0 ``aux_loss``
  too); JAX's ``train_loss`` at step 0 for the undivided batch, whose
  later steps the unsharded port holds;
* ``optim.compress``: two error-feedback steps over a ``("data",)`` mesh of
  the 4 ranks against ``jax.vmap(..., axis_name="data")`` over R = 4
  simulated ranks: residuals bit-equal, the summed ``g_hat`` within 1e-6 x
  max (the sums run in another order).

Every rank returns the same ``TrainResult``.  The file imports no JAX:
``spawn`` re-imports it in every worker.
"""
# ruff: noqa: E402
import pytest

pytest.importorskip("torch")

import contextlib
import dataclasses
import io
import os
import subprocess
import sys
import tempfile
import time
import traceback
import types
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeCell
from repro_torch.data.pipeline import make_batch
from repro_torch.launch import constrain
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import sharding as sh
from repro_torch.launch import steps as st
from repro_torch.models import transformer as T
from repro_torch.optim import adamw, compress
from repro_torch.train import loop

ARCH, MOE = "smat-ffn-1.3b:smoke", "deepseek-v2-lite-16b:smoke"
ATTN = "smat-attn-1.3b:smoke"
DENSE = "minitron-4b:smoke"                # a dense FFN
SSD = "mamba2-1.3b:smoke"
DS236 = "deepseek-v2-236b:smoke"           # MLA with a q_lora_rank
GEMMA = "gemma2-27b:smoke"                 # gemma_pair
ZAMBA = "zamba2-7b:smoke"                  # zamba: a shared block
AUDIO = "musicgen-medium:smoke"            # codebooks
VLM = "pixtral-12b:smoke"                  # tokens+patches: 24 + 8 patches
SHAPE = ShapeCell("t", "train", 32, 4)
SMALL = ShapeCell("t", "train", 32, 2)    # (4, 1) does not divide it
ODD = ShapeCell("t", "train", 30, 4)      # (1, 4) does not divide 30
STEPS, MOE_STEPS, EF_STEPS = 4, 2, 2
MESHES = ((1, 4), (2, 2), (4, 1))
DATA_MESHES = ((2, 2, 1), (4, 1))         # model = 1: data-parallel only
# the runs whose compute splits over ``model`` and the JAX package holds
# too: (case, arch, mesh)
SPLIT = (("ffn1x4", ARCH, (1, 4)), ("ffn2x2", ARCH, (2, 2)),
         ("attn1x4", ATTN, (1, 4)), ("moe1x4", MOE, (1, 4)),
         ("moe2x2", MOE, (2, 2)), ("ssd1x4", SSD, (1, 4)),
         ("gemma1x4", GEMMA, (1, 4)), ("zamba1x4", ZAMBA, (1, 4)),
         ("audio1x4", AUDIO, (1, 4)), ("vlm1x4", VLM, (1, 4)))
# the fit rule's other side: a dim the model axis does not divide stays
# replicated (6 heads: attention whole on every rank; d_ff 258: the dense
# FFN token-wise on the rank's positions; vocab 514: embedding and loss on
# the rank's positions; 6 experts: the routed bank whole on every rank);
# the einsum dispatch keeps the bank whole too (the JAX package constrains
# nothing in it); pixtral with vocab 514: the loss scores the text
# positions among the rank's positions of the carry
HEADS6 = DENSE + "/heads6"
VOCAB514 = DENSE + "/vocab514"
VLM514 = VLM + "/vocab514"
EXPERTS6 = MOE + "/experts6"
EINSUM = MOE + "/einsum"
VARIANTS = {"heads6": {"n_heads": 6, "d_ff": 258}, "vocab514":
            {"vocab_size": 514}, "experts6": {"n_experts": 6},
            "einsum": {"moe_dispatch": "einsum"}}
# every split run (no JAX reference for the others); new cases go last, as
# a case's place in the list is part of its test's id
SPLIT_ALL = SPLIT[:3] + (("dense1x4", DENSE, (1, 4)),
                         ("heads61x4", HEADS6, (1, 4)),
                         ("vocab5141x4", VOCAB514, (1, 4))) + SPLIT[3:6] + (
    ("ds2361x4", DS236, (1, 4)), ("experts61x4", EXPERTS6, (1, 4)),
    ("einsum1x4", EINSUM, (1, 4))) + SPLIT[6:] + (
    ("vlm5141x4", VLM514, (1, 4)),)
# the runs whose final parameters are held (and run in float64 for that)
FINAL = SPLIT_ALL[:4] + SPLIT[3:]
# the REFS keys whose split runs' final parameters are held in float64 runs
# too: AdamW's m / sqrt(v) turns the float32 split's noise in the norm
# scales' near-zero gradients into single elements past the float32 bound
# (2.1x in one of 128 of ``blocks.1.ln1`` on (1, 4); 1.2x in ``embed`` of
# gemma2-27b:smoke, 1.4x in ``lm_head`` of musicgen-medium:smoke)
FINAL64 = ("moe", "gemma", "audio")
REFS = {"ffn": ARCH, "attn": ATTN, "dense": DENSE, "heads6": HEADS6,
        "vocab514": VOCAB514, "moe": MOE, "ssd": SSD, "ds236": DS236,
        "experts6": EXPERTS6, "einsum": EINSUM, "gemma": GEMMA,
        "zamba": ZAMBA, "audio": AUDIO, "vlm": VLM, "vlm514": VLM514}
# the MLA/MoE, SSD and later layouts' runs train MOE_STEPS steps, the SSD
# run under remat="full" (the collectives run again in the backward's
# recompute)
SHORT = ("moe", "ssd", "ds236", "experts6", "einsum", "gemma", "zamba",
         "audio", "vlm", "vlm514")
REMAT = {"ssd": "full"}
WORLD = 4
SPAWN_TIMEOUT_S = 300      # the group takes about 25 s
JAX_TOL = 1e-4
TESTS = Path(__file__).resolve().parent


def _cfg(arch):
    """``arch``'s config in float32 (``<arch>/<variant>``: with VARIANTS'
    fields replaced, and named so: the JAX weights are the base arch's)."""
    base, _, variant = arch.partition("/")
    return dataclasses.replace(get_config(base), dtype="float32", name=arch,
                               **VARIANTS.get(variant, {}))


def _kw(steps=STEPS, remat="none"):
    return dict(total_steps=steps, ckpt_every=2, remat=remat,
                opt_cfg=adamw.AdamWConfig(lr=1e-3, total_steps=steps,
                                          warmup_steps=1))


def _steps(key):
    """The steps the REFS key ``key``'s runs train."""
    return MOE_STEPS if key in SHORT else STEPS


def _key_kw(key):
    """``_kw`` of the mesh runs of the REFS key ``key``."""
    return _kw(_steps(key), REMAT.get(key, "none"))


def _mesh(shape):
    axes = ("pod", "data", "model")[-len(shape):]
    return mesh_lib.make_mesh(shape, axes, device_type="cpu")


def _batch(cfg, shape, step=0):
    return loop.batch_to_device(make_batch(cfg, shape, step), "cpu")


def _name(shape):
    return "x".join(map(str, shape))


@contextlib.contextmanager
def _widths():
    """Record the widths every kernel wrapper is called at, by wrapper:
    ``(G, N)`` for the SpMM (B1) and SDDMM (B2) ones (G = 1 for an
    unbatched call; N the panel's columns), ``(G,)`` for B5."""
    from repro_torch.kernels import bcsr_attn
    from repro_torch.kernels import bcsr_spmm as pk
    seen = {"spmm": [], "sddmm": [], "attn": []}
    own = {"spmm": pk.bcsr_spmm_nnz_stream, "sddmm": pk.bcsr_sddmm,
           "attn": bcsr_attn.bcsr_attn_fused}

    def spmm(vals, row_ids, col_ids, b, *args, **kw):
        seen["spmm"].append((vals.shape[0] if vals.dim() == 4 else 1,
                             b.shape[-1]))
        return own["spmm"](vals, row_ids, col_ids, b, *args, **kw)

    def sddmm(dc, b, *args, **kw):
        seen["sddmm"].append((dc.shape[0] if dc.dim() == 3 else 1,
                              dc.shape[-1]))
        return own["sddmm"](dc, b, *args, **kw)

    def attn(q, *args, **kw):
        seen["attn"].append((q.shape[0],))
        return own["attn"](q, *args, **kw)
    pk.bcsr_spmm_nnz_stream, pk.bcsr_sddmm = spmm, sddmm
    bcsr_attn.bcsr_attn_fused = attn
    try:
        yield seen
    finally:
        pk.bcsr_spmm_nnz_stream, pk.bcsr_sddmm = own["spmm"], own["sddmm"]
        bcsr_attn.bcsr_attn_fused = own["attn"]


@contextlib.contextmanager
def _gathered_shapes(root):
    """Record the shape of every parameter of the module ``root`` as each
    group the model runs computes with it (inside
    ``launch.constrain.gathered``: the mesh step's gathered parameters,
    one group at a time)."""
    own = T.gathered
    prefix = {id(m): n + "." if n else "" for n, m in root.named_modules()}
    shapes = {}

    @contextlib.contextmanager
    def gathered(module, names=None):
        with own(module, names):
            shapes.update({prefix[id(module)] + n: tuple(p.shape)
                           for n, p in module.named_parameters()
                           if names is None or n in names})
            yield
    T.gathered = gathered
    try:
        yield shapes
    finally:
        T.gathered = own


def _block(mesh, spec, shape):
    """This rank's block of a tensor of ``shape`` under ``spec``: a
    ``(start, stop)`` a dim."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple((int(r[0]), int(r[-1]) + 1) for r in (
        sh.local_shard(mesh, torch.arange(n), sh.P(a))
        for n, a in zip(shape, spec)))


def _nbytes(t):
    t = sh.local(t)
    return t.numel() * t.element_size()


def _wait_for(out_dir, name, jax_proc=None, timeout_s=SPAWN_TIMEOUT_S):
    """The JAX side's ``<name>.npz`` as a dict, once it is written.  Fails
    with its log if the JAX process ``jax_proc`` failed first."""
    path = Path(out_dir) / f"{name}.npz"
    deadline = time.monotonic() + timeout_s
    while not path.exists():
        if jax_proc is not None and jax_proc.poll():
            log = (Path(out_dir) / "jax.log").read_text()
            pytest.fail(f"the JAX reference process exited "
                        f"{jax_proc.returncode}:\n{log[-4000:]}")
        if time.monotonic() > deadline:
            raise TimeoutError(f"no {path} in {timeout_s} s")
        time.sleep(0.1)
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _inputs(out_dir, jax_proc=None):
    """What the JAX side writes first: its seed-0 weights, a nested numpy
    tree by arch, and the R ranks' gradients (a leading rank axis)."""
    weights, grads = {}, {}
    for key, value in _wait_for(out_dir, "inputs", jax_proc).items():
        kind, rest = key.split("/", 1)
        if kind == "g":
            grads[rest] = value
            continue
        arch, *parents, leaf = rest.split("/")
        node = weights.setdefault(arch, {})
        for name in parents:
            node = node.setdefault(name, {})
        node[leaf] = value
    return weights, grads


def _use_jax_weights(weights):
    """Make ``T.init_params(cfg, seed=0)`` build the JAX seed-0 weights of
    ``cfg`` (by name) where ``weights`` holds them; returns the function it
    replaced."""
    own = T.init_params

    def init_params(cfg, seed=0, device="cuda"):
        if seed == 0 and cfg.name in weights:
            return convert.params_from_jax(cfg, weights[cfg.name], device)
        return own(cfg, seed=seed, device=device)
    T.init_params = init_params
    return own


@contextlib.contextmanager
def _jax_weights(weights):
    own = _use_jax_weights(weights)
    try:
        yield
    finally:
        T.init_params = own


# ------------------------------------------------------------- the ranks
def _storage_and_grads(mesh, cfg, shape=SHAPE):
    """Per-leaf local bytes (held, and the dry-run's) and the step-0
    gradients summed over the data group."""
    model = st.shard_model(T.init_params(cfg, seed=0, device="cpu"), mesh)
    opt = st.init_opt_state(model)
    b_specs = sh.batch_shardings(mesh, st.input_specs(cfg, shape))
    batch = sh.distribute_tree(mesh, _batch(cfg, shape), b_specs)
    held = {"params." + k: _nbytes(v) for k, v in model.state_dict().items()}
    held.update({"opt." + k: _nbytes(v)
                 for k, v in T.flat_specs(opt).items()})
    held.update({"batch." + k: _nbytes(v) for k, v in batch.items()})
    want, _, _ = dryrun._cell_leaves(cfg, shape, mesh, False, "meta")
    with _widths() as widths, _gathered_shapes(model.module) as shapes:
        metrics, grads = st.mesh_loss_and_grads(cfg, model, batch,
                                                remat="none")
    record = dict(st.RECORD)
    split = sorted(n for n, s in shapes.items()
                   if s != tuple(model.shards[n].shape))
    return {"held": held, "want": want, "loss0": float(metrics["loss"]),
            "aux0": float(metrics["aux_loss"]),
            "grads": sh.full(grads), "split": split, "widths": widths,
            "shapes": shapes, "record": record,
            "shards": {n: (g.to_local().clone(),
                           _block(mesh, model.specs[n], g.shape))
                       for n, g in grads.items() if g is not None},
            "model_index": mesh_lib.model_group(mesh)[1],
            "batch_rows": sh.local(batch)["tokens"].shape[0]}


def _case_run(name, arch, shape, out_dir, kw=None, cell=SHAPE):
    """Step-0 storage and gradients on the mesh ``shape``, then
    ``loop.train`` of ``cell`` (``kw``, default ``_kw()``) checkpointed
    under ``out_dir/ckpt_<name>``."""
    mesh = _mesh(shape)
    cfg = _cfg(arch)
    out = _storage_and_grads(mesh, cfg, cell)
    ckpt = f"{out_dir}/ckpt_{name}"
    out["result"] = dataclasses.asdict(
        loop.train(cfg, cell, mesh, ckpt_dir=ckpt, **(kw or _kw())))
    return out


def _case_final64(name, arch, shape, out_dir):
    """The split run ``name`` of a FINAL64 key in float64, checkpointed
    under ``out_dir/ckpt_<name>64``."""
    cfg = dataclasses.replace(_cfg(arch), dtype="float64")
    loop.train(cfg, SHAPE, _mesh(shape), ckpt_dir=f"{out_dir}/ckpt_{name}64",
               **_key_kw(name[:-3]))
    return {}


def _case_moe(out_dir):
    res = loop.train(_cfg(MOE), SHAPE, _mesh((4, 1)), **_kw(MOE_STEPS))
    return {"result": dataclasses.asdict(res)}


def _case_undivided(out_dir):
    mesh = _mesh((4, 1))
    cfg = _cfg(ARCH)
    spec = sh.batch_shardings(mesh, st.input_specs(cfg, SMALL))["tokens"]
    res = loop.train(cfg, SMALL, mesh, **_kw())
    return {"spec": tuple(spec), "result": dataclasses.asdict(res),
            "record": dict(st.RECORD)}


def _case_elastic(out_dir):
    def mesh_factory(restart_idx):
        return _mesh((2, 2) if restart_idx == 0 else (4, 1))
    res = loop.train_with_restarts(_cfg(ARCH), SHAPE, mesh_factory,
                                   ckpt_dir=f"{out_dir}/elastic",
                                   fail_at_step=3, **_kw())
    return {"result": dataclasses.asdict(res)}


def _case_pod_order(out_dir):
    mesh = _mesh((2, 2, 1))
    full = torch.arange(8 * 3, dtype=torch.float32).reshape(8, 3)
    spec = sh.P(("pod", "data"), None)
    d = sh.shard_tensor(mesh, full, spec)
    coord = mesh.get_coordinate()
    piece = coord[0] * 2 + coord[1]
    # a dim over the size-1 model axis: the gather is the shard itself
    one = sh.shard_tensor(mesh, full, sh.P(None, "model"))
    # the per-layer gather's collectives: a block over ("pod", "data") and
    # over "data" alone (replicated over pod) gathered back, and each
    # rank's gradient summed over the 4 ranks into the rank's block
    rank = dist.get_rank()
    grad = _rank_tensor(rank, (8, 3))
    over = {}
    for name, spec in (("pod_data", sh.P(("pod", "data"), None)),
                       ("data", sh.P("data", None))):
        local = sh.local_shard(mesh, full, spec)
        over[name] = (torch.equal(sh.gather_data(mesh, local, spec), full),
                      sh.scatter_grad(mesh, grad, spec),
                      _block(mesh, spec, full.shape))
    return {"local": torch.equal(d.to_local(), full[2 * piece:2 * piece + 2]),
            "gathered": torch.equal(d.full_tensor(), full),
            "placements": [str(p) for p in d.placements],
            "size1_alias": one.full_tensor().data_ptr() ==
            one.to_local().data_ptr(), "layer": over}


# the archs whose split ``_embed`` is held bit-equal to the unsharded one:
# the gemma_pair scale, the ordered codebook sum, the patch rows
EMBED_ARCHS = (GEMMA, AUDIO, VLM)
EMBED_DTYPES = ("float32", "bfloat16")


def _case_embed(out_dir):
    """The split ``_embed`` on a ``(1, 4)`` mesh, each rank with its vocab
    shard of ``embed`` as the mesh step gathers it, against this rank's
    positions of the unsharded ``_embed``: bit-equal or not, by arch and
    dtype."""
    mesh = _mesh((1, 4))
    index = mesh_lib.model_group(mesh)[1]
    out = {}
    for arch in EMBED_ARCHS:
        for dtype in EMBED_DTYPES:
            cfg = dataclasses.replace(_cfg(arch), dtype=dtype)
            full = T.init_params(cfg, seed=0, device="cpu")
            batch = _batch(cfg, SHAPE)
            with torch.no_grad():
                want = T._embed(cfg, full, batch).chunk(4, dim=1)[index]
                model = st.shard_model(full, mesh)
                shard = sh.gather_data(mesh,
                                       model.shards["embed"].to_local(),
                                       model.specs["embed"])
                with constrain.use_mesh(mesh, split=True):
                    got = T._embed(cfg, types.SimpleNamespace(embed=shard),
                                   batch)
            out[arch, dtype] = (tuple(shard.shape), got.dtype == want.dtype
                                and torch.equal(got, want))
    return out


def _rank_tensor(rank, shape, dtype=torch.float32):
    """A tensor every rank can rebuild for any rank."""
    n = int(np.prod(shape))
    return (torch.arange(n, dtype=torch.float64).reshape(shape) * 0.37
            + 100.0 * rank - n / 5).to(dtype)


def _case_collectives(out_dir):
    """Each collective of the split, forward and backward, on a ``(1, 4)``
    mesh: an input and an upstream gradient that depend on the rank
    (``_rank_tensor``); the same calls with no split."""
    rank = dist.get_rank()
    out = {}

    def run(name, fn, x_shape, dtype=torch.float32):
        x = _rank_tensor(rank, x_shape, dtype).requires_grad_()
        y = fn(x)
        y.backward(_rank_tensor(rank + 7, y.shape, dtype))
        out[name] = (y.detach(), x.grad)
    with constrain.use_mesh(_mesh((1, 4)), split=True):
        split = constrain.model_split()
        out["split"] = (split.index, split.size)
        run("gather", lambda x: constrain.gather(x, 1), (2, 3, 5))
        run("scatter", lambda x: constrain.scatter(x, 1), (2, 8, 5))
        run("scatter_bf16", lambda x: constrain.scatter(x, 2), (3, 2, 8),
            torch.bfloat16)
        run("reduce", constrain.reduce, (4, 3))
        run("enter", lambda x: constrain.enter(x) * 1.0, (4, 3))
        run("local_seq", lambda x: constrain.local_seq(x, 1), (2, 8, 3))
        out["pmax"] = constrain.pmax_model(_rank_tensor(rank, (5,)))
    with constrain.use_mesh(_mesh((1, 4))):    # no split: identities
        x = _rank_tensor(rank, (2, 8))
        out["no_split"] = (constrain.model_split(),
                           all(f(x) is x for f in (
                               lambda t: constrain.gather(t, 1),
                               lambda t: constrain.scatter(t, 1),
                               constrain.reduce, constrain.enter,
                               constrain.local_seq, constrain.pmax_model)))
    return out


def _case_error_feedback(grads):
    """This rank's row of ``grads`` (bf16 where the name says so) through
    EF_STEPS steps of ``ef_compress_grads``, and ``compressed_psum`` of
    ``w``, over a ``("data",)`` mesh of every rank."""
    rank = dist.get_rank()
    g = {}
    for name, a in grads.items():
        t = torch.from_numpy(np.ascontiguousarray(a[rank]))
        g[name] = t.to(torch.bfloat16) if name.startswith("bf16") else t
    out = {"g_hat": [], "residual": []}
    mesh = mesh_lib.make_mesh((WORLD,), ("data",), device_type="cpu")
    with constrain.use_mesh(mesh):
        residual = compress.init_residual(g)
        for _ in range(EF_STEPS):
            g_hat, residual = compress.ef_compress_grads(g, residual, "data")
            out["g_hat"].append(g_hat)
            out["residual"].append(residual)
        out["psum"] = compress.compressed_psum(g["w"], "data")
    return out


# the per-layer gather's runs over data groups of more than one rank:
# (case, arch, mesh), one step each under each of LAYER_REMATS on SHAPE
# (ODD_DP for the case named in LAYER_CELLS: the model axis does not divide
# its 31 positions, so no leaf splits and the model-sharded ones are
# gathered over both axes; the einsum dispatch's expert bank is sharded
# over both axes but computed whole beside the split, so its gradient is
# summed over the model group before its block is taken), and the key of
# their unsharded step's references
ODD_DP = ShapeCell("t", "train", 31, 4)
LAYERS = (("ffn4x1", ARCH, (4, 1)), ("ffn2x2x1", ARCH, (2, 2, 1)),
          ("gemma2x2", GEMMA, (2, 2)), ("moe2x2", MOE, (2, 2)),
          ("zamba4x1", ZAMBA, (4, 1)), ("ffn2x2odd", ARCH, (2, 2)),
          ("einsum2x2", EINSUM, (2, 2)))
LAYER_REMATS = ("none", "full")
LAYER_CELLS = {"ffn2x2odd": ODD_DP}
LAYER_REFS = {"ffn4x1": "ffn", "ffn2x2x1": "ffn", "gemma2x2": "gemma",
              "moe2x2": "moe", "zamba4x1": "zamba", "ffn2x2odd": "ffn_odd",
              "einsum2x2": "einsum"}


def _case_layers(out_dir):
    """One mesh step of each of LAYERS under each of LAYER_REMATS: the
    step's record and events, its loss and its gradients gathered
    whole."""
    out = {}
    st.EVENTS = []
    for case, arch, shape in LAYERS:
        mesh = _mesh(shape)
        cfg = _cfg(arch)
        cell = LAYER_CELLS.get(case, SHAPE)
        model = st.shard_model(T.init_params(cfg, seed=0, device="cpu"),
                               mesh)
        b_specs = sh.batch_shardings(mesh, st.input_specs(cfg, cell))
        batch = sh.distribute_tree(mesh, _batch(cfg, cell), b_specs)
        for remat in LAYER_REMATS:
            metrics, grads = st.mesh_loss_and_grads(cfg, model, batch,
                                                    remat=remat)
            out[case, remat] = {"record": dict(st.RECORD),
                                "events": list(st.EVENTS),
                                "loss0": float(metrics["loss"]),
                                "grads": sh.full(grads)}
    return out


CASES = {**{f"ffn{_name(m)}": (
    lambda o, m=m: _case_run(f"ffn{_name(m)}", ARCH, m, o))
    for m in MESHES + DATA_MESHES},
         **{c: (lambda o, c=c, a=a, m=m: _case_run(c, a, m, o,
                                                   _key_kw(c[:-3])))
            for c, a, m in SPLIT_ALL[2:]},
         **{f"{c}64": (lambda o, c=c, a=a, m=m: _case_final64(c, a, m, o))
            for c, a, m in FINAL if c[:-3] in FINAL64},
         "gemma_odd": lambda o: _case_run("gemma_odd", GEMMA, (1, 4), o,
                                          _kw(MOE_STEPS), ODD),
         "embed": _case_embed, "collectives": _case_collectives,
         "moe": _case_moe, "undivided": _case_undivided,
         "elastic": _case_elastic, "layers": _case_layers}


def _run(results, name, case, *args):
    try:
        results[name] = case(*args)
    except Exception:                  # reported by the case's own test
        results[name] = {"error": traceback.format_exc()}


def _worker(rank, world, store_path, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    try:
        results = {}
        _run(results, "pod_order", _case_pod_order, out_dir)
        weights, grads = _inputs(out_dir)   # the JAX process writes them
        _run(results, "ef", _case_error_feedback, grads)
        _use_jax_weights(weights)
        for name, case in CASES.items():
            _run(results, name, case, out_dir)
        torch.save(results, f"{out_dir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


# ------------------------------------------- the references, and the group
@pytest.fixture(scope="module")
def ranks():
    """Every rank's results, the port's unsharded runs and one-rank mesh
    run (in this process, no process group beside the one-rank one), and
    the JAX side's, on one thread as the ranks run (a CPU reduction's order
    depends on the thread count)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield _spawn_and_reference()
    finally:
        torch.set_num_threads(threads)


def _step0(cfg, dtype=None, shape=SHAPE):
    """The unsharded step-0 loss, gradients and kernel widths (the model in
    ``dtype`` when given)."""
    model = T.init_params(cfg, seed=0, device="cpu")
    if dtype is not None:
        model = model.to(dtype)
    with _widths() as widths:
        loss, parts = T.train_loss(cfg, model, _batch(cfg, shape),
                                   remat="none")
        loss.backward()
    return {"loss0": float(loss.detach()), "widths": widths,
            "aux0": float(parts["aux_loss"].detach()),
            "grads": {n: p.grad for n, p in model.named_parameters()}}


def _unsharded(tmp):
    cfg = _cfg(ARCH)
    final = {c[:-3] for c, _, _ in FINAL}
    return {**{f"{k}0": _step0(_cfg(a)) for k, a in REFS.items()},
            "gemma_odd0": _step0(_cfg(GEMMA), shape=ODD),
            "ffn_odd0": _step0(cfg, shape=ODD_DP),
            # the same steps in float64 (the attention core computes in
            # float32 either way): each leaf's float32 rounding floor
            "f64": {**{k: _step0(_cfg(a), torch.float64)["grads"]
                       for k, a in REFS.items()},
                    "ffn_odd": _step0(cfg, torch.float64, ODD_DP)["grads"]},
            **{k: loop.train(_cfg(a), SHAPE, device="cpu",
                             ckpt_dir=f"{tmp}/ckpt_ref_{k}", **_kw(_steps(k)))
               for k, a in REFS.items()},
            # the same runs in float64: the final parameters' floor
            **{f"{k}64": loop.train(
                dataclasses.replace(_cfg(REFS[k]), dtype="float64"), SHAPE,
                device="cpu", ckpt_dir=f"{tmp}/ckpt_ref64_{k}",
                **_kw(_steps(k)))
               for k in final},
            "gemma_odd": loop.train(_cfg(GEMMA), ODD, device="cpu",
                                    ckpt_dir=f"{tmp}/ckpt_ref_gemma_odd",
                                    **_kw(MOE_STEPS)),
            "small": loop.train(cfg, SMALL, device="cpu", **_kw())}


def _one_rank_mesh(tmp):
    """``train(cfg, SHAPE, mesh)`` on a ``(1, 1)`` mesh of a one-rank gloo
    group."""
    dist.init_process_group("gloo", store=dist.FileStore(f"{tmp}/store1", 1),
                            rank=0, world_size=1)
    try:
        res = loop.train(_cfg(ARCH), SHAPE, _mesh((1, 1)), **_kw())
        return res, dict(st.RECORD)
    finally:
        dist.destroy_process_group()


def _start_jax(tmp):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.pathsep.join(
        p for p in (str(TESTS.parent / "src"), os.environ.get("PYTHONPATH"))
        if p))
    with open(f"{tmp}/jax.log", "w") as log:
        return subprocess.Popen(
            [sys.executable, str(TESTS / "jax_mesh_reference.py"), tmp],
            env=env, stdout=log, stderr=subprocess.STDOUT)


def _spawn_and_reference():
    with tempfile.TemporaryDirectory() as tmp:
        jax_proc = _start_jax(tmp)
        ranks = mp.spawn(_worker, args=(WORLD, f"{tmp}/store", tmp),
                         nprocs=WORLD, join=False)
        try:
            weights, grads = _inputs(tmp, jax_proc)
            with _jax_weights(weights):
                ref = _unsharded(tmp)
                ref["one_rank"], ref["one_rank_record"] = \
                    _one_rank_mesh(tmp)
            ref["ef_grads"] = grads
            deadline = time.monotonic() + SPAWN_TIMEOUT_S
            while not ranks.join(timeout=5):
                if time.monotonic() > deadline:
                    pytest.fail(f"the {WORLD} ranks did not finish in "
                                f"{SPAWN_TIMEOUT_S} s")
            jax_ref = _wait_for(tmp, "reference", jax_proc)
        finally:
            for proc in ranks.processes:
                if proc.is_alive():
                    proc.kill()
            if jax_proc.poll() is None:
                jax_proc.kill()
        got = [torch.load(f"{tmp}/rank{r}.pt") for r in range(WORLD)]
        final = [c for c, _, _ in FINAL]
        last = {"ckpt_ref_gemma_odd": MOE_STEPS, "ckpt_gemma_odd": MOE_STEPS,
                **{f"ckpt{kind}_{name}": _steps(c[:-3]) for c in final
                   for kind, name in (("", c), ("", f"{c}64"),
                                      ("_ref", c[:-3]),
                                      ("_ref64", c[:-3]))}}
        ckpts = {name: {f: (Path(tmp) / name /
                            f"step_{last.get(name, STEPS):08d}" / f)
                        .read_bytes() for f in ("arrays.npz",
                                                "manifest.json")}
                 for name in (*(f"ckpt_ref_{c[:-3]}" for c in final),
                              *(f"ckpt_ref64_{c[:-3]}" for c in final),
                              *(f"ckpt_{c}" for c in final),
                              *(f"ckpt_{c}64" for c in final
                                if c[:-3] in FINAL64),
                              "ckpt_ref_gemma_odd", "ckpt_gemma_odd")}
        steps = {name: sorted(os.listdir(Path(tmp) / name))
                 for name in ("ckpt_ref_gemma_odd", "ckpt_gemma_odd",
                              "elastic")}
    return got, ref, ckpts, steps, jax_ref


def _case(ranks, name):
    got = [r[name] for r in ranks]
    for r, res in enumerate(got):
        assert "error" not in res, f"rank {r}:\n{res['error']}"
    return got


def _close(got, want, rtol=1e-5):
    np.testing.assert_allclose(got, want, rtol=rtol, atol=0)


def _same_result(got):
    """Every rank returned the same ``TrainResult``."""
    for res in got[1:]:
        assert res["result"] == got[0]["result"]
    return got[0]["result"]


def test_one_data_rank_is_bit_equal_to_unsharded(ranks):
    """``gemma2-27b:smoke`` on ``(1, 4)`` over 4 x 30 tokens: the ``model``
    axis does not divide the sequence, so the compute stays replicated over
    it (the fit rule); one data rank, so every step is the unsharded one,
    bit for bit."""
    got, ref, ckpts, steps, _ = ranks
    case = _case(got, "gemma_odd")
    res = _same_result(case)
    assert res["losses"] == ref["gemma_odd"].losses
    assert res["aux_losses"] == ref["gemma_odd"].aux_losses
    assert case[0]["loss0"] == ref["gemma_odd0"]["loss0"]
    assert case[0]["split"] == []
    # no gather and no reduce-scatter over the data group of one rank
    for c in case:
        assert c["record"] == dict.fromkeys(st.RECORD, 0), c["record"]
    for name, want in ref["gemma_odd0"]["grads"].items():
        assert torch.equal(case[0]["grads"][name], want), name
    # the final parameters and AdamW state, written on the mesh: the same
    # bytes as the unsharded run's checkpoint at the same step
    assert steps["ckpt_gemma_odd"] == steps["ckpt_ref_gemma_odd"] == \
        ["step_00000002"]
    assert ckpts["ckpt_gemma_odd"] == ckpts["ckpt_ref_gemma_odd"]


def test_model_axis_of_one_is_bit_equal_to_unsharded(ranks):
    """A ``model`` axis of one rank keeps the replicated step: the one-rank
    ``(1, 1)`` gloo mesh's losses equal the unsharded run's bit for bit,
    and its last step gathered and reduce-scattered nothing."""
    _, ref, _, _, _ = ranks
    assert ref["one_rank"].losses == ref["ffn"].losses
    assert ref["one_rank_record"] == dict.fromkeys(st.RECORD, 0)


@pytest.mark.parametrize("mesh", DATA_MESHES)
def test_data_parallel_mesh_matches_unsharded(ranks, mesh):
    """The step's gradients come back reduce-scattered: each rank's block
    of every leaf (its storage block) against the same block of the
    unsharded gradient."""
    got, ref, _, _, _ = ranks
    case = _case(got, f"ffn{_name(mesh)}")
    res = _same_result(case)
    assert case[0]["split"] == []
    _close(res["losses"], ref["ffn"].losses)
    _close(case[0]["loss0"], ref["ffn0"]["loss0"])
    for name, want in ref["ffn0"]["grads"].items():
        for r, c in enumerate(case):      # each rank holds its block
            shard, block = c["shards"][name]
            diff = (shard - want[tuple(slice(*b) for b in block)]).abs() \
                .max().item()
            assert diff <= 1e-6 * want.abs().max().item(), (mesh, r, name,
                                                            diff)


# ------------------------------------------- compute split over ``model``
def _split_case(ranks, case):
    got, ref, ckpts, _, jax_ref = ranks
    key = case[:-3]                       # a key of REFS
    return _case(got, case), ref[f"{key}0"], ref, ckpts, jax_ref, key


def _grad_tol(want, f64):
    """1e-6 x max|grad|, over the leaf's own float32 rounding floor: the
    unsharded float32 gradient's distance from the float64 one."""
    return 1e-6 * want.abs().max().item() + \
        (want.double() - f64).abs().max().item()


@pytest.mark.parametrize("case,arch,mesh", SPLIT_ALL)
def test_split_losses_match_unsharded(ranks, case, arch, mesh):
    got, want, ref, _, _, key = _split_case(ranks, case)
    _close(_same_result(got)["losses"], ref[key].losses)
    _close(got[0]["loss0"], want["loss0"])


@pytest.mark.parametrize("case,arch,mesh", SPLIT_ALL)
def test_split_step0_gradients_match_unsharded(ranks, case, arch, mesh):
    """Every rank's step-0 gradient, gathered over ``model``, against the
    unsharded one within 1e-6 x max|grad| plus the leaf's float32 floor
    (the split sums the heads' and ranks' partial products in another
    order; on ``wk``/``wq`` the floor reads up to 2e-6 x max)."""
    got, want, ref, _, _, key = _split_case(ranks, case)
    if _cfg(arch).layout == "mla_moe":
        # replicated compute whose gradient a rank could count m times
        assert {f"blocks.{i}.{n}" for i in (0, 1) for n in (
            "moe.router", "ln2", "mla.kv_norm", "mla.wkv_a")} <= \
            set(want["grads"])
    for name, g in want["grads"].items():
        tol = _grad_tol(g, ref["f64"][key][name])
        for r, c in enumerate(got):
            diff = (c["grads"][name] - g).abs().max().item()
            assert diff <= tol, (case, r, name, diff, tol)


@pytest.mark.parametrize("case,arch,mesh", FINAL)
def test_split_final_parameters_match_unsharded(ranks, case, arch, mesh):
    """The parameters after the run's steps (4; 2 for the MLA/MoE and SSD
    runs), written on the mesh, against the unsharded run's at the same
    step: within 1e-5 x max|param| plus twice the leaf's floor, the
    unsharded float32 run's distance from the same run in float64.
    AdamW's m / sqrt(v) turns float32 noise in a near-zero gradient into
    a step-sized difference: 3.9e-5 x max in one ``embed`` element even
    on the data-parallel ``(4, 1)``, which splits nothing.  (The two
    fit-rule variants sum more partial gradients over the model group and
    move single elements past this floor, 7e-5 x max of ``wk`` with 6
    heads; their losses and gradients are held above.)  FINAL64's runs:
    the split run in float64 against the unsharded one in float64, to the
    same bound."""
    _, _, _, ckpts, _, key = _split_case(ranks, case)
    mine = f"ckpt_{case}64" if key in FINAL64 else f"ckpt_{case}"
    got, want, f64 = (np.load(io.BytesIO(ckpts[n]["arrays.npz"]))
                      for n in (mine, f"ckpt_ref_{key}",
                                f"ckpt_ref64_{key}"))
    params = [k for k in want.files if k.startswith("params")]
    assert params and sorted(got.files) == sorted(want.files)
    for k in params:
        w = want[k]
        if not np.issubdtype(w.dtype, np.floating):
            np.testing.assert_array_equal(got[k], w, err_msg=k)
            continue
        floor = np.abs(w.astype(np.float64) - f64[k]).max()
        tol = 1e-5 * np.abs(w).max() + 2 * floor
        diff = np.abs(got[k] - (f64[k] if key in FINAL64 else w)).max()
        assert diff <= tol, (case, k, diff, tol)


# the leaves, by REFS key and module.leaf, whose unsharded float32 gradient
# itself stands at or past the bound below from JAX's: SSD's depthwise
# conv, whose gradient the packages sum over the batch and positions in
# other orders, and ``w_in``, whose gradient flows back through it (on
# layer 0: conv_w 1.12 of the bound, conv_b 0.82, w_in 0.87; the split
# 1.33, 1.16 and 0.99).  Their split is held to the unsharded port's
# distance from JAX plus its own tolerance against the unsharded port,
# and that distance to 1e-5 x max|grad|
JAX_FROM_UNSHARDED = {"ssd": ("ssd.conv_w", "ssd.conv_b", "ssd.w_in")}


@pytest.mark.parametrize("case,arch,mesh", SPLIT)
def test_split_matches_jax_loop(ranks, case, arch, mesh):
    """Against the JAX package: the losses of its loop (1e-5 relative),
    and ``jax.grad`` at step 0 within 1e-6 x max|grad| plus twice the
    leaf's float32 floor (each package rounds on its own;
    JAX_FROM_UNSHARDED's leaves: the unsharded port's distance from JAX
    plus 1e-6 x max|grad| and the floor once)."""
    got, want, ref, _, jax_ref, key = _split_case(ranks, case)
    _close(_same_result(got)["losses"], jax_ref[f"loss/{key}"])
    for name, g in want["grads"].items():
        j = _jax_grad(jax_ref, key, name)
        floor = (g.double() - ref["f64"][key][name]).abs().max().item()
        tol = 1e-6 * j.abs().max().item() + 2 * floor
        if ".".join(name.split(".")[-2:]) in JAX_FROM_UNSHARDED.get(key, ()):
            off = (g - j).abs().max().item()
            assert off <= 1e-5 * j.abs().max().item(), (key, name, off)
            tol += off - floor
        diff = (got[0]["grads"][name] - j).abs().max().item()
        assert diff <= tol, (case, name, diff, tol)


# the stacked leading axes of the JAX tree under each top-level key: the
# blocks' layer axis, zamba's units [n_units, unit_len] and tail
_JAX_STACKED = {"blocks": 1, "units": 2, "tail": 1}


def _jax_grad(jax_ref, key, name):
    """``jax.grad``'s leaf of the port's parameter ``name`` (the stacked
    layer axes indexed by the name's numbers)."""
    path = name.split(".")
    lead = _JAX_STACKED.get(path[0], 0)
    j = jax_ref["grad/" + "/".join([key, path[0], *path[1 + lead:]])]
    for i in path[1:1 + lead]:
        j = j[int(i)]
    return torch.from_numpy(np.ascontiguousarray(j))


def _mla_moe_split(cfg, m):
    """The shapes of an ``mla_moe`` model's ``model``-split leaves a rank
    holds: MLA's per-head projections (1/m of the heads), the routed bank
    (1/m of the experts; ``gather`` dispatch) and the shared experts (1/m
    of their hidden columns), each where ``m`` divides its dim."""
    D, H, E = cfg.d_model, cfg.n_heads, cfg.n_experts
    nope, rope, vd, r = (cfg.nope_head_dim, cfg.rope_head_dim,
                         cfg.v_head_dim, cfg.kv_lora_rank)
    fe, fs = cfg.expert_d_ff, cfg.expert_d_ff * cfg.n_shared_experts
    out = {}
    for i in range(cfg.n_layers):
        a, e = f"blocks.{i}.mla.", f"blocks.{i}.moe."
        if H % m == 0:
            q = "wq_b" if cfg.q_lora_rank else "wq"
            out.update({a + q: (cfg.q_lora_rank or D, H * (nope + rope) // m),
                        a + "wkv_b": (r, H * (nope + vd) // m),
                        a + "wo": (H * vd // m, D)})
        if E % m == 0 and cfg.moe_dispatch == "gather":
            out.update({e + "w_gate": (E // m, D, fe),
                        e + "w_up": (E // m, D, fe),
                        e + "w_down": (E // m, fe, D)})
        if fs % m == 0:
            out.update({e + "shared.w_gate": (D, fs // m),
                        e + "shared.w_up": (D, fs // m),
                        e + "shared.w_down": (fs // m, D)})
    return out


def _attn_mlp_blocks(cfg):
    """The prefixes of the modules holding an ``attn``/``mlp`` pair:
    each ``attn_mlp`` block, both halves of each ``gemma_pair`` block,
    ``zamba``'s shared block."""
    if cfg.layout == "attn_mlp":
        return [f"blocks.{i}." for i in range(cfg.n_layers)]
    if cfg.layout == "gemma_pair":
        return [f"blocks.{i}.{kind}." for i in range(cfg.n_layers // 2)
                for kind in ("local", "global")]
    return ["shared_attn."] if cfg.layout == "zamba" else []


@pytest.mark.parametrize("case,arch,mesh", SPLIT_ALL)
def test_split_rank_shapes_and_widths(ranks, case, arch, mesh):
    """Each rank holds 1/model of every head-, hidden-, expert- and
    vocab-split weight (``wk``/``wv`` whole where the axis does not divide
    the kv heads; the routed bank whole where it does not divide the
    experts or the dispatch is ``einsum``), runs the unsharded step's
    kernel calls, the FFN's B1/B2 on 1/model of the tokens, B5 and the
    attention backward's batched products on 1/model of the heads."""
    got, want, _, _, _, _ = _split_case(ranks, case)
    cfg = _cfg(arch)
    m = mesh[1]
    D, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    V, F = cfg.vocab_size, cfg.d_ff
    split = {}
    if V % m == 0:
        cb = (cfg.n_codebooks,) if cfg.input_mode == "codebooks" else ()
        split.update({"embed": cb + (V // m, D), "lm_head": cb + (D, V // m)})
    if cfg.layout == "mla_moe":
        split.update(_mla_moe_split(cfg, m))
    blocks = _attn_mlp_blocks(cfg)
    heads = H % m == 0
    kv = heads and KV % m == 0
    for b in blocks * heads:
        a = b + "attn."
        split.update({a + "wq": (D, H * hd // m), a + "wo": (H * hd // m, D)})
        if kv:
            split.update({a + "wk": (D, KV * hd // m),
                          a + "wv": (D, KV * hd // m)})
        if cfg.qkv_bias:
            split[a + "bq"] = (H * hd // m,)
            if kv:
                split.update({a + "bk": (KV * hd // m,),
                              a + "bv": (KV * hd // m,)})
    dense = cfg.ffn_sparsity is None
    for b in blocks * (dense and F % m == 0):
        f = b + "mlp."
        split.update({f + "w_gate": (D, F // m), f + "w_up": (D, F // m),
                      f + "w_down": (F // m, D)})
    for r, c in enumerate(got):
        assert c["model_index"] == r % m
        assert c["split"] == sorted(split), (r, c["split"])
        shapes = {**{n: tuple(g.shape) for n, g in want["grads"].items()},
                  **split}
        assert c["shapes"] == shapes, r
        if blocks and not kv:
            assert c["shapes"][blocks[0] + "attn.wk"] == (D, KV * hd)
        rows = c["batch_rows"]
        tokens = rows * SHAPE.seq_len // m
        for kind, calls in c["widths"].items():
            assert len(calls) == len(want["widths"][kind]), (r, kind)
            for call in calls:
                if call[0] == 1:             # the FFN: its tokens
                    assert call[1] == tokens, (r, kind, call)
                else:                        # attention: its heads
                    assert call[0] == rows * H // m, (r, kind, call)
    assert len(got[0]["widths"]["attn"]) == (
        cfg.n_layers if cfg.attn_sparsity else 0)


@pytest.mark.parametrize("mesh", MESHES)
def test_rank_bytes_equal_the_dryrun_per_device_bytes(ranks, mesh):
    got, _, _, _, _ = ranks
    cfg = _cfg(ARCH)
    for r, case in enumerate(_case(got, f"ffn{mesh[0]}x{mesh[1]}")):
        assert case["held"] == case["want"], (mesh, r)
        # the embedding (model, data) is cut in four on every mesh here
        assert 4 * case["held"]["params.embed"] == \
            cfg.vocab_size * cfg.d_model * 4


@pytest.mark.parametrize("case", ["moe1x4", "moe2x2", "gemma1x4"])
def test_split_moe_rank_bytes_equal_the_dryrun_per_device_bytes(ranks,
                                                                 case):
    got, _, _, _, _ = ranks
    if case.startswith("moe"):
        # the routed bank (model, data): a quarter of it on every rank
        cfg = _cfg(MOE)
        leaf = "params.blocks.0.moe.w_gate"
        numel = cfg.n_experts * cfg.d_model * cfg.expert_d_ff
    else:
        # both halves' heads and hidden columns and the vocab over model
        cfg = _cfg(GEMMA)
        leaf = "params.blocks.0.global.mlp.w_gate"
        numel = cfg.d_model * cfg.d_ff
    for r, c in enumerate(_case(got, case)):
        assert c["held"] == c["want"], (case, r)
        assert 4 * c["held"][leaf] == numel * 4
        if case == "gemma1x4":
            assert 4 * c["held"]["params.embed"] == \
                cfg.vocab_size * cfg.d_model * 4


@pytest.mark.parametrize("case,arch,mesh", [
    c for c in SPLIT_ALL if _cfg(c[1]).layout == "mla_moe"])
def test_split_aux_loss_matches_unsharded(ranks, case, arch, mesh):
    """The MoE load-balance loss under the split: every rank routes the
    whole sequence and counts its positions' share, the shares summed over
    the model group; at step 0 within 1e-6 of the unsharded value, and
    over the loop's steps within 1e-5 relative."""
    got, want, ref, _, _, key = _split_case(ranks, case)
    assert want["aux0"] > 0
    for r, c in enumerate(got):
        assert abs(c["aux0"] - want["aux0"]) <= 1e-6, (case, r, c["aux0"])
    _close(_same_result(got)["aux_losses"], ref[key].aux_losses)


@pytest.mark.parametrize("arch", EMBED_ARCHS)
@pytest.mark.parametrize("dtype", EMBED_DTYPES)
def test_split_embed_is_bit_equal_to_unsharded(ranks, arch, dtype):
    """The split ``_embed`` on each rank of ``(1, 4)``: the rank's positions
    of the unsharded ``_embed``, bit for bit (each reduce-scattered row sum
    has one nonzero term; the gemma_pair scale, the codebooks' ordered sum
    and the patch rows act after it), from a quarter of the vocab."""
    got, _, _, _, _ = ranks
    cfg = _cfg(arch)
    cb = (cfg.n_codebooks,) if cfg.input_mode == "codebooks" else ()
    for r, case in enumerate(_case(got, "embed")):
        shape, equal = case[arch, dtype]
        assert shape == cb + (cfg.vocab_size // 4, cfg.d_model), (r, shape)
        assert equal, (arch, dtype, r)


def test_moe_global_aux_loss_matches_unsharded(ranks):
    got, ref, _, _, _ = ranks
    res = _same_result(_case(got, "moe"))
    _close(res["losses"], ref["moe"].losses)
    _close(res["aux_losses"], ref["moe"].aux_losses)
    assert min(ref["moe"].aux_losses) > 0


def test_undivided_batch_is_replicated(ranks):
    got, ref, _, _, _ = ranks
    case = _case(got, "undivided")
    assert case[0]["spec"] == (None, None)
    _close(_same_result(case)["losses"], ref["small"].losses)
    for c in case:        # the replicated batch keeps the whole-model step
        rec = c["record"]
        assert rec["gathers"] == rec["regathers"] == \
            rec["reduce_scatters"] == rec["peak_bytes"] == 0, rec


def test_elastic_restart_onto_another_mesh(ranks):
    got, ref, _, steps, _ = ranks
    res = _same_result(_case(got, "elastic"))
    assert res["restarts_used"] == 1 and res["final_step"] == STEPS
    assert len(res["losses"]) == STEPS - 2     # resumed from step 2
    _close(res["losses"], ref["ffn"].losses[2:])
    assert steps["elastic"] == ["step_00000002", "step_00000004"]


def test_pod_data_dim_takes_the_jax_order(ranks):
    got, _, _, _, _ = ranks
    for case in _case(got, "pod_order"):
        assert case["local"] and case["gathered"]
        assert case["placements"] == ["S(0)", "S(0)", "R"]
        assert case["size1_alias"]


@pytest.mark.parametrize("spec", ["pod_data", "data"])
def test_pod_data_gather_and_reduce_scatter_take_the_jax_order(ranks, spec):
    """``gather_data`` brings a block sharded over ``("pod", "data")`` (pod
    major) or over ``data`` alone back to the whole tensor, and
    ``scatter_grad`` gives each rank its block of the 4 ranks' summed
    gradient: one of four pod-major blocks, or, over ``data`` alone, the
    block of its data coordinate (the same on both pods)."""
    got, _, _, _, _ = ranks
    total = sum(_rank_tensor(q, (8, 3)) for q in range(WORLD))
    rows = set()
    for r, case in enumerate(_case(got, "pod_order")):
        gathered, block, (span, _) = case["layer"][spec]
        assert gathered, r
        torch.testing.assert_close(block, total[slice(*span)], rtol=1e-6,
                                   atol=0)
        rows.add(span)
    assert len(rows) == (4 if spec == "pod_data" else 2)


# ------------------------------------------------- the per-layer gather
def _layer_groups(cfg, shape, seq_len):
    """The per-layer gather's groups on a mesh of ``shape``, in forward
    order (``embed``, the stack's blocks (``zamba``: each unit's Mamba2
    layers, then its use of the shared block; the tail), the head), each
    group's data-sharded leaves, each group's gathered bytes (float32;
    a model-split leaf keeps its ``model`` shard), and the other floating
    leaves."""
    axes = ("pod", "data", "model")[-len(shape):]
    mesh = mesh_lib.make_abstract_mesh(shape, axes)
    flat = T.flat_specs(T.param_specs(cfg, device="meta"))
    specs = sh.param_shardings(mesh, flat)
    split = st.split_leaves(cfg, mesh, specs, seq_len)
    m = mesh_lib.axis_sizes(mesh)["model"]
    gathered = {}
    for n, t in flat.items():
        if sh.data_sharded(mesh, specs[n]):
            keep = sh.keep_axes(specs[n], ("model",)) if n in split else ()
            gathered[n] = [k // m if a == "model" else k for k, a in zip(
                t.shape, tuple(keep) + (None,) * t.dim())]
    others = sorted(n for n, t in flat.items() if t.is_floating_point()
                    and n not in gathered and n in specs)
    if cfg.layout == "zamba":
        stack = [g for u in range(cfg.hybrid_n_units) for g in (
            *(f"units.{u}.{i}" for i in range(cfg.hybrid_unit_len)),
            "shared_attn")] + [f"tail.{i}" for i in range(cfg.hybrid_tail)]
    else:
        stack = [f"blocks.{i}" for i in range(T._n_repeats(cfg))]
    order = ["embed", *stack, "lm_head+final_norm"]
    members = {g: {n for n in gathered if n in g.split("+") or
                   n.startswith(g + ".")} for g in order}
    nbytes = {g: 4 * sum(int(np.prod(gathered[n])) for n in members[g])
              for g in order}
    return order, members, nbytes, others


def _layer_runs(ranks, case, remat):
    return [c[case, remat] for c in _case(ranks[0], "layers")]


def _case_groups(case, arch, mesh):
    return _layer_groups(_cfg(arch), mesh,
                         LAYER_CELLS.get(case, SHAPE).seq_len)


@pytest.mark.parametrize("remat", LAYER_REMATS)
@pytest.mark.parametrize("case,arch,mesh", LAYERS)
def test_layer_gather_holds_one_group_at_a_time(ranks, case, arch, mesh,
                                                remat):
    """The forward gathers each group just before it runs (``zamba``'s
    shared block at each use), the backward gathers it again in reverse
    order (every group but ``embed``, whose backward needs no weight: the
    checkpoint's recompute under "full", autograd's saved tensors under
    "none"), each time that group's data-sharded leaves and no other leaf
    alive on the rank; the record counts them, and its peak of gathered
    bytes is no larger than the largest group's weights plus its
    gradient."""
    order, members, nbytes, _ = _case_groups(case, arch, mesh)
    for r, run in enumerate(_layer_runs(ranks, case, remat)):
        gathers = [e for e in run["events"] if e[0] == "gather"]
        fwd = [e[2] for e in gathers if e[1] == "forward"]
        bwd = [e[2] for e in gathers if e[1] == "backward"]
        assert fwd == order, (r, fwd)
        assert bwd == order[:0:-1], (r, bwd)
        for _, phase, group, leaves, alive in gathers:
            assert set(leaves) == members[group], (r, phase, group, leaves)
            assert alive == leaves, (r, phase, group, alive)
        rec = run["record"]
        assert rec["gathers"] == sum(len(members[g]) for g in fwd), rec
        assert rec["regathers"] == sum(len(members[g]) for g in bwd), rec
        assert rec["group_bytes"] == max(nbytes.values()), rec
        assert rec["peak_bytes"] <= 2 * rec["group_bytes"], rec


@pytest.mark.parametrize("remat", LAYER_REMATS)
@pytest.mark.parametrize("case,arch,mesh", LAYERS)
def test_layer_gather_reduce_scatters_each_gradient_once(ranks, case, arch,
                                                         mesh, remat):
    """Over one step each data-sharded leaf's gradient crosses exactly one
    reduce-scatter over the data group (``zamba``'s shared block too,
    after its last use in the backward) and no all-reduce; every other
    floating leaf's crosses one all-reduce over the data group whole, as
    before the per-layer gather."""
    _, members, _, others = _case_groups(case, arch, mesh)
    leaves = sorted(set().union(*members.values()))
    for r, run in enumerate(_layer_runs(ranks, case, remat)):
        ev = run["events"]
        assert sorted(e[1] for e in ev if e[0] == "reduce_scatter") == \
            leaves, r
        assert sorted(e[1] for e in ev if e[0] == "all_reduce") == \
            others, r
        rec = run["record"]
        assert (rec["reduce_scatters"], rec["all_reduces"]) == \
            (len(leaves), len(others)), (r, rec)


@pytest.mark.parametrize("remat", LAYER_REMATS)
@pytest.mark.parametrize("case,arch,mesh", LAYERS)
def test_layer_gather_matches_unsharded(ranks, case, arch, mesh, remat):
    """Step 0 under the per-layer gather against the unsharded step: the
    loss within 1e-5 relative, every rank's gradient (gathered whole)
    within 1e-6 x max|grad| plus the leaf's float32 floor."""
    _, ref, _, _, _ = ranks
    key = LAYER_REFS[case]
    want = ref[f"{key}0"]
    for r, run in enumerate(_layer_runs(ranks, case, remat)):
        _close(run["loss0"], want["loss0"])
        for name, g in want["grads"].items():
            tol = _grad_tol(g, ref["f64"][key][name])
            diff = (run["grads"][name] - g).abs().max().item()
            assert diff <= tol, (case, remat, r, name, diff, tol)


# ------------------------------------------------------ against the JAX loop
def test_one_rank_gloo_mesh_loop_matches_jax_loop(ranks):
    """The port's ``train(cfg, shape, mesh)`` on a ``(1, 1)`` mesh of a
    one-rank gloo group against the JAX package's ``train(cfg, shape,
    make_mesh((1, 1), ("data", "model")))`` (what ``tests/test_substrates.py``
    runs), 4 steps from the same weights."""
    _, ref, _, _, jax_ref = ranks
    assert len(ref["one_rank"].losses) == STEPS
    np.testing.assert_allclose(ref["one_rank"].losses, jax_ref["loss/ffn"],
                               rtol=JAX_TOL, atol=JAX_TOL)


@pytest.mark.parametrize("case,want,first", [
    ("ffn1x4", "ffn", 0), ("ffn2x2", "ffn", 0), ("ffn4x1", "ffn", 0),
    ("elastic", "ffn", 2), ("undivided", "small", 0), ("moe", "moe", 0)])
def test_mesh_losses_match_jax_loop(ranks, case, want, first):
    """Each 4-rank case's losses against the JAX loop's on a ``(1, 1)``
    mesh from step ``first`` (where the elastic run resumes); the
    undivided case's step-0 loss against JAX's ``train_loss`` (its later
    steps are held against the unsharded port above), and the MoE case's
    step-0 ``aux_loss`` too."""
    got, _, _, _, jax_ref = ranks
    res = _same_result(_case(got, case))
    want_losses = jax_ref[f"loss/{want}"][first:]
    n = len(want_losses)
    assert n == (1 if case == "undivided" else len(res["losses"]))
    np.testing.assert_allclose(res["losses"][:n], want_losses, rtol=JAX_TOL,
                               atol=JAX_TOL)
    if case == "moe":
        np.testing.assert_allclose(res["aux_losses"][0], jax_ref["aux/moe"],
                                   rtol=JAX_TOL, atol=JAX_TOL)


def _want_collective(name, r):
    """``(y, dx)`` of ``_case_collectives``' ``name`` on rank ``r`` of 4,
    from the definitions."""
    xs = {"gather": (2, 3, 5), "scatter": (2, 8, 5), "reduce": (4, 3),
          "enter": (4, 3), "local_seq": (2, 8, 3)}[name]
    x = [_rank_tensor(q, xs) for q in range(WORLD)]
    if name == "gather":                    # backward: reduce-scatter
        g = [_rank_tensor(q + 7, (2, 12, 5)) for q in range(WORLD)]
        return torch.cat(x, 1), sum(g).chunk(WORLD, 1)[r]
    if name == "scatter":                   # backward: all-gather
        g = [_rank_tensor(q + 7, (2, 2, 5)) for q in range(WORLD)]
        return sum(x).chunk(WORLD, 1)[r], torch.cat(g, 1)
    if name == "reduce":                    # backward: the identity
        return sum(x), _rank_tensor(r + 7, xs)
    if name == "enter":                     # backward: all-reduce
        return x[r], sum(_rank_tensor(q + 7, xs) for q in range(WORLD))
    grad = torch.zeros(xs)                  # local_seq: zeros elsewhere
    grad[:, 2 * r:2 * r + 2] = _rank_tensor(r + 7, (2, 2, 3))
    return x[r][:, 2 * r:2 * r + 2], grad


@pytest.mark.parametrize("name", ["gather", "scatter", "reduce", "enter",
                                  "local_seq"])
def test_split_collectives_and_their_backwards(ranks, name):
    got, _, _, _, _ = ranks
    for r, case in enumerate(_case(got, "collectives")):
        assert case["split"] == (r, WORLD)
        y, dx = case[name]
        want_y, want_dx = _want_collective(name, r)
        torch.testing.assert_close(y, want_y, rtol=1e-6, atol=0)
        torch.testing.assert_close(dx, want_dx, rtol=1e-6, atol=0)


def test_split_max_and_bf16_sums(ranks):
    """``pmax_model`` is the elementwise maximum; a bf16 reduce-scatter
    sums in float32 and rounds once; with no split every collective
    returns its input."""
    got, _, _, _, _ = ranks
    for r, case in enumerate(_case(got, "collectives")):
        torch.testing.assert_close(case["pmax"], _rank_tensor(3, (5,)))
        x = [_rank_tensor(q, (3, 2, 8), torch.bfloat16) for q in range(WORLD)]
        total = sum(t.float() for t in x).to(torch.bfloat16)
        y, dx = case["scatter_bf16"]
        assert torch.equal(y, total.chunk(WORLD, 2)[r])
        assert dx.dtype == torch.bfloat16 and dx.shape == (3, 2, 8)
        assert case["no_split"] == (None, True)


# an attention + dense MLP pair whose kv heads the axis does not divide
_ATTN_MLP = {"attn.wq", "attn.wo", "mlp.w_gate", "mlp.w_up", "mlp.w_down"}
_MLA_MOE = {"mla.wq", "mla.wkv_b", "mla.wo", "moe.w_gate", "moe.w_up",
            "moe.w_down", "moe.shared.w_gate", "moe.shared.w_up",
            "moe.shared.w_down"}


@pytest.mark.parametrize("arch,shape,seq,want", [
    (ARCH, (1, 4), 32, {"embed", "lm_head", "attn.wq", "attn.wo"}),
    (ARCH, (2, 2), 32, {"embed", "lm_head", "attn.wq", "attn.wo", "attn.wk",
                        "attn.wv"}),
    (ATTN, (4, 2), 64, {"embed", "lm_head", "attn.wq", "attn.wo", "attn.wk",
                        "attn.wv"}),
    (DENSE, (1, 4), 32, {"embed", "lm_head", "attn.wq", "attn.wo",
                         "mlp.w_gate", "mlp.w_up", "mlp.w_down"}),
    ("qwen2.5-14b:smoke", (1, 2), 32, {
        "embed", "lm_head", "attn.wq", "attn.wo", "attn.wk", "attn.wv",
        "attn.bq", "attn.bk", "attn.bv", "mlp.w_gate", "mlp.w_up",
        "mlp.w_down"}),
    (ARCH, (4, 1), 32, set()),          # model = 1
    (ARCH, (1, 4), 30, set()),          # the axis does not divide L
    # mla_moe: MLA's heads, the routed bank (EP), the shared experts
    (MOE, (1, 4), 32, {"embed", "lm_head"} | _MLA_MOE),
    # ssd: the vocab only (the mixer's leaves stay replicated)
    ("mamba2-1.3b:smoke", (1, 4), 32, {"embed", "lm_head"}),
    # codebooks: each codebook's table split on its vocab; 2 kv heads
    (AUDIO, (1, 4), 32, {"embed", "lm_head"} | _ATTN_MLP),
    # gemma_pair: both halves of the block
    (GEMMA, (1, 4), 32, {"embed", "lm_head"} | {
        f"{kind}.{n}" for kind in ("local", "global") for n in _ATTN_MLP}),
    # zamba: the shared block (no Mamba2 leaf)
    (ZAMBA, (1, 4), 32, {"embed", "lm_head"} | {
        f"shared_attn.{n}" for n in _ATTN_MLP}),
    # tokens+patches: 32 tokens and 8 patches, the carry's 40 positions
    (VLM, (1, 4), 40, {"embed", "lm_head"} | _ATTN_MLP),
])
def test_split_leaves_follow_the_fit_rule(arch, shape, seq, want):
    """The leaves the mesh step computes on their ``model`` shard, by
    module and leaf name (``blocks.<i>.`` dropped), on an abstract mesh
    (no process group)."""
    names = _split_names(arch, shape, seq)
    assert {n.split(".", 2)[-1] if n.startswith("blocks.") else n
            for n in names} == want
    per_block = len(want - {"embed", "lm_head"})
    cfg = get_config(arch)
    blocks = {"gemma_pair": cfg.n_layers // 2, "zamba": 1}.get(cfg.layout,
                                                               cfg.n_layers)
    assert len(names) == len(want & {"embed", "lm_head"}) + \
        per_block * blocks


def _split_names(arch, shape, seq):
    base, _, variant = arch.partition("/")
    cfg = dataclasses.replace(get_config(base), **VARIANTS.get(variant, {}))
    mesh = mesh_lib.make_abstract_mesh(shape, ("data", "model"))
    specs = sh.param_shardings(mesh, T.flat_specs(T.param_specs(
        cfg, device="meta")))
    return st.split_leaves(cfg, mesh, specs, seq)


@pytest.mark.parametrize("arch,shape,want", [
    # a q_lora_rank: wq_b splits, wq_a and q_norm stay replicated
    (DS236, (1, 4), {"embed", "lm_head", "mla.wq_b", "mla.wkv_b", "mla.wo",
                     "moe.w_gate", "moe.w_up", "moe.w_down",
                     "moe.shared.w_gate", "moe.shared.w_up",
                     "moe.shared.w_down"}),
    # 6 experts on 4: the bank whole; the einsum dispatch: the bank whole
    (EXPERTS6, (1, 4), {"embed", "lm_head"} | _MLA_MOE - {
        "moe.w_gate", "moe.w_up", "moe.w_down"}),
    (EINSUM, (2, 2), {"embed", "lm_head"} | _MLA_MOE - {
        "moe.w_gate", "moe.w_up", "moe.w_down"}),
    # 4 heads and 4 experts on 8: MLA and the bank whole; the shared
    # experts' 64 hidden columns split
    (MOE, (1, 8), {"embed", "lm_head", "moe.shared.w_gate",
                   "moe.shared.w_up", "moe.shared.w_down"}),
])
def test_split_leaves_of_mla_moe_follow_the_fit_rule(arch, shape, want):
    """The path keys tell the routed bank (``moe.w_gate`` [E, D, F]: split
    over its experts) from the shared experts' ``shared.w_gate`` (its
    hidden columns) and the dense FFN's ``mlp.w_gate``, and each splits
    only where the ``model`` axis divides its dim."""
    names = _split_names(arch, shape, 32)
    assert {n.split(".", 2)[-1] if n.startswith("blocks.") else n
            for n in names} == want


def test_error_feedback_over_four_ranks_matches_jax(ranks):
    got, ref, _, _, jax_ref = ranks
    grads = ref["ef_grads"]
    for r, out in enumerate(_case(got, "ef")):
        for s in range(EF_STEPS):
            for k, g in grads.items():
                tag = (r, s, k)
                got_g = out["g_hat"][s][k]
                if k == "idx":           # integer leaves pass through
                    np.testing.assert_array_equal(got_g.numpy(), g[r])
                    continue
                np.testing.assert_array_equal(
                    out["residual"][s][k].numpy(), jax_ref[f"ef/r/{s}/{k}"][r],
                    err_msg=str(tag))
                want_g = jax_ref[f"ef/g_hat/{s}/{k}"][r]
                np.testing.assert_allclose(
                    got_g.numpy(), want_g, rtol=0,
                    atol=1e-6 * np.abs(want_g).max(), err_msg=str(tag))
        want_p = jax_ref["ef/psum"][r]
        np.testing.assert_allclose(out["psum"].numpy(), want_p, rtol=0,
                                   atol=1e-6 * np.abs(want_p).max())


# ------------------------------------------------------ without a group
@pytest.mark.parametrize("shape,axes,spec,want", [
    ((2, 2), ("data", "model"), sh.P("data", "model"), ["S(0)", "S(1)"]),
    ((2, 2), ("data", "model"), sh.P("model", "data"), ["S(1)", "S(0)"]),
    ((2, 2), ("data", "model"), sh.P(None, None), ["R", "R"]),
    ((2, 2, 2), ("pod", "data", "model"), sh.P(None, ("pod", "data"), "model"),
     ["S(1)", "S(1)", "S(2)"]),
])
def test_placements_of_a_spec(shape, axes, spec, want):
    mesh = mesh_lib.make_abstract_mesh(shape, axes)
    assert [str(p) for p in sh.placements(mesh, spec)] == want


def test_placements_refuse_an_axis_tuple_out_of_mesh_order():
    mesh = mesh_lib.make_abstract_mesh((2, 2, 1), ("pod", "data", "model"))
    with pytest.raises(ValueError, match="mesh's axis order"):
        sh.placements(mesh, sh.P(("data", "pod")))


def test_no_mesh_sums_nothing():
    t = torch.arange(3.0)
    assert constrain.current_mesh() is None
    assert not constrain.data_parallel()
    with constrain.use_mesh(None):
        assert constrain.current_mesh() is None
        assert constrain.psum_data([t])[0] is t


def test_a_cuda_mesh_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mesh = types.SimpleNamespace(device_type="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        loop.train(_cfg(ARCH), SHAPE, mesh, total_steps=1)

"""The port's training mesh over ``torch.distributed`` CPU ranks (``gloo``),
against its own unsharded ``train(..., mesh=None)`` and against the JAX
package's loop, ``train(cfg, shape, make_mesh((1, 1), ("data", "model")))``
(GSPMD gives the same result on any mesh), from the same JAX seed-0
weights.

One group of 4 processes (``torch.multiprocessing``, a ``FileStore`` under
a temporary directory; no TCP port) runs every case; each test reads its
case's results (rank by rank).  Beside it, a child process runs the JAX
side (``jax_mesh_reference.py``): it writes the weights every run starts
from and the R = 4 ranks' gradients first, then the JAX losses and error
feedback outputs.  This process runs the unsharded runs and a one-rank
``(1, 1)`` gloo mesh meanwhile.

* ``(1, 4)``: ``smat-ffn-1.3b:smoke`` in float32, 4 steps: losses, step-0
  gradients and the final checkpoint (parameters and AdamW state) bit-equal
  to the unsharded run's (one data rank; compute is replicated over
  ``model``), the checkpoint byte for byte;
* ``(2, 2)`` and ``(4, 1)``: losses within 1e-5 relative, the step-0
  gradients summed over the data group within 1e-6 x max|grad|;
* storage: each rank's bytes of every parameter, buffer, AdamW leaf and
  batch leaf equal ``launch.dryrun``'s per-device bytes at that mesh
  (``_cell_leaves``, which divides by ``_per_device_bytes``);
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
  one-rank mesh; JAX's ``train_loss`` at step 0 for the undivided batch
  and the MoE (its ``aux_loss`` too), whose later steps the unsharded
  port holds;
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
SHAPE = ShapeCell("t", "train", 32, 4)
SMALL = ShapeCell("t", "train", 32, 2)    # (4, 1) does not divide it
STEPS, MOE_STEPS, EF_STEPS = 4, 2, 2
MESHES = ((1, 4), (2, 2), (4, 1))
WORLD = 4
SPAWN_TIMEOUT_S = 300      # the group takes about 25 s
JAX_TOL = 1e-4
TESTS = Path(__file__).resolve().parent


def _cfg(arch):
    return dataclasses.replace(get_config(arch), dtype="float32")


def _kw(steps=STEPS):
    return dict(total_steps=steps, ckpt_every=2,
                opt_cfg=adamw.AdamWConfig(lr=1e-3, total_steps=steps,
                                          warmup_steps=1))


def _mesh(shape):
    axes = ("pod", "data", "model")[-len(shape):]
    return mesh_lib.make_mesh(shape, axes, device_type="cpu")


def _batch(cfg, shape, step=0):
    return loop.batch_to_device(make_batch(cfg, shape, step), "cpu")


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
def _storage_and_grads(mesh, cfg):
    """Per-leaf local bytes (held, and the dry-run's) and the step-0
    gradients summed over the data group."""
    model = st.shard_model(T.init_params(cfg, seed=0, device="cpu"), mesh)
    opt = st.init_opt_state(model)
    b_specs = sh.batch_shardings(mesh, st.input_specs(cfg, SHAPE))
    batch = sh.distribute_tree(mesh, _batch(cfg, SHAPE), b_specs)
    held = {"params." + k: _nbytes(v) for k, v in model.state_dict().items()}
    held.update({"opt." + k: _nbytes(v)
                 for k, v in T.flat_specs(opt).items()})
    held.update({"batch." + k: _nbytes(v) for k, v in batch.items()})
    want, _, _ = dryrun._cell_leaves(cfg, SHAPE, mesh, False, "meta")
    metrics, grads = st.mesh_loss_and_grads(cfg, model, batch, remat="none")
    return {"held": held, "want": want, "loss0": float(metrics["loss"]),
            "grads": grads}


def _case_ffn(shape, out_dir):
    mesh = _mesh(shape)
    cfg = _cfg(ARCH)
    out = _storage_and_grads(mesh, cfg)
    ckpt = f"{out_dir}/ckpt_{shape[0]}x{shape[1]}"
    out["result"] = dataclasses.asdict(
        loop.train(cfg, SHAPE, mesh, ckpt_dir=ckpt, **_kw()))
    return out


def _case_moe(out_dir):
    res = loop.train(_cfg(MOE), SHAPE, _mesh((4, 1)), **_kw(MOE_STEPS))
    return {"result": dataclasses.asdict(res)}


def _case_undivided(out_dir):
    mesh = _mesh((4, 1))
    cfg = _cfg(ARCH)
    spec = sh.batch_shardings(mesh, st.input_specs(cfg, SMALL))["tokens"]
    res = loop.train(cfg, SMALL, mesh, **_kw())
    return {"spec": tuple(spec), "result": dataclasses.asdict(res)}


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
    return {"local": torch.equal(d.to_local(), full[2 * piece:2 * piece + 2]),
            "gathered": torch.equal(d.full_tensor(), full),
            "placements": [str(p) for p in d.placements],
            "size1_alias": one.full_tensor().data_ptr() ==
            one.to_local().data_ptr()}


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


CASES = {**{f"ffn{a}x{b}": (lambda o, s=(a, b): _case_ffn(s, o))
            for a, b in MESHES},
         "moe": _case_moe, "undivided": _case_undivided,
         "elastic": _case_elastic}


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


def _unsharded(tmp):
    cfg = _cfg(ARCH)
    model = T.init_params(cfg, seed=0, device="cpu")
    loss, _ = T.train_loss(cfg, model, _batch(cfg, SHAPE), remat="none")
    loss.backward()
    return {"loss0": float(loss.detach()),
            "grads": {n: p.grad for n, p in model.named_parameters()},
            "ffn": loop.train(cfg, SHAPE, device="cpu",
                              ckpt_dir=f"{tmp}/ckpt_ref", **_kw()),
            "moe": loop.train(_cfg(MOE), SHAPE, device="cpu",
                              **_kw(MOE_STEPS)),
            "small": loop.train(cfg, SMALL, device="cpu", **_kw())}


def _one_rank_mesh(tmp):
    """``train(cfg, SHAPE, mesh)`` on a ``(1, 1)`` mesh of a one-rank gloo
    group."""
    dist.init_process_group("gloo", store=dist.FileStore(f"{tmp}/store1", 1),
                            rank=0, world_size=1)
    try:
        return loop.train(_cfg(ARCH), SHAPE, _mesh((1, 1)), **_kw())
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
                ref["one_rank"] = _one_rank_mesh(tmp)
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
        ckpts = {name: {f: (Path(tmp) / name / "step_00000004" / f)
                        .read_bytes()
                        for f in ("arrays.npz", "manifest.json")}
                 for name in ("ckpt_ref", "ckpt_1x4")}
        steps = {name: sorted(os.listdir(Path(tmp) / name))
                 for name in ("ckpt_ref", "ckpt_1x4", "elastic")}
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
    got, ref, ckpts, steps, _ = ranks
    case = _case(got, "ffn1x4")
    res = _same_result(case)
    assert res["losses"] == ref["ffn"].losses
    assert case[0]["loss0"] == ref["loss0"]
    for name, want in ref["grads"].items():
        assert torch.equal(case[0]["grads"][name], want), name
    # the final parameters and AdamW state, written on the mesh: the same
    # bytes as the unsharded run's checkpoint at the same step
    assert steps["ckpt_1x4"] == steps["ckpt_ref"] == ["step_00000002",
                                                      "step_00000004"]
    assert ckpts["ckpt_1x4"] == ckpts["ckpt_ref"]


@pytest.mark.parametrize("mesh", [(2, 2), (4, 1)])
def test_data_parallel_mesh_matches_unsharded(ranks, mesh):
    got, ref, _, _, _ = ranks
    case = _case(got, f"ffn{mesh[0]}x{mesh[1]}")
    res = _same_result(case)
    _close(res["losses"], ref["ffn"].losses)
    _close(case[0]["loss0"], ref["loss0"])
    for name, want in ref["grads"].items():
        for r, c in enumerate(case):      # every rank holds the full sum
            diff = (c["grads"][name] - want).abs().max().item()
            assert diff <= 1e-6 * want.abs().max().item(), (mesh, r, name,
                                                            diff)


@pytest.mark.parametrize("mesh", MESHES)
def test_rank_bytes_equal_the_dryrun_per_device_bytes(ranks, mesh):
    got, _, _, _, _ = ranks
    cfg = _cfg(ARCH)
    for r, case in enumerate(_case(got, f"ffn{mesh[0]}x{mesh[1]}")):
        assert case["held"] == case["want"], (mesh, r)
        # the embedding (model, data) is cut in four on every mesh here
        assert 4 * case["held"]["params.embed"] == \
            cfg.vocab_size * cfg.d_model * 4


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
    undivided and MoE cases' step-0 loss (and ``aux_loss``) against JAX's
    ``train_loss`` (their later steps are held against the unsharded port
    above)."""
    got, _, _, _, jax_ref = ranks
    res = _same_result(_case(got, case))
    want_losses = jax_ref[f"loss/{want}"][first:]
    n = len(want_losses)
    assert n == (1 if case in ("undivided", "moe") else len(res["losses"]))
    np.testing.assert_allclose(res["losses"][:n], want_losses, rtol=JAX_TOL,
                               atol=JAX_TOL)
    if case == "moe":
        np.testing.assert_allclose(res["aux_losses"][0], jax_ref["aux/moe"],
                                   rtol=JAX_TOL, atol=JAX_TOL)


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

"""The port's training stack against the JAX package's on the same numpy
inputs: data pipeline (bit-equal), AdamW (1e-6 on one float32 tree), the
``smat-ffn-1.3b:smoke`` loss and every gradient at step 0, and a 4-step
loss trajectory (1e-4, the ROADMAP's tolerance for model loss: both sum in
float32, in different orders).  Then the port's own contracts: checkpoint
round trip (bit-equal, bf16 included), restart after an injected failure,
and ``remat="full"`` == ``"none"``."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs.base import ShapeCell as JShapeCell
from repro.data import pipeline as jpipe
from repro.launch import steps as jsteps
from repro.models import transformer as JT
from repro.optim import adamw as jadamw
from repro_torch import convert
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeCell
from repro_torch.data import pipeline as tpipe
from repro_torch.launch import steps as tsteps
from repro_torch.models import attention as A
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from repro_torch.train import loop

ARCH = "smat-ffn-1.3b:smoke"
SHAPE = ShapeCell("t", "train", 32, 2)
J_SHAPE = JShapeCell("t", "train", 32, 2)


def _cfgs():
    return (dataclasses.replace(jax_get_config(ARCH), dtype="float32"),
            dataclasses.replace(get_config(ARCH), dtype="float32"))


@pytest.fixture(scope="module")
def pair():
    jcfg, tcfg = _cfgs()
    jparams = JT.init_params(jcfg, seed=0)
    np_params = jax.tree.map(np.asarray, jparams)
    return jcfg, tcfg, jparams, np_params


def _batch_np(cfg, step, shape=SHAPE):
    return tpipe.make_batch(cfg, shape, step)


def _jax_grad_of(jgrads, name: str) -> np.ndarray:
    """The JAX gradient leaf of the port's parameter ``name`` (the JAX tree
    stacks the layers on a leading axis)."""
    parts = name.split(".")
    if parts[0] != "blocks":
        return np.asarray(jgrads[parts[0]])
    leaf = jgrads["blocks"]
    for key in parts[2:]:
        leaf = leaf[key]
    return np.asarray(leaf[int(parts[1])])


# -------------------------------------------------------------------- data
@pytest.mark.parametrize("seed,step,host", [(0, 0, 0), (0, 7, 0), (3, 2, 1),
                                            (11, 5, 3)])
def test_make_batch_bit_equal_to_jax(seed, step, host):
    jcfg, tcfg = _cfgs()
    got = tpipe.make_batch(tcfg, SHAPE, step, tpipe.DataConfig(seed=seed),
                           host_id=host, n_hosts=4, local_batch=2)
    want = jpipe.make_batch(jcfg, J_SHAPE, step, jpipe.DataConfig(seed=seed),
                            host_id=host, n_hosts=4, local_batch=2)
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype
        np.testing.assert_array_equal(got[key], want[key])


def test_prefetch_iterator_yields_make_batch():
    _, tcfg = _cfgs()
    it = tpipe.PrefetchIterator(tcfg, SHAPE, start_step=3)
    try:
        for step in (3, 4):
            got_step, batch = next(it)
            assert got_step == step
            np.testing.assert_array_equal(batch["tokens"],
                                          _batch_np(tcfg, step)["tokens"])
    finally:
        it.close()


# --------------------------------------------------------------- optimizer
def test_adamw_update_matches_jax():
    """Three updates of one float32 tree (a matrix, decayed; a vector, not
    decayed; a sparse-layer ``vals`` block stack, decayed), with clipping
    active: parameters, moments and metrics within 1e-6."""
    rng = np.random.default_rng(0)
    shapes = {"w": (6, 5), "ln": (5,), "vals": (3, 4, 4)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    cfg_j = jadamw.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10,
                               clip_norm=0.5)
    cfg_t = adamw.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10,
                              clip_norm=0.5)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = jadamw.init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    ts = adamw.init(tp)
    for i in range(3):
        grads = {k: rng.standard_normal(s).astype(np.float32)
                 for k, s in shapes.items()}
        jp, js, jm = jadamw.update(cfg_j, {k: jnp.asarray(v)
                                           for k, v in grads.items()}, js, jp)
        tp, ts, tm = adamw.update(cfg_t, {k: torch.from_numpy(v)
                                          for k, v in grads.items()}, ts, tp)
        for k in shapes:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-6, err_msg=k)
            for mom in ("m", "v"):
                np.testing.assert_allclose(ts[mom][k].numpy(),
                                           np.asarray(js[mom][k]),
                                           rtol=1e-6, atol=1e-6)
        for key in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       rtol=1e-6)
        assert int(ts["step"]) == int(js["step"]) == i + 1


def test_adamw_leaves_buffers_alone():
    _, tcfg = _cfgs()
    model = T.init_params(tcfg, seed=0, device="cpu")
    params = dict(model.named_parameters())
    state = adamw.init(params)
    assert set(state["m"]) == set(params)
    buffers = {k: v.clone() for k, v in model.named_buffers()}
    grads = {k: torch.ones_like(p) for k, p in params.items()}
    adamw.update(adamw.AdamWConfig(), grads, state, params)
    for k, v in model.named_buffers():
        assert torch.equal(v, buffers[k]), k


# ------------------------------------------------------------- model grads
def test_step0_loss_and_every_gradient_match_jax(pair):
    jcfg, tcfg, jparams, np_params = pair
    batch = _batch_np(tcfg, 0)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: JT.train_loss(jcfg, p, jbatch, remat="none"),
        has_aux=True, allow_int=True)(jparams)

    model = convert.params_from_jax(tcfg, np_params, "cpu")
    loss, _ = T.train_loss(tcfg, model, loop.batch_to_device(batch, "cpu"),
                           remat="none")
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-4,
                               atol=1e-4)
    n_sparse = 0
    for name, p in model.named_parameters():
        assert p.grad is not None, name
        np.testing.assert_allclose(p.grad.numpy(), _jax_grad_of(jgrads, name),
                                   rtol=1e-4, atol=1e-4, err_msg=name)
        n_sparse += name.endswith(".vals")
    assert n_sparse == 3 * tcfg.n_layers


def _trajectory(jcfg, tcfg, jparams, np_params, shape=SHAPE):
    """Four steps of each package's ``make_train_step`` from the same
    weights on the same batches of ``shape``: every loss within 1e-4."""
    kw = dict(lr=1e-3, warmup_steps=2, total_steps=4)
    jstep = jax.jit(jsteps.make_train_step(jcfg, jadamw.AdamWConfig(**kw),
                                           remat="none"))
    tstep = tsteps.make_train_step(tcfg, adamw.AdamWConfig(**kw),
                                   remat="none")
    model = convert.params_from_jax(tcfg, np_params, "cpu")
    t_opt = adamw.init(dict(model.named_parameters()))
    jp, j_opt = jparams, jadamw.init(jparams)
    for step in range(4):
        batch = _batch_np(tcfg, step, shape)
        jp, j_opt, jm = jstep(jp, j_opt, {k: jnp.asarray(v)
                                          for k, v in batch.items()})
        model, t_opt, tm = tstep(model, t_opt,
                                 loop.batch_to_device(batch, "cpu"))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-4, atol=1e-4,
                                   err_msg=f"step {step}")
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4)


def test_train_step_trajectory_matches_jax(pair):
    jcfg, tcfg, jparams, np_params = pair
    _trajectory(jcfg, tcfg, jparams, np_params)


def test_row_loop_train_trajectory_matches_jax(pair):
    """The same trajectory with the FFN spec's ``backend="row_loop"`` in
    both packages (JAX's static-schedule Pallas kernels in interpret mode,
    the port's plain versions of B3/B4 on the CPU)."""
    jcfg, tcfg, jparams, np_params = pair
    jcfg = dataclasses.replace(jcfg, ffn_sparsity=dataclasses.replace(
        jcfg.ffn_sparsity, backend="row_loop", interpret=True))
    tcfg = dataclasses.replace(tcfg, ffn_sparsity=dataclasses.replace(
        tcfg.ffn_sparsity, backend="row_loop"))
    _trajectory(jcfg, tcfg, jparams, np_params)


def test_attention_train_trajectory_matches_jax():
    """The 4-step trajectory of smat-attn-1.3b:smoke (block-sparse attention
    in banded(32) 16x16 blocks on 64-token batches, where the band leaves
    out the blocks below the diagonal's three; the FFN as above): the port
    through B5's plain version and its composed backward, JAX through its
    composed ``xla`` path (the JAX package pins fused == composed)."""
    arch = "smat-attn-1.3b:smoke"
    jcfg = dataclasses.replace(jax_get_config(arch), dtype="float32")
    tcfg = dataclasses.replace(get_config(arch), dtype="float32")
    assert tcfg.attn_sparsity.backend == "fused"
    meta = A.attention_mask_meta(tcfg.attn_sparsity.mask, 64,
                                 tcfg.attn_sparsity.block)
    assert meta.nnzb < 10      # block-causal on 4 block-rows stores 10
    jparams = JT.init_params(jcfg, seed=0)
    _trajectory(jcfg, tcfg, jparams, jax.tree.map(np.asarray, jparams),
                ShapeCell("t", "train", 64, 2))


def test_sharded_train_trajectory_matches_jax(monkeypatch):
    """The 4-step trajectory of ``smat-ffn-1.3b:smoke`` with
    ``SparsitySpec(shards=2)`` (default ``shard_chunks=2``) in both
    packages: the port's partitioned product and its unchunked backward,
    JAX's ``spmm_sharded`` (unlocked as in ``jax_oracle``, ROADMAP C1)."""
    from repro.obs import jaxmon
    monkeypatch.setattr(jaxmon, "_trace_active",
                        lambda: not jax._src.core.trace_state_clean())
    jcfg, tcfg = _cfgs()
    jcfg = dataclasses.replace(jcfg, ffn_sparsity=dataclasses.replace(
        jcfg.ffn_sparsity, shards=2))
    tcfg = dataclasses.replace(tcfg, ffn_sparsity=dataclasses.replace(
        tcfg.ffn_sparsity, shards=2))
    jparams = JT.init_params(jcfg, seed=0)
    _trajectory(jcfg, tcfg, jparams, jax.tree.map(np.asarray, jparams))


def test_remat_full_matches_none():
    _, tcfg = _cfgs()
    batch = loop.batch_to_device(_batch_np(tcfg, 1), "cpu")
    grads, losses = {}, {}
    for remat in ("none", "full"):
        model = T.init_params(tcfg, seed=0, device="cpu")
        loss, _ = T.train_loss(tcfg, model, batch, remat=remat)
        loss.backward()
        losses[remat] = float(loss.detach())
        grads[remat] = {n: p.grad for n, p in model.named_parameters()}
    assert losses["full"] == losses["none"]
    for name, g in grads["none"].items():
        torch.testing.assert_close(grads["full"][name], g, rtol=1e-6,
                                   atol=1e-6, msg=name)
    with pytest.raises(NotImplementedError, match="not ported"):
        T.train_loss(tcfg, T.init_params(tcfg, seed=0, device="cpu"), batch,
                     remat="dots")


# -------------------------------------------------------------- checkpoint
def _bf16_state():
    model = T.init_params(get_config(ARCH), seed=0, device="cpu")
    assert model.embed.dtype == torch.bfloat16
    opt = adamw.init(dict(model.named_parameters()))
    opt["step"] = torch.tensor(7, dtype=torch.int32)
    return {"params": model.state_dict(), "opt": opt}


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


@pytest.mark.parametrize("async_save", [False, True])
def test_checkpoint_roundtrip_bit_equal_with_keep(tmp_path, async_save):
    state = _bf16_state()
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=async_save)
    for step in (10, 20, 30):
        mgr.save(step, state, block=True)
    mgr.wait()
    assert mgr.all_steps() == [20, 30]          # keep=2 removed step 10
    assert not any(".tmp" in p for p in os.listdir(tmp_path))
    restored, step = mgr.restore(state)
    assert step == 30
    want = dict(_flat(state))
    got = dict(_flat(restored))
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        assert got[key].dtype == value.dtype, key
        assert torch.equal(got[key], value), key
    with open(tmp_path / "step_00000030" / "manifest.json") as f:
        assert '"bfloat16"' in f.read()


def test_checkpoint_save_copies_before_returning(tmp_path):
    """An async save holds a host copy: updating the tensor in place right
    after ``save`` does not change what is written."""
    w = torch.arange(6.0).reshape(2, 3)
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    mgr.save(1, {"w": w})
    w.add_(100.0)
    mgr.wait()
    restored, _ = mgr.restore({"w": w})
    np.testing.assert_array_equal(restored["w"].numpy(),
                                  np.arange(6.0).reshape(2, 3))


# --------------------------------------------------------------- the loop
def test_restart_after_injected_failure_resumes_bit_equal(tmp_path):
    """Fail at step 3, resume from the step-2 checkpoint: the run reaches
    its final step, and the resumed steps give the losses of an
    uninterrupted run exactly."""
    _, tcfg = _cfgs()
    kw = dict(device="cpu", total_steps=5,
              opt_cfg=adamw.AdamWConfig(lr=1e-3, total_steps=5,
                                        warmup_steps=1),
              ckpt_every=2)
    res = loop.train_with_restarts(tcfg, SHAPE, ckpt_dir=str(tmp_path / "a"),
                                   fail_at_step=3, **kw)
    assert res.final_step == 5 and res.restarts_used == 1
    assert len(res.losses) == 3                 # steps 2, 3, 4 after resume
    assert CheckpointManager(str(tmp_path / "a")).latest_step() == 5
    clean = loop.train(tcfg, SHAPE, ckpt_dir=str(tmp_path / "b"), **kw)
    assert clean.losses[2:] == res.losses
    assert all(np.isfinite(clean.losses))


def test_injected_failure_without_restarts_raises():
    _, tcfg = _cfgs()
    with pytest.raises(loop.SimulatedFailure):
        loop.train(tcfg, SHAPE, device="cpu", total_steps=3, fail_at_step=1)

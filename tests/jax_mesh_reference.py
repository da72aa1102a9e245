"""The JAX package's side of ``test_torch_train_mesh.py``, run as a child
process (that test file imports no JAX: ``spawn`` re-imports it in every
rank).

    python tests/jax_mesh_reference.py OUT_DIR

First writes ``OUT_DIR/inputs.npz``: the JAX seed-0 weights of the eight
archs the mesh tests train (``w/<arch>/<path>``, float32), which the JAX
runs below start from too, and R = 4 ranks' error feedback gradients
(``g/<name>``, stacked on a leading rank axis).  Then
``OUT_DIR/reference.npz``:

* ``loss/<case>``: the JAX loop's losses, ``train(cfg, shape,
  make_mesh((1, 1), ("data", "model")))`` (GSPMD gives the same result on
  any mesh), for ``ffn`` (``smat-ffn-1.3b:smoke`` on 4 x 32 tokens, 4
  steps), ``attn`` (``smat-attn-1.3b:smoke``, the same), ``moe``
  (``deepseek-v2-lite-16b:smoke``, 2 steps), ``ssd``
  (``mamba2-1.3b:smoke``), ``gemma`` (``gemma2-27b:smoke``), ``zamba``
  (``zamba2-7b:smoke``), ``audio`` (``musicgen-medium:smoke``) and ``vlm``
  (``pixtral-12b:smoke``, 24 tokens after 8 patches), 2 steps each;
  ``loss/small``: the ffn arch's step-0
  loss on 2 x 32 tokens (``train_loss`` on the first batch); ``aux/moe``:
  the MoE arch's step-0 load-balance loss on 4 x 32;
* ``grad/<case>/<path>``: ``jax.grad`` of ``train_loss`` on the first 4 x
  32 batch for each of those cases, by the JAX tree's path (the block
  leaves stacked on a leading layer axis);
* ``ef/g_hat/<step>/<name>``, ``ef/r/<step>/<name>``: two steps of
  ``ef_compress_grads`` over the R ranks, simulated with ``jax.vmap(...,
  axis_name="data")`` (which binds the ``psum``), and ``ef/psum``:
  ``compressed_psum`` of ``w``.

Each file is written under a temporary name and renamed, so a reader sees
it whole.
"""
import concurrent.futures
import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_config
from repro.configs.base import ShapeCell
from repro.data.pipeline import make_batch
from repro.launch import mesh as jmesh
from repro.models import transformer as JT
from repro.optim import adamw
from repro.optim import compress
from repro.train import loop

ARCH, MOE = "smat-ffn-1.3b:smoke", "deepseek-v2-lite-16b:smoke"
ATTN, SSD = "smat-attn-1.3b:smoke", "mamba2-1.3b:smoke"
GEMMA, ZAMBA = "gemma2-27b:smoke", "zamba2-7b:smoke"
AUDIO, VLM = "musicgen-medium:smoke", "pixtral-12b:smoke"
SHAPE = ShapeCell("t", "train", 32, 4)
SMALL = ShapeCell("t", "train", 32, 2)
STEPS, MOE_STEPS, EF_STEPS, R = 4, 2, 2, 4
THREADS = 3


def _cfg(arch):
    return dataclasses.replace(get_config(arch), dtype="float32")


def _flat(tree, prefix):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _flat(value, f"{prefix}{key}/")
        else:
            yield f"{prefix}{key}", np.asarray(value)


def _write(out_dir, name, arrays):
    tmp = os.path.join(out_dir, name + ".tmp.npz")
    np.savez(tmp, **arrays)
    os.replace(tmp, os.path.join(out_dir, name))


def _grads():
    """R ranks' gradients, on very different scales, with a bf16 leaf
    (its name says so) and an integer one."""
    rng = np.random.default_rng(7)
    w = rng.standard_normal((R, 24, 16)).astype(np.float32)
    w[1] *= 1e-3
    return {"w": w,
            "b": rng.standard_normal((R, 16)).astype(np.float32) * 1e-4,
            "bf16_v": rng.standard_normal((R, 40)).astype(np.float32),
            "idx": np.tile(np.arange(5, dtype=np.int32), (R, 1))}


def _losses(arch, shape, steps):
    kw = dict(lr=1e-3, total_steps=steps, warmup_steps=1)
    res = loop.train(_cfg(arch), shape,
                     jmesh.make_mesh((1, 1), ("data", "model")),
                     total_steps=steps, opt_cfg=adamw.AdamWConfig(**kw))
    return np.asarray(res.losses, np.float64)


def _step0(arch, shape):
    """The loss and the MoE load-balance loss of ``train_loss`` on the
    first batch."""
    cfg = _cfg(arch)
    batch = {k: jnp.asarray(v) for k, v in make_batch(cfg, shape, 0).items()}
    loss, parts = jax.jit(
        lambda p, b: JT.train_loss(cfg, p, b, remat="none"))(
            JT.init_params(cfg, seed=0), batch)
    return (np.asarray([loss], np.float64),
            np.asarray(parts["aux_loss"], np.float64))


def _grads0(arch, shape):
    """``jax.grad`` of ``train_loss`` on the first batch: its floating
    leaves by the tree's path."""
    cfg = _cfg(arch)
    batch = {k: jnp.asarray(v) for k, v in make_batch(cfg, shape, 0).items()}
    grads = jax.jit(jax.grad(
        lambda p, b: JT.train_loss(cfg, p, b, remat="none")[0],
        allow_int=True))(JT.init_params(cfg, seed=0), batch)
    return {k: v for k, v in _flat(grads, "")
            if np.issubdtype(v.dtype, np.floating)}


def _error_feedback(grads):
    g = {k: jnp.asarray(v, jnp.bfloat16) if k.startswith("bf16")
         else jnp.asarray(v) for k, v in grads.items()}
    step = jax.vmap(lambda g, r: compress.ef_compress_grads(g, r, "data"),
                    axis_name="data")
    r = jax.vmap(compress.init_residual)(g)
    out = {}
    for s in range(EF_STEPS):
        g_hat, r = step(g, r)
        for k in g:
            out[f"ef/g_hat/{s}/{k}"] = np.asarray(g_hat[k])
            out[f"ef/r/{s}/{k}"] = np.asarray(r[k])
    out["ef/psum"] = np.asarray(jax.vmap(
        lambda x: compress.compressed_psum(x, "data"),
        axis_name="data")(g["w"]))
    return out


def _init_once():
    """Draw each arch's seed-0 weights once and make ``init_params`` return
    a copy of them (the loop donates its parameters), so the JAX runs
    start from the weights written for the port."""
    archs = (ARCH, MOE, ATTN, SSD, GEMMA, ZAMBA, AUDIO, VLM)
    with concurrent.futures.ThreadPoolExecutor(THREADS) as pool:
        params = dict(zip(archs, pool.map(
            lambda arch: JT.init_params(_cfg(arch), seed=0), archs)))
    JT.init_params = lambda cfg, seed=0: jax.tree.map(jnp.copy,
                                                      params[cfg.name])
    return params


def _case(case, arch, steps):
    """The loop's losses and the step-0 ``jax.grad`` of one case."""
    out = {f"loss/{case}": _losses(arch, SHAPE, steps)}
    out.update({f"grad/{case}/{k}": v
                for k, v in _grads0(arch, SHAPE).items()})
    return out


def main(out_dir):
    grads = _grads()
    inputs = {f"g/{k}": v for k, v in grads.items()}
    for arch, params in _init_once().items():
        inputs.update(_flat(params, f"w/{arch}/"))
    _write(out_dir, "inputs.npz", inputs)
    # the cases in THREADS threads (as the draws above): XLA compiles and
    # runs without the GIL, and each case's results are its own
    with concurrent.futures.ThreadPoolExecutor(THREADS) as pool:
        parts = [pool.submit(_case, *c) for c in (
            ("zamba", ZAMBA, MOE_STEPS), ("moe", MOE, MOE_STEPS),
            ("ffn", ARCH, STEPS), ("attn", ATTN, STEPS),
            ("ssd", SSD, MOE_STEPS), ("gemma", GEMMA, MOE_STEPS),
            ("audio", AUDIO, MOE_STEPS), ("vlm", VLM, MOE_STEPS))]
        ef = pool.submit(_error_feedback, grads)
        small = pool.submit(_step0, ARCH, SMALL)
        moe0 = pool.submit(_step0, MOE, SHAPE)
        ref = ef.result()
        for part in parts:
            ref.update(part.result())
        ref["loss/small"], _ = small.result()
        _, ref["aux/moe"] = moe0.result()
    _write(out_dir, "reference.npz", ref)


if __name__ == "__main__":
    main(sys.argv[1])

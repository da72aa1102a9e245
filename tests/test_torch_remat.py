"""The port's ``remat`` policies against ``remat="none"`` and against the
JAX package's ``jax.checkpoint`` policies.

``"full"`` checkpoints each block whole; ``"dots"`` and ``"names"`` run
``torch.utils.checkpoint`` with a selective policy
(``create_selective_checkpoint_contexts``) that saves the outputs of the
products without batch dimensions (``aten.mm``/``addmm``), or only the
tensors tagged ``attn_ctx`` and ``moe_eout`` by ``layers.checkpoint_name``.
On the CPU every policy's loss and gradients are bit-equal to ``"none"``'s
(the recomputed forward is the same ops on the same inputs), on the sparse
FFN (its ``torch.autograd.Function``s under the selective checkpoint), the
MLA/MoE and the ``gemma_pair`` smoke models, and ``zamba``'s (its tail
checkpointed); each loss is within 1e-5 of JAX's under the same policy.
The policies save what they name: the tagged op twice a DeepSeek layer
under ``"names"``, nothing there under ``"dots"``.
"""
# ruff: noqa: E402
import pytest

torch = pytest.importorskip("torch")

import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_config as jax_get_config
from repro.models import transformer as JT
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeCell
from repro_torch.data import pipeline
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.train import loop

ARCHS = ["smat-ffn-1.3b:smoke", "deepseek-v2-lite-16b:smoke",
         "gemma2-27b:smoke", "zamba2-7b:smoke"]


def _to_numpy(tree):
    return jax.tree.map(
        lambda a: np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16
                             else a), tree)


@pytest.fixture(scope="module", params=ARCHS)
def run(request):
    """Per policy: (loss, {name: grad}) of the port's step-0 ``train_loss``
    on the JAX weights, and the JAX loss under the same policy."""
    arch = request.param
    jcfg = dataclasses.replace(jax_get_config(arch), dtype="float32")
    tcfg = dataclasses.replace(get_config(arch), dtype="float32")
    jparams = JT.init_params(jcfg, seed=0)
    model = convert.params_from_jax(tcfg, _to_numpy(jparams), "cpu")
    batch = pipeline.make_batch(tcfg, ShapeCell("t", "train", 32, 2), 0)
    tb = loop.batch_to_device(batch, "cpu")
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    out = {}
    for remat in T.REMAT:
        model.zero_grad(set_to_none=True)
        loss, _ = T.train_loss(tcfg, model, tb, remat=remat)
        loss.backward()
        grads = {n: p.grad.clone() for n, p in model.named_parameters()
                 if p.grad is not None}
        jloss = jax.jit(lambda p, r=remat: JT.train_loss(
            jcfg, p, jb, remat=r)[0])(jparams)
        out[remat] = (loss.detach(), grads, float(jloss))
    return arch, out


@pytest.mark.parametrize("remat", ["full", "dots", "names"])
def test_gradients_bit_equal_to_none(run, remat):
    arch, out = run
    loss, grads, _ = out[remat]
    want_loss, want, _ = out["none"]
    assert torch.equal(loss, want_loss), arch
    assert sorted(grads) == sorted(want)
    for name, g in want.items():
        assert torch.equal(grads[name], g), f"{arch} {remat}: {name}"


@pytest.mark.parametrize("remat", list(T.REMAT))
def test_loss_within_1e5_of_jax(run, remat):
    arch, out = run
    loss, _, jloss = out[remat]
    assert abs(float(loss) - jloss) <= 1e-5, (arch, float(loss), jloss)


def _saved_ops(arch, remat):
    """Counter of the (op, tag) pairs the policy marks MUST_SAVE during a
    forward (not its recompute)."""
    cfg = dataclasses.replace(get_config(arch), dtype="float32")
    model = T.init_params(cfg, seed=0, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 16)))
    seen = collections.Counter()
    policy = T._remat_policy(remat)
    save = torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE

    def spy(ctx, op, *args, **kwargs):
        decision = policy(ctx, op, *args, **kwargs)
        if decision == save and not ctx.is_recompute:
            tag = args[1] if op == L.CHECKPOINT_NAME_OP else ""
            seen[(str(op), tag)] += 1
        return decision
    orig = T._remat_policy
    T._remat_policy = lambda r: spy
    try:
        loss, _ = T.train_loss(cfg, model, {"tokens": tokens,
                                            "labels": tokens}, remat=remat)
        loss.backward()
    finally:
        T._remat_policy = orig
    return seen


def test_names_saves_the_tagged_tensors_only():
    seen = _saved_ops("deepseek-v2-lite-16b:smoke", "names")
    assert seen == {("repro_torch.checkpoint_name.default", "attn_ctx"): 2,
                    ("repro_torch.checkpoint_name.default", "moe_eout"): 2}
    # no tag in an attn_mlp or gemma_pair block: "names" saves nothing
    assert _saved_ops("gemma2-27b:smoke", "names") == {}


def test_dots_saves_the_unbatched_products():
    """gemma2-27b:smoke: per half q, k, v, o and the gated MLP's three
    products, 2 halves: 14 ``aten.mm`` outputs; the attention scores
    (batched) are recomputed."""
    seen = _saved_ops("gemma2-27b:smoke", "dots")
    assert seen == {("aten.mm.default", ""): 14}


def test_checkpoint_name_is_the_identity():
    x = torch.randn(3, 5, requires_grad=True)
    y = L.checkpoint_name(x, "attn_ctx")
    assert torch.equal(y, x) and y is not x
    y.sum().backward()
    assert torch.equal(x.grad, torch.ones_like(x))
    with torch.no_grad():
        assert L.checkpoint_name(x, "attn_ctx") is x


def test_unknown_remat_raises():
    cfg = get_config("gemma2-27b:smoke")
    model = T.init_params(cfg, seed=0, device="cpu")
    with pytest.raises(ValueError, match="unknown remat"):
        T.forward(cfg, model, {"tokens": torch.zeros(1, 4, dtype=torch.long)},
                  remat="offload")

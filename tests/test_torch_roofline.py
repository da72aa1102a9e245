"""``launch.roofline``: the HLO text parser and ``model_flops_for`` against
the JAX package's, and the analytic work count against a count taken over
the plain forward.

The JAX package's ``HLO_SAMPLE`` cases (``tests/test_dryrun_small.py``) run
through the port's ``parse_collectives`` and must give the JAX parser's
counts, bytes and wire bytes exactly.  ``model_flops_for`` must equal the
JAX function for each arch x shape.  ``work_count``'s flops of a ``:smoke``
prefill are held to ``torch.utils.flop_counter.FlopCounterMode`` over the
plain CPU forward (the same products) with no tolerance: the only gap is
stated and computed exactly.  The plain forward evaluates the whole square
of causal scores (the count takes the lower triangle), the plain fused
attention walks every schedule slot of the mask, padding included (the
count takes the live blocks), and the eager prefill runs the LM head at
every position (the count takes the last of each sequence, the only logits
the prefill returns).  The byte terms are held to sums taken independently
from the specs.
"""
# ruff: noqa: E402
import pytest

torch = pytest.importorskip("torch")

import dataclasses

import numpy as np
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_get_config
from repro.launch import roofline as jrl
from repro_torch.configs import SHAPES, get_config
from repro_torch.configs.base import ShapeCell
from repro_torch.core import perf_model as pm
from repro_torch.launch import dryrun
from repro_torch.launch import roofline as rl
from repro_torch.launch import steps as st
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

HLO_SAMPLE = """
ENTRY %main {
  %p0 = f32[128,256]{1,0} parameter(0)
  %ag = f32[512,256]{1,0} all-gather(%p0), replica_groups={{0,1,2,3}}, dimensions={0}
  %ar = bf16[1024]{0} all-reduce(%x), replica_groups=[8,4]<=[32], to_apply=%add
  %rs = f32[64,64]{1,0} reduce-scatter(%y), replica_groups={{0,1}}, dimensions={0}
  %cp = f32[32]{0} collective-permute(%z), source_target_pairs={{0,1}}
  %d = f32[128,128]{1,0} dot(%a, %b)
}
"""
DONE_SAMPLE = """
  %ags = f32[256]{0} all-gather-start(%p), replica_groups={{0,1}}
  %agd = f32[256]{0} all-gather-done(%ags)
"""


@pytest.mark.parametrize("text", [HLO_SAMPLE, DONE_SAMPLE, ""])
def test_parse_collectives_equals_jax(text):
    got, want = rl.parse_collectives(text), jrl.parse_collectives(text)
    assert got.to_dict() == want.to_dict()


def test_parse_collectives_counts_and_bytes():
    st = rl.parse_collectives(HLO_SAMPLE)
    assert st.counts == {"all-gather": 1, "all-reduce": 1,
                         "reduce-scatter": 1, "collective-permute": 1}
    assert st.bytes_total["all-gather"] == 512 * 256 * 4
    assert st.bytes_total["all-reduce"] == 1024 * 2
    expected = (3 / 4) * 512 * 256 * 4 + 2 * (3 / 4) * 1024 * 2 + \
        (1 / 2) * 64 * 64 * 4 + 32 * 4
    assert abs(st.wire_bytes - expected) < 1e-6


def test_parse_collectives_ignores_done_ops():
    assert rl.parse_collectives(DONE_SAMPLE).counts == {"all-gather": 1}


def test_roofline_terms_and_bottleneck_on_the_h100():
    r = rl.compute_roofline(
        flops=pm.PEAK_FLOPS_BF16 * 0.010,     # 10 ms of compute
        bytes_acc=pm.HBM_BW * 0.002,          # 2 ms of HBM
        wire_bytes=pm.NVLINK_BW * 0.050,      # 50 ms of NVLink
        n_devices=4, model_flops=pm.PEAK_FLOPS_BF16 * 0.010 * 4 * 0.5)
    assert r.bottleneck == "collective"
    assert r.t_compute == pytest.approx(0.010, abs=1e-12)
    assert r.t_bound == pytest.approx(0.050, abs=1e-12)
    assert r.useful_ratio == pytest.approx(0.5, abs=1e-12)
    assert r.peak_fraction == pytest.approx(0.2, abs=1e-12)
    # the JAX function, given the H100's constants, returns the same terms
    j = jrl.compute_roofline(pm.PEAK_FLOPS_BF16 * 0.010, pm.HBM_BW * 0.002,
                             pm.NVLINK_BW * 0.050, 4,
                             pm.PEAK_FLOPS_BF16 * 0.020,
                             peak=pm.PEAK_FLOPS_BF16, hbm=pm.HBM_BW,
                             ici=pm.NVLINK_BW)
    assert dataclasses.asdict(j) == r.to_dict()


@pytest.mark.parametrize("arch", ["smat-ffn-1.3b", "smat-attn-1.3b",
                                  "smat-ffn-1.3b:smoke",
                                  "smat-attn-1.3b:smoke",
                                  "deepseek-v2-lite-16b", "deepseek-v2-236b",
                                  "mamba2-1.3b", "deepseek-v2-lite-16b:smoke",
                                  "mamba2-1.3b:smoke"])
def test_model_flops_equal_jax(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    for name in SHAPES:
        assert rl.model_flops_for(cfg, SHAPES[name]) == \
            jrl.model_flops_for(jcfg, JAX_SHAPES[name])
    assert rl.model_flops_for(cfg, SHAPES["train_4k"], n_tokens=7) == \
        jrl.model_flops_for(jcfg, JAX_SHAPES["train_4k"], n_tokens=7)


@pytest.mark.parametrize("arch", ["smat-ffn-1.3b:smoke",
                                  "smat-attn-1.3b:smoke"])
def test_work_count_against_the_plain_forward(arch):
    cfg = get_config(arch)
    B, Lq = 2, 128
    model = T.init_params(cfg, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(B, Lq)))
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        T.prefill(cfg, model, {"tokens": tokens}, Lq)
    work = rl.work_count(cfg, ShapeCell("p", "prefill", Lq, B),
                         device="cpu")
    per_pair = 4 * cfg.head_dim * cfg.n_heads * B * cfg.n_layers
    if cfg.attn_sparsity is None:
        # the plain forward scores the whole square, the count the triangle
        gap = per_pair * (Lq * Lq - Lq * (Lq + 1) // 2)
    else:
        # the plain fused attention walks every schedule slot
        meta = A.attention_mask_meta(cfg.attn_sparsity.mask, Lq,
                                     tuple(cfg.attn_sparsity.block))
        h, w = meta.block
        slots = meta.n_block_rows * meta.max_bpr
        gap = per_pair * (slots - meta.nnzb) * h * w
    gap += 2 * B * (Lq - 1) * cfg.d_model * cfg.vocab_size      # the head
    assert fc.get_total_flops() == work.flops + gap
    parts = work.parts["flops"]
    assert parts["projections"] + parts["ffn"] + parts["attention"] + \
        parts["head"] == work.flops


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_work_count_terms(kind):
    cfg = get_config("smat-ffn-1.3b:smoke")
    shape = ShapeCell("c", kind, 64, 2)
    work = rl.work_count(cfg, shape, device="cpu")
    parts = work.parts["flops"]
    fwd = parts["projections"] + parts["ffn"] + parts["attention"] + \
        parts["head"]
    assert work.flops == (3 * fwd if kind == "train" else fwd)
    if kind == "train":
        # the forward of a prefill, with the LM head at every position
        pre = rl.work_count(cfg, dataclasses.replace(shape, kind="prefill"),
                            device="cpu").parts["flops"]
        assert parts == dict(pre, head=pre["head"] * shape.seq_len,
                             passes=3)
    assert work.bytes == sum(work.parts["bytes"].values())
    assert work.wire_bytes == 0
    # one card: per-device numbers are the whole
    assert work.per_device(1, work.weight_bytes) == (work.flops, work.bytes)


def _spec_bytes(tree) -> int:
    return sum(t.numel() * t.element_size()
               for t in T.flat_specs(tree).values())


@pytest.mark.parametrize("arch", ["smat-ffn-1.3b:smoke",
                                  "smat-attn-1.3b:smoke"])
@pytest.mark.parametrize("kind,seq", [("train", 64), ("prefill", 64),
                                      ("decode", 64), ("decode", 72)])
def test_work_count_bytes_from_the_specs(arch, kind, seq):
    """Each byte term against its sum over the specs: the weights (the
    embedding's unread rows left out), the inputs, the K/V rows a step
    touches (from ``cache_specs`` and, in decode, the page table the layer
    decodes through), the logits, and AdamW's state from ``opt_specs``."""
    cfg = get_config(arch)
    B, V = 2, cfg.vocab_size
    work = rl.work_count(cfg, ShapeCell("c", kind, seq, B), device="cpu")
    flat = T.flat_specs(T.param_specs(cfg, device="cpu"))
    floats = {k: t for k, t in flat.items() if t.is_floating_point()}
    total = _spec_bytes(floats)
    embed = _spec_bytes(flat["embed"])
    tokens = B if kind == "decode" else B * seq
    unread = embed * (V - min(tokens, V)) / V
    weights = total - unread
    if kind == "train":
        # backward re-read (no embedding), gradients, AdamW's 3 passes
        weights += (total - embed) + total + 3 * total
    cache = _spec_bytes(T.cache_specs(cfg, B, seq))
    ring = T.cache_specs(cfg, B, seq)["k"].shape[2]
    if kind == "train":
        kv = 0
    elif kind == "prefill":
        kv = cache
    else:
        table = L._decode_pages(cfg, cfg.sliding_window, seq)
        keys = ring
        if table is not None:
            pages, live = table
            h, w = cfg.attn_sparsity.block
            keys = int(live[(seq - 1) // h].sum()) * w
        kv = cache * (keys + 1) / ring
    state = 0
    if kind == "train":
        opt = st.opt_specs(cfg, flat)
        state = 2 * (_spec_bytes(opt["m"]) + _spec_bytes(opt["v"]))
    want = {"weights": weights,
            "inputs": _spec_bytes(st.input_specs(
                cfg, ShapeCell("c", kind, seq, B))),
            "logits": 4 * (tokens if kind == "train" else B) * V,
            "kv_cache": kv, "optimizer_state": state}
    assert work.parts["bytes"] == pytest.approx(want, rel=1e-12, abs=0)
    assert work.bytes == pytest.approx(sum(want.values()), rel=1e-12)
    if kind != "train":
        # the logits the dry-run's record says the step returns
        _, outs, _ = dryrun._cell_leaves(
            cfg, ShapeCell("c", kind, seq, B), dryrun.make_mesh(), True,
            "cpu")
        assert outs["logits"] == want["logits"]


def test_live_blocks_per_row_equals_the_mask_bcsr():
    masks = [A.blockwise_causal(), A.banded(1), A.banded(17), A.banded(40),
             A.local_global(7, 5), A.local_global(16, 16),
             dataclasses.replace(A.banded(40), window_cap=9),
             dataclasses.replace(A.local_global(33, 40), window_cap=32)]
    for mask in masks:
        for seq in (1, 37, 100):
            for block in ((16, 16), (8, 16), (16, 8)):
                a = A.attention_mask_bcsr(mask, seq, block)
                want = np.bincount(a.row_ids, minlength=-(-seq // block[0]))
                np.testing.assert_array_equal(
                    rl.live_blocks_per_row(mask, seq, block), want)


@pytest.mark.parametrize("cache_len", [32, 48, 64, 72, 256])
@pytest.mark.parametrize("paged", ["auto", "force", "off"])
def test_decode_keys_follow_the_paged_decision(cache_len, paged):
    cfg = get_config("smat-attn-1.3b:smoke")
    cfg = dataclasses.replace(cfg, attn_sparsity=dataclasses.replace(
        cfg.attn_sparsity, paged_decode=paged))
    table = L._decode_pages(cfg, cfg.sliding_window, cache_len)
    keys = rl._decode_keys(cfg, cache_len)
    if table is None:
        assert keys == cache_len
    else:
        _, live = table
        h, w = cfg.attn_sparsity.block
        assert keys == int(live[(cache_len - 1) // h].sum()) * w < cache_len \
            or paged == "force"


def test_collective_term_of_a_partitioned_ffn():
    cfg = get_config("smat-ffn-1.3b:smoke")
    cfg = dataclasses.replace(cfg, ffn_sparsity=dataclasses.replace(
        cfg.ffn_sparsity, shards=2))
    shape = ShapeCell("c", "prefill", 32, 2)
    assert rl.work_count(cfg, shape, n_devices=1, device="cpu"
                         ).wire_bytes == 0
    assert rl.work_count(cfg, shape, n_devices=4, device="cpu"
                         ).wire_bytes == 0           # not one shard a rank
    work = rl.work_count(cfg, shape, n_devices=2, device="cpu")
    es = 2                                            # bf16
    want = 0.0
    for i, o, meta in rl._sparse_layers(cfg, "cpu"):
        h = meta.block[0]
        want += 0.5 * meta.n_shards * meta.rows_per_shard * h * 64 * es
    assert work.wire_bytes == want > 0


# counts worked by hand from the docstring's rules at smoke size
# deepseek-v2-lite-16b:smoke: d 128, 4 heads, nope 32, rope 16, v 32, latent
# r 64, no q LoRA, 4 experts of width 64 (top-2, 1 shared), vocab 512, 2
# layers.  Per token a layer: q 128*4*48 = 24576, latent + rope key
# 128*80 = 10240, out 4*32*128 = 16384, and the wkv_b products
# 64*4*(32+32) = 16384 (per-head K/V in prefill; the absorbed q and context
# in decode): 67584.  MoE: router 128*4 + 3*128*64*(2+1) = 74240.
# mamba2-1.3b:smoke: d 128, d_inner 256, 16 heads of 16, state 16, 1 group
# (conv channels 256 + 32 = 288), chunk 32, vocab 512, 2 layers.  Per token
# a layer: in 128*(256+288+16) + out 256*128 = 104448.
HAND = {
    ("deepseek-v2-lite-16b:smoke", "prefill", 16, 2): {
        "projections": 2 * 32 * 67584 * 2,
        # 2 rows x 16*17/2 causal pairs a head, 2*(48+32) a pair
        "attention": 2 * 4 * (48 + 32) * (2 * 136) * 2,
        "ffn": 2 * 32 * 74240 * 2,
        "head": 2 * 2 * 128 * 512},
    ("deepseek-v2-lite-16b:smoke", "decode", 16, 1): {
        "projections": 2 * 1 * 67584 * 2,
        # the whole 16-slot ring, 2*(2*64 + 16) a pair a head
        "attention": 2 * 4 * (2 * 64 + 16) * 16 * 2,
        "ffn": 2 * 1 * 74240 * 2,
        "head": 2 * 1 * 128 * 512},
    ("mamba2-1.3b:smoke", "prefill", 64, 2): {
        "projections": 2 * 128 * 104448 * 2,
        # conv 2*4*288 a token; 2 chunks of 32*33/2 pairs a row at
        # 2*(16+16) a head; 4*16*16 a head a token
        "attention": (2 * 128 * 4 * 288 + 2 * 16 * 32 * (2 * 2 * 528)
                      + 4 * 128 * 16 * 16 * 16) * 2,
        "ffn": 0,
        "head": 2 * 2 * 128 * 512},
    ("mamba2-1.3b:smoke", "decode", 64, 2): {
        "projections": 2 * 2 * 104448 * 2,
        "attention": (2 * 2 * 4 * 288 + 4 * 2 * 16 * 16 * 16) * 2,
        "ffn": 0,
        "head": 2 * 2 * 128 * 512},
}
# bytes: the decode cache a step touches (bf16 latent of 64 + 16 a position
# a layer over 16 + 1 rows; a mamba row's conv window 3*288 bf16 and f32
# state 16*16*16, read and written in decode, written by a prefill)
HAND_CACHE = {
    ("deepseek-v2-lite-16b:smoke", "prefill", 16, 2): 80 * 2 * 2 * 2 * 16,
    ("deepseek-v2-lite-16b:smoke", "decode", 16, 1): 80 * 2 * 2 * 1 * 17,
    ("mamba2-1.3b:smoke", "prefill", 64, 2): (3 * 288 * 2 + 4096 * 4) * 2 * 2,
    ("mamba2-1.3b:smoke", "decode", 64, 2): (3 * 288 * 2 + 4096 * 4) * 2 * 2
    * 2,
}


@pytest.mark.parametrize("key", list(HAND), ids=lambda k: f"{k[0]}-{k[1]}")
def test_work_count_of_the_new_layouts_by_hand(key):
    arch, kind, seq, batch = key
    work = rl.work_count(get_config(arch), ShapeCell("c", kind, seq, batch),
                         device="cpu")
    parts = work.parts["flops"]
    assert {k: parts[k] for k in HAND[key]} == HAND[key]
    assert work.flops == sum(HAND[key].values())
    assert work.parts["bytes"]["kv_cache"] == HAND_CACHE[key]


def test_moe_weight_bytes_read_only_reachable_experts():
    """deepseek-v2-lite-16b:smoke decoding one token (top-2 of 4 experts):
    half of each routed bank is read.  Floating bytes by hand: embed and
    head 512*128*2 each, final norm 128*4; a layer: norms 2*128*4, MLA
    128*192*2 + 128*80*2 + 64*4 + 64*256*2 + 128*128*2 = 135424, router
    128*4*4, routed banks 3*4*128*64*2 = 196608, shared 3*128*64*2."""
    cfg = get_config("deepseek-v2-lite-16b:smoke")
    layer = 1024 + 135424 + 2048 + 196608 + 49152
    total = 2 * 131072 + 512 + 2 * layer
    fwd = total - 131072 + 256 - 2 * 196608 // 2    # one embedding row
    work = rl.work_count(cfg, ShapeCell("c", "decode", 16, 1), device="cpu")
    assert work.parts["bytes"]["weights"] == fwd
    # 4 tokens x top-2 reach every expert: the whole bank is read
    work4 = rl.work_count(cfg, ShapeCell("c", "prefill", 4, 1), device="cpu")
    assert work4.parts["bytes"]["weights"] == total - 131072 + 4 * 256
    # training re-reads the reached experts and runs AdamW on everything
    tr = rl.work_count(cfg, ShapeCell("c", "train", 1, 1), device="cpu")
    rest = total - 131072 - 196608
    assert tr.parts["bytes"]["weights"] == (rest + 256) + rest + 4 * total


# ------------------------------- gemma_pair, zamba, codebooks, tokens+patches
def _plain_prefill_flops(cfg, B, Lq, seed=0):
    """FlopCounterMode over the plain CPU prefill of random weights (with
    random patch embeddings in front for ``tokens+patches``)."""
    model = T.init_params(cfg, device="cpu")
    rng = np.random.default_rng(seed)
    P = cfg.patch_tokens if cfg.input_mode == "tokens+patches" else 0
    row = (cfg.n_codebooks,) if cfg.input_mode == "codebooks" else ()
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, size=(B, Lq - P) + row))}
    if P:
        batch["patch_embeds"] = torch.from_numpy(rng.standard_normal(
            (B, P, cfg.d_model)).astype(np.float32))
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        T.prefill(cfg, model, batch, Lq)
    return fc.get_total_flops()


@pytest.mark.parametrize("arch", ["gemma2-27b:smoke", "musicgen-medium:smoke",
                                  "pixtral-12b:smoke", "h2o-danube-1.8b:smoke",
                                  "qwen2.5-14b:smoke"])
def test_work_count_of_the_new_inputs_against_the_plain_forward(arch):
    """A 2 x 128 prefill: the plain forward scores the whole square of
    every layer (the count: the causal triangle, within the window where
    the layer has one: the local halves of ``gemma_pair``, danube's
    layers) and runs the head (each codebook's) at every position (the
    count: the last).  The patches of ``tokens+patches`` are positions of
    the sequence."""
    cfg = get_config(arch)
    B, Lq = 2, 128
    work = rl.work_count(cfg, ShapeCell("p", "prefill", Lq, B), device="cpu")
    per_pair = 4 * cfg.head_dim * cfg.n_heads * B
    if cfg.layout == "gemma_pair":
        half = cfg.n_layers // 2
        counted = half * (rl._causal_pairs(Lq, cfg.sliding_window) +
                          rl._causal_pairs(Lq, None))
    else:
        counted = cfg.n_layers * rl._causal_pairs(Lq, cfg.sliding_window)
    gap = per_pair * (cfg.n_layers * Lq * Lq - counted)
    cb = cfg.n_codebooks if cfg.input_mode == "codebooks" else 1
    gap += 2 * B * (Lq - 1) * cfg.d_model * cfg.vocab_size * cb
    assert _plain_prefill_flops(cfg, B, Lq) == work.flops + gap
    windowed = cfg.layout == "gemma_pair" or bool(cfg.sliding_window)
    assert windowed == (counted < cfg.n_layers * Lq * (Lq + 1) // 2)


def test_work_count_of_zamba_by_hand():
    """zamba2-7b:smoke (2 units of 2 Mamba2 layers + a tail of 1: 5 ``ssd``
    layers as mamba2-1.3b:smoke's, 104448 projection flops a token a layer;
    the shared block applied twice: q/k/v/o 128*128 + 2*128*64 + 128*128 =
    49152 a token, the MLP 3*128*256 a token, attention 4*32*4 a causal
    pair a row) prefilling 2 x 64, and its decode cache: 5 conv windows
    and states, and the 2 units' own K/V rings."""
    cfg = get_config("zamba2-7b:smoke")
    work = rl.work_count(cfg, ShapeCell("c", "prefill", 64, 2), device="cpu")
    ssd_mixer = 2 * 128 * 4 * 288 + 2 * 16 * 32 * (2 * 2 * 528) + \
        4 * 128 * 16 * 16 * 16
    want = {"projections": 2 * 128 * 104448 * 5 + 2 * 128 * 49152 * 2,
            "attention": ssd_mixer * 5 + 4 * 32 * 4 * 2 * (64 * 65 // 2) * 2,
            "ffn": 2 * 128 * 3 * 128 * 256 * 2,
            "head": 2 * 2 * 128 * 512}
    assert {k: work.parts["flops"][k] for k in want} == want
    ssd_cache = (3 * 288 * 2 + 4096 * 4) * 5 * 2
    kv = 2 * 2 * 32 * 2 * 2                  # K and V, bf16, a position
    assert work.parts["bytes"]["kv_cache"] == ssd_cache + kv * 64 * 2
    dec = rl.work_count(cfg, ShapeCell("c", "decode", 64, 2), device="cpu")
    assert dec.parts["bytes"]["kv_cache"] == 2 * ssd_cache + kv * 65 * 2
    # the shared block's weights read once a pass, not once a unit
    flat = T.flat_specs(T.param_specs(cfg, device="cpu"))
    total = sum(v.numel() * v.element_size() for v in flat.values()
                if v.is_floating_point())
    embed = 512 * 128 * 2
    assert work.parts["bytes"]["weights"] == total - embed + embed * 128 / 512


@pytest.mark.parametrize("arch", ["gemma2-27b:smoke", "zamba2-7b:smoke",
                                  "musicgen-medium:smoke",
                                  "pixtral-12b:smoke"])
@pytest.mark.parametrize("kind,seq", [("train", 64), ("prefill", 64),
                                      ("decode", 64), ("decode", 96)])
def test_new_layout_bytes_from_the_specs(arch, kind, seq):
    """Each byte term from the specs: the weights (the embedding rows the
    text positions gather, from every codebook's table), the inputs, the
    decode cache (a prefill writes every leaf; a decode step reads each
    K/V ring and writes one row, reads and writes each conv window and
    state), the logits (every codebook's; a train step's at the text
    positions) and AdamW's state."""
    cfg = get_config(arch)
    B, V = 2, cfg.vocab_size
    work = rl.work_count(cfg, ShapeCell("c", kind, seq, B), device="cpu")
    flat = T.flat_specs(T.param_specs(cfg, device="cpu"))
    floats = {k: t for k, t in flat.items() if t.is_floating_point()}
    total = _spec_bytes(floats)
    embed = _spec_bytes(flat["embed"])
    P = cfg.patch_tokens if cfg.input_mode == "tokens+patches" else 0
    text = B if kind == "decode" else B * (seq - P)
    weights = total - embed * (V - min(text, V)) / V
    if kind == "train":
        weights += (total - embed) + total + 3 * total
    kv = 0.0
    if kind != "train":
        for name, leaf in T.flat_specs(T.cache_specs(cfg, B, seq)).items():
            nbytes = leaf.numel() * leaf.element_size()
            if kind == "prefill":
                kv += nbytes
            elif name.rsplit(".", 1)[-1] in ("k", "v"):
                ring = leaf.shape[-3]
                kv += nbytes * (ring + 1) / ring
            else:
                kv += 2 * nbytes
    state = 0
    if kind == "train":
        opt = st.opt_specs(cfg, flat)
        state = 2 * (_spec_bytes(opt["m"]) + _spec_bytes(opt["v"]))
    cb = cfg.n_codebooks if cfg.input_mode == "codebooks" else 1
    want = {"weights": weights,
            "inputs": _spec_bytes(st.input_specs(
                cfg, ShapeCell("c", kind, seq, B))),
            "logits": 4 * (text if kind == "train" else B) * V * cb,
            "kv_cache": kv, "optimizer_state": state}
    assert work.parts["bytes"] == pytest.approx(want, rel=1e-12, abs=0)
    if kind != "train":
        _, outs, _ = dryrun._cell_leaves(
            cfg, ShapeCell("c", kind, seq, B), dryrun.make_mesh(), True,
            "cpu")
        assert outs["logits"] == want["logits"]


@pytest.mark.parametrize("arch", ["gemma2-27b", "zamba2-7b",
                                  "musicgen-medium", "pixtral-12b",
                                  "h2o-danube-1.8b", "minitron-4b",
                                  "qwen2.5-14b", "gemma2-27b:smoke",
                                  "zamba2-7b:smoke"])
def test_model_flops_of_the_new_archs_equal_jax(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    for name in SHAPES:
        assert rl.model_flops_for(cfg, SHAPES[name]) == \
            jrl.model_flops_for(jcfg, JAX_SHAPES[name])

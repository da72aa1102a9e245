"""End to end on the PyTorch/CUDA port: train a ~100M-parameter LM
whose FFN weights are block-sparse (the paper's technique as a training
feature), with checkpointing; the steps of ``examples/train_sparse_lm.py``.

  PYTHONPATH=src python examples/torch_train_sparse_lm.py --steps 150
  PYTHONPATH=src python examples/torch_train_sparse_lm.py --device cpu \\
      --layers 1 --vocab 256 --steps 12 --batch 2 --seq 16

~100M params: d_model=768, 12 layers, vocab 32000, FFN 3072 at 30%
block-density (block 32x32), float32.  On the card every sparse product
runs kernels B1 (forward and dB) and B2 (dvals), in float32 (3xTF32).
``--layers`` and ``--vocab`` cut the depth and the vocabulary (a CPU run).
Checkpoints go to ``--ckpt-dir`` (default: a temporary directory, removed
at the end).
"""
import argparse
import dataclasses
import logging
import tempfile

from repro_torch.configs.base import ModelConfig, ShapeCell
from repro_torch.core.sparse_linear import SparsitySpec
from repro_torch.models.transformer import resolve_device
from repro_torch.optim import adamw
from repro_torch.train.loop import train

logging.basicConfig(level=logging.INFO,
                    format="%(asctime)s %(message)s", datefmt="%H:%M:%S")

CONFIG = ModelConfig(
    name="smat-ffn-100m", family="dense", layout="attn_mlp",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=4, head_dim=64,
    d_ff=3072, vocab_size=32000,
    ffn_sparsity=SparsitySpec(density=0.30, block=(32, 32),
                              backend="nnz_stream"),
    dtype="float32",
)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--layers", type=int, default=CONFIG.n_layers)
    ap.add_argument("--vocab", type=int, default=CONFIG.vocab_size)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = dataclasses.replace(CONFIG, n_layers=args.layers,
                              vocab_size=args.vocab)
    print(f"params ~{cfg.param_count() / 1e6:.0f}M "
          f"(sparse FFN at {cfg.ffn_sparsity.density:.0%} block-density)")
    shape = ShapeCell("train", "train", args.seq, args.batch)
    warmup = min(20, max(args.steps // 5, 1))
    with tempfile.TemporaryDirectory() as tmp:
        res = train(cfg, shape, device=device, total_steps=args.steps,
                    opt_cfg=adamw.AdamWConfig(lr=6e-4, warmup_steps=warmup,
                                              total_steps=args.steps),
                    ckpt_dir=args.ckpt_dir or tmp, ckpt_every=50,
                    log_every=10)
    print(f"loss: {res.losses[0]:.3f} -> {res.losses[-1]:.3f} "
          f"over {len(res.losses)} steps")
    assert res.losses[-1] < res.losses[0]
    print("OK")
    return {"param_count": cfg.param_count(), "losses": res.losses}


if __name__ == "__main__":
    main()

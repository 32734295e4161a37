"""End-to-end LM training on the PyTorch port, with checkpointing (the
loop of ``examples/train_lm.py``).

The default config has ~28M parameters (150 steps of 2 x 128 tokens);
``--big`` selects the ~100M, 300-step variant.  Both are float32 at head
dim 64: on the card every layer's attention runs the flash-attention
kernel K5 forward and its backward kernel, on the CPU their plain
versions.  The run must lower the loss by more than 1.0.

    PYTHONPATH=src python examples/train_lm_torch.py [--steps N] [--big]
    PYTHONPATH=src python examples/train_lm_torch.py --device cpu
"""
import argparse
import shutil
import tempfile
import time

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.data import lm_batch_fn
from repro_torch.device import resolve_device
from repro_torch.models.transformer import (TransformerConfig, init_params,
                                            lm_loss)
from repro_torch.optim import AdamWConfig, init_state
from repro_torch.train import make_train_step
from repro_torch.tree import tree_leaves


def make_config(big: bool = False) -> TransformerConfig:
    if big:     # ~100M params: 8L x d512 x ffn2048, 32k vocab
        return TransformerConfig(
            name="lm-100m", n_layers=8, d_model=512, n_heads=8,
            n_kv_heads=4, d_ff=2048, vocab=32768, dtype=torch.float32,
            attn_impl="dense", remat=False)
    return TransformerConfig(  # ~28M params
        name="lm-28m", n_layers=4, d_model=384, n_heads=6, n_kv_heads=3,
        d_ff=1536, vocab=16384, dtype=torch.float32, attn_impl="dense",
        remat=False)


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=None,
                    help="150 (300 with --big)")
    ap.add_argument("--big", action="store_true")
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint directory (default: a temporary one, "
                         "removed at the end)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = make_config(args.big)
    steps = args.steps or (300 if args.big else 150)
    params = init_params(torch.Generator(device=dev).manual_seed(0), cfg,
                         device=dev)
    n_params = sum(t.numel() for t in tree_leaves(params))
    print(f"model: {n_params / 1e6:.1f}M params on {dev}")

    opt = AdamWConfig(lr=3e-4)
    state = init_state(params)
    step_fn = make_train_step(lambda p, b: lm_loss(p, b, cfg), opt,
                              donate=True)
    make_batch = lm_batch_fn(cfg.vocab, batch=8 if args.big else 2,
                             seq=256 if args.big else 128, seed=0)
    root = args.ckpt or tempfile.mkdtemp(prefix="repro_lm_ckpt")
    mgr = CheckpointManager(root, save_every=100)
    losses = []
    t0 = time.perf_counter()
    try:
        for step in range(steps):
            batch = {k: torch.from_numpy(v).to(dev)
                     for k, v in make_batch(step).items()}
            params, state, metrics = step_fn(params, state, batch)
            losses.append(float(metrics["loss"]))
            if step % 25 == 0:
                print(f"step {step:4d} loss {losses[-1]:.4f} "
                      f"({time.perf_counter() - t0:.0f}s)", flush=True)
            mgr.maybe_save(step + 1, (params, state))
        mgr.wait()
    finally:
        if args.ckpt is None:
            shutil.rmtree(root, ignore_errors=True)
    print(f"final loss {losses[-1]:.4f} (start {losses[0]:.4f})")
    if not losses[-1] < losses[0] - 1.0:
        raise AssertionError("model did not learn")
    print("OK: loss decreased by", round(losses[0] - losses[-1], 2))
    return losses


if __name__ == "__main__":
    main()

"""LM training launcher (``repro.launch.train``) on one GPU.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \
        --seq 4096 --batch 3 --steps 10
    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \
        --smoke --steps 50 --ckpt /tmp/ckpt --device cpu

The reference's flags, plus ``--device`` (default ``cuda``).  ``--arch``
takes the five LM arch ids, resolved through the port's ``configs``
modules (``ARCHS``, which the registry will replace, ROADMAP §1 item
16.3); ``--smoke`` picks the arch's smoke config.  As the reference
does:

  * batches are a pure function of (seed, step) (``lm_batch_fn``) and
    the weights are drawn from seed 0, so a restart from checkpoint step
    N reproduces the run: on the CPU, bitwise;
  * params and AdamW state are donated to the step, which updates them
    in place (``make_train_step(..., donate=True)``, the counterpart of
    the reference's ``jit(..., donate_argnums=(0, 1))``);
  * ``--ckpt`` checkpoints (params, state) every ``--ckpt-every`` steps
    with ``checkpoint.CheckpointManager`` and resumes from the newest
    verifying step;
  * each logged step prints its time and the p99/p50 skew of the last 50
    step times, flagging a straggler past 3x.

``--compress int8`` compresses a data-parallel gradient all-reduce that
one GPU does not have, and more than one visible GPU would need the
production mesh: both raise, naming ROADMAP items 16.4 and 16.5.
"""
from __future__ import annotations

import argparse
import importlib
import time

import numpy as np
import torch

from ..checkpoint import CheckpointManager
from ..data.pipeline import lm_batch_fn
from ..device import resolve_device
from ..models.transformer import init_params, lm_loss
from ..optim.adamw import AdamWConfig, init_state
from ..train.step import make_train_step

__all__ = ["ARCHS", "build_lm_training", "lm_config", "main"]

# the LM arch ids and their config modules under repro_torch.configs
ARCHS = {"llama3.2-3b": "llama3_2_3b", "qwen2-7b": "qwen2_7b",
         "gemma3-27b": "gemma3_27b",
         "granite-moe-3b-a800m": "granite_moe_3b_a800m",
         "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b"}


def lm_config(arch: str, smoke: bool = False):
    """The arch's config (or its smoke config)."""
    if arch not in ARCHS:
        raise SystemExit(f"train.py drives the LM archs {sorted(ARCHS)}; "
                         f"got {arch!r} (GNN and recsys examples live under "
                         "examples/)")
    mod = importlib.import_module(f"..configs.{ARCHS[arch]}", __package__)
    return mod.make_smoke_config() if smoke else mod.make_config()


def build_lm_training(cfg, opt: AdamWConfig, device, seed: int = 0):
    """(params drawn from ``seed`` on ``device``, AdamW state, the donating
    step)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = init_params(gen, cfg, device=dev)
    state = init_state(params, compress=opt.compress is not None)
    step_fn = make_train_step(lambda p, b: lm_loss(p, b, cfg), opt,
                              donate=True)
    return params, state, step_fn


def _check_one_device(dev) -> None:
    if dev.type == "cuda" and torch.cuda.device_count() > 1:
        raise NotImplementedError(
            f"{torch.cuda.device_count()} GPUs are visible: training across "
            "several needs the production meshes and FSDP/TP sharding "
            "(ROADMAP §1 items 16.5 and 16.4); make one visible "
            "(CUDA_VISIBLE_DEVICES)")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--compress", choices=["int8"], default=None)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.compress is not None:
        raise NotImplementedError(
            "--compress int8 compresses the data-parallel gradient "
            "all-reduce, which one GPU does not have: ROADMAP §1 item 16.4")
    dev = resolve_device(args.device)
    _check_one_device(dev)
    cfg = lm_config(args.arch, args.smoke)
    opt = AdamWConfig(lr=args.lr)
    params, opt_state, step_fn = build_lm_training(cfg, opt, dev)
    make_batch = lm_batch_fn(cfg.vocab, args.batch, args.seq, args.seed)

    start_step = 0
    mgr = None
    if args.ckpt:
        mgr = CheckpointManager(args.ckpt, save_every=args.ckpt_every)
        restored = mgr.restore_or_none((params, opt_state),
                                       device=dev)
        if restored is not None:
            (params, opt_state), start_step, _meta = restored
            print(f"[train] resumed from step {start_step} on {dev}")

    times = []
    loss = float("nan")
    for step in range(start_step, args.steps):
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in make_batch(step).items()}
        t0 = time.perf_counter()
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        loss = float(metrics["loss"])
        dt = time.perf_counter() - t0
        if step > start_step + 1:   # skip the warm-up steps' outliers
            times.append(dt)
        if step % args.log_every == 0 and times:
            p50 = float(np.percentile(times[-50:], 50))
            p99 = float(np.percentile(times[-50:], 99))
            skew = p99 / max(p50, 1e-9)
            straggler = " STRAGGLER?" if (len(times) > 20 and
                                          skew > 3.0) else ""
            print(f"[train] step {step} loss {loss:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"dt {dt*1e3:.1f}ms p99/p50 {skew:.2f}{straggler}",
                  flush=True)
        if not np.isfinite(loss):
            raise RuntimeError(f"loss diverged at step {step}")
        if mgr:
            mgr.maybe_save(step + 1, (params, opt_state),
                           metadata={"loss": loss})
    if mgr:
        mgr.wait()
    print(f"[train] done: {args.steps - start_step} steps, "
          f"final loss {loss:.4f}")
    return loss


if __name__ == "__main__":
    main()

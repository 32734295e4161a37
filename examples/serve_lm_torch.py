"""Serving example on the PyTorch port: batched prefill, then greedy
decode from a KV cache (the loop of ``examples/serve_lm.py``).

    # llama3.2-3b at full width on the card, weights drawn from a seed
    PYTHONPATH=src python examples/serve_lm_torch.py
    # the smoke config on the CPU
    PYTHONPATH=src python examples/serve_lm_torch.py --smoke --device cpu

Every full-attention layer's prefill runs the flash-attention kernel on
the card (its plain version on the CPU).  The JAX demo's local/global
layer pattern waits for the sliding-window slice of the port.
"""
import argparse
import time

import torch

from repro_torch.configs.llama3_2_3b import make_config, make_smoke_config
from repro_torch.device import resolve_device
from repro_torch.models.transformer import (decode_step, grow_cache,
                                            init_params, prefill_step)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(params, prompt, cfg, gen_len: int) -> tuple:
    """Greedy generation: prefill, grow the cache by ``gen_len``, then
    ``gen_len - 1`` decode steps.  Returns (ids (B, gen_len), the last
    logits, prefill seconds, decode seconds)."""
    t0 = time.perf_counter()
    logits, cache = prefill_step(params, prompt, cfg)
    cache = grow_cache(cache, gen_len)
    tokens = torch.argmax(logits, -1)[:, None]
    _sync(prompt.device)
    prefill_s = time.perf_counter() - t0
    out = [tokens]
    t0 = time.perf_counter()
    for _ in range(gen_len - 1):
        logits, cache = decode_step(params, cache, tokens, cfg)
        tokens = torch.argmax(logits, -1)[:, None]
        out.append(tokens)
    _sync(prompt.device)
    return torch.cat(out, dim=1), logits, prefill_s, time.perf_counter() - t0


def main(argv=None) -> torch.Tensor:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="the smoke config instead of llama3.2-3b")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--gen-len", type=int, default=32)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = make_smoke_config() if args.smoke else make_config()
    # serve_lm.py's 4 x 96 on the smoke config; 2 prompts of 4096 tokens
    # at full width
    batch, prompt_len = (4, 96) if args.smoke else (2, 4096)

    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_params(gen, cfg, device=dev)
    prompt = torch.randint(0, cfg.vocab, (batch, prompt_len), generator=gen,
                           device=dev)
    with torch.no_grad():
        ids, logits, prefill_s, decode_s = generate(params, prompt, cfg,
                                                    args.gen_len)
    steps = max(args.gen_len - 1, 1)
    print(f"{cfg.name} on {dev}: prefill {batch}x{prompt_len} "
          f"{prefill_s * 1e3:.0f} ms; decoded {args.gen_len - 1} tokens/seq "
          f"x {batch} seqs: {decode_s / steps * 1e3:.1f} ms/token")
    if not bool(torch.isfinite(logits).all()):
        raise SystemExit("non-finite logits")
    print("generated token ids (seq 0):", ids[0, :16].tolist())
    print("OK")
    return ids


if __name__ == "__main__":
    main()

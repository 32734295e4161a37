"""``chip_smoke.py``'s phase [22] alone, on the card: [1] the device, [2]
the kernel builds, then [22] (K5's sliding-window mode at gemma3's local
shape, in float32 and at a ragged shape; gemma3-27b at full width and
depth: a 1 x 16,384 prefill and 8 decode steps, 1 x 32,768 prefilled
twice; the kernel route against the plain route on one period of 6
layers); last, after every timed run, a warm prefill under the profiler
(device time by kernel, idle share).

    PYTHONPATH=src python tools/gemma_phase.py
"""
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
import chip_smoke as cs  # noqa: E402


def profile_gemma() -> None:
    """A warm 1 x GEMMA_DECODE_PROMPT prefill of gemma3-27b under the
    profiler (a profiler session leaves overhead on later launches)."""
    import torch
    from repro_torch.configs.gemma3_27b import make_config
    from repro_torch.models.transformer import init_params, prefill_step
    cfg = make_config()
    gen = torch.Generator(device=cs.DEVICE).manual_seed(cs.SEED + 33)
    params = init_params(gen, cfg, device=cs.DEVICE)
    prompt = torch.randint(0, cfg.vocab, (1, cs.GEMMA_DECODE_PROMPT),
                           generator=gen, device=cs.DEVICE)
    with torch.no_grad():
        cs.profile_serving("gemma3 warm prefill", lambda: prefill_step(
            params, prompt, cfg))
    del params
    torch.cuda.empty_cache()


def main() -> None:
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs.load_main_config()
    t0 = time.perf_counter()
    _, _, smi = cs.phase_device()
    cs.phase_build()
    t22 = time.perf_counter()
    cs.log(f"[22] gemma3-27b; {smi}")
    row = cs.phase_flash_window()
    paths = cs.phase_gemma()
    print(json.dumps({"window_row": row, "launches_by_path": paths}),
          flush=True)
    print(f"gemma_phase: [22] {time.perf_counter() - t22:.1f} s; {smi}",
          flush=True)
    profile_gemma()
    print(f"gemma_phase: total {time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()

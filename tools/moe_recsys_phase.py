"""``chip_smoke.py``'s phase [21] alone, on the card: [1] the device, [2]
the kernel builds, then [21] (granite-moe-3b-a800m at full width and
depth: a 2 x 32,768 prefill through K5, 32 decode steps, the share of
choices dropped by capacity a layer, the routing on the card against the
CPU, the kernel route against the plain route in float32 and bfloat16;
moonshot at 1 x 4,096 and qwen2-7b at 1 x 32,768 with 8 decode steps
each; MIND's serve_p99, serve_bulk, retrieval_cand and train_batch
cells); last, after every timed run, a granite decode step and prefill
under the profiler (device time by kernel, idle share).

    PYTHONPATH=src python tools/moe_recsys_phase.py
"""
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
import chip_smoke as cs  # noqa: E402


def main() -> None:
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs.load_main_config()
    t0 = time.perf_counter()
    _, _, smi = cs.phase_device()
    cs.phase_build()
    t21 = time.perf_counter()
    cs.log(f"[21] MoE serving, qwen2 and MIND; {smi}")
    paths = {**cs.phase_moe_serving(), **cs.phase_mind()}
    print(json.dumps({"launches_by_path": {
        k: c["flash_attention"] for k, c in paths.items()}}), flush=True)
    print(f"moe_recsys_phase: [21] {time.perf_counter() - t21:.1f} s; {smi}",
          flush=True)
    cs.profile_granite()
    print(f"moe_recsys_phase: total {time.perf_counter() - t0:.1f} s",
          flush=True)


if __name__ == "__main__":
    main()

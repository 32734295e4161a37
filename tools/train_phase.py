"""``chip_smoke.py``'s phase [23] alone, on the card: [1] the device, [2]
the kernel builds, then [23] (K5's backward against its plain version at
the training shapes and timed beside SDPA's backward; the kernel route
against the plain route on 2 layers of llama3.2-3b; llama3.2-3b trained
at full width and depth; ``examples/train_lm_torch.py`` and three smoke
configs).  Prints the K5 bwd rows and the paths' launch counts as JSON.

    PYTHONPATH=src python tools/train_phase.py
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
    cs.log(f"[23] LM training; {smi}")
    row, window_row, paths = cs.phase_train()
    print(json.dumps({"bwd_row": row, "bwd_window_row": window_row,
                      "launches_by_path": paths}), flush=True)
    print(f"train_phase: total {time.perf_counter() - t0:.1f} s; {smi}",
          flush=True)


if __name__ == "__main__":
    main()

"""Run ``chip_smoke.py``'s weighted phase alone on the card: the device
and the builds ([1], [2]), then [18] (W1 and W2 at a mid-search state of
the weighted production graph, the weighted run, one sharded batch, the
accuracy check and R5's unit grid), and print the phase's kernels line.

    PYTHONPATH=src python tools/weighted_phase.py
"""
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke  # noqa: E402


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("weighted_phase: no CUDA device", file=sys.stderr)
        return 2
    chip_smoke.load_main_config()
    chip_smoke.phase_device()
    chip_smoke.phase_build()
    rows, paths = chip_smoke.phase_weighted()
    for row in rows:
        row["launches"] = paths["weighted"][row["name"]]
    print(json.dumps({"kernels": rows}, default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

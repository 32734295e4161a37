"""``chip_smoke.py``'s phase [20] alone, on the card: [1] the device, [2]
the kernel builds, then [20] (K4 over the molecule cell's edge plan at
D = 3, 64, 288 and 1,152, timed at MACE's width; EGNN, NequIP and MACE
at full width on the molecule cell, EGNN once more in bf16; GraphSAGE
on a NeighborSampler batch of the minibatch_lg cell).

    PYTHONPATH=src python tools/gnn_phase.py
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
    cs.phase_device()
    cs.phase_build()
    t20 = time.perf_counter()
    cs.log("[20] GNN cells")
    row, paths = cs.phase_gnn_cells()
    print(json.dumps({"segsum_molecule": row, "launches_by_path": {
        k: c["gather_segment_sum"] for k, c in paths.items()}}), flush=True)
    print(f"gnn_phase: [20] {time.perf_counter() - t20:.1f} s, total "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()

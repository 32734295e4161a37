"""``chip_smoke.py``'s SPMD phase alone, on the card: [1] the device, [2]
the kernel builds, [4] the production cell's ``run_kadabra`` in one
process (the comparison run), then [16] (4 ranks spawned on the card in
a gloo group, each aggregation, the resume, hyperbolic(1000)) and the
one-rank NCCL aggregations.  About 100 s on an H100.

    PYTHONPATH=src python tools/spmd_phase.py
"""
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
import chip_smoke as cs  # noqa: E402


def main() -> None:
    import torch
    from repro_torch.core import rmat_graph
    from repro_torch.kernels.frontier import FLAT
    cs.load_main_config()
    t0 = time.perf_counter()
    cs.phase_device()
    cs.phase_build()
    rmat = rmat_graph(cs.RMAT_SCALE, cs.EDGE_FACTOR, seed=cs.SEED,
                      device="cuda")
    res, _ = cs.drive("rmat", rmat, FLAT, cs.MAIN_EPS, cs.MAIN_DELTA,
                      sample_batch_size=cs.BATCH,
                      max_epochs=cs.MAIN_MAX_EPOCHS)
    del rmat
    torch.cuda.empty_cache()
    print(cs.phase_spmd(res), flush=True)
    cs.phase_nccl(1 << cs.RMAT_SCALE)
    print(f"spmd_phase total {time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()

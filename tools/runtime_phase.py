"""``chip_smoke.py``'s phase [19] alone, on the card: [1] the device, [2]
the kernel builds, [4]'s main-path run (the yardstick of [19a] and
[19b]), then [19] (telemetry on that run, ``ResilientRunner`` through
five faults on it, the ladder on one card and across 4 spawned ranks, a
``torch.profiler`` trace).

    PYTHONPATH=src python tools/runtime_phase.py
"""
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
import chip_smoke as cs  # noqa: E402


def main() -> None:
    from repro_torch.core import rmat_graph
    from repro_torch.kernels.frontier import FLAT
    cs.load_main_config()
    t0 = time.perf_counter()
    cs.phase_device()
    cs.phase_build()
    rmat = rmat_graph(cs.RMAT_SCALE, cs.EDGE_FACTOR, seed=cs.SEED,
                      device="cuda")
    cs.log(f"[4] main path: run_kadabra R-MAT 2^{cs.RMAT_SCALE} x "
           f"{cs.EDGE_FACTOR}, B={cs.BATCH}, eps={cs.MAIN_EPS}")
    res, counts = cs.drive("rmat", rmat, FLAT, cs.MAIN_EPS, cs.MAIN_DELTA,
                           sample_batch_size=cs.BATCH,
                           max_epochs=cs.MAIN_MAX_EPOCHS)
    del rmat
    t19 = time.perf_counter()
    cs.log("[19] runtime")
    cs.phase_runtime(res, counts)
    print(f"runtime_phase: [19] {time.perf_counter() - t19:.1f} s, total "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()

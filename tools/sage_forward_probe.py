"""GraphSAGE's forward on the minibatch_lg cell before and after training
steps, on the card: 5 forwards, 3 AdamW steps, 5 forwards (host clock
around work that ends in a synchronize), then one forward under the
profiler.  It showed that a forward timed right after an unsynchronised
step also times that step's device work.

    PYTHONPATH=src python tools/sage_forward_probe.py
"""
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
import chip_smoke as cs  # noqa: E402


def wall_ms(fn, n: int) -> list:
    import torch
    out = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(round((time.perf_counter() - t0) * 1e3, 2))
    return out


def main() -> None:
    import numpy as np
    import torch
    from repro_torch.configs import graphsage_reddit
    from repro_torch.configs._families import GNN_SHAPES
    from repro_torch.core import rmat_graph
    from repro_torch.data import NeighborSampler
    from repro_torch.models import gnn
    from repro_torch.optim import AdamWConfig, init_state
    from repro_torch.train import make_train_step
    torch.backends.cuda.matmul.allow_tf32 = False
    cs.phase_device()
    cell = GNN_SHAPES["minibatch_lg"]
    graph = rmat_graph(cs.SAMPLER_SCALE, cs.SAMPLER_EDGE_FACTOR,
                       seed=cs.SEED, device="cuda")
    rng = np.random.default_rng(cs.SEED)
    feats = rng.standard_normal((graph.n_nodes, cell["d_feat"]),
                                dtype=np.float32)
    labels = rng.integers(0, cell["classes"], graph.n_nodes).astype(
        np.int32)
    sampler = NeighborSampler(graph, cs.SAMPLER_FANOUTS, cs.SAMPLER_SEEDS)
    batch = sampler.to_graph_batch(sampler.sample(0), feats, labels,
                                   n_classes=cell["classes"],
                                   pad_nodes=cell["nodes"],
                                   pad_edges=cell["edges"], device="cuda")
    cfg = graphsage_reddit.cfg_for_shape(graphsage_reddit.make_config(), cell)
    params = gnn.sage_init(torch.Generator().manual_seed(0), cfg,
                           device="cuda")
    step = make_train_step(lambda p, b: gnn.sage_loss(p, b, cfg),
                           AdamWConfig())

    def forward():
        with torch.no_grad():
            return gnn.sage_forward(params, batch, cfg)

    print("forward before steps (ms)", wall_ms(forward, 5))
    print("steps (ms)", wall_ms(lambda: step(params, init_state(params),
                                              batch), 3))
    print("forward after steps (ms)", wall_ms(forward, 5))
    rows, wall = cs.profile_twice(forward)
    print(f"profiled forward: wall {wall:.3f} ms")
    for ms, calls, key in sorted(rows, reverse=True)[:6]:
        print(f"  {ms:.3f} ms x{calls} {key[:90]}")


if __name__ == "__main__":
    main()

"""Quickstart on the PyTorch port: approximate betweenness on a power-law
graph, then one forward stream shared by three centralities (the run of
``examples/quickstart.py``).

    # on the card
    PYTHONPATH=src python examples/quickstart_torch.py
    # on the CPU, smaller
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu --n 300
"""
import argparse

import numpy as np

from repro_torch.core import (AdaptiveConfig, brandes_numpy,
                              hyperbolic_graph, run_adaptive, run_kadabra)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=2000,
                    help="vertices of the hyperbolic graph")
    args = ap.parse_args(argv)

    # a power-law graph (the paper's synthetic family, laptop scale)
    graph = hyperbolic_graph(args.n, avg_degree=12.0, seed=0,
                             device=args.device)
    print(f"graph on {graph.device}: |V|={graph.n_nodes}  "
          f"|E|={graph.n_edges // 2}")

    # (eps, delta)-approximation: every betweenness value within eps of
    # the truth with probability 1 - delta
    cfg = AdaptiveConfig(eps=0.05, delta=0.1, n0_base=400)
    res = run_kadabra(graph, config=cfg, seed=0, device=args.device)
    print(f"converged={res.converged}  samples={res.tau} "
          f"(static cap omega={res.omega:.0f})  epochs={res.n_epochs}")
    print("top-5 vertices by approximate betweenness:")
    for v in np.argsort(res.btilde)[::-1][:5]:
        print(f"  v={v:<6} b~={res.btilde[v]:.4f}")

    # against the exact Brandes oracle (feasible at this scale)
    err = float(np.abs(res.btilde - brandes_numpy(graph)).max())
    print(f"max |b~ - b| = {err:.4f}  (guarantee: < {cfg.eps} w.p. >= 0.9)")
    if not err < cfg.eps:
        raise SystemExit(f"max error {err} >= eps {cfg.eps}")

    # one forward stream feeds every estimator: each metric keeps its own
    # stop rule, the traversals are paid once
    multi = run_adaptive(graph, ("betweenness", "closeness", "harmonic"),
                         config=cfg, seed=0, device=args.device)
    print(f"\nmulti-metric run: {multi.tau} samples, {multi.n_epochs} "
          f"epochs, converged={multi.converged}")
    for rep in multi.reports:
        top_v = int(np.argmax(rep.scores))
        print(f"  {rep.name:<12} stopped at epoch {rep.stop_epoch} "
              f"(tau={rep.tau}); top vertex {top_v} "
              f"score={rep.scores[top_v]:.4f}")
        if not np.isfinite(rep.scores).all():
            raise SystemExit(f"{rep.name}: non-finite scores")
    print("OK")
    return {"kadabra": res, "multi": multi, "max_err": err}


if __name__ == "__main__":
    main()

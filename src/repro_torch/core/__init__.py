"""Core of the port: graph storage, batched BFS, path sampling, KADABRA
statistics and the adaptive engine (mirrors ``repro.core``)."""
from .adaptive import BetweennessResult, EpochStats, run_kadabra
from .bfs import (BFSResult, BidirResult, bfs_sssp, bfs_sssp_batched,
                  bidirectional_bfs, bidirectional_bfs_batched)
from .brandes import brandes_numpy
from .diameter import DiameterEstimate, estimate_diameter
from .engine import (AdaptiveConfig, AdaptiveRunResult, draw_fold,
                     resolve_sample_batch_size, run_adaptive)
from .graph import (CSCLayout, Graph, build_csc_layout, build_graph,
                    choose_csc_blocks, erdos_renyi_graph, from_edge_list,
                    graph_from_numpy, grid_graph, hyperbolic_graph,
                    rmat_graph, with_csc_layout)
from .kadabra import (KadabraParams, calibrate_deltas, check_stop,
                      compute_omega, f_term, g_term)
from .sampler import PathSample, sample_pairs, sample_path_batched

__all__ = [
    "AdaptiveConfig", "AdaptiveRunResult", "BFSResult", "BetweennessResult",
    "BidirResult", "CSCLayout", "DiameterEstimate", "EpochStats", "Graph",
    "KadabraParams", "PathSample", "bfs_sssp", "bfs_sssp_batched",
    "bidirectional_bfs", "bidirectional_bfs_batched", "brandes_numpy",
    "build_csc_layout", "build_graph", "calibrate_deltas", "check_stop",
    "choose_csc_blocks", "compute_omega", "draw_fold", "erdos_renyi_graph",
    "estimate_diameter", "f_term", "from_edge_list", "g_term",
    "graph_from_numpy", "grid_graph", "hyperbolic_graph", "rmat_graph",
    "resolve_sample_batch_size", "run_adaptive", "run_kadabra",
    "sample_pairs", "sample_path_batched", "with_csc_layout",
]

"""Core of the port: graph storage, batched BFS, path sampling, KADABRA
statistics, the aggregation over a ``torch.distributed`` group and the
adaptive engine (mirrors ``repro.core``)."""
from .adaptive import (BetweennessResult, EpochStats, run_fixed_sampling,
                       run_kadabra)
from .bfs import (BFSResult, BidirResult, SSSPResult, bfs_sssp,
                  bfs_sssp_batched, bfs_sssp_batched_sharded,
                  bidirectional_bfs, bidirectional_bfs_batched,
                  bidirectional_bfs_batched_sharded, delta_sssp_batched,
                  delta_sssp_batched_sharded)
from .brandes import brandes_numpy
from .diameter import (DiameterEstimate, WeightedDiameterEstimate,
                       estimate_diameter, estimate_diameter_sharded,
                       estimate_diameter_weighted,
                       estimate_diameter_weighted_sharded)
from .distributed import SamplerMesh
from .engine import (AdaptiveConfig, AdaptiveRunResult, draw_fold,
                     resolve_sample_batch_size, run_adaptive, run_fixed)
from .estimators import available_metrics, get_estimator
from .graph import (CSCLayout, Graph, build_csc_layout, build_graph,
                    choose_csc_blocks, erdos_renyi_graph, from_edge_list,
                    graph_from_numpy, grid_graph, hyperbolic_graph,
                    rmat_graph, symmetric_dyadic_weights, with_csc_layout,
                    with_weights)
from .kadabra import (KadabraParams, calibrate_deltas, check_stop,
                      compute_omega, f_term, g_term)
from .partition import (ExchangePlan, PartitionedGraph, ShardedCSCLayout,
                        auto_exchange_budget, default_exchange_budget,
                        exchange_plan, gather_graph, global_row,
                        max_active_source_chunks, partition_graph,
                        partitioned_from_numpy, repartition,
                        shard_vertex_range, vertex_owner)
from .sampler import (ForwardSample, PathSample, sample_batch, sample_pairs,
                      sample_path, sample_path_batched,
                      sample_path_batched_sharded,
                      sample_path_forward_batched,
                      sample_path_forward_batched_sharded,
                      sample_path_weighted_batched,
                      sample_path_weighted_batched_sharded)
from .shards import GroupShardMesh, ShardMesh

__all__ = [
    "AdaptiveConfig", "AdaptiveRunResult", "BFSResult", "BetweennessResult",
    "BidirResult", "CSCLayout", "DiameterEstimate", "EpochStats",
    "ExchangePlan", "ForwardSample", "Graph", "GroupShardMesh",
    "KadabraParams", "PathSample",
    "PartitionedGraph", "SSSPResult", "SamplerMesh", "ShardMesh",
    "ShardedCSCLayout", "WeightedDiameterEstimate",
    "auto_exchange_budget", "available_metrics", "bfs_sssp",
    "bfs_sssp_batched", "bfs_sssp_batched_sharded", "bidirectional_bfs",
    "bidirectional_bfs_batched", "bidirectional_bfs_batched_sharded",
    "brandes_numpy", "build_csc_layout", "build_graph", "calibrate_deltas",
    "check_stop", "choose_csc_blocks", "compute_omega",
    "default_exchange_budget", "delta_sssp_batched",
    "delta_sssp_batched_sharded", "draw_fold", "erdos_renyi_graph",
    "estimate_diameter", "estimate_diameter_sharded",
    "estimate_diameter_weighted", "estimate_diameter_weighted_sharded",
    "exchange_plan",
    "f_term", "from_edge_list", "g_term", "gather_graph", "get_estimator",
    "global_row", "graph_from_numpy", "grid_graph", "hyperbolic_graph",
    "max_active_source_chunks", "partition_graph", "partitioned_from_numpy",
    "repartition", "rmat_graph", "resolve_sample_batch_size",
    "run_adaptive", "run_fixed", "run_fixed_sampling", "run_kadabra",
    "sample_batch", "sample_pairs", "sample_path", "sample_path_batched",
    "sample_path_batched_sharded", "sample_path_forward_batched",
    "sample_path_forward_batched_sharded", "sample_path_weighted_batched",
    "sample_path_weighted_batched_sharded", "shard_vertex_range",
    "symmetric_dyadic_weights", "vertex_owner", "with_csc_layout",
    "with_weights",
]

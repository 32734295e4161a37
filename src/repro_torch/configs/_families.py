"""The port's copy of the cell shapes (``repro.configs._families``): the
LM cells, every GNN cell (full-batch classification, the
neighbour-sampled ``minibatch_lg`` and the batched ``molecule``
regression) and MIND's recsys cells.  The registry, ``ArchDef`` and
the family builders wait for their slice, with ``launch/dryrun.py``."""

__all__ = ["GNN_SHAPES", "LM_SHAPES", "RECSYS_SHAPES"]

LM_SHAPES = {
    "train_4k": dict(seq=4096, batch=256),
    "prefill_32k": dict(seq=32768, batch=32),
    "decode_32k": dict(seq=32768, batch=128),
    "long_500k": dict(seq=524288, batch=1),
}

# (nodes_pad, edges_pad, d_feat, n_classes, n_graphs, task)
GNN_SHAPES = {
    # cora-scale full batch: 2708 nodes / 10556 und. edges (x2 directed)
    "full_graph_sm": dict(nodes=3072, edges=21504, d_feat=1433, classes=7,
                          graphs=1, task="cls",
                          logical="n_nodes=2,708 n_edges=10,556"),
    # reddit neighbor-sampled: 1024 seeds, fanout 15-10
    "minibatch_lg": dict(nodes=169984, edges=168960, d_feat=602, classes=41,
                         graphs=1, task="cls",
                         logical="n_nodes=232,965 n_edges=114,615,892 "
                                 "batch_nodes=1,024 fanout=15-10"),
    # ogbn-products full batch
    "ogb_products": dict(nodes=2449408, edges=61865984, d_feat=100,
                         classes=47, graphs=1, task="cls",
                         logical="n_nodes=2,449,029 n_edges=61,859,140"),
    # 128 molecules x 30 atoms / 64 edges
    "molecule": dict(nodes=4096, edges=8192, d_feat=1, classes=0,
                     graphs=128, task="reg",
                     logical="n_nodes=30 n_edges=64 batch=128"),
}

# MIND: training on in-batch negatives, online and bulk serving, and one
# user against ~10^6 candidates (padded to a multiple of 1,024)
RECSYS_SHAPES = {
    "train_batch": dict(batch=65536, kind="train"),
    "serve_p99": dict(batch=512, kind="serve"),
    "serve_bulk": dict(batch=262144, kind="serve"),
    "retrieval_cand": dict(batch=1, candidates=1000448, kind="retrieval",
                           logical="n_candidates=1,000,000"),
}

"""The port's copy of the cell shapes it uses
(``repro.configs._families``): the LM cells and the full-batch GNN
classification cells.  ``minibatch_lg`` waits for the neighbour sampler
and ``molecule`` for the equivariant models; the registry and
``ArchDef`` wait for their slice."""

__all__ = ["GNN_SHAPES", "LM_SHAPES"]

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
    # ogbn-products full batch
    "ogb_products": dict(nodes=2449408, edges=61865984, d_feat=100,
                         classes=47, graphs=1, task="cls",
                         logical="n_nodes=2,449,029 n_edges=61,859,140"),
}

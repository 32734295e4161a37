"""The port's copy of the GNN cell shapes it uses
(``repro.configs._families.GNN_SHAPES``): the full-batch classification
cells.  ``minibatch_lg`` waits for the neighbour sampler and
``molecule`` for the equivariant models."""

__all__ = ["GNN_SHAPES"]

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

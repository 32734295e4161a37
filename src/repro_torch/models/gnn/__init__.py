"""Graph neural networks of the port (``repro.models.gnn``): the
GraphBatch substrate and GraphSAGE."""
from .convert import sage_params_from_numpy
from .message_passing import (GraphBatch, gather_src, graph_regression_loss,
                              node_classification_loss, scatter_dst,
                              scatter_mean)
from .models import SageConfig, sage_forward, sage_init, sage_loss

__all__ = ["GraphBatch", "SageConfig", "gather_src", "graph_regression_loss",
           "node_classification_loss", "sage_forward", "sage_init",
           "sage_loss", "sage_params_from_numpy", "scatter_dst",
           "scatter_mean"]

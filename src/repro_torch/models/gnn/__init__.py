"""Graph neural networks of the port (``repro.models.gnn``): the
GraphBatch substrate, GraphSAGE, EGNN, NequIP and MACE (with the irreps
machinery), and the converters of JAX weights."""
from . import irreps
from .convert import (egnn_params_from_numpy, mace_params_from_numpy,
                      nequip_params_from_numpy, sage_params_from_numpy)
from .message_passing import (GraphBatch, gather_src, graph_regression_loss,
                              node_classification_loss, scatter_dst,
                              scatter_edges, scatter_edges_mean,
                              scatter_mean)
from .models import (EgnnConfig, MaceConfig, NequipConfig, SageConfig,
                     egnn_forward, egnn_init, egnn_loss, mace_forward,
                     mace_init, mace_loss, nequip_forward, nequip_init,
                     nequip_loss, sage_forward, sage_init, sage_loss)

__all__ = ["EgnnConfig", "GraphBatch", "MaceConfig", "NequipConfig",
           "SageConfig", "egnn_forward", "egnn_init", "egnn_loss",
           "egnn_params_from_numpy", "gather_src", "graph_regression_loss",
           "irreps", "mace_forward", "mace_init", "mace_loss",
           "mace_params_from_numpy", "nequip_forward", "nequip_init",
           "nequip_loss", "nequip_params_from_numpy",
           "node_classification_loss", "sage_forward", "sage_init",
           "sage_loss", "sage_params_from_numpy", "scatter_dst",
           "scatter_edges", "scatter_edges_mean", "scatter_mean"]

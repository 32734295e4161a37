"""nequip [gnn] — 5 layers, d_hidden=32, l_max=2, n_rbf=8, cutoff=5,
E(3) tensor-product messages.  [arXiv:2101.03164]
Non-geometric cells (cora/reddit/products) get synthetic coordinates:
the arch runs on every assigned shape."""
import dataclasses

from ..models.gnn.models import NequipConfig

__all__ = ["cfg_for_shape", "make_config", "make_smoke_config"]


def make_config():
    return NequipConfig(n_layers=5, d_hidden=32, l_max=2, n_rbf=8,
                        cutoff=5.0)


def make_smoke_config():
    return NequipConfig(n_layers=2, d_hidden=8)


def cfg_for_shape(cfg, shape):
    return dataclasses.replace(cfg, n_classes=shape["classes"])

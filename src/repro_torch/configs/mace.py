"""mace [gnn] — 2 layers, d_hidden=128, l_max=2, correlation_order=3,
n_rbf=8, E(3)-ACE higher-order messages.  [arXiv:2206.07697]"""
import dataclasses

from ..models.gnn.models import MaceConfig

__all__ = ["cfg_for_shape", "make_config", "make_smoke_config"]


def make_config():
    return MaceConfig(n_layers=2, d_hidden=128, l_max=2, correlation=3,
                      n_rbf=8)


def make_smoke_config():
    return MaceConfig(n_layers=1, d_hidden=8)


def cfg_for_shape(cfg, shape):
    return dataclasses.replace(cfg, n_classes=shape["classes"])

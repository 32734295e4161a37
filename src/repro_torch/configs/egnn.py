"""egnn [gnn] — 4 layers, d_hidden=64, E(n) equivariance.
[arXiv:2102.09844]"""
import dataclasses

from ..models.gnn.models import EgnnConfig

__all__ = ["cfg_for_shape", "make_config", "make_smoke_config"]


def make_config():
    return EgnnConfig(n_layers=4, d_hidden=64)


def make_smoke_config():
    return EgnnConfig(n_layers=2, d_hidden=16)


def cfg_for_shape(cfg, shape):
    return dataclasses.replace(cfg, d_in=shape["d_feat"],
                               n_classes=shape["classes"])

"""graphsage-reddit [gnn] — 2 layers, d_hidden=128, mean aggregator,
sample sizes 25-10.  [arXiv:1706.02216]"""
import dataclasses

from ..models.gnn.models import SageConfig

__all__ = ["cfg_for_shape", "make_config", "make_smoke_config"]


def make_config():
    return SageConfig(n_layers=2, d_hidden=128, aggregator="mean")


def make_smoke_config():
    return SageConfig(n_layers=2, d_hidden=16, d_in=8, n_classes=3)


def cfg_for_shape(cfg, shape):
    return dataclasses.replace(cfg, d_in=shape["d_feat"],
                               n_classes=max(shape["classes"], 1))

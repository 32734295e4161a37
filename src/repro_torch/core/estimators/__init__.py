"""Estimator plugins of the adaptive engine and their registry
(``repro.core.estimators``).  This slice holds betweenness; closeness
and harmonic come with the forward stream."""
from __future__ import annotations

from .base import DrawBatch, Estimator, MetricReport, RunContext
from .kadabra import BetweennessEstimator

__all__ = ["BetweennessEstimator", "DrawBatch", "Estimator", "MetricReport",
           "RunContext", "available_metrics", "get_estimator"]

_REGISTRY = {"betweenness": BetweennessEstimator}
# historical name of the betweenness algorithm
_ALIASES = {"kadabra": "betweenness"}


def available_metrics():
    return sorted(_REGISTRY)


def get_estimator(name: str) -> Estimator:
    """A fresh plugin instance for a metric name or alias."""
    try:
        cls = _REGISTRY[_ALIASES.get(name, name)]
    except KeyError:
        raise KeyError(f"no estimator {name!r} registered "
                       f"(have: {available_metrics()})") from None
    return cls()

"""Data pipeline of the port (``repro.data``)."""
from .pipeline import graph_to_batch

__all__ = ["graph_to_batch"]

"""Starting the port's processes (``repro.launch``)."""
from .mesh import spawn_local

__all__ = ["spawn_local"]

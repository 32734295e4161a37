"""Models of the port (``repro.models``): GraphSAGE so far."""

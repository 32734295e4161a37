"""Models of the port (``repro.models``): GraphSAGE and the dense LM's
serving path so far."""

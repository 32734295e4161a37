"""Models of the port (``repro.models``): the four GNNs and the dense
LM's serving path so far."""

"""Models of the port (``repro.models``): the GNNs, the LM's serving
path (dense and MoE) and MIND so far."""

"""Configurations of the port (``repro.configs``): betweenness,
graphsage-reddit and llama3.2-3b so far.  The registry and ``ArchDef`` wait for their
slice."""

"""Configurations of the port (``repro.configs``): betweenness,
graphsage-reddit, egnn, nequip, mace and llama3.2-3b so far.  The
registry and ``ArchDef`` wait for their slice."""

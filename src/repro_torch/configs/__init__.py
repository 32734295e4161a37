"""Model configurations of the port (``repro.configs``): graphsage-reddit
so far.  The registry and ``ArchDef`` wait for the LM slice."""

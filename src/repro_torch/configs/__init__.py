"""Configurations of the port (``repro.configs``): betweenness,
graphsage-reddit, egnn, nequip, mace, mind, llama3.2-3b, qwen2-7b,
gemma3-27b, granite-moe-3b-a800m and moonshot-v1-16b-a3b.
The registry and ``ArchDef`` wait for their slice."""

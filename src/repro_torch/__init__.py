"""PyTorch/CUDA port of the KADABRA betweenness system.

A second package beside ``repro`` (the JAX reference).  It imports torch
and numpy only.  Entry points take ``device=`` (default ``"cuda"``) and
raise without a card unless the caller asks for ``device="cpu"``.
"""

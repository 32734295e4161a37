"""Plain PyTorch versions of the frontier-expansion kernels.

Contract (one BFS level, edge-centric, batched over B samples,
vertex-major state), the same as ``repro.kernels.frontier.ref``:

    contrib[v, b] = sum_{e: dst[e] == v}
                        sigma[src[e], b] * [dist[src[e], b] == levels[b]]

  src, dst : (E,) int32 COO edges; padded slots point at the sink row
  dist     : (rows, B) int32, the sink row and padding rows hold -3
  sigma    : (rows, B) float32
  levels   : (B,) int32
  contrib  : (rows, B) float32

The node-blocked version runs the same sum over a ``CSCLayout``'s edge
order and keeps the row count it was handed.  While sigma holds exact
integers below 2^24 every summation order gives the same bits, so these
versions and the kernels agree bit for bit on BFS-derived state.
"""
from __future__ import annotations

import torch

__all__ = ["frontier_expand_batched_ref", "frontier_expand_node_blocked_ref"]


# (edge, sample) cells gathered at once; bounds the temporaries at full
# graph size to a few hundred MB
_CHUNK_CELLS = 1 << 26


def _expand(src, dst, dist, sigma, levels, rows: int):
    out = torch.zeros((rows, dist.shape[1]), dtype=torch.float32,
                      device=dist.device)
    chunk = max(1, _CHUNK_CELLS // max(dist.shape[1], 1))
    for lo in range(0, src.shape[0], chunk):
        s = src[lo: lo + chunk].long()
        vals = torch.where(dist[s] == levels[None, :], sigma[s], 0.0)
        out.index_add_(0, dst[lo: lo + chunk].long(), vals)
    return out


def frontier_expand_batched_ref(src, dst, dist, sigma, levels):
    return _expand(src, dst, dist, sigma, levels, dist.shape[0])


def frontier_expand_node_blocked_ref(csc, dist, sigma, levels):
    """Expand over the CSC edge order; (V+1, B) or (csc.v_pad, B) in, the
    same row count out."""
    rows = dist.shape[0]
    out = _expand(csc.src, csc.dst, dist, sigma, levels,
                  max(csc.v_pad, rows))
    return out if rows >= csc.v_pad else out[:rows]

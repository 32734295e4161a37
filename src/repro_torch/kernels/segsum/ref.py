"""Plain PyTorch version of the fused gather + segment sum
(``repro.kernels.segsum.ref``).

Contract (GNN message aggregation, embedding bags):

    out[s, :] = sum_{i : seg[i] == s} w[i] * table[ids[i], :]

ids, seg (N,) int32 or int64 with ids in [0, V1) and seg in [0, S);
w (N,) float32; table (V1, D) float32 or bfloat16.  The products and
their sum are float32 whatever the table's type, rounded once to
``table.dtype`` at the end.

The entries go through in chunks of ``chunk`` (2^22 by default), so the
gathered rows never take more than chunk x D x 4 bytes: unchunked, a
60M-entry, 128-column call would materialize ~31 GB.  The sum is an
``index_add_``, whose order on the card varies from run to run; the
kernel is held against this version within the summation-order error.
"""
from __future__ import annotations

import torch

__all__ = ["CHUNK", "gather_segment_sum_ref"]

CHUNK = 1 << 22


def gather_segment_sum_ref(ids, seg, w, table, n_segments: int, *,
                           chunk: int = CHUNK):
    out = torch.zeros((n_segments, table.shape[1]), dtype=torch.float32,
                      device=table.device)
    for lo in range(0, ids.shape[0], chunk):
        rows = table.index_select(0, ids[lo:lo + chunk]).float()
        rows = rows * w[lo:lo + chunk, None].float()
        out.index_add_(0, seg[lo:lo + chunk], rows)
    return out.to(table.dtype)

"""Epoch length of the adaptive loop, and the schema stamp of its
checkpointed state (``repro.core.epoch``)."""
from __future__ import annotations

__all__ = ["epoch_length", "frame_schema_id"]


def epoch_length(n_devices: int, *, base: int = 1000,
                 exponent: float = 1.33, minimum: int = 1) -> int:
    """Samples per device per epoch: n0 = base / (P*T)^exponent, the
    paper's rule with one device as one thread; at least ``minimum``."""
    return max(minimum, round(base / (max(n_devices, 1) ** exponent)))


def frame_schema_id(estimators, *, lane: str, generator: str,
                    stream: str) -> str:
    """The checkpoint ``schema`` stamp of the engine's state, e.g.
    ``"epoch-state-torch-v1:single:cuda:bidir:betweenness[path_counts]"``.

    It names the lane (``single``, ``spmd<W>`` for W ranks, each with its
    own generator, or ``sharded<S>``: the lanes draw different streams),
    the random generator's device type (a CPU
    generator's state is 5,056 bytes of MT19937, a CUDA one's 16 bytes
    of Philox seed and offset), the draw stream (``bidir``, ``forward``
    or ``weighted``: a frame of one stream's samples does not continue
    another's) and every estimator with its channels, in channel-row
    order.  It differs from the JAX engine's
    ``epoch-state-v2:`` stamp, whose random state is a JAX key: restoring
    a state of another layout raises ``CheckpointSchemaError`` before any
    shape check."""
    parts = [f"{e.name}[{','.join(e.channels)}]" for e in estimators]
    return (f"epoch-state-torch-v1:{lane}:{generator}:{stream}:"
            + "+".join(parts))

"""The paper's own workload (``repro.configs.betweenness``): adaptive
betweenness sampling on R-MAT 2^20 x 30 at eps 0.01, delta 0.1, B = 64.
The registry and ``ArchDef`` wait for their slice."""
import dataclasses

from ..core.engine import AdaptiveConfig

__all__ = ["BetweennessConfig", "make_config", "make_smoke_config"]


@dataclasses.dataclass(frozen=True)
class BetweennessConfig:
    rmat_scale: int = 20
    edge_factor: int = 30
    eps: float = 0.01
    delta: float = 0.1
    # adaptive.sample_batch_size is B, the concurrent samples of one
    # batched frontier expansion
    adaptive: AdaptiveConfig = dataclasses.field(
        default_factory=lambda: AdaptiveConfig(eps=0.01, delta=0.1,
                                               sample_batch_size=64))


def make_config() -> BetweennessConfig:
    return BetweennessConfig()


def make_smoke_config() -> BetweennessConfig:
    return BetweennessConfig(rmat_scale=8, edge_factor=4, eps=0.1,
                             adaptive=AdaptiveConfig(eps=0.1, delta=0.1,
                                                     n0_base=64,
                                                     sample_batch_size=8))

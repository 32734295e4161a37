"""mind [recsys] — embed_dim=64, n_interests=4, capsule_iters=3,
history 50, a float32 item table of 2^21 rows (512 MiB).
[arXiv:1904.08030]

The reference config's values: the paper's industrial deployment held
10^8+ items; the reference cut the table to 2^21 rows."""
from ..models.recsys.mind import MindConfig

__all__ = ["make_config", "make_smoke_config"]


def make_config():
    return MindConfig(n_items=2_097_152, embed_dim=64, n_interests=4,
                      capsule_iters=3, hist_len=50)


def make_smoke_config():
    return MindConfig(n_items=1024, embed_dim=16, n_interests=4,
                      capsule_iters=3, hist_len=10)

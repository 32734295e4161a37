"""Train and eval step factories of the port (``repro.train``)."""
from .step import make_eval_step, make_train_step

__all__ = ["make_eval_step", "make_train_step"]

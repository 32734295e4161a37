"""Recommender models of the port (``repro.models.recsys``): MIND."""
from .convert import mind_params_from_numpy
from .mind import (MindConfig, init_params, interest_capsules,
                   label_aware_user_vector, retrieval_scores,
                   serve_interests, train_loss)

__all__ = ["MindConfig", "init_params", "interest_capsules",
           "label_aware_user_vector", "mind_params_from_numpy",
           "retrieval_scores", "serve_interests", "train_loss"]

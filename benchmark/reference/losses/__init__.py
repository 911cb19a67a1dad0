"""Losses and evaluation metrics (twin of ``rdmnet_tpu/losses``)."""

from benchmark.reference.losses.circle_loss import weighted_circle_loss
from benchmark.reference.losses.evaluator import Evaluator, isotropic_transform_error
from benchmark.reference.losses.losses import (
    CoarseMatchingLoss,
    GapLoss,
    OverallLoss,
    OverlapLoss,
    SingleSideChamferLoss,
    VoteLoss,
)

__all__ = ["weighted_circle_loss", "Evaluator", "isotropic_transform_error",
           "CoarseMatchingLoss", "GapLoss", "OverallLoss", "OverlapLoss",
           "SingleSideChamferLoss", "VoteLoss"]

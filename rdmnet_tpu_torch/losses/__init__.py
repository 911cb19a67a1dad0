"""Losses and evaluation metrics (twin of ``rdmnet_tpu/losses``)."""

from rdmnet_tpu_torch.losses.circle_loss import weighted_circle_loss
from rdmnet_tpu_torch.losses.evaluator import Evaluator, isotropic_transform_error
from rdmnet_tpu_torch.losses.losses import (
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

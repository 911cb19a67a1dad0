"""Models (twin of ``rdmnet_tpu/models``)."""

from rdmnet_tpu_torch.models.rdmnet import RDMNet, pipeline

__all__ = ["RDMNet", "pipeline"]

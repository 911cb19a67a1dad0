"""Models (twin of ``rdmnet_tpu/models``)."""

from rdmnet_tpu_torch.models.rdmnet import RDMNet, pipeline, with_pyramid

__all__ = ["RDMNet", "pipeline", "with_pyramid"]

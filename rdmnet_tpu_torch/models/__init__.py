"""Models (twin of ``rdmnet_tpu/models``)."""

from rdmnet_tpu_torch.models.rdmnet import RDMNet, capture_pipeline, pipeline, with_pyramid


def create_model(cfg, device=None) -> RDMNet:
    """The flagship model for ``cfg`` (the reference's ``create_model``), on
    CUDA unless ``device`` names another device."""
    return RDMNet(cfg, device=device)


__all__ = ["RDMNet", "capture_pipeline", "create_model", "pipeline", "with_pyramid"]

"""Network modules (twins of ``rdmnet_tpu/nn``)."""

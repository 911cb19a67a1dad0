"""Pyramid / graph construction (twin of ``rdmnet_tpu/graph``)."""

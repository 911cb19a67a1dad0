"""Tensor ops of the port (twins of ``rdmnet_tpu/ops``) and its CUDA kernels."""

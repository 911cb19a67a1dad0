"""Command-line entry points of the port (twins of ``rdmnet_tpu/cli``):
export, serve and infer so far."""

"""Command-line entry points of the port (twins of ``rdmnet_tpu/cli``):
trainval, test, eval, export, serve and infer."""

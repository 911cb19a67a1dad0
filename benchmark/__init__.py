"""The benchmark of ``rdmnet_tpu_torch`` on NVIDIA cards: ``python3 benchmark/run.py``."""

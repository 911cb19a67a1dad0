"""rdmnet_tpu_torch — the PyTorch/CUDA port of rdmnet_tpu (single-pair
inference, the train and eval steps, and serving: export, the HTTP server,
the infer CLI and device RANSAC).

Mirrors ``rdmnet_tpu``'s module layout (``config``, ``ops``, ``graph``,
``nn``, ``models``, ``losses``, ``engine``, ``utils``, ``data``, ``cli``,
``serving``). Imports torch and numpy only.
Entry points run on CUDA unless the caller passes ``device="cpu"``; the two
hand-written CUDA kernels live in ``csrc/`` and are built with ``nvcc`` at
first use (``ops/kernels``).
"""

__version__ = "0.1.0"

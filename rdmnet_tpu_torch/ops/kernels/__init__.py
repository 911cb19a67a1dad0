"""Hand-written CUDA kernels of the port, each beside its plain PyTorch version.

``radius_knn`` (csrc/radius_knn.cu) and ``sinkhorn`` (csrc/sinkhorn.cu).
Every CUDA wrapper counts its launches in ``<wrapper>.launches`` and, per
path of its kernel, in ``<wrapper>.path_launches``.
"""

from rdmnet_tpu_torch.ops.kernels.radius_knn import radius_knn_cuda
from rdmnet_tpu_torch.ops.kernels.sinkhorn import sinkhorn_cuda

WRAPPERS = {"radius_knn": radius_knn_cuda, "sinkhorn": sinkhorn_cuda}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
        fn.path_launches = dict.fromkeys(fn.path_launches, 0)


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def path_launch_counts() -> dict:
    """Launches per path: {"radius_knn": {"list": n, "select": n},
    "sinkhorn": {"register": n, "cluster": n, "group": n}}."""
    return {name: dict(fn.path_launches) for name, fn in WRAPPERS.items()}

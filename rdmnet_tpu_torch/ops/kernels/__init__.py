"""Hand-written CUDA kernels of the port, each beside its plain PyTorch version.

The TPU kernels' counterparts (``WRAPPERS``): ``radius_knn``
(csrc/radius_knn.cu) and ``sinkhorn`` (csrc/sinkhorn.cu). The kernels of the
port with no Pallas counterpart (``PORT_WRAPPERS``), which take the host round
trips out of the main path so that it can be captured in a CUDA graph:
``segment_sums`` (csrc/segment_sum.cu, the grid subsample's voxel sums),
``nms_peel`` (csrc/nms.cu, the NMS rounds) and ``eigh4`` (csrc/eigh4.cu,
Horn's top eigenvector); and ``gather_grad`` (csrc/gather_grad.cu), the
backward of the sentinel gathers under autograd, which runs only in
training. Every CUDA wrapper counts its launches in
``<wrapper>.launches`` and, per path of its kernel, in
``<wrapper>.path_launches``. A wrapper counts where it launches; a launch
captured in a CUDA graph counts once, at the capture, and not at a replay.
"""

from rdmnet_tpu_torch.ops.kernels.eigh4 import eigh4_cuda
from rdmnet_tpu_torch.ops.kernels.gather_grad import gather_grad_cuda
from rdmnet_tpu_torch.ops.kernels.nms import nms_peel_cuda
from rdmnet_tpu_torch.ops.kernels.radius_knn import radius_knn_cuda
from rdmnet_tpu_torch.ops.kernels.segment_sum import segment_sums_cuda
from rdmnet_tpu_torch.ops.kernels.sinkhorn import sinkhorn_cuda

WRAPPERS = {"radius_knn": radius_knn_cuda, "sinkhorn": sinkhorn_cuda}
PORT_WRAPPERS = {"segment_sums": segment_sums_cuda, "nms_peel": nms_peel_cuda,
                 "eigh4": eigh4_cuda, "gather_grad": gather_grad_cuda}


def reset_launch_counts() -> None:
    for fn in (*WRAPPERS.values(), *PORT_WRAPPERS.values()):
        fn.launches = 0
        fn.path_launches = dict.fromkeys(fn.path_launches, 0)


def launch_counts() -> dict:
    """Launches of the TPU kernels' counterparts: {"radius_knn": n, "sinkhorn": n}."""
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def all_launch_counts() -> dict:
    """Launches of every kernel: ``launch_counts()`` and the port's own
    {"segment_sums": n, "nms_peel": n, "eigh4": n, "gather_grad": n}."""
    return {name: fn.launches for name, fn in {**WRAPPERS, **PORT_WRAPPERS}.items()}


def path_launch_counts() -> dict:
    """Launches per path of the TPU kernels' counterparts: {"radius_knn":
    {"list": n, "select": n, "block": n}, "sinkhorn": {"register": n,
    "cluster": n, "group": n}}."""
    return {name: dict(fn.path_launches) for name, fn in WRAPPERS.items()}

"""Greedy NMS by parallel peeling: CUDA kernel wrapper and its plain PyTorch
version.

Kernel: ``csrc/nms.cu``. It replaces no TPU kernel: the JAX package peels in
a ``lax.while_loop`` on the device (``rdmnet_tpu/ops/nms.py:88-101``), which
XLA lowers without Pallas. Both versions take the strict-lower adjacency
``adj_earlier`` (B, M, M) bool (row i, column j < i: nodes i and j suppress
each other) and the valid nodes (B, M), and return the lexicographically
first maximal independent set, keep (B, M) bool, and the rounds it took as a
0-d int32 tensor (the clouds' maximum). Each round confirms every active node
with no earlier active neighbour and deactivates the confirmed nodes and the
later actives that see a confirmed one. The set is unique, so the two
versions' keep masks and rounds are equal.

The plain version loops on ``active.any()``, one host round trip a round;
the kernel runs every round in one launch (a CTA per cloud), so the forward
has no host round trip there. It packs the adjacency's strict-lower part
into 32-bit words itself, into shared memory while the words fit there
(``smem_bytes(M) <= SMEM_MAX``: M <= 1348), else into a scratch buffer in
device memory.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from rdmnet_tpu_torch.ops.kernels._build import check, launch, load_library

SMEM_MAX = 232_448  # shared memory a CTA may take (227 KB)


def smem_bytes(m: int) -> int:
    """Shared memory of a CTA that holds its cloud's packed rows (as
    ``nms_peel_launch`` sizes it): M rows at an odd stride of W | 1 words
    and the three sets of W words, W = ceil(M / 32)."""
    w = -(-m // 32)
    return 4 * (3 * w + m * (w | 1))


def nms_peel_plain(adj_earlier: torch.Tensor,
                   nodes_mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: the peeling as a Python loop (module docstring)."""
    adj = adj_earlier.float()
    keep = torch.zeros_like(nodes_mask)
    active = nodes_mask.clone()
    rounds = 0
    while bool(active.any()):
        has_earlier_active = (adj @ active.float()[..., None])[..., 0] > 0.0
        confirm = active & ~has_earlier_active
        killed = (adj @ confirm.float()[..., None])[..., 0] > 0.0
        keep = keep | confirm
        active = active & ~confirm & ~killed
        rounds += 1
    return keep, torch.full((), rounds, dtype=torch.int32, device=nodes_mask.device)


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = load_library("nms").nms_peel_launch
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 4
    fn.restype = ctypes.c_int
    return fn


def nms_peel_cuda(adj_earlier: torch.Tensor,
                  nodes_mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel on the current stream of the tensors' card (one
    launch per call), the rows in shared memory or, past ``SMEM_MAX``, in
    device memory. ``launches`` counts every launch, ``path_launches`` by
    where the rows were held."""
    for name, t in (("adj_earlier", adj_earlier), ("nodes_mask", nodes_mask)):
        if not t.is_cuda or t.dtype != torch.bool:
            raise ValueError(f"nms_peel_cuda: {name} must be a CUDA bool tensor")
    if nodes_mask.device != adj_earlier.device:
        raise ValueError("nms_peel_cuda: adj_earlier and nodes_mask must lie on one card")
    b, m = nodes_mask.shape
    if adj_earlier.shape != (b, m, m):
        raise ValueError("nms_peel_cuda: expected adj_earlier (B, M, M), nodes_mask (B, M)")
    dev = nodes_mask.device
    adj, mask = adj_earlier.contiguous(), nodes_mask.contiguous()
    keep = torch.empty((b, m), dtype=torch.bool, device=dev)
    rounds = torch.empty((b,), dtype=torch.int32, device=dev)
    path = "shared" if smem_bytes(m) <= SMEM_MAX else "device"
    scratch = (None if path == "shared"
               else torch.empty((b, m, -(-m // 32)), dtype=torch.int32, device=dev))
    err = launch(_launcher(), dev, adj.data_ptr(), mask.data_ptr(), b, m,
                 None if scratch is None else scratch.data_ptr(), keep.data_ptr(),
                 rounds.data_ptr())
    check(err, "nms_peel")
    nms_peel_cuda.launches += 1
    nms_peel_cuda.path_launches[path] += 1
    total = rounds.amax() if b else torch.zeros((), dtype=torch.int32, device=dev)
    return keep, total


nms_peel_cuda.launches = 0
nms_peel_cuda.path_launches = {"shared": 0, "device": 0}  # where the packed rows are held


def nms_peel(adj_earlier: torch.Tensor,
             nodes_mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Route by device: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors. No fallback: a failing launch raises."""
    if nodes_mask.is_cuda:
        return nms_peel_cuda(adj_earlier, nodes_mask)
    if nodes_mask.device.type != "cpu":
        raise ValueError(f"nms_peel: unsupported device {nodes_mask.device}")
    return nms_peel_plain(adj_earlier, nodes_mask)

"""Sorted segment sums of the grid subsample: CUDA kernel wrapper and its
plain PyTorch version.

Kernel: ``csrc/segment_sum.cu``. It replaces no TPU kernel: the JAX package
sums each voxel's points with ``jax.ops.segment_sum``
(``rdmnet_tpu/ops/grid_subsample.py:141``), which XLA evaluates sequentially
in sorted order in float32. Both versions sum, for cloud b and segment s, the
sorted rows ``start[b, s] .. start[b, s] + length[b, s] - 1`` left to right
from +0 in float32, so their sums are bit-equal to each other and to XLA's.

The plain version adds every segment's j-th row in step j, a loop as long as
the longest segment, whose trip count it reads from the device; the kernel
(a thread per segment) needs no such read, so the graph build it serves has
no host round trip.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from rdmnet_tpu_torch.ops.kernels._build import check, launch, load_library


def segment_sums_plain(points: torch.Tensor, start: torch.Tensor,
                       length: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: points (B, N, 3) float32 sorted by segment,
    start and length (B, cap) int -> (B, cap, 3) sums. Step j adds each
    segment's j-th row in one elementwise float32 add (+0 past its length)."""
    b, n, _ = points.shape
    cap = start.shape[1]
    start = start.long()
    sums = torch.zeros((b, cap, 3), dtype=points.dtype, device=points.device)
    steps = int(length.max()) if b * cap > 0 else 0
    for j in range(steps):
        take = torch.clamp(start + j, max=n - 1)
        row = torch.gather(points, 1, take[..., None].expand(b, cap, 3))
        row = torch.where((j < length)[..., None], row, torch.zeros_like(row))
        sums = sums + row
    return sums


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = load_library("segment_sum").segment_sum_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    return fn


def segment_sums_cuda(points: torch.Tensor, start: torch.Tensor,
                      length: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream of the tensors' card (one
    launch per call). points (B, N, 3) float32, start and length (B, cap)
    int32, all contiguous on one card. ``launches`` counts every launch."""
    for name, t, dt in (("points", points, torch.float32), ("start", start, torch.int32),
                        ("length", length, torch.int32)):
        if not t.is_cuda or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"segment_sums_cuda: {name} must be a contiguous CUDA {dt} tensor")
    if start.device != points.device or length.device != points.device:
        raise ValueError("segment_sums_cuda: points, start and length must lie on one card")
    b, n, c = points.shape
    if c != 3 or start.dim() != 2 or start.shape[0] != b or length.shape != start.shape:
        raise ValueError("segment_sums_cuda: expected points (B, N, 3), start and length "
                         "(B, cap)")
    cap = start.shape[1]
    out = torch.empty((b, cap, 3), dtype=torch.float32, device=points.device)
    err = launch(_launcher(), points.device, points.data_ptr(), start.data_ptr(),
                 length.data_ptr(), b, n, cap, out.data_ptr())
    check(err, "segment_sums")
    segment_sums_cuda.launches += 1
    segment_sums_cuda.path_launches["thread"] += 1
    return out


segment_sums_cuda.launches = 0
segment_sums_cuda.path_launches = {"thread": 0}  # one path: a thread per segment


def segment_sums(points: torch.Tensor, start: torch.Tensor, length: torch.Tensor) -> torch.Tensor:
    """Route by device: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors. No fallback: a failing launch raises."""
    if points.is_cuda:
        return segment_sums_cuda(points.float().contiguous(), start.to(torch.int32).contiguous(),
                                 length.to(torch.int32).contiguous())
    if points.device.type != "cpu":
        raise ValueError(f"segment_sums: unsupported device {points.device}")
    return segment_sums_plain(points, start, length)

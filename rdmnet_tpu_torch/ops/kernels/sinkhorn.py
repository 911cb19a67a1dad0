"""Fused log-domain Sinkhorn: CUDA kernel wrapper and its plain PyTorch version.

Kernel: ``csrc/sinkhorn.cu`` (replaces ``rdmnet_tpu/ops/pallas/sinkhorn.py``
sinkhorn_pallas). Both versions run ``num_iterations`` of
``u = log_mu - LSE_j(s + v)``, ``v = log_nu - LSE_i(s + u)`` from u = v = 0
and return ``s + u + v``; masked entries carry -1e12.

The kernel has two paths, chosen by ``sinkhorn_plan``: K1 <=
``REGISTER_K1_MAX`` holds the patch in registers; a larger K1 streams it from
device memory every half-step, with u, v and the column partials in a
scratch buffer the wrapper allocates.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from rdmnet_tpu_torch.ops.kernels._build import check, load_library

REGISTER_K1_MAX = 208  # a patch lives in the registers of 256 threads: K1 <= 16 * 13
STREAM_WARPS = 16  # streaming path: a CTA of 16 warps per patch, one column partial each


class SinkhornPlan(NamedTuple):
    """How ``csrc/sinkhorn.cu`` runs one call."""

    route: str  # "register" or "stream"
    scratch_floats: int  # per patch: u, v and the warps' column partials (max, sum); 0 in registers


def sinkhorn_plan(k1: int) -> SinkhornPlan:
    """Launch plan of one call (pure; the CPU tests call it)."""
    if k1 < 1:
        raise ValueError(f"sinkhorn: K1={k1} must be at least 1")
    if k1 <= REGISTER_K1_MAX:
        return SinkhornPlan("register", 0)
    return SinkhornPlan("stream", k1 * (2 + 2 * STREAM_WARPS))


def _lse(t: torch.Tensor, dim: int) -> torch.Tensor:
    # the shift carries no gradient (as in jax.nn.logsumexp): under autograd
    # each half-step then keeps one (P, K1, K1) tensor, the exp, for backward
    m = t.amax(dim=dim, keepdim=True).detach()
    return (m + torch.log(torch.exp(t - m).sum(dim=dim, keepdim=True))).squeeze(dim)


def sinkhorn_plain(scores: torch.Tensor, log_mu: torch.Tensor, log_nu: torch.Tensor,
                   num_iterations: int) -> torch.Tensor:
    """Plain PyTorch version: (P, K1, K1), (P, K1), (P, K1) -> (P, K1, K1).
    Differentiable: the training route (the JAX package trains through its
    ``lax.scan`` version too; neither has a backward kernel)."""
    u = torch.zeros_like(log_mu)
    v = torch.zeros_like(log_nu)
    for _ in range(num_iterations):
        u = log_mu - _lse(scores + v[..., None, :], dim=-1)
        v = log_nu - _lse(scores + u[..., :, None], dim=-2)
    return scores + u[..., :, None] + v[..., None, :]


@functools.lru_cache(maxsize=None)
def _launcher(stream: bool):
    lib = load_library("sinkhorn")
    fn = lib.sinkhorn_stream_launch if stream else lib.sinkhorn_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p] * (3 if stream else 2)
    fn.restype = ctypes.c_int
    return fn


def sinkhorn_cuda(scores: torch.Tensor, log_mu: torch.Tensor, log_nu: torch.Tensor,
                  num_iterations: int) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream of the tensors' card (one
    launch per call), whichever device is current. ``launches`` counts every
    launch, ``path_launches`` each path's ("register", "stream"). The kernel
    has no backward: with grad mode on, inputs that require grad raise
    instead of returning a result cut off from the graph."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (scores, log_mu, log_nu)):
        raise RuntimeError("sinkhorn_cuda has no backward: call it under torch.no_grad(), "
                           "or take the plain version (use_kernel=False) to train")
    for name, t in (("scores", scores), ("log_mu", log_mu), ("log_nu", log_nu)):
        if not t.is_cuda or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"sinkhorn_cuda: {name} must be a contiguous CUDA float32 tensor")
    if log_mu.device != scores.device or log_nu.device != scores.device:
        raise ValueError("sinkhorn_cuda: scores, log_mu and log_nu must lie on one card")
    p, k1, k2 = scores.shape
    if k1 != k2 or log_mu.shape != (p, k1) or log_nu.shape != (p, k1):
        raise ValueError("sinkhorn_cuda: expected scores (P, K1, K1), log_mu/log_nu (P, K1)")
    plan = sinkhorn_plan(k1)
    out = torch.empty_like(scores)
    streamed = plan.route == "stream"
    args = [scores.data_ptr(), log_mu.data_ptr(), log_nu.data_ptr(), p, k1, num_iterations]
    if streamed:
        # held until the launch is queued; the allocator reuses it in stream order
        scratch = torch.empty((p, plan.scratch_floats), dtype=torch.float32,
                              device=scores.device)
        args.append(scratch.data_ptr())
    with torch.cuda.device(scores.device):  # launch on the tensors' card
        stream = torch.cuda.current_stream(scores.device).cuda_stream
        err = _launcher(streamed)(*args, out.data_ptr(), stream)
    check(err, "sinkhorn")
    sinkhorn_cuda.launches += 1
    sinkhorn_cuda.path_launches[plan.route] += 1
    return out


sinkhorn_cuda.launches = 0
sinkhorn_cuda.path_launches = {"register": 0, "stream": 0}


def sinkhorn(scores: torch.Tensor, log_mu: torch.Tensor, log_nu: torch.Tensor,
             num_iterations: int, use_kernel: bool = True) -> torch.Tensor:
    """``use_kernel``: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors (inference). ``use_kernel=False`` is the training route, the
    plain version under autograd on either device, chosen by the caller. No
    fallback: a failing launch raises."""
    if scores.is_cuda and use_kernel:
        return sinkhorn_cuda(scores.float().contiguous(), log_mu.float().contiguous(),
                             log_nu.float().contiguous(), num_iterations)
    if scores.device.type not in ("cpu", "cuda"):
        raise ValueError(f"sinkhorn: unsupported device {scores.device}")
    return sinkhorn_plain(scores, log_mu, log_nu, num_iterations)

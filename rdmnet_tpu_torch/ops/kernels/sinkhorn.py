"""Fused log-domain Sinkhorn: CUDA kernel wrapper and its plain PyTorch version.

Kernel: ``csrc/sinkhorn.cu`` (replaces ``rdmnet_tpu/ops/pallas/sinkhorn.py``
sinkhorn_pallas). Both versions run ``num_iterations`` of
``u = log_mu - LSE_j(s + v)``, ``v = log_nu - LSE_i(s + u)`` from u = v = 0
and return ``s + u + v``; masked entries carry -1e12.

The kernel has three paths, chosen by ``sinkhorn_plan`` from K1 alone: K1 <=
``REGISTER_K1_MAX`` holds the patch in registers; a larger K1 holds it in the
shared memory of a thread-block cluster of 2, 4 or 8 CTAs, the smallest that
fits (to K1 = 546); past that a group of G CTAs holds it, launched
cooperatively so that a group's CTAs are resident together and exchange
column partials and v through a scratch buffer in device memory: to K1 =
``GROUP_K1_MAX`` the smallest G whose band fits in shared memory, past it G <=
``GROUP_CTAS_MAX`` CTAs each keeping as many rows of its band in shared
memory as fit and reading the rest (``spill_rows``) from device memory in
every half-step. The wrapper allocates every scratch buffer.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from rdmnet_tpu_torch.ops.kernels._build import check, load_library

REGISTER_K1_MAX = 208  # a patch lives in the registers of 256 threads: K1 <= 16 * 13
CLUSTER_SIZES = (2, 4, 8)  # the portable thread-block cluster sizes
CLUSTER_WARPS = 16  # cluster path: 16 warps a CTA, one column partial each
SMEM_MAX = 232_448  # shared memory a CTA may take (227 KB)
GROUP_CTAS_MAX = 132  # group path: a group's CTAs, one an SM of an H100 SXM, resident at once
GROUP_K1_MAX = 2640  # group path's last K1 without spill: 132 CTAs of 20 rows fit to here
BAR_STRIDE = 32  # group path: int32 words between two groups' barrier counters


class SinkhornPlan(NamedTuple):
    """How ``csrc/sinkhorn.cu`` runs one call."""

    route: str  # "register", "cluster" or "group"
    # device scratch on the group path, per resident group: G x K1 column
    # partials (max, sum) and K1 tagged v words, zero at the launch; else 0
    scratch_floats: int
    cluster: int = 0  # CTAs a patch on the cluster path, else 0
    cta_bytes: int = 0  # shared memory a CTA takes
    group: int = 0  # CTAs a patch on the group path (G), else 0
    # group path past GROUP_K1_MAX: the rows of a CTA's band read from device
    # memory in every half-step, the last of its ceil(K1 / G) rows; else 0
    spill_rows: int = 0


def register_cta_bytes(k1: int) -> int:
    """Static shared memory of the register path's CTA at this K1: the
    column partials, the grid's last rows and four vectors (``sinkhorn.cu``'s
    ``sinkhorn_kernel<N>``, N the layout the launcher picks)."""
    n = next(n for n, top in ((2, 32), (5, 80), (9, 144), (13, 208)) if k1 <= top)
    w = 16 * n
    return 4 * (2 * 16 * 16 * (n | 1) + 16 * w + 4 * w)


def cluster_cta_bytes(k1: int, c: int) -> int:
    """Dynamic shared memory of a cluster-path CTA: its band of ceil(K1 / C)
    rows, 16 warps' column partials (max, sum), two parity exchange buffers
    (max, sum), v, and its rows' log_mu and u; float32."""
    band = -(-k1 // c)
    return 4 * (band * k1 + (2 * CLUSTER_WARPS + 5) * k1 + 2 * band)


def group_cta_bytes(k1: int, g: int, spill_rows: int = 0) -> int:
    """Dynamic shared memory of a group-path CTA: the rows of its band of
    ceil(K1 / G) that it keeps (all but ``spill_rows``), of K1p = K1 rounded
    up to 32 columns, v (K1p), and its rows' log_mu and u; float32
    (``sinkhorn.cu``'s ``group_smem_bytes``)."""
    band = -(-k1 // g)
    k1p = -(-k1 // 32) * 32
    return 4 * ((band - spill_rows) * k1p + k1p + 2 * band)


def group_size(k1: int) -> int:
    """The smallest G whose CTA fits in ``SMEM_MAX`` at this K1, or 0 past
    ``GROUP_CTAS_MAX``: the band may hold B = (SMEM_MAX / 4 - K1p) // (K1p +
    2) rows, so G = ceil(K1 / B) (no smaller G fits, and no band is empty)."""
    k1p = -(-k1 // 32) * 32
    rows = (SMEM_MAX // 4 - k1p) // (k1p + 2)
    g = -(-k1 // rows) if rows > 0 else 0
    return g if 0 < g <= GROUP_CTAS_MAX else 0


def group_spill(k1: int):
    """Past ``GROUP_K1_MAX``: (G, spill rows). The band takes B =
    ceil(K1 / ``GROUP_CTAS_MAX``) rows and G = ceil(K1 / B) CTAs (no band
    empty); a CTA keeps as many of its B rows as fit beside v, u and log_mu,
    (SMEM_MAX / 4 - K1p - 2 B) // K1p, and reads the rest from device memory.
    The path's limits: K1 <= 57216, where v, u and log_mu still fit (past it
    this raises), and the G = 126 to 132 CTAs of every K1 > 2640 resident at
    once, which only a card of at least G SMs holds (on a smaller one
    ``sinkhorn_cuda`` raises)."""
    band = -(-k1 // GROUP_CTAS_MAX)
    k1p = -(-k1 // 32) * 32
    kept = (SMEM_MAX // 4 - k1p - 2 * band) // k1p
    if kept < 0:
        raise ValueError(f"sinkhorn: K1={k1} does not fit the group path: v alone passes "
                         f"{SMEM_MAX} bytes of shared memory")
    return -(-k1 // band), band - min(kept, band)


def sinkhorn_plan(k1: int) -> SinkhornPlan:
    """Launch plan of one call (pure; the CPU tests call it): the register
    path to ``REGISTER_K1_MAX``, then the smallest cluster whose CTAs fit in
    ``SMEM_MAX``, then the smallest group (``group_size``), then groups of
    at most ``GROUP_CTAS_MAX`` CTAs whose bands spill (``group_spill``)."""
    if k1 < 1:
        raise ValueError(f"sinkhorn: K1={k1} must be at least 1")
    if k1 <= REGISTER_K1_MAX:
        return SinkhornPlan("register", 0, 0, register_cta_bytes(k1))
    for c in CLUSTER_SIZES:
        if cluster_cta_bytes(k1, c) <= SMEM_MAX:
            return SinkhornPlan("cluster", 0, c, cluster_cta_bytes(k1, c))
    g, spill = (group_size(k1), 0) if k1 <= GROUP_K1_MAX else group_spill(k1)
    return SinkhornPlan("group", 2 * (g + 1) * k1, 0, group_cta_bytes(k1, g, spill), g, spill)


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


NO_CLUSTER = -1  # sinkhorn_cluster_launch: no cluster of the plan fits on the card
NO_GROUP = -2  # sinkhorn_group_launch: the card cannot hold the groups at once


@functools.lru_cache(maxsize=None)
def _launcher(route: str):
    lib = load_library("sinkhorn")
    fn = getattr(lib, {"register": "sinkhorn_launch", "cluster": "sinkhorn_cluster_launch",
                       "group": "sinkhorn_group_launch"}[route])
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 \
        + {"register": [], "cluster": [ctypes.c_int],
           "group": [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2}[route] \
        + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    return fn


def cluster_occupancy(k1: int, device=None) -> int:
    """Clusters of the cluster path at this K1 that the card holds at once
    (``cudaOccupancyMaxActiveClusters``); card only."""
    plan = sinkhorn_plan(k1)
    if plan.route != "cluster":
        raise ValueError(f"sinkhorn: K1={k1} takes the {plan.route} path, not a cluster")
    lib = load_library("sinkhorn")
    fn = lib.sinkhorn_cluster_occupancy
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    n = ctypes.c_int(0)
    with torch.cuda.device(device if device is not None else torch.cuda.current_device()):
        check(fn(k1, plan.cluster, ctypes.byref(n)), "sinkhorn_cluster_occupancy")
    return n.value


@functools.lru_cache(maxsize=None)
def group_resident(k1: int, device_index: int) -> int:
    """CTAs of the group path at this K1 that card ``device_index`` holds at
    once (occupancy x SMs; ``sinkhorn_group_resident``); card only."""
    plan = sinkhorn_plan(k1)
    if plan.route != "group":
        raise ValueError(f"sinkhorn: K1={k1} takes the {plan.route} path, not a group")
    fn = load_library("sinkhorn").sinkhorn_group_resident
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    n = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        check(fn(k1, plan.group, plan.spill_rows, ctypes.byref(n)), "sinkhorn_group_resident")
    return n.value


def sinkhorn_cuda(scores: torch.Tensor, log_mu: torch.Tensor, log_nu: torch.Tensor,
                  num_iterations: int) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream of the tensors' card (one
    launch per call), whichever device is current. ``launches`` counts every
    launch, ``path_launches`` each path's ("register", "cluster", "group").
    A cluster that cannot be scheduled, or a group the card cannot
    hold at once, raises; no path falls back to another.
    The kernel has no backward: with grad mode on, inputs that require grad raise
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
    args = [scores.data_ptr(), log_mu.data_ptr(), log_nu.data_ptr(), p, k1, num_iterations]
    if plan.route == "cluster":
        args.append(plan.cluster)
    elif plan.route == "group":
        # a persistent grid: as many groups as the card holds at once, at most P
        groups = min(p, group_resident(k1, scores.device.index) // plan.group)
        if groups < 1 and p > 0:
            raise RuntimeError(f"sinkhorn: this card cannot hold a group of {plan.group} CTAs "
                               f"with {plan.cta_bytes} bytes of shared memory each at once "
                               f"(K1={k1})")
        # held until the launch is queued (the allocator reuses it in stream
        # order); zero: no tag the kernel waits for
        scratch = torch.zeros((groups, plan.scratch_floats), dtype=torch.float32,
                              device=scores.device)
        counters = torch.zeros((groups, BAR_STRIDE), dtype=torch.int32, device=scores.device)
        args += [plan.group, plan.spill_rows, groups, scratch.data_ptr(), counters.data_ptr()]
    with torch.cuda.device(scores.device):  # launch on the tensors' card
        stream = torch.cuda.current_stream(scores.device).cuda_stream
        err = _launcher(plan.route)(*args, out.data_ptr(), stream)
    if err == NO_CLUSTER:
        raise RuntimeError(f"sinkhorn: no cluster of {plan.cluster} CTAs with "
                           f"{plan.cta_bytes} bytes of shared memory each fits on this card "
                           f"(K1={k1})")
    if err == NO_GROUP:
        raise RuntimeError(f"sinkhorn: this card cannot hold the groups of {plan.group} CTAs "
                           f"at once (K1={k1})")
    check(err, "sinkhorn")
    sinkhorn_cuda.launches += 1
    sinkhorn_cuda.path_launches[plan.route] += 1
    return out


sinkhorn_cuda.launches = 0
sinkhorn_cuda.path_launches = {"register": 0, "cluster": 0, "group": 0}


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

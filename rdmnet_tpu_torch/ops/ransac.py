"""Device-parallel RANSAC registration (twin of ``rdmnet_tpu/ops/ransac.py``).

Hypotheses are drawn, solved (the batched Horn ``weighted_procrustes``) and
scored against every correspondence in parallel, a chunk of hypotheses at a
time so that memory stays at ``chunk x capacity`` residuals whatever the
iteration count. The best count and transform stay on the device between
chunks: the loop never waits for the host.

Semantics, as the JAX version:
* samples are drawn with replacement, as ``floor(u * n_valid)`` over the
  valid prefix;
* ties keep the earliest hypothesis (first maximum in a chunk, strict ``>``
  across chunks);
* the winner is refit once on its inliers when at least 3 exist;
* with fewer than ``num_samples`` valid rows, one weighted Procrustes over
  all valid rows (``fallback_weights``) is the answer.

Plain PyTorch, as the JAX version is plain ``jnp``: no kernel of its own
(Horn's eigenvectors run on ``eigh4`` on the card). Nothing in it reads a
value back, so on the card ``ransac_registration_host`` replays one captured
program per (capacity, iterations, samples, chunk) (``capture_ransac``), as
the JAX version jits one.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional, Tuple, Union

import numpy as np
import torch

from rdmnet_tpu_torch.ops.procrustes import weighted_procrustes


def ransac_registration(
    src_points: torch.Tensor,
    ref_points: torch.Tensor,
    valid_mask: torch.Tensor,
    draws: Union[torch.Generator, torch.Tensor],
    *,
    num_iterations: int,
    num_samples: int = 4,
    threshold: float = 0.3,
    fallback_weights: Optional[torch.Tensor] = None,
    chunk: int = 2048,
) -> torch.Tensor:
    """(4, 4) transform from padded correspondences.

    src_points / ref_points (N, 3) padded endpoints, valid rows first;
    valid_mask (N,) bool. ``draws`` is the source of randomness: a
    ``torch.Generator`` on the points' device, or the uniforms themselves,
    (n_chunks, chunk, num_samples) in [0, 1), with n_chunks =
    ceil(num_iterations / chunk) (hypotheses round up to whole chunks).
    ``threshold``: a float or a 0-d tensor on the points' device (a captured
    program's input); both square in float32, as the JAX version does. No
    op reads a value back to the host.
    """
    dev, dtype = src_points.device, src_points.dtype
    n_cap = src_points.shape[0]
    n_valid = valid_mask.to(torch.int32).sum()
    if isinstance(threshold, torch.Tensor):
        thr2 = threshold.to(dtype) ** 2
    else:  # folded on the host: a float32 square, exact in the comparison's dtype
        thr2 = float(np.float32(threshold) ** 2)
    n_chunks = max(1, -(-num_iterations // chunk))
    shape = (n_chunks, chunk, num_samples)
    if isinstance(draws, torch.Generator):
        u = torch.rand(shape, generator=draws, device=dev, dtype=dtype)
    else:
        u = torch.as_tensor(draws, dtype=dtype, device=dev)
        if tuple(u.shape) != shape:
            raise ValueError(f"uniforms of shape {tuple(u.shape)}, expected {shape}")
    idx = (u * n_valid.to(dtype)).to(torch.int32).clamp(0, max(n_cap - 1, 0)).long()
    valid_f = valid_mask.to(dtype)

    best_inl = torch.full((), -1.0, dtype=dtype, device=dev)
    best_tf = torch.eye(4, dtype=dtype, device=dev)
    src_t = src_points.T
    for c in range(n_chunks):
        tf = weighted_procrustes(src_points[idx[c]], ref_points[idx[c]])  # (chunk, 4, 4)
        moved = tf[:, :3, :3] @ src_t + tf[:, :3, 3:]  # (chunk, 3, N)
        res2 = ((ref_points.T[None] - moved) ** 2).sum(1)  # (chunk, N)
        inl = ((res2 < thr2).to(dtype) * valid_f).sum(-1)  # (chunk,)
        # the first maximum, as a 1-element index: a 0-d index tensor is read back
        top = torch.argmax(inl, 0, keepdim=True)
        top_inl = inl[top][0]
        better = top_inl > best_inl
        best_inl = torch.where(better, top_inl, best_inl)
        best_tf = torch.where(better, tf[top][0], best_tf)

    # final polish: refit on the winning hypothesis's inliers (>= 3)
    moved = src_points @ best_tf[:3, :3].T + best_tf[:3, 3]
    inlier_w = (((ref_points - moved) ** 2).sum(-1) < thr2).to(dtype) * valid_f
    refit = weighted_procrustes(src_points, ref_points, inlier_w)
    best_tf = torch.where(inlier_w.sum() >= 3, refit, best_tf)

    # degenerate input (< num_samples valid rows): one weighted solve
    fw = valid_f if fallback_weights is None else fallback_weights * valid_f
    fallback = weighted_procrustes(src_points, ref_points, fw)
    return torch.where(n_valid >= num_samples, best_tf, fallback)


def ransac_capacity(n: int) -> Tuple[int, int]:
    """(capacity, chunk) of ``n`` correspondences: capacity a multiple of
    512, and as many hypotheses per chunk as keep ``chunk x capacity`` near
    4M residuals (256 to 2048)."""
    cap = max(512, 512 * -(-n // 512))
    return cap, int(min(2048, max(256, (1 << 22) // cap)))


MAX_PROGRAMS = 32  # programs kept on a card, as the JAX version's lru_cache(32)


def capture_ransac(capacity: int, chunk: int, num_iterations: int, num_samples: int,
                   device, pool=None):
    """``ransac_registration`` at one (capacity, chunk, iterations, samples)
    as a program on the card (``program.StepProgram``, warmed up and
    captured here: every call replays), the counterpart of the JAX version's
    ``_compiled``. ``program(src, ref, mask, weights, threshold, seed) ->
    (4, 4)``: src/ref (capacity, 3) float32 rows, valid rows first, mask
    (capacity,) bool, weights (capacity,) float32 (the fallback's); the
    threshold is a float32 input of the program, not a constant of it; the
    program's generator, registered with the graph, is seeded with ``seed``
    before the replay, so each call draws what an eager call on
    ``torch.Generator(device).manual_seed(seed)`` draws. The output is
    overwritten by the next call. Raises on a CPU device, where RANSAC runs
    eagerly."""
    from rdmnet_tpu_torch.device import resolve_device
    from rdmnet_tpu_torch.program import StepProgram

    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(f"capture_ransac: a CUDA graph needs a CUDA device, got {dev}; "
                         "RANSAC runs eagerly there")
    generator = torch.Generator(device=dev)

    def stage(src, ref, mask, weights, threshold, seed):
        generator.manual_seed(int(seed))
        return {"src": src, "ref": ref, "mask": mask, "weights": weights,
                "threshold": np.float32(threshold)}

    @torch.no_grad()
    def body(static):
        return ransac_registration(
            static["src"], static["ref"], static["mask"], generator,
            num_iterations=num_iterations, num_samples=num_samples,
            threshold=static["threshold"], fallback_weights=static["weights"], chunk=chunk)

    shapes = {"src": ((capacity, 3), torch.float32), "ref": ((capacity, 3), torch.float32),
              "mask": ((capacity,), torch.bool), "weights": ((capacity,), torch.float32),
              "threshold": ((), torch.float32)}
    return StepProgram("capture_ransac", body, stage, shapes, dev, generator, pool).prime()


def eager_solver(capacity: int, chunk: int, num_iterations: int, num_samples: int,
                 device) -> Callable:
    """``solve(src, ref, mask, weights, threshold, seed) -> (4, 4)``:
    ``ransac_registration`` called eagerly on ``device``, the draws from a
    new generator seeded with ``seed`` (the CPU's RANSAC, and the oracle of
    the card's programs)."""
    def solve(src, ref, mask, weights, threshold, seed):
        def put(a):
            return torch.from_numpy(np.asarray(a)).to(device)

        with torch.no_grad():
            return ransac_registration(
                put(src), put(ref), put(mask), torch.Generator(device=device).manual_seed(seed),
                num_iterations=num_iterations, num_samples=num_samples, threshold=threshold,
                fallback_weights=put(weights), chunk=chunk)
    return solve


@functools.cache
def _pool(device: torch.device):
    return torch.cuda.graph_pool_handle()


@functools.lru_cache(maxsize=MAX_PROGRAMS)
def _program(capacity: int, chunk: int, num_iterations: int, num_samples: int,
             device: torch.device):
    return capture_ransac(capacity, chunk, num_iterations, num_samples, device, _pool(device))


def solver(capacity: int, chunk: int, num_iterations: int, num_samples: int,
           device: torch.device) -> Callable:
    """What ``ransac_registration_host`` calls: on the card the program of
    this shape (``capture_ransac``; at most ``MAX_PROGRAMS`` kept, the least
    recently used dropped first, all over one graph pool a card, replayed
    one at a time), elsewhere ``eager_solver``."""
    if device.type != "cuda":
        return eager_solver(capacity, chunk, num_iterations, num_samples, device)
    return _program(capacity, chunk, num_iterations, num_samples, device)


def ransac_registration_host(
    src_points: np.ndarray,
    ref_points: np.ndarray,
    weights: Optional[np.ndarray] = None,
    *,
    num_iterations: int = 50000,
    num_samples: int = 4,
    threshold: float = 0.3,
    seed: int = 0,
    device=None,
) -> np.ndarray:
    """numpy in, numpy (4, 4) float64 out, on ``device`` (CUDA unless told
    otherwise). Pads the correspondences to ``ransac_capacity``; the draws
    come from a generator on the device seeded with ``seed``. On the card
    the call replays the program of its shape (``solver``)."""
    from rdmnet_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    n = len(src_points)
    cap, chunk = ransac_capacity(n)
    pad = cap - n
    s = np.pad(np.asarray(src_points, np.float32), ((0, pad), (0, 0)))
    r = np.pad(np.asarray(ref_points, np.float32), ((0, pad), (0, 0)))
    m = np.zeros(cap, bool)
    m[:n] = True
    w = np.ones(cap, np.float32)
    if weights is not None:
        w[:n] = np.asarray(weights, np.float32)
    w[n:] = 0.0
    tf = solver(cap, chunk, num_iterations, num_samples, dev)(s, r, m, w, threshold, seed)
    return tf.cpu().numpy().astype(np.float64)

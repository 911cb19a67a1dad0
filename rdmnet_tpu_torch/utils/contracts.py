"""Fast kernel and precision contracts (twin of ``rdmnet_tpu/utils/contracts.py``).

Small shapes, each aimed at a fault the CPU tests cannot see: the CPU runs
the kernels' plain versions, so only a run on the card holds the CUDA
kernels (``csrc/``) and the card's float32 pose path to their contracts.
``chip_smoke.py`` runs them on the card.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from rdmnet_tpu_torch.data.procedural import procedural_pair
from rdmnet_tpu_torch.device import resolve_device
from rdmnet_tpu_torch.nn.sinkhorn import log_sinkhorn
from rdmnet_tpu_torch.ops.geometry import apply_transform
from rdmnet_tpu_torch.ops.kernels.sinkhorn import sinkhorn
from rdmnet_tpu_torch.ops.procrustes import weighted_procrustes
from rdmnet_tpu_torch.ops.radius_search import radius_knn
from rdmnet_tpu_torch.utils.se3_np import euler_zyx_matrix

# contract 1: one query tile against one support block of the scan
KNN_QUERIES, KNN_SUPPORT, KNN_COUNT, KNN_RADIUS, KNN_K = 256, 2048, 2000, 4.8, 8
KNN_TOL = 1e-3          # m^2: the expanded-form float32 rounding scale
SINKHORN_SHAPE, SINKHORN_ITERS, SINKHORN_TOL = (8, 17, 17), 20, 1e-3
POSE_POINTS, RRE_MAX_DEG, RTE_MAX_M = 2048, 0.01, 1e-3


def default_scan() -> np.ndarray:
    """The ref cloud of ``procedural_pair(7351, n_rings=80, n_azimuths=3000)``
    (20352 points): a ~20k-point LiDAR-like scan whose first rows lie along
    rings, as a KITTI scan's do."""
    return procedural_pair(7351, n_rings=80, n_azimuths=3000)[0]


def knn_violations(table: np.ndarray, scan: np.ndarray) -> int:
    """Rows of a (KNN_QUERIES, KNN_K) table that break the float64 oracle:
    indices in range, ascending distances and each within the radius (to
    ``KNN_TOL``), as many entries as the oracle allows, and the same sorted
    distances as the oracle's nearest."""
    q = scan[:KNN_QUERIES].astype(np.float64)
    s = scan[:KNN_SUPPORT].astype(np.float64)
    d64 = ((q[:, None, :] - s[None, :, :]) ** 2).sum(-1)
    d64[:, KNN_COUNT:] = np.inf
    r2, tol, k = KNN_RADIUS ** 2, KNN_TOL, KNN_K
    bad = 0
    for r in range(KNN_QUERIES):
        raw = table[r]
        ok = bool(np.all((raw == KNN_SUPPORT) | ((raw >= 0) & (raw < KNN_COUNT))))
        idx = raw[(raw >= 0) & (raw < KNN_COUNT)]
        dr = d64[r, idx]
        ok &= bool(np.all(np.diff(dr) >= -tol))
        ok &= bool(np.all(dr <= r2 + tol))
        sure_in = int((d64[r] <= r2 - tol).sum())
        may_in = int((d64[r] <= r2 + tol).sum())
        ok &= min(k, sure_in) <= len(idx) <= min(k, may_in)
        if len(idx):
            osort = np.sort(d64[r][d64[r] <= r2 + tol])[:len(idx)]
            ok &= bool(np.all(np.abs(np.sort(dr) - osort) <= tol))
        bad += not ok
    return bad


def sinkhorn_inputs() -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(scores, log_mu, log_nu) of contract 2, float32 from seed 0."""
    rng = np.random.RandomState(0)
    p, k1, _ = SINKHORN_SHAPE
    scores = rng.randn(*SINKHORN_SHAPE).astype(np.float32)
    log_mu = (rng.randn(p, k1) * 0.1).astype(np.float32)
    log_nu = (rng.randn(p, k1) * 0.1).astype(np.float32)
    return scores, log_mu, log_nu


def rotation_error_deg(gt: np.ndarray, est: np.ndarray) -> float:
    """Angle of est_R^T gt_R in degrees from the chord, ``|R_est - R_gt|_F =
    2 sqrt(2) sin(theta / 2)``, in float64. The trace formula of
    ``metrics_np.compute_relative_rotation_error`` cannot resolve this
    contract's limit on float32 matrices: near a trace of 3, arccos turns the
    matrices' rounding (~1e-7) into 0.01-0.04 deg."""
    chord = np.linalg.norm(est[:3, :3].astype(np.float64) - gt[:3, :3].astype(np.float64))
    return float(np.degrees(2.0 * np.arcsin(min(1.0, chord / (2.0 * np.sqrt(2.0))))))


def pose_gt() -> np.ndarray:
    """The known SE(3) of contract 3."""
    gt = np.eye(4, dtype=np.float32)
    gt[:3, :3] = euler_zyx_matrix(0.9, -0.4, 0.3).astype(np.float32)
    gt[:3, 3] = [2.0, -1.5, 0.8]
    return gt


def run_fast_contracts(device=None, scan: Optional[np.ndarray] = None) -> Dict[str, str]:
    """Run the contracts on ``device`` (CUDA unless named otherwise); returns
    ``{name: "pass" | "FAIL ..."}``. A kernel that raises is not caught.

    1. ``knn_exact``: the radius-kNN search (``radius_knn_cuda`` on the card,
       the plain version on the CPU) against a float64 oracle, tie-tolerant,
       256 queries of ``scan`` against its first 2048 rows (2000 valid),
       r 4.8, k 8;
    2. ``sinkhorn``: the Sinkhorn route (``sinkhorn_cuda`` on the card)
       against ``log_sinkhorn`` at (8, 17, 17), 20 iterations, within 1e-3;
    3. ``horn_pose_recovery``: ``weighted_procrustes`` on 2048 scan points
       under a known SE(3): RRE < 0.01 deg (``rotation_error_deg``) and
       RTE < 1 mm.

    The JAX package's contract 4 (approximate-search recall) has no
    counterpart: the port has no ``approx_recall`` and always searches
    exactly. ``scan`` is an (N >= 2048, 3) float32 array; the JAX package
    reads a bundled KITTI scan, which is not in the repository, so the
    default is ``default_scan()``.
    """
    dev = resolve_device(device)
    scan = (default_scan() if scan is None else np.asarray(scan))[:, :3].astype(np.float32)
    results: Dict[str, str] = {}

    q = torch.from_numpy(scan[:KNN_QUERIES]).to(dev)
    s = torch.from_numpy(scan[:KNN_SUPPORT]).to(dev)
    count = torch.tensor(KNN_COUNT, dtype=torch.int32, device=dev)
    table = radius_knn(q, s, count, KNN_RADIUS, KNN_K).cpu().numpy()
    bad = knn_violations(table, scan)
    results["knn_exact"] = "pass" if bad == 0 else (
        f"FAIL {bad}/{KNN_QUERIES} rows violate the float64 top-k")

    scores, log_mu, log_nu = (torch.from_numpy(a).to(dev) for a in sinkhorn_inputs())
    with torch.no_grad():
        got = sinkhorn(scores, log_mu, log_nu, SINKHORN_ITERS, use_kernel=True)
        want = log_sinkhorn(scores, log_mu, log_nu, SINKHORN_ITERS)
    err = float((got - want).abs().max())
    results["sinkhorn"] = "pass" if err < SINKHORN_TOL else f"FAIL max|diff|={err:.2e}"

    gt = pose_gt()
    src = torch.from_numpy(scan[:POSE_POINTS]).to(dev)
    ref = apply_transform(src, torch.from_numpy(gt).to(dev))
    est = weighted_procrustes(src, ref).cpu().numpy()
    rre = rotation_error_deg(gt, est)
    rte = float(np.linalg.norm(est[:3, 3].astype(np.float64) - gt[:3, 3]))
    results["horn_pose_recovery"] = ("pass" if rre < RRE_MAX_DEG and rte < RTE_MAX_M
                                     else f"FAIL RRE={rre:.5f}deg RTE={rte * 1e3:.3f}mm")
    return results

"""Published baseline results bundled for figure overlays (own copy of
``rdmnet_tpu/utils/baselines.py``).

The reference compares its recall curves against prior methods whose
per-pair dumps it loads from local disk
(experiments/eval_visualization_for_basline_methods.py:1-392 — not
distributable). What IS distributable are the published summary metrics, so
`rdmnet-eval --figures --baselines <dataset>` overlays these on the recall
curves and renders a method-comparison figure.

Sources:
* RDMNet rows: the bundled reference README table
  (the upstream README.md:99-108) — KITTI-trained model evaluated on all
  four datasets; RR %, RRE deg, RTE cm at the 5 deg / 2 m acceptance
  thresholds (reference eval.py).
* KITTI baseline rows: the standard KITTI odometry registration benchmark
  table as published in GeoTransformer (Qin et al., CVPR 2022, Table 6) and
  reproduced in the RDMNet paper's comparison (Shi et al., T-ITS 2023) —
  all evaluated at the same 5 deg / 2 m criterion on sequences 8-10.

These are POINT metrics (recall at the fixed thresholds), not curves: the
overlay draws each method's published RR as a level line; full curves need
per-pair errors that were never published.
"""

from __future__ import annotations

from typing import Dict

# dataset -> method -> {rr (%), rre_deg, rte_cm}
PUBLISHED_RESULTS: Dict[str, Dict[str, Dict[str, float]]] = {
    "kitti": {
        "RDMNet (paper)": {"rr": 99.82, "rre_deg": 0.18, "rte_cm": 5.3},
        "GeoTransformer": {"rr": 99.8, "rre_deg": 0.24, "rte_cm": 6.8},
        "Predator": {"rr": 99.8, "rre_deg": 0.27, "rte_cm": 6.8},
        "CoFiNet": {"rr": 99.8, "rre_deg": 0.41, "rte_cm": 8.2},
        "D3Feat": {"rr": 99.8, "rre_deg": 0.30, "rte_cm": 7.2},
        "FCGF": {"rr": 96.6, "rre_deg": 0.30, "rte_cm": 9.5},
    },
    # KITTI-trained generalization rows (reference README.md:99-108 only
    # publishes RDMNet for these)
    "kitti360": {
        "RDMNet (paper)": {"rr": 99.89, "rre_deg": 0.25, "rte_cm": 7.0},
    },
    "apollo": {
        "RDMNet (paper)": {"rr": 100.0, "rre_deg": 0.10, "rte_cm": 4.6},
    },
    "mulran": {
        # ~70 deg FOV; the reference's hardest generalization setting
        "RDMNet (paper)": {"rr": 87.09, "rre_deg": 0.45, "rte_cm": 14.4},
    },
}


def published_for(dataset: str) -> Dict[str, Dict[str, float]]:
    """Published rows for a dataset key (empty dict if unknown)."""
    return PUBLISHED_RESULTS.get(dataset, {})

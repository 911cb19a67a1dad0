"""Offline evaluation of the port over dumped .npz features (twin of
``rdmnet_tpu/cli/eval.py``; reference experiments/eval.py:27-308).

The reference's reporting quirks, kept:
* pair seq 8 / src frame 15 is skipped (eval.py:93-95);
* RRE/RTE are averaged over accepted pairs only (eval.py:229-237);
* PMR tiers at >0 / >=0.1 / >=0.3 / >=0.5 coarse precision;
* registration methods: lgr (the dumped transform), svd (weighted Procrustes
  on the dumped correspondences), ransac (on ``--device`` through
  ``ops/ransac.py``, or numpy), ransac_featurematch (mutual nearest coarse
  features, then RANSAC), teaser (needs ``teaserpp_python``).

Usage:
    rdmnet-torch-eval --feature_dir DIR
        [--method lgr|svd|ransac|ransac_featurematch|teaser] [--json_out FILE]
        [--figures [--figure_dir DIR] [--baselines kitti|kitti360|apollo|mulran|none]]

``--figures`` writes per-sequence trajectories (Umeyama-aligned, with their
ATE), recall-vs-threshold curves and, with published results for the
dataset, a method comparison, under the JAX CLI's file names.
"""

from __future__ import annotations

import argparse
import functools
import glob
import importlib.util
import json
import os.path as osp

import numpy as np

from rdmnet_tpu_torch.utils.se3_np import apply_transform


def procrustes_np(src, ref, weights=None):
    """Weighted SVD Procrustes: the (4, 4) transform taking src onto ref."""
    if weights is None:
        weights = np.ones(len(src))
    w = weights / (weights.sum() + 1e-12)
    mu_s = (src * w[:, None]).sum(0)
    mu_r = (ref * w[:, None]).sum(0)
    h = (src - mu_s).T @ ((ref - mu_r) * w[:, None])
    u, _, vt = np.linalg.svd(h)
    d = np.sign(np.linalg.det(vt.T @ u.T))
    r = vt.T @ np.diag([1.0, 1.0, d]) @ u.T
    tf = np.eye(4)
    tf[:3, :3] = r
    tf[:3, 3] = mu_r - r @ mu_s
    return tf


def ransac_device(src, ref, weights, num_iterations=5000, num_samples=4, threshold=0.3,
                  seed=0, device=None):
    """RANSAC with every hypothesis solved and scored in parallel on
    ``device`` (CUDA unless told otherwise); the interface of ``ransac_np``."""
    from rdmnet_tpu_torch.ops.ransac import ransac_registration_host

    return ransac_registration_host(src, ref, weights, num_iterations=num_iterations,
                                    num_samples=num_samples, threshold=threshold, seed=seed,
                                    device=device)


def ransac_np(src, ref, weights, num_iterations=5000, num_samples=4, threshold=0.3, seed=0):
    """Sequential RANSAC on the host, refit on the best hypothesis' inliers."""
    rng = np.random.RandomState(seed)
    n = len(src)
    best_tf, best_inliers = np.eye(4), -1
    if n < num_samples:
        return procrustes_np(src, ref, weights)
    for _ in range(num_iterations):
        idx = rng.choice(n, num_samples, replace=False)
        tf = procrustes_np(src[idx], ref[idx])
        res = np.linalg.norm(ref - apply_transform(src, tf), axis=1)
        inliers = int((res < threshold).sum())
        if inliers > best_inliers:
            best_inliers, best_tf = inliers, tf
    res = np.linalg.norm(ref - apply_transform(src, best_tf), axis=1)
    mask = res < threshold
    if mask.sum() >= 3:
        best_tf = procrustes_np(src[mask], ref[mask])
    return best_tf


def teaser_np(src, ref):
    """TEASER++ registration (reference eval.py:196-219); needs the optional
    ``teaserpp_python`` package."""
    try:
        import teaserpp_python
    except ImportError as e:
        raise ImportError(
            "method 'teaser' requires the optional teaserpp-python package "
            "(https://github.com/MIT-SPARK/TEASER-plusplus); it is not installed "
            "in this environment. Use --method lgr|svd|ransac.") from e
    params = teaserpp_python.RobustRegistrationSolver.Params()
    params.cbar2 = 1.0
    params.noise_bound = 0.01  # reference eval.py:201
    params.estimate_scaling = False
    params.rotation_estimation_algorithm = (
        teaserpp_python.RobustRegistrationSolver.ROTATION_ESTIMATION_ALGORITHM.GNC_TLS)
    params.rotation_gnc_factor = 1.4
    params.rotation_max_iterations = 100
    params.rotation_cost_threshold = 1e-12
    solver = teaserpp_python.RobustRegistrationSolver(params)
    solver.solve(src.T.astype(np.float64), ref.T.astype(np.float64))
    sol = solver.getSolution()
    tf = np.eye(4)
    tf[:3, :3] = sol.rotation
    tf[:3, 3] = sol.translation
    return tf


def main(argv=None):
    """Parse ``argv`` (``sys.argv`` if None), evaluate the dumps, and return
    the summary that ``--json_out`` writes."""
    from rdmnet_tpu_torch.config import make_cfg
    from rdmnet_tpu_torch.engine.meters import SummaryBoard
    from rdmnet_tpu_torch.utils.metrics_np import (compute_registration_error,
                                                   evaluate_correspondences,
                                                   evaluate_sparse_correspondences)

    parser = argparse.ArgumentParser()
    parser.add_argument("--feature_dir", required=True)
    parser.add_argument("--method", default="lgr",
                        choices=["lgr", "svd", "ransac", "ransac_featurematch", "teaser"])
    parser.add_argument("--num_corr", type=int, default=None)
    parser.add_argument("--ransac_iterations", type=int, default=50000)
    parser.add_argument("--ransac_impl", default="device", choices=["device", "numpy"],
                        help="device = parallel hypotheses on --device (ops/ransac.py); "
                             "numpy = sequential host loop")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="where device RANSAC runs: cuda (default; fails without a "
                             "card) or cpu")
    parser.add_argument("--verbose", action="store_true")
    parser.add_argument("--json_out", default=None,
                        help="write the summary (RR/RRE/RTE/PIR..., per-pair errors, "
                             "failed pairs) as JSON")
    parser.add_argument("--figures", action="store_true",
                        help="write trajectory (Umeyama/ATE) and recall-vs-threshold figures")
    parser.add_argument("--figure_dir", default=None,
                        help="where --figures go (default <feature_dir>/figures)")
    parser.add_argument("--baselines", default=None,
                        choices=["kitti", "kitti360", "apollo", "mulran", "none"],
                        help="overlay the bundled published results (utils/baselines.py) "
                             "on the figures and write a method comparison. Default: "
                             "the dataset key in the feature_dir's name, if any; 'none' "
                             "disables")
    args = parser.parse_args(argv)
    if args.figures and importlib.util.find_spec("matplotlib") is None:
        parser.error("--figures draws with matplotlib, which is not installed here")

    cfg = make_cfg()
    ransac_fn = (functools.partial(ransac_device, device=args.device)
                 if args.ransac_impl == "device" else ransac_np)
    coarse_meter, fine_meter, reg_meter = SummaryBoard(), SummaryBoard(), SummaryBoard()
    accepted_rre, accepted_rte = [], []
    fail_cases, all_pairs = [], []

    files = sorted(glob.glob(osp.join(args.feature_dir, "*.npz")))
    for i, fname in enumerate(files):
        parts = osp.splitext(osp.basename(fname))[0].split("_")
        seq_id = parts[0]
        src_frame, ref_frame = int(parts[1]), int(parts[2])
        # the reference skips this corrupted pair (eval.py:93-95)
        if seq_id == "8" and src_frame == 15:
            continue

        d = np.load(fname)
        gt_transform = d["transform"]
        ref_corr, src_corr, corr_scores = d["ref_corr_points"], d["src_corr_points"], d["corr_scores"]
        if args.num_corr is not None and len(corr_scores) > args.num_corr:
            sel = np.argsort(-corr_scores)[: args.num_corr]
            ref_corr, src_corr, corr_scores = ref_corr[sel], src_corr[sel], corr_scores[sel]

        c = evaluate_sparse_correspondences(
            len(d["ref_points_c"]), len(d["src_points_c"]), d["ref_node_corr_indices"],
            d["src_node_corr_indices"], d["gt_node_corr_indices"])
        coarse_meter.update("precision", c["precision"])
        # reference tiers (eval.py:144-147): > for the 0 tier, >= for the others
        coarse_meter.update("PMR>0", float(c["precision"] > 0.0))
        for thr in (0.1, 0.3, 0.5):
            coarse_meter.update(f"PMR>={thr}", float(c["precision"] >= thr))

        f = evaluate_correspondences(ref_corr, src_corr, gt_transform,
                                     positive_radius=cfg.eval.acceptance_radius)
        fine_meter.update("inlier_ratio", f["inlier_ratio"])
        fine_meter.update("overlap", f["overlap"])
        fine_meter.update("num_corr", f["num_corr"])
        fine_meter.update("recall", float(f["inlier_ratio"] >= cfg.eval.inlier_ratio_threshold))

        if args.method == "lgr":
            est = d["estimated_transform"]
        elif args.method == "svd":
            est = procrustes_np(src_corr, ref_corr, corr_scores)
        elif args.method == "ransac_featurematch":
            # mutual nearest coarse features, then RANSAC on the node pairs
            rf, sf = d["ref_feats_c"], d["src_feats_c"]
            sim = rf @ sf.T
            r2s, s2r = sim.argmax(1), sim.argmax(0)
            mutual = s2r[r2s] == np.arange(len(rf))
            ref_m = d["ref_points_c"][mutual]
            src_m = d["src_points_c"][r2s[mutual]]
            est = ransac_fn(src_m, ref_m, np.ones(len(ref_m)),
                            num_iterations=args.ransac_iterations,
                            num_samples=cfg.ransac.num_points,
                            threshold=cfg.ransac.distance_threshold)
        elif args.method == "teaser":
            est = teaser_np(src_corr, ref_corr)
        else:
            est = ransac_fn(src_corr, ref_corr, corr_scores,
                            num_iterations=args.ransac_iterations,
                            num_samples=cfg.ransac.num_points,
                            threshold=cfg.ransac.distance_threshold)

        rre, rte, rx, ry, rz = compute_registration_error(gt_transform, est)
        all_pairs.append({"seq_id": seq_id, "src_frame": src_frame, "ref_frame": ref_frame,
                          "estimated_transform": est, "gt_transform": gt_transform,
                          "rre": rre, "rte": rte, "pir": c["precision"],
                          "ir": f["inlier_ratio"], "overlap": f["overlap"]})
        accepted = rre < cfg.eval.rre_threshold and rte < cfg.eval.rte_threshold
        reg_meter.update("recall", float(accepted))
        if accepted:
            accepted_rre.append(rre)
            accepted_rte.append(rte)
            reg_meter.update("rx", rx)
            reg_meter.update("ry", ry)
            reg_meter.update("rz", rz)
        else:
            fail_cases.append(f"{seq_id}_{src_frame}_{ref_frame}")
        if args.verbose:
            print(f"[{i + 1}/{len(files)}] {osp.basename(fname)}: "
                  f"RRE {rre:.3f} RTE {rte:.3f} accepted={accepted}")

    print(f"== eval ({args.method}) over {len(files)} pairs ==")
    print("coarse:", coarse_meter.format())
    print("fine:  ", fine_meter.format())
    print(f"reg:    RR: {reg_meter.mean('recall') * 100:.2f}%, "
          f"RRE: {np.mean(accepted_rre) if accepted_rre else float('nan'):.4f} deg, "
          f"RTE: {np.mean(accepted_rte) * 100 if accepted_rte else float('nan'):.2f} cm, "
          f"Rx: {reg_meter.mean('rx'):.3f}, Ry: {reg_meter.mean('ry'):.3f}, "
          f"Rz: {reg_meter.mean('rz'):.3f}")
    if fail_cases:
        print("failed pairs:", fail_cases)

    summary = {
        "method": args.method,
        "n_pairs": len(all_pairs),
        "RR": float(reg_meter.mean("recall")),
        "RRE_deg": float(np.mean(accepted_rre)) if accepted_rre else None,
        "RTE_m": float(np.mean(accepted_rte)) if accepted_rte else None,
        "PIR": float(coarse_meter.mean("precision")),
        "IR": float(fine_meter.mean("inlier_ratio")),
        "overlap": float(fine_meter.mean("overlap")),
        "failed_pairs": fail_cases,
        "per_pair": [{"seq_id": p["seq_id"], "src_frame": p["src_frame"],
                      "ref_frame": p["ref_frame"], "rre": float(p["rre"]),
                      "rte": float(p["rte"]), "pir": float(p["pir"]), "ir": float(p["ir"]),
                      "overlap": float(p["overlap"])} for p in all_pairs],
    }
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(summary, f, indent=1)
        print(f"summary JSON written to {args.json_out}")
    if args.figures and all_pairs:
        write_figures(args, cfg, all_pairs, float(reg_meter.mean("recall")), accepted_rre,
                      accepted_rte)
    return summary


def default_baselines(feature_dir: str):
    """The dataset key in ``feature_dir``'s name (``rdmnet-torch-test``
    writes ``output/features<dataset>``), or None."""
    base = osp.basename(osp.normpath(feature_dir)).lower()
    for key in ("kitti360", "mulran", "apollo", "kitti"):
        if key in base:
            return key
    return None


def write_figures(args, cfg, all_pairs, recall, accepted_rre, accepted_rte) -> str:
    """The ``--figures`` outputs; returns their directory."""
    from rdmnet_tpu_torch.utils.baselines import published_for
    from rdmnet_tpu_torch.utils.eval_figures import (plot_method_comparison, plot_recall_curves,
                                                     sequence_trajectory_report)

    baselines = args.baselines if args.baselines is not None else default_baselines(
        args.feature_dir)
    published = published_for(baselines) if baselines not in (None, "none") else {}
    figure_dir = args.figure_dir or osp.join(args.feature_dir, "figures")
    ate = sequence_trajectory_report(all_pairs, figure_dir, method=args.method)
    for seq, errors in ate.items():
        print(f"traj seq {seq}:", ", ".join(f"{k}: {v:.3f}" for k, v in errors.items()))
    plot_recall_curves(
        osp.join(figure_dir, f"recall_curves_{args.method}.png"),
        {args.method: (np.array([p["rre"] for p in all_pairs]),
                       np.array([p["rte"] for p in all_pairs]))},
        rre_fixed=cfg.eval.rre_threshold, rte_fixed=cfg.eval.rte_threshold, published=published)
    if published:
        ours = f"ours ({args.method})"
        rows = {ours: {
            "rr": recall * 100,
            "rre_deg": float(np.mean(accepted_rre)) if accepted_rre else float("nan"),
            "rte_cm": float(np.mean(accepted_rte)) * 100 if accepted_rte else float("nan"),
        }}
        rows.update(published)
        plot_method_comparison(osp.join(figure_dir, f"method_comparison_{args.method}.png"),
                               rows, highlight=ours,
                               title=f"{baselines}: this run vs published results")
    print(f"figures written to {figure_dir}")
    return figure_dir


if __name__ == "__main__":
    main()

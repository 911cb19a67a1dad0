"""Registration pair datasets: KITTI / KITTI-360 / Apollo-SouthBay / MulRan
(own copy of ``rdmnet_tpu/data/datasets.py``).

One parameterised class over the four on-disk layouts:

| dataset  | GT file    | cloud path                      | splits |
|----------|------------|---------------------------------|--------|
| kitti    | icp10/%02d | downsampled_xyzi/%02d/%06d.npy  | train 0-5 / val 6-7 / test 8-10 |
| kitti360 | icp10/%04d | downsampled_xyzi/%04d/%010d.npy | test 0,2-7,9,10 |
| apollo   | icp10/%02d | downsampled_xyzi/%02d/%06d.npy  | test 1-4 |
| mulran   | icp10/<seq> | downsampled_xyzi/<seq>/%d.npy  | test kaist01, riveside01, sejong01 |

GT line format: ``anc_idx pos_idx r00 r01 ... t2`` (3x4 row-major), frame0 =
pos_idx (ref), frame1 = anc_idx (src). Items draw from one
``np.random.RandomState`` in the JAX package's order (ref subsample, src
subsample, augmentation), so a seed gives the same items bit for bit.
"""

from __future__ import annotations

import dataclasses
import os
import os.path as osp
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np

from rdmnet_tpu_torch.utils.se3_np import augment_point_cloud_pair


@dataclasses.dataclass(frozen=True)
class DatasetSchema:
    gt_file: str              # format string over seq
    cloud_path: str           # format string over (seq, frame)
    train_seqs: tuple = ()
    val_seqs: tuple = ()
    test_seqs: tuple = ()


SCHEMAS: Dict[str, DatasetSchema] = {
    "kitti": DatasetSchema(
        gt_file="icp10/{seq:02d}",
        cloud_path="downsampled_xyzi/{seq:02d}/{frame:06d}.npy",
        train_seqs=(0, 1, 2, 3, 4, 5),
        val_seqs=(6, 7),
        test_seqs=(8, 9, 10),
    ),
    "kitti360": DatasetSchema(
        gt_file="icp10/{seq:04d}",
        cloud_path="downsampled_xyzi/{seq:04d}/{frame:010d}.npy",
        test_seqs=(0, 2, 3, 4, 5, 6, 7, 9, 10),
    ),
    "apollo": DatasetSchema(
        gt_file="icp10/{seq:02d}",
        cloud_path="downsampled_xyzi/{seq:02d}/{frame:06d}.npy",
        test_seqs=(1, 2, 3, 4),
    ),
    "mulran": DatasetSchema(
        gt_file="icp10/{seq}",
        cloud_path="downsampled_xyzi/{seq}/{frame:d}.npy",
        test_seqs=("kaist01", "riveside01", "sejong01"),
    ),
}


def load_gt_pairs(path: str, seq) -> List[dict]:
    """Parse one GT pair file; lines with fewer than 14 fields are skipped."""
    out = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 14:
                continue
            anc_idx, pos_idx = int(parts[0]), int(parts[1])
            tf = np.array([float(x) for x in parts[2:14]]).reshape(3, 4)
            tf = np.vstack([tf, [0.0, 0.0, 0.0, 1.0]])
            out.append({"seq_id": seq, "frame0": pos_idx, "frame1": anc_idx,
                        "transform": tf.astype(np.float32)})
    return out


def make_dataset(dataset: str, root: str, subset: str) -> List[dict]:
    """Pair metadata of one split; ``infer`` is the two bundled demo pairs."""
    schema = SCHEMAS[dataset]
    if subset == "infer":
        # the two bundled demo pairs (reference kitti/dataset.py:56-63)
        return [
            {"seq_id": 0, "frame0": 0, "frame1": 4, "transform": np.eye(4, dtype=np.float32)},
            {"seq_id": 0, "frame0": 0, "frame1": 7, "transform": np.eye(4, dtype=np.float32)},
        ]
    seqs = {"train": schema.train_seqs, "val": schema.val_seqs, "test": schema.test_seqs}[subset]
    metadata = []
    for seq in seqs:
        metadata += load_gt_pairs(osp.join(root, schema.gt_file.format(seq=seq)), seq)
    return metadata


def write_procedural_root(root: str, dataset: str, sequences: Mapping[object, Tuple[int, int]],
                          **scan_kwargs) -> None:
    """Write a dataset root in ``dataset``'s layout from procedural scans
    (``data.procedural.procedural_sequence``; the JAX package's
    ``scripts/make_synth_kitti.py --procedural`` writes the same files).
    ``sequences`` maps a sequence to (scene seed, frames); frame i+1 pairs
    with frame i under their exact relative pose. Every other sequence of
    the schema gets an empty GT file. MulRan clouds are xyz, the others
    xyzi."""
    from rdmnet_tpu_torch.data.procedural import procedural_sequence

    schema = SCHEMAS[dataset]
    for seq, (seed, n_frames) in sequences.items():
        scans, poses = procedural_sequence(seed, n_frames, **scan_kwargs)
        for i, scan in enumerate(scans):
            path = osp.join(root, schema.cloud_path.format(seq=seq, frame=i))
            os.makedirs(osp.dirname(path), exist_ok=True)
            np.save(path, scan[:, :3] if dataset == "mulran" else scan)
        lines = []
        for i in range(n_frames - 1):
            tf = np.linalg.inv(poses[i]) @ poses[i + 1]
            lines.append(f"{i + 1} {i} " + " ".join(f"{v:.9f}" for v in tf[:3].reshape(-1)))
        gt = osp.join(root, schema.gt_file.format(seq=seq))
        os.makedirs(osp.dirname(gt), exist_ok=True)
        with open(gt, "w") as f:
            f.write("\n".join(lines))
    for seq in schema.train_seqs + schema.val_seqs + schema.test_seqs:
        gt = osp.join(root, schema.gt_file.format(seq=seq))
        if not osp.exists(gt):
            os.makedirs(osp.dirname(gt), exist_ok=True)
            open(gt, "a").close()


class RegistrationPairDataset:
    """One (ref, src) pair per item as numpy dicts: a random ``point_limit``
    subsample per cloud and optional augmentation (reference
    kitti/dataset.py:108-191).

    ``root`` may be a comma-separated list of roots of one schema,
    concatenated; with more than one, ``seq_id`` becomes ``"<i>.<seq>"``
    (root index prefix) so dump names stay distinct, and cloud paths are
    resolved per root. The ``infer`` subset reads the demo clouds from
    ``demo_asset_dir`` (default ``<root>/assets/pc``)."""

    def __init__(
        self,
        dataset: str,
        root: str,
        subset: str,
        point_limit: Optional[int] = None,
        use_augmentation: bool = False,
        augmentation_noise: float = 0.01,
        augmentation_min_scale: float = 0.8,
        augmentation_max_scale: float = 1.2,
        augmentation_shift: float = 2.0,
        augmentation_rotation: float = 1.0,
        seed: int = 7351,
        demo_asset_dir: Optional[str] = None,
    ):
        self.dataset = dataset
        self.schema = SCHEMAS[dataset]
        self.subset = subset
        self.point_limit = point_limit
        self.use_augmentation = use_augmentation
        self.aug = dict(
            noise=augmentation_noise,
            min_scale=augmentation_min_scale,
            max_scale=augmentation_max_scale,
            shift=augmentation_shift,
            rotation_factor=augmentation_rotation,
        )
        self.rng = np.random.RandomState(seed)
        self.demo_asset_dir = demo_asset_dir
        roots = [r for r in str(root).split(",") if r]
        self.root = roots[0]
        if subset == "infer" or len(roots) == 1:
            self.metadata = make_dataset(dataset, self.root, subset)
        else:
            self.metadata = []
            for i, r in enumerate(roots):
                for meta in make_dataset(dataset, r, subset):
                    seq, f0, f1 = meta["seq_id"], meta["frame0"], meta["frame1"]
                    meta["ref_path"] = osp.join(r, self.schema.cloud_path.format(seq=seq, frame=f0))
                    meta["src_path"] = osp.join(r, self.schema.cloud_path.format(seq=seq, frame=f1))
                    meta["seq_id"] = f"{i}.{seq}"
                    self.metadata.append(meta)

    def __len__(self):
        return len(self.metadata)

    def _cloud_path(self, seq, frame) -> str:
        if self.subset == "infer":
            base = self.demo_asset_dir or osp.join(self.root, "assets/pc")
            return osp.join(base, f"{frame:06d}.npy")
        return osp.join(self.root, self.schema.cloud_path.format(seq=seq, frame=frame))

    def _load_point_cloud(self, path: str) -> np.ndarray:
        points = np.load(path)[:, :3].astype(np.float32)
        if self.point_limit is not None and points.shape[0] > self.point_limit:
            indices = self.rng.permutation(points.shape[0])[: self.point_limit]
            points = points[indices]
        return points

    def __getitem__(self, index: int) -> dict:
        meta = self.metadata[index]
        ref_points = self._load_point_cloud(
            meta.get("ref_path") or self._cloud_path(meta["seq_id"], meta["frame0"]))
        src_points = self._load_point_cloud(
            meta.get("src_path") or self._cloud_path(meta["seq_id"], meta["frame1"]))
        transform = meta["transform"].astype(np.float32)
        if self.use_augmentation:
            ref_points, src_points, transform = augment_point_cloud_pair(
                self.rng, ref_points, src_points, transform, **self.aug)
        return {
            "seq_id": meta["seq_id"],
            "ref_frame": meta["frame0"],
            "src_frame": meta["frame1"],
            "ref_points": ref_points,
            "src_points": src_points,
            "transform": transform,
        }

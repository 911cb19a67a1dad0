"""Registration pair datasets (own copy of the part of
``rdmnet_tpu/data/datasets.py`` that inference reads: the ``infer`` subset,
the two bundled demo pairs). The train/val/test subsets, their GT files and
augmentation come with the data-pipeline slice."""

from __future__ import annotations

import os.path as osp
from typing import List, Optional

import numpy as np


def make_dataset(dataset: str, root: str, subset: str) -> List[dict]:
    if subset != "infer":
        raise NotImplementedError(
            f"subset {subset!r}: the port reads only the 'infer' demo pairs so far")
    # the two bundled demo pairs (reference kitti/dataset.py:56-63)
    return [
        {"seq_id": 0, "frame0": 0, "frame1": 4, "transform": np.eye(4, dtype=np.float32)},
        {"seq_id": 0, "frame0": 0, "frame1": 7, "transform": np.eye(4, dtype=np.float32)},
    ]


class RegistrationPairDataset:
    """One (ref, src) pair per item as numpy dicts. The demo clouds are read
    from ``demo_asset_dir`` (default ``<root>/assets/pc``)."""

    def __init__(self, dataset: str, root: str, subset: str,
                 demo_asset_dir: Optional[str] = None):
        self.dataset = dataset
        self.subset = subset
        self.demo_asset_dir = demo_asset_dir
        self.root = [r for r in str(root).split(",") if r][0]
        self.metadata = make_dataset(dataset, self.root, subset)

    def __len__(self):
        return len(self.metadata)

    def _cloud_path(self, frame) -> str:
        base = self.demo_asset_dir or osp.join(self.root, "assets/pc")
        return osp.join(base, f"{frame:06d}.npy")

    @staticmethod
    def _load_point_cloud(path: str) -> np.ndarray:
        return np.load(path)[:, :3].astype(np.float32)

    def __getitem__(self, index: int) -> dict:
        meta = self.metadata[index]
        return {
            "seq_id": meta["seq_id"],
            "ref_frame": meta["frame0"],
            "src_frame": meta["frame1"],
            "ref_points": self._load_point_cloud(self._cloud_path(meta["frame0"])),
            "src_points": self._load_point_cloud(self._cloud_path(meta["frame1"])),
            "transform": meta["transform"].astype(np.float32),
        }

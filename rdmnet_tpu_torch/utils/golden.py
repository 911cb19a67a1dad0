"""A PairBatch from the reference's stacked collate graph
(twin of ``rdmnet_tpu/utils/golden.py``).

Two stacked layouts must not be confused:

* the reference's collate (its ``utils/data.py``) PACKS each level's valid
  rows, ref first: ``points[i]`` is (ref_n + src_n, 3), ``lengths[i]`` is
  [ref_n, src_n], and every index table points into the stacked rows of its
  target level with the sentinel ``total`` = ref_n + src_n of that level;
* the port's own ``graph/pyramid.StackedGraph`` pads each cloud to its
  capacity C and puts src at an offset of C, sentinel 2C.

``pair_batch_from_stacked`` splits the reference's layout into per-cloud
``CloudPyramid``s of capacity ``round8(max(ref_n, src_n))`` per level (pad
rows at ``pad_coord``, sentinel = capacity), so the model runs on the
reference's exact neighbour structure; ``stack_pair_batch`` packs a
``PairBatch`` the other way. ``load_golden_npz`` reads the golden dump of
``scripts/dump_reference_golden.py`` (numpy only).
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from rdmnet_tpu_torch.device import resolve_device
from rdmnet_tpu_torch.graph.pyramid import CloudPyramid, PairBatch


def _round8(n: int) -> int:
    return max(8, -(-n // 8) * 8)


def _split_table(table: np.ndarray, q_ref_n: int, q_src_n: int, s_ref_n: int, s_src_n: int,
                 s_cap: int, q_cap: int):
    """Stacked (q_total, K) table -> per-cloud (q_cap, K) tables into their
    own cloud's rows, sentinel ``s_cap``; entries into the other cloud or at
    the stacked sentinel become the sentinel."""
    k = table.shape[1]

    def one(rows, lo, hi):
        out = np.full((q_cap, k), s_cap, np.int32)
        out[:len(rows)] = np.where((rows >= lo) & (rows < hi), rows - lo, s_cap)
        return out

    return (one(table[:q_ref_n], 0, s_ref_n),
            one(table[q_ref_n:q_ref_n + q_src_n], s_ref_n, s_ref_n + s_src_n))


def pair_batch_from_stacked(points: Sequence[np.ndarray], lengths: Sequence[np.ndarray],
                            neighbors: Sequence[np.ndarray], subsampling: Sequence[np.ndarray],
                            upsampling: Sequence[np.ndarray], transform: np.ndarray,
                            pad_coord: float = 1.0e9, device=None) -> PairBatch:
    """Split the reference's stacked pyramid into the port's ``PairBatch``,
    on CUDA unless ``device`` names another device.

    points: per level (total_i, 3), ref rows first; lengths: per level
    [ref_n, src_n]; neighbors: per level (total_i, K_i) into level i;
    subsampling: level i (total_{i+1}, K_i) into level i; upsampling: level i
    (total_i, K_{i+1}) into level i+1; transform: (4, 4) src -> ref.
    ``dropped`` is zero (the reference drops nothing) and the input features
    are 1 on valid rows."""
    dev = resolve_device(device)
    ns = len(points)
    ref_n = [int(lengths[i][0]) for i in range(ns)]
    src_n = [int(lengths[i][1]) for i in range(ns)]
    caps = [_round8(max(ref_n[i], src_n[i])) for i in range(ns)]

    pts: List[List[np.ndarray]] = [[], []]
    for i in range(ns):
        for c, (n, off) in enumerate(((ref_n[i], 0), (src_n[i], ref_n[i]))):
            p = np.full((caps[i], 3), pad_coord, np.float32)
            p[:n] = points[i][off:off + n]
            pts[c].append(p)

    nbrs: List[list] = [[], []]
    subs: List[list] = [[], []]
    ups: List[list] = [[], []]
    for i in range(ns):
        tabs = [(nbrs, neighbors[i], i, i)]
        if i < ns - 1:
            tabs += [(subs, subsampling[i], i + 1, i), (ups, upsampling[i], i, i + 1)]
        for out, table, q, s in tabs:
            r, t = _split_table(np.asarray(table), ref_n[q], src_n[q], ref_n[s], src_n[s],
                                caps[s], caps[q])
            out[0].append(r)
            out[1].append(t)

    def tensors(arrays):
        return tuple(torch.from_numpy(a).to(dev) for a in arrays)

    def pyramid(c, counts):
        return CloudPyramid(
            points=tensors(pts[c]),
            counts=tuple(torch.tensor(n, dtype=torch.int32, device=dev) for n in counts),
            neighbors=tensors(nbrs[c]), subsampling=tensors(subs[c]), upsampling=tensors(ups[c]),
            dropped=torch.zeros((ns,), dtype=torch.int32, device=dev))

    feats = []
    for n in (ref_n[0], src_n[0]):
        f = np.zeros((caps[0], 1), np.float32)
        f[:n] = 1.0
        feats.append(torch.from_numpy(f).to(dev))
    return PairBatch(ref=pyramid(0, ref_n), src=pyramid(1, src_n), ref_feats=feats[0],
                     src_feats=feats[1],
                     transform=torch.as_tensor(np.asarray(transform, np.float32), device=dev))


def stack_pair_batch(batch: PairBatch) -> dict:
    """The reference's stacked layout of a ``PairBatch``'s pyramid (numpy),
    the inverse of ``pair_batch_from_stacked``: per level the valid ref rows
    then the valid src rows, each table into the stacked rows of its target
    level, sentinel = that level's total. Keys are the splitter's arguments."""
    ref, src = batch.ref, batch.src
    ns = len(ref.points)
    n = [(int(ref.counts[i]), int(src.counts[i])) for i in range(ns)]
    host = lambda t: t.detach().cpu().numpy()  # noqa: E731

    def stack(ref_tab, src_tab, q, s):
        total = n[s][0] + n[s][1]
        r, t = host(ref_tab)[:n[q][0]], host(src_tab)[:n[q][1]]
        r = np.where(r < n[s][0], r, total)
        t = np.where(t < n[s][1], t + n[s][0], total)
        return np.concatenate([r, t]).astype(np.int64)

    return dict(
        points=[np.concatenate([host(ref.points[i])[:n[i][0]], host(src.points[i])[:n[i][1]]])
                for i in range(ns)],
        lengths=[np.array(n[i], np.int64) for i in range(ns)],
        neighbors=[stack(ref.neighbors[i], src.neighbors[i], i, i) for i in range(ns)],
        subsampling=[stack(ref.subsampling[i], src.subsampling[i], i + 1, i)
                     for i in range(ns - 1)],
        upsampling=[stack(ref.upsampling[i], src.upsampling[i], i, i + 1)
                    for i in range(ns - 1)],
    )


def load_golden_npz(path: str):
    """The golden dump -> (graph pieces, outputs, state_dict) as numpy."""
    with np.load(path, allow_pickle=False) as z:
        ns = 1 + max(int(k.split("_")[-1]) for k in z.files if k.startswith("points_"))
        graph = dict(
            points=[z[f"points_{i}"] for i in range(ns)],
            lengths=[z[f"lengths_{i}"] for i in range(ns)],
            neighbors=[z[f"neighbors_{i}"] for i in range(ns)],
            subsampling=[z[f"subsampling_{i}"] for i in range(ns - 1)],
            upsampling=[z[f"upsampling_{i}"] for i in range(ns - 1)],
        )
        outputs = {k[len("out_"):]: z[k] for k in z.files if k.startswith("out_")}
        state_dict = {k[len("sd::"):]: z[k] for k in z.files if k.startswith("sd::")}
    return graph, outputs, state_dict

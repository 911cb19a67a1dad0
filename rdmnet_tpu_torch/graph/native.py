"""ctypes bindings for the native C++ host graph builder (twin of
``rdmnet_tpu/graph/native.py``).

The library is ``native/graph_builder.cpp`` of this repository, compiled by
the port itself at first use into ``rdmnet_tpu_torch/_build/`` with the flags
of ``native/Makefile`` (``-O3 -march=native -fopenmp``), so that on one host
its results equal those of the JAX package's library bit for bit. The file
name carries a hash of the source, the command line and the host CPU. The port
never loads ``native/librdmnet_native.so`` and never runs ``make`` in
``native/``. Nothing is built at import time.

It serves the host data path: preprocessing (ICP on the CPU), calibration
checks and pyramids built on the host.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import platform
import subprocess
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from rdmnet_tpu_torch.ops.grid_subsample import voxel_sort_key_np

REPO_DIR = Path(__file__).resolve().parents[2]
SOURCE = REPO_DIR / "native" / "graph_builder.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXX = ["g++", "-O3", "-march=native", "-fopenmp", "-std=c++17", "-fPIC", "-Wall", "-shared"]


def _host_cpu() -> bytes:
    """What ``-march=native`` compiles for: the host's CPU model and flags."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            lines = f.read().splitlines()
    except OSError:
        return platform.processor().encode()
    return b"\n".join(sorted({ln for ln in lines if ln.startswith((b"model name", b"flags"))}))


def library_path() -> Path:
    """The library's file: a hash of the source, the command line and the
    host CPU, since ``-march=native`` builds differ from host to host."""
    h = hashlib.sha1(SOURCE.read_bytes())
    h.update(" ".join(CXX).encode())
    h.update(_host_cpu())
    return BUILD_DIR / f"librdmnet_native-{h.hexdigest()[:12]}.so"


def build() -> Path:
    """Compile the library unless this source with these flags is built."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    res = subprocess.run([*CXX, "-o", str(tmp), str(SOURCE)], capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"{CXX[0]} failed to build {SOURCE.name}:\n{res.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent reader never sees a partial file
    return out


@functools.lru_cache(maxsize=None)
def _load() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.rdm_grid_subsample.restype = ctypes.c_int32
    lib.rdm_grid_subsample.argtypes = [f32p, ctypes.c_int32, ctypes.c_float, f32p, ctypes.c_int32]
    lib.rdm_radius_knn.restype = None
    lib.rdm_radius_knn.argtypes = [f32p, ctypes.c_int32, f32p, ctypes.c_int32, ctypes.c_float,
                                   ctypes.c_int32, ctypes.c_int32, i32p]
    return lib


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def available() -> bool:
    """Whether the library builds and loads on this host."""
    try:
        _load()
        return True
    except (OSError, RuntimeError):
        return False


def grid_subsample_native(points: np.ndarray, voxel_size: float, cap: int,
                          pad_coord: float = 1.0e9) -> Tuple[np.ndarray, int]:
    """Voxel-centroid subsample. Returns ((cap, 3) padded, count)."""
    lib = _load()
    points = np.ascontiguousarray(points, np.float32)
    out = np.full((cap, 3), pad_coord, np.float32)
    count = lib.rdm_grid_subsample(_f32p(points), len(points), voxel_size, _f32p(out), cap)
    return out, int(count)


def radius_knn_native(q_points: np.ndarray, s_points: np.ndarray, s_count: int,
                      radius: float, k: int, sentinel: Optional[int] = None) -> np.ndarray:
    """Radius-bounded kNN, sentinel-padded, ascending distance -> (Q, k) int32."""
    lib = _load()
    q = np.ascontiguousarray(q_points, np.float32)
    s = np.ascontiguousarray(s_points, np.float32)
    sentinel = len(s) if sentinel is None else sentinel
    out = np.empty((len(q), k), np.int32)
    lib.rdm_radius_knn(_f32p(q), len(q), _f32p(s), s_count, radius, k, sentinel,
                       out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return out


def build_pyramid_native(points: np.ndarray, spec, pad_coord: float = 1.0e9) -> dict:
    """The whole pyramid on the host, in the device builder's layout: level 0
    in the device builder's voxel-key order, each level's neighbour,
    subsampling and upsampling tables (upsampling tables below
    ``spec.build_upsampling_from_level`` stay all sentinel, as on the device)."""
    level_points: List[np.ndarray] = []
    counts: List[int] = []
    p, c = points[: spec.caps[0]], min(len(points), spec.caps[0])
    key = voxel_sort_key_np(p, 2.0 * spec.voxel_size)
    p = p[np.argsort(key, kind="stable")]
    padded = np.full((spec.caps[0], 3), pad_coord, np.float32)
    padded[:c] = p
    level_points.append(padded)
    counts.append(c)

    voxel = spec.voxel_size
    for lvl in range(1, spec.num_stages):
        voxel *= 2
        sub, cnt = grid_subsample_native(level_points[-1][: counts[-1]], voxel, spec.caps[lvl],
                                         pad_coord)
        level_points.append(sub)
        counts.append(cnt)

    neighbors, subsampling, upsampling = [], [], []
    radius = spec.search_radius
    for lvl in range(spec.num_stages):
        k = spec.neighbor_limits[lvl]
        nbr = np.full((spec.caps[lvl], k), spec.caps[lvl], np.int32)
        nbr[: counts[lvl]] = radius_knn_native(level_points[lvl][: counts[lvl]],
                                               level_points[lvl], counts[lvl], radius, k,
                                               sentinel=spec.caps[lvl])
        neighbors.append(nbr)
        if lvl < spec.num_stages - 1:
            sub = np.full((spec.caps[lvl + 1], k), spec.caps[lvl], np.int32)
            sub[: counts[lvl + 1]] = radius_knn_native(
                level_points[lvl + 1][: counts[lvl + 1]], level_points[lvl], counts[lvl],
                radius, k, sentinel=spec.caps[lvl])
            subsampling.append(sub)
            k_up = spec.upsampling_limit or spec.neighbor_limits[lvl + 1]
            up = np.full((spec.caps[lvl], k_up), spec.caps[lvl + 1], np.int32)
            if lvl >= spec.build_upsampling_from_level:
                up[: counts[lvl]] = radius_knn_native(
                    level_points[lvl][: counts[lvl]], level_points[lvl + 1], counts[lvl + 1],
                    radius * 2, k_up, sentinel=spec.caps[lvl + 1])
            upsampling.append(up)
        radius *= 2

    return {"points": level_points, "counts": counts, "neighbors": neighbors,
            "subsampling": subsampling, "upsampling": upsampling}

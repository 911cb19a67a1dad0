"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for ``sm_90a`` into ``rdmnet_tpu_torch/_build/lib<name>-<hash>.so`` (the
hash covers the source, every ``csrc/*.cuh`` header and the flags, so an
edited source or header rebuilds) and
loaded with ctypes. Nothing is built at import time; a wrapper builds its
library at first use, and a caller may start several ``Build``s (one
``nvcc`` process each) before waiting on any.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Optional

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
KERNELS = ("radius_knn", "sinkhorn", "segment_sum", "nms", "eigh4", "gather_grad", "mark")

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and Path(cand, "bin", "nvcc").exists():
            return str(Path(cand, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                           "the CUDA toolkit is installed")
    return found


def source_path(name: str) -> Path:
    return CSRC_DIR / f"{name}.cu"


def library_path(name: str) -> Path:
    h = hashlib.sha1(source_path(name).read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


class Build:
    """One running ``nvcc``; ``wait()`` returns its output (the
    ``-Xptxas -v`` register and spill report) or raises on failure."""

    def __init__(self, name: str):
        self.name = name
        self.out = library_path(name)
        self.proc: Optional[subprocess.Popen] = None
        if self.out.exists():
            return
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        self.tmp = self.out.with_suffix(f".{os.getpid()}.tmp")
        cmd: List[str] = [nvcc_path(), *NVCC_FLAGS, "-o", str(self.tmp),
                          str(source_path(name))]
        self.proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True)

    def wait(self) -> str:
        if self.proc is None:
            return f"{self.out.name}: already built"
        log, _ = self.proc.communicate()
        if self.proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {self.name}:\n{log}")
        os.replace(self.tmp, self.out)  # atomic: readers never see a partial file
        return log


def load_library(name: str) -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        Build(name).wait()
        lib = ctypes.CDLL(str(library_path(name)))
        _LIBS[name] = lib
    return lib


def launch(fn, device, *args) -> int:
    """Call the C launch function ``fn`` with ``args`` and the current stream
    of ``device``'s card, with that card current (whichever device is current
    for the caller); returns its ``cudaError_t``."""
    import torch

    with torch.cuda.device(device):
        return fn(*args, torch.cuda.current_stream(device).cuda_stream)


def check(err: int, name: str) -> None:
    """Raise on a nonzero cudaError_t returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {err}")

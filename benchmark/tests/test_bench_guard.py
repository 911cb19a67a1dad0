"""Nothing the benchmark runs imports JAX or the JAX package; the reference
does not import the program either. Names are compared whole by their top
level, so ``rdmnet_tpu_torch`` is not ``rdmnet_tpu``."""

import subprocess
import sys

import pytest

from benchmark.harness import guard
from benchmark.tests.tiny import REPO

MODULES = sorted((REPO / "benchmark").rglob("*.py"))
REFERENCE = [p for p in MODULES if "reference" in p.relative_to(REPO / "benchmark").parts]


def test_the_walk_finds_the_benchmark():
    assert len(MODULES) > 30 and len(REFERENCE) > 20


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax(path):
    assert guard.forbidden_imports(path) == []


@pytest.mark.parametrize("path", REFERENCE, ids=lambda p: str(p.relative_to(REPO)))
def test_reference_stands_alone(path):
    assert guard.forbidden_imports(path, guard.FORBIDDEN_IN_REFERENCE) == []


def test_names_compare_whole(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import rdmnet_tpu_torch.models\nfrom jaxtyping import Array\n"
                 "import importlib\nimportlib.import_module('jax.numpy')\n")
    assert guard.forbidden_imports(f) == ["jax.numpy"]
    assert guard.loaded_forbidden(["rdmnet_tpu_torch", "jaxtyping", "flax.linen", "numpy"]) \
        == ["flax.linen"]


def test_the_program_loads_no_jax():
    code = ("import sys; sys.path.insert(0, {r!r}); import benchmark.run, "
            "rdmnet_tpu_torch.serving, rdmnet_tpu_torch.engine, benchmark.reference.api, "
            "benchmark.harness.drivers.register, benchmark.harness.drivers.train; "
            "from benchmark.harness import guard; print(guard.loaded_forbidden())").format(
        r=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_run_without_a_card_prints_no_result():
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "kitti.register",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=REPO,
                         env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode == 2 and out.stdout == ""
    assert "no CUDA device" in out.stderr

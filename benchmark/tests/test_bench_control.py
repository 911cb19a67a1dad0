"""The control of each kind of cell fails the limits: the plain reference
with TF32 products in the program's place, at the tiny cells' sizes. TF32
exists only on a card: run with ``-m cuda`` there; it skips elsewhere."""

import pytest
import torch

from benchmark.harness import cells, judge
from benchmark.tests.tiny import make_checkout


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: TF32 products exist only there")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["tiny.register", "tiny.train"])
def test_control_fails(tmp_path, card, cell):
    root = make_checkout(tmp_path)
    c = cells.load_cell(root, cell)
    checks = cells.driver(c).control(c, 2 ** 31 + 5, card)
    ok, compared = judge.decide(checks, c.limits)
    assert not ok, compared
